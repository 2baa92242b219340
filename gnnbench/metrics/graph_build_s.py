"""Seconds of set-up in the port's graph build: G (``from_coo``), Gᵀ
(``reverse``) where the cell trains, and the bundle or the server that
holds it, by the benchmark's host clock."""


def read(obs):
    parts = obs.get("graph_build_s")
    return sum(parts.values()) if parts else None
