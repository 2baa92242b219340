"""Seconds of set-up in copying the graph's index arrays to the card:
the port's ``graph.upload`` spans, G's and, where the cell trains, Gᵀ's,
summed (host time; the copies are from pageable memory)."""
from gnnbench import spans


def read(obs):
    return spans.setup_seconds("graph.upload")
