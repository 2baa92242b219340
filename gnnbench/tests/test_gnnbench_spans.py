"""The readers of the port's spans (``gnnbench/spans.py``,
``metrics/*``): on synthetic span lists, and on tiny traced runs on the
CPU, where no span has a device time."""
import pytest

from gnnbench import spans as S
from gnnbench.harness import load_file_module, reader_path

from .conftest import BENCH, CELLS, mode_of, run_tiny

_ids = iter(range(1, 10_000))


def ev(name, ts, dur, parent=None, **args):
    return {"name": name, "ts": float(ts), "dur": float(dur),
            "args": dict(args, id=next(_ids), parent=parent, depth=0)}


def step(t0, i, fwd, bwd, clip, opt, aggs=()):
    """One training step's spans from ``t0`` (µs), the device times
    given; ``aggs``: (name, route, device_ms, child of the previous)."""
    f = ev("train.forward", t0, 10, step=i, device_ms=fwd)
    out = [f]
    prev = None
    for k, (name, route, ms, nested) in enumerate(aggs):
        a = ev(name, t0 + 1 + k, 1, parent=(prev or f)["args"]["id"]
               if nested else f["args"]["id"], route=route, dir="fwd",
               device_ms=ms)
        out.append(a)
        prev = a
    out += [ev("train.backward", t0 + 10, 10, step=i, device_ms=bwd),
            ev("train.clip", t0 + 20, 1, step=i, device_ms=clip),
            ev("train.optimizer", t0 + 21, 1, step=i, device_ms=opt)]
    return out


def reader(name):
    return load_file_module(reader_path(BENCH, name), f"t_{name}").read


def test_units_and_medians():
    spans = (step(0, 0, 1.0, 2.0, 0.1, 0.2) + step(100, 1, 3.0, 4.0, 0.3, 0.4)
             + step(200, 2, 5.0, 6.0, 0.5, 0.6))
    assert S.train_units(spans) == [(0.0, 22.0), (100.0, 122.0),
                                    (200.0, 222.0)]
    med = S.unit_median(S.train_units, lambda s: S.device_ms(
        s, {"train.clip", "train.optimizer"}), spans)
    assert med == pytest.approx(0.7)
    assert S.unit_median(S.train_units, lambda s: S.device_ms(
        s, {"train.backward"}), spans) == 4.0


def test_a_step_pairs_with_its_own_optimizer_span():
    a = step(0, 3, 1.0, 1.0, 1.0, 1.0)
    b = step(50, 3, 1.0, 1.0, 1.0, 1.0)      # the same step id again
    assert S.train_units(a + b) == [(0.0, 22.0), (50.0, 72.0)]
    assert S.train_units(a[:-1]) == []       # no optimizer span: no unit


def test_plain_route_leaves():
    aggs = [("agg.attn:fused", "kernel", 5.0, False),
            ("agg.hetero:u_w_v", "fused", 7.0, False),
            ("agg.u_mul_e_add_v", "segment", 2.0, True),   # the leaf
            ("agg.e_copy_max_v", "ell", 3.0, False)]
    spans = step(0, 0, 1.0, 1.0, 1.0, 1.0, aggs)
    leaves = [e["name"] for e in S.plain_leaves(spans)]
    assert leaves == ["agg.u_mul_e_add_v", "agg.e_copy_max_v"]
    assert S.plain_route_ms(spans) == 5.0
    assert S.plain_route_ms(step(0, 0, 1, 1, 1, 1)) is None   # no agg.*
    del spans[-5]["args"]["device_ms"]       # a leaf read on the CPU
    assert S.plain_route_ms(spans) is None


def test_refresh_units_and_setup():
    build = [ev("graph.host_index", 0, 2e6), ev("graph.host_index", 3e6,
                                                1e6)]
    r1 = [ev("serve.refresh", 5e6, 100),
          ev("agg.u_mul_e_add_v", 5e6 + 1, 10, route="segment",
             device_ms=4.0),
          ev("serve.refresh_store", 5e6 + 100, 30)]
    r2 = [ev("serve.refresh", 6e6, 100),
          ev("agg.u_mul_e_add_v", 6e6 + 1, 10, route="segment",
             device_ms=6.0),
          ev("graph.host_index", 6e6 + 2, 1)]      # not set-up's
    spans = build + r1 + r2
    assert S.refresh_units(spans) == [(5e6, 5e6 + 100), (6e6, 6e6 + 100)]
    assert S.unit_median(S.refresh_units, S.plain_route_ms, spans) == 5.0
    assert [e["dur"] for e in S.setup_spans(spans)] == [2e6, 1e6]


def test_readers_read_the_process_spans(monkeypatch):
    from repro_torch import obs
    spans = (step(0, 0, 1.0, 2.0, 0.1, 0.2)
             + [ev("graph.host_index", -5e6, 2e6),
                ev("graph.upload", -3e6, 5e5), ev("gnn.make_bundle", -2e6,
                                                  2.5e5)]
             + step(100, 1, 3.0, 4.0, 0.3, 0.4,
                    [("agg.u_mul_e_add_v", "segment", 9.0, False)]))
    waits = []
    monkeypatch.setattr(obs, "trace_events", lambda: spans)
    monkeypatch.setattr(obs, "resolve_device_spans",
                        lambda wait=False: waits.append(wait) or 0)
    got = {n: reader(n)({}) for n in (
        "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
        "plain_route_ms.train", "host_index_s", "upload_s",
        "make_bundle_s", "store_span_ms.refresh", "plain_route_ms.refresh")}
    assert got == {"forward_ms.train": 2.0, "backward_ms.train": 3.0,
                   "optimizer_ms.train": pytest.approx(0.5),
                   "plain_route_ms.train": 9.0, "host_index_s": 2.0,
                   "upload_s": 0.5, "make_bundle_s": 0.25,
                   "store_span_ms.refresh": None,
                   "plain_route_ms.refresh": None}
    assert waits and all(waits)
    # a program without device timing or these spans: nothing, no raise
    monkeypatch.delattr(obs, "resolve_device_spans")
    monkeypatch.setattr(obs, "trace_events", lambda: [
        ev("serve.refresh", 0, 100)])
    for name in got:
        assert reader(name)({}) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_host_spans(tiny, cell):
    from repro_torch import obs
    obs.clear_trace()
    r = run_tiny(tiny, cell, trace=True)
    m = r["metrics"]
    assert r["correct"] is True
    build = [m[n]["value"] for n in ("host_index_s", "upload_s",
                                     "make_bundle_s")]
    assert all(v > 0 for v in build)
    assert sum(build) <= m["graph_build_s"]["value"]
    if mode_of(cell) == "refresh":
        assert m["store_span_ms.refresh"]["value"] > 0
        assert "refresh_store_ms.refresh" in m
    for name in ("forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "plain_route_ms.train",
                 "plain_route_ms.refresh"):
        assert name not in m                 # no device time on the CPU
