"""Port parity for ``repro_torch.obs`` (metrics, spans, measured events)
and the spans and metrics the serving tier and the sampled trainer record
through it.

The metrics module is a copy of the JAX package's: the same values give
the same buckets, quantiles and snapshot JSON in both. Span nesting,
export, coverage and the disabled no-op mirror ``tests/obs/test_spans.py``
and ``tests/obs/test_metrics.py``; a CPU tensor needs no fence, so the
fence's device wait is exercised on the card (chip_smoke.py).
"""
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.core.serving import GNNServer
from repro_torch.data import make_node_dataset
from repro_torch.launch.serve_gnn import run_session
from repro_torch.models.gnn import sage
from repro_torch.models.gnn.train import train_sampled
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

VALUES = [0.0, -2.0, 1e-9, 2.0 ** -20, 3.7e-4, 0.001, 0.002, 0.02, 0.3, 0.5,
          1.0, 1.5, 2.0 - 1e-12, 7.0, 16.0, 1e3]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (obs, jax_obs):
        mod.reset_metrics()
        mod.clear_trace()
        mod.clear_events()
    yield
    for mod in (obs, jax_obs):
        mod.reset_metrics()
        mod.clear_trace()
        mod.clear_events()


# --------------------------------------------------------------------- #
# metrics: equal to JAX's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("lo,hi", [(-20, 4), (-6, 2), (0, 0)])
def test_histogram_buckets_and_quantiles_equal_jax(lo, hi):
    a, b = Histogram("h", lo, hi), jax_obs.metrics.Histogram("h", lo, hi)
    for v in VALUES:
        assert a.bucket_index(v) == b.bucket_index(v), v
        a.observe(v)
        b.observe(v)
    assert a.buckets() == b.buckets()
    for q in (0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q), q
    assert a._snapshot() == b._snapshot()


def test_snapshot_json_equal_jax():
    for mod in (obs, jax_obs):
        mod.counter("c").inc(3)
        mod.gauge("g").set(2.5)
        h = mod.histogram("h")
        for v in VALUES:
            h.observe(v)
        mod.histogram("narrow", -4, 1).observe(0.25)
    assert json.dumps(obs.snapshot(), sort_keys=True) == json.dumps(
        jax_obs.snapshot(), sort_keys=True)


def test_percentile_nearest_rank_equal_jax():
    rng = np.random.default_rng(0)
    xs = list(rng.random(101))
    for p in (1, 50, 90, 99, 100):
        assert obs.percentile_nearest_rank(xs, p) == \
            jax_obs.percentile_nearest_rank(xs, p)
    for bad in (0, 101):
        with pytest.raises(ValueError):
            obs.percentile_nearest_rank(xs, bad)
    with pytest.raises(ValueError):
        obs.percentile_nearest_rank([], 50)


def test_bucket_index_power_of_two_edges():
    h = Histogram("t.edges")
    for i in (-20, -3, -1, 0, 1, 2):
        assert h.bucket_index(float(2.0 ** i)) == i
    assert h.bucket_index(2.0 - 1e-12) == 0
    assert h.bucket_index(0.5 - 1e-12) == -2
    assert h.bucket_index(float(2.0 ** 10)) == h.hi
    assert h.bucket_index(float(2.0 ** -30)) == h.lo
    for v in (1e-6, 3.7e-4, 0.02, 0.3, 1.5, 7.0):
        assert h.bucket_index(v) == math.floor(math.log2(v))


def test_counter_and_histogram_concurrent_exact():
    c, h = obs.counter("t.c"), obs.histogram("t.h")

    def worker(seed):
        for i in range(2_000):
            c.inc()
            h.observe(((seed + i) % 100 + 1) / 100.0)

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == 16_000 and h.count == 16_000
    assert sum(n for _, n in h.buckets()) == 16_000


def test_registry_get_or_create_and_type_mismatch():
    assert obs.counter("x") is obs.counter("x")
    with pytest.raises(TypeError):
        obs.histogram("x")
    reg = MetricsRegistry()
    reg.counter("x").inc()
    assert "x" not in MetricsRegistry().snapshot()
    assert reg.snapshot()["x"]["value"] == 1


def test_disabled_mode_is_noop():
    prev = obs.set_enabled(False)
    try:
        assert obs.enabled() is False
        c = obs.counter("dead")
        c.inc(5)
        assert c is obs.histogram("dead2")       # the shared null
        with obs.span("dead") as sp:
            sp.fence(torch.ones(4))
        assert obs.timed("dead", lambda: 7) == 7
        obs.measured_event("dead", 1.0)
    finally:
        assert obs.set_enabled(prev) is False
    assert obs.snapshot() == {}
    assert obs.trace_events() == []
    assert obs.measured_events() == {}


# --------------------------------------------------------------------- #
# spans (tests/obs/test_spans.py)
# --------------------------------------------------------------------- #
def test_span_records_chrome_complete_event():
    with obs.span("unit.work", args={"k": 3}):
        time.sleep(0.001)
    (ev,) = obs.trace_events()
    assert (ev["name"], ev["ph"], ev["cat"]) == ("unit.work", "X", "repro")
    assert ev["dur"] >= 1_000
    assert ev["args"] == {"k": 3, "depth": 0, "id": ev["args"]["id"],
                          "parent": None}
    assert isinstance(ev["args"]["id"], int)
    assert obs.snapshot()["span.unit.work"]["count"] == 1


def test_nesting_depth():
    with obs.span("outer"):
        with obs.span("inner"):
            pass
        with obs.span("inner2"):
            pass
    by = {e["name"]: e for e in obs.trace_events()}
    assert [by[n]["args"]["depth"] for n in ("outer", "inner", "inner2")] \
        == [0, 1, 1]
    out, inn = by["outer"], by["inner"]
    assert out["ts"] <= inn["ts"]
    assert inn["ts"] + inn["dur"] <= out["ts"] + out["dur"] + 1


def test_fence_returns_value_and_walks_containers():
    with obs.span("unit.fenced") as sp:
        y = sp.fence({"a": (torch.arange(4.0) * 2.0, None), "b": [1]})
    assert float(y["a"][0][1]) == 2.0
    assert obs.fence(None) is None
    assert [e["name"] for e in obs.trace_events()] == ["unit.fenced"]


def test_export_chrome_trace_loads(tmp_path):
    with obs.span("a"):
        with obs.span("b"):
            pass
    path = obs.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    assert len(doc["traceEvents"]) == 2
    for ev in doc["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(ev)


def test_span_coverage():
    assert obs.span_coverage() == 0.0
    with obs.span("s1"):
        time.sleep(0.002)
    with obs.span("s2"):
        time.sleep(0.002)
    assert 0.5 < obs.span_coverage() <= 1.0
    evs = obs.trace_events()
    assert obs.span_coverage(evs) == jax_obs.span_coverage(evs)
    obs.clear_trace()
    with obs.span("outer"):
        with obs.span("inner"):
            time.sleep(0.002)
    assert obs.span_coverage() <= 1.0


# --------------------------------------------------------------------- #
# measured events
# --------------------------------------------------------------------- #
def test_timed_records_one_event_per_call():
    for i in range(3):
        assert obs.timed("op:a", lambda: torch.ones(2) * i)[0] == i
    obs.timed("op:b", lambda: None)
    got = obs.measured_events()
    assert list(got) == ["op:a", "op:b"]
    assert got["op:a"]["calls"] == 3 and got["op:b"]["calls"] == 1
    r = got["op:a"]
    assert r["min_s"] <= r["mean_s"] <= r["max_s"]
    assert r["mean_s"] == pytest.approx(r["total_s"] / 3)


def test_measured_event_rows_equal_jax():
    for s in (0.5, 0.25, 2.0):
        obs.measured_event("serve:infer", s)
        jax_obs.measured_event("serve:infer", s)
    row = obs.measured_events()["serve:infer"]
    # JAX keeps the row privately and reports it joined to plan rows
    ref = jax_obs.events._MEASURED["serve:infer"]
    assert {k: row[k] for k in ref} == ref
    assert (row["calls"], row["total_s"], row["min_s"], row["max_s"]) == (
        3, 2.75, 0.25, 2.0)


# --------------------------------------------------------------------- #
# the callers: the serving tier and the sampled trainer
# --------------------------------------------------------------------- #
def test_serving_session_spans_and_metrics():
    """A 4-client session records the JAX server's spans: intake and
    handle tile the serving loop, the nested ones sit inside them; the
    batch histogram counts every served batch; the out cache counts
    every lookup."""
    g, feats, _, _, _, nc = make_node_dataset("tiny", device="cpu")
    model = sage.init(torch.Generator().manual_seed(0), feats.shape[1], 16,
                      nc, device="cpu")
    srv = GNNServer("sage", model, g, feats, mode="layerwise",
                    device="cpu")
    n = g.n_src
    res = run_session(srv, n_clients=4, requests_per_client=10,
                      ids_fn=lambda rng: rng.integers(0, n, 3))
    names = {e["name"] for e in obs.trace_events()}
    assert {"serve.intake", "serve.handle", "serve.batching",
            "serve.refresh", "serve.cache_lookup",
            "serve.respond"} <= names
    loop = [e for e in obs.trace_events()
            if e["name"] in ("serve.intake", "serve.handle")]
    assert all(e["args"]["depth"] == 0 for e in loop)
    assert obs.span_coverage(loop) > 0.9
    snap = obs.snapshot()
    assert snap["serve.batch_seconds"]["count"] == srv.served_batches
    assert obs.measured_events()["serve:infer"]["calls"] == \
        srv.served_batches
    oc = res["stats"]["out_cache"]
    assert snap["serve.cache.out.hits"]["value"] == oc.hits
    assert snap["serve.cache.out.misses"]["value"] == oc.misses


def test_serving_fanout_spans():
    g, feats, _, _, _, nc = make_node_dataset("tiny", device="cpu")
    model = sage.init(torch.Generator().manual_seed(0), feats.shape[1], 16,
                      nc, device="cpu")
    srv = GNNServer("sage", model, g, feats, mode="fanout", fanout=4,
                    device="cpu")
    srv.serve([(0, np.arange(5))])
    names = [e["name"] for e in obs.trace_events()]
    for name in ("serve.sample", "serve.cache_lookup", "serve.infer"):
        assert names.count(name) == 1, name
    snap = obs.snapshot()
    assert snap["serve.cache.feat.misses"]["value"] + \
        snap["serve.cache.feat.hits"]["value"] > 0
    assert obs.measured_events()["block:u_copy_mean_v"]["calls"] == 2


def test_train_sampled_spans_and_probe():
    """``train_sampled`` records one ``train.epoch`` per epoch with its
    sample / step spans nested inside, one drift probe (one signature),
    and the probe's block forward and backward as measured events."""
    g, feats, labels, tm, _, nc = make_node_dataset("tiny", device="cpu")
    model = sage.init(torch.Generator().manual_seed(0), feats.shape[1], 8,
                      nc, device="cpu")
    _, hist = train_sampled(sage.forward_blocks, model, g, feats, labels,
                            np.nonzero(tm)[0], fanouts=(3, 3),
                            batch_size=16, epochs=2, max_batches=3)
    assert hist["n_batches"] == [3, 3]
    evs = obs.trace_events()
    count = {n: sum(e["name"] == n for e in evs)
             for n in ("train.epoch", "train.sample", "train.step",
                       "train.drift_probe")}
    assert count == {"train.epoch": 2, "train.sample": 6, "train.step": 6,
                     "train.drift_probe": 1}
    epochs = [e for e in evs if e["name"] == "train.epoch"]
    assert all(e["args"]["depth"] == 0 for e in epochs)
    assert all(e["args"]["depth"] == 1 for e in evs
               if e["name"] in ("train.sample", "train.step"))
    assert obs.span_coverage(evs) > 0.9
    got = obs.measured_events()
    # 2 layers: the probe's two forwards and every step's forward
    assert got["block:u_copy_mean_v"]["calls"] == 2 * 2 + 6 * 2
    # layer 0's input needs no grad: one backward per probe / step
    assert got["block_bwd:u_copy_mean_v"]["calls"] == 1 + 6
