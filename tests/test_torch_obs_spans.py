"""The port's spans beyond the JAX package's: ids and parents, the
``record_function`` annotation under a running profiler, device timing
without a host wait (a fake timing-event class stands in for CUDA's),
``timed`` without a fence, and the spans at the port's layer boundaries —
the trainer's step, the aggregation calls, the graph build and the
refresh's store."""
import collections
import itertools
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.binary_reduce import gspmm
from repro_torch.core.graph import from_coo, reverse
from repro_torch.core.serving import GNNServer
from repro_torch.models.gnn import gat, sage
from repro_torch.models.gnn.common import make_bundle
from repro_torch.models.gnn.train import make_train_step, train_sampled
from repro_torch.obs import spans

TRAIN = ("train.forward", "train.backward", "train.clip", "train.optimizer")


@pytest.fixture(autouse=True)
def _clean():
    for clear in (obs.reset_metrics, obs.clear_trace, obs.clear_events):
        clear()
    yield
    for clear in (obs.reset_metrics, obs.clear_trace, obs.clear_events):
        clear()


def _graph(n=40, m=200, seed=0):
    rng = np.random.default_rng(seed)
    return from_coo(rng.integers(0, n, m), rng.integers(0, n, m), n_src=n,
                    n_dst=n, device="cpu")


def _named(name):
    return [e for e in obs.trace_events() if e["name"] == name]


# --------------------------------------------------------------------- #
# the mechanism
# --------------------------------------------------------------------- #
def test_span_ids_and_parents_per_thread():
    with obs.span("outer"):
        with obs.span("inner"):
            pass
        with obs.span("inner2"):
            pass
        t = threading.Thread(target=lambda: obs.span("other").__exit__(
            None, None, None))
        t.start()
        t.join()
    with obs.span("after"):
        pass
    by = {e["name"]: e["args"] for e in obs.trace_events()}
    ids = [by[n]["id"] for n in ("outer", "inner", "inner2", "other",
                                 "after")]
    assert len(set(ids)) == 5
    assert by["outer"]["parent"] is None and by["after"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["inner2"]["parent"] == by["outer"]["id"]
    assert by["other"]["parent"] is None      # another thread's outermost


def test_record_function_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("unit.annotated"):
            y = x + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in evs if e.get("name") == "unit.annotated"]
    assert len(ann) == 1 and ann[0]["cat"] == "user_annotation"
    add = [e for e in evs if e.get("name") == "aten::add"]
    a0, a1 = ann[0]["ts"], ann[0]["ts"] + ann[0]["dur"]
    assert any(a0 <= e["ts"] and e["ts"] + e["dur"] <= a1 for e in add)
    assert float(y[0]) == 2.0


def test_record_function_only_under_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with obs.span("unit.plain"):
        pass
    assert entered == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with obs.span("unit.profiled"):
        pass
    assert entered == ["unit.profiled"]


def _count_fences(monkeypatch):
    calls = collections.Counter()
    real = spans.fence

    def fence(value):
        calls["fence"] += 1
        return real(value)

    monkeypatch.setattr(spans, "fence", fence)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.update(["synchronize"]))
    return calls


def test_timed_never_fences(monkeypatch):
    calls = _count_fences(monkeypatch)
    g = _graph()
    x = torch.randn(40, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(3):
            gspmm(g, "u_copy_add_v", u=x)
        obs.timed("op:a", lambda: x * 2)
    assert calls == {}
    got = obs.measured_events()
    assert got["u_copy_add_v"]["calls"] == 3 and got["op:a"]["calls"] == 1
    assert len(_named("agg.u_copy_add_v")) == 3


class FakeEvent:
    """A timing event on a fake stream: ``record`` stamps the next tick;
    ``query`` is true once the test marks the event done; ``synchronize``
    (a host wait) marks it done and is counted."""
    made = 0
    tick = 0
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None
        self.done = False

    def record(self, stream=None):
        FakeEvent.tick += 1
        self.t = FakeEvent.tick
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        FakeEvent.waits += 1
        self.done = True

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_device(monkeypatch):
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(FakeEvent, "tick", 0)
    monkeypatch.setattr(FakeEvent, "waits", 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(spans, "_current_stream", lambda index: "stream")
    monkeypatch.setattr(spans, "_PENDING", collections.deque())
    monkeypatch.setattr(spans, "_POOL", {})
    monkeypatch.setattr(spans, "_EXITS", itertools.count(1))
    return FakeEvent


def _pending_events():
    return [p[1] for p in spans._PENDING]


def test_device_span_resolves_lazily_without_a_wait(fake_device,
                                                   monkeypatch):
    monkeypatch.setattr(spans, "RESOLVE_EVERY", 2)
    with obs.span("unit.dev", device=True) as sp:
        pass
    assert sp.on_device and fake_device.waits == 0
    (ev,) = obs.trace_events()
    assert "device_ms" not in ev["args"]          # nothing waited for
    assert obs.resolve_device_spans() == 1        # not done: still pending
    start, end = _pending_events()[0][:2]
    start.done = end.done = True
    with obs.span("unit.host"):                   # a host span reads none
        pass
    assert "device_ms" not in ev["args"]
    with obs.span("unit.dev2", device=True):      # the 2nd device exit
        pass
    assert ev["args"]["device_ms"] == 1.0 and fake_device.waits == 0
    assert len(spans._PENDING) == 1 and fake_device.made == 4
    # unit.dev's events went back to the pool: the next span reuses them
    with obs.span("unit.dev3", device=True):
        pass
    assert fake_device.made == 4
    assert obs.resolve_device_spans(wait=True) == 0
    assert fake_device.waits == 2              # on each end event
    assert _named("unit.dev3")[0]["args"]["device_ms"] == 1.0


def test_capture_is_asked_once_per_device_span(fake_device, monkeypatch):
    asked = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: asked.append(1) or False)
    monkeypatch.setattr(spans, "RESOLVE_EVERY", 1)
    with obs.span("unit.host"):
        pass
    assert asked == []
    for _ in range(3):
        with obs.span("unit.dev", device=True):
            pass
    assert len(asked) == 3
    # the operands' device names the card; a host device times nothing
    with obs.span("unit.cpu", device=torch.device("cpu")) as sp:
        pass
    assert not sp.on_device and len(asked) == 3
    with obs.span("unit.card", device=torch.device("cuda", 1)) as sp:
        pass
    assert sp.on_device and _pending_events()[-1][2] == 1


def test_oldest_first_and_trace_events_never_waits(fake_device):
    for name in ("a", "b", "c"):
        with obs.span(name, device=True):
            pass
    second = _pending_events()[1]
    second[0].done = second[1].done = True     # b done, a not yet
    obs.resolve_device_spans()
    assert len(spans._PENDING) == 3            # a blocks the queue
    evs = obs.trace_events()
    assert fake_device.waits == 0
    assert all("device_ms" not in e["args"] for e in evs)
    assert obs.resolve_device_spans(wait=True) == 0
    assert [e["args"]["device_ms"] for e in obs.trace_events()] == \
        [1.0, 1.0, 1.0]


def test_pending_bound_counts_dropped_device(fake_device, monkeypatch):
    monkeypatch.setattr(spans, "MAX_PENDING", 2)
    for name in ("a", "b", "c"):
        with obs.span(name, device=True):
            pass
    assert len(spans._PENDING) == 2
    assert obs.snapshot()["trace.dropped_device"]["value"] == 1
    obs.resolve_device_spans(wait=True)
    got = {e["name"]: e["args"].get("device_ms") for e in obs.trace_events()}
    assert got == {"a": 1.0, "b": 1.0, "c": None}
    assert len(spans._POOL[0]) == 6            # c's pair went back too


def test_no_device_events_while_capturing(fake_device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with obs.span("unit.captured", device=True) as sp:
        pass
    assert not sp.on_device and fake_device.made == 0
    assert obs.timed("op:c", lambda: 3) == 3
    assert obs.measured_events() == {}


@pytest.mark.parametrize("clear", ["clear_events", "clear_trace"])
def test_a_reading_from_before_a_clear_stays_before_it(fake_device, clear):
    with torch.no_grad():
        obs.timed("op:e", lambda: torch.ones(2))
    assert spans._PENDING                      # not read yet
    getattr(obs, clear)()
    assert not spans._PENDING and fake_device.waits == 1
    obs.clear_events()
    with obs.span("unit.after", device=True):
        pass
    assert obs.measured_events() == {}
    # the span itself stays in the trace until the trace is cleared
    assert len(_named("agg.op:e")) == (clear == "clear_events")


def test_timed_records_the_device_time_when_resolved(fake_device):
    with torch.no_grad():
        obs.timed("op:d", lambda: torch.ones(2), args={"route": "segment"})
    assert fake_device.waits == 0
    assert obs.measured_events()["op:d"]["total_s"] == pytest.approx(1e-3)
    (ev,) = _named("agg.op:d")
    assert ev["args"]["route"] == "segment"
    assert ev["args"]["device_ms"] == 1.0


def test_nothing_recorded_with_telemetry_off(fake_device):
    g = _graph()
    x = torch.randn(40, 8, requires_grad=True)
    model = sage.init(torch.Generator().manual_seed(0), 8, 8, 3,
                      device="cpu")
    opt_init, step = make_train_step(sage.forward)
    obs.clear_trace()                   # the graph built above
    prev = obs.set_enabled(False)
    try:
        with obs.span("dead", device=True):
            pass
        gspmm(g, "u_copy_add_v", u=x).sum().backward()
        with torch.no_grad():
            gspmm(g, "u_copy_add_v", u=x)
        reverse(_graph(seed=1))
        step(model, opt_init(model), 0, make_bundle(g), x.detach(),
             torch.zeros(40, dtype=torch.long), torch.ones(40, dtype=bool),
             torch.Generator().manual_seed(0))
    finally:
        obs.set_enabled(prev)
    assert obs.trace_events() == [] and obs.measured_events() == {}
    assert fake_device.made == 0 and not spans._PENDING


# --------------------------------------------------------------------- #
# the layer boundaries
# --------------------------------------------------------------------- #
def _tiny_app(app):
    g = _graph(60, 400)
    gen = torch.Generator().manual_seed(0)
    if app == "sage":
        model = sage.init(gen, 8, 8, 3, device="cpu")
    else:
        model = gat.init(gen, 8, 4, 3, n_heads=2, device="cpu")
    mod = {"sage": sage, "gat": gat}[app]
    x = torch.randn(60, 8, generator=gen)
    labels = torch.randint(0, 3, (60,), generator=gen)
    return g, model, mod, x, labels


@pytest.mark.parametrize("app", ["sage", "gat"])
def test_train_step_records_its_four_spans(app):
    g, model, mod, x, labels = _tiny_app(app)
    bundle = make_bundle(g)
    opt_init, step = make_train_step(mod.forward)
    obs.clear_trace()
    step(model, opt_init(model), 7, bundle, x, labels,
         torch.ones(60, dtype=bool), torch.Generator().manual_seed(1))
    got = [e for e in obs.trace_events() if e["name"] in TRAIN]
    got.sort(key=lambda e: e["ts"])
    assert [e["name"] for e in got] == list(TRAIN)
    assert {e["args"]["step"] for e in got} == {7}
    assert len({e["args"]["depth"] for e in got}) == 1
    for a, b in zip(got, got[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + 1
    fwd = [e for e in obs.trace_events() if e["name"].startswith("agg.")
           and e["args"]["dir"] == "fwd"]
    assert fwd and {e["args"]["parent"] for e in fwd} == {
        got[0]["args"]["id"]}


def test_sampled_steps_nest_under_train_step():
    g = _graph(80, 300)
    rng = np.random.default_rng(0)
    model = sage.init(torch.Generator().manual_seed(0), 8, 8, 3,
                      device="cpu")
    train_sampled(sage.forward_blocks, model, g,
                  rng.standard_normal((80, 8)).astype(np.float32),
                  rng.integers(0, 3, 80), np.arange(60), fanouts=(2, 2),
                  batch_size=32, epochs=1, max_batches=2)
    steps = {e["args"]["id"] for e in _named("train.step")}
    assert len(steps) == 2
    for name in TRAIN:
        got = _named(name)
        assert len(got) == 2, name
        assert {e["args"]["parent"] for e in got} == steps, name


def test_gat_aggregation_spans_both_directions():
    g, model, _, x, _ = _tiny_app("gat")
    logits = gat.forward(model, make_bundle(g), x, strategy="kernel")
    logits.sum().backward()
    agg = [e for e in obs.trace_events() if e["name"].startswith("agg.")]
    dirs = collections.defaultdict(set)
    for e in agg:
        assert {"route", "dir", "id", "parent"} <= set(e["args"])
        dirs[e["name"]].add(e["args"]["dir"])
    for op in ("sddmm:u_add_v_copy_e", "sddmm:e_sub_v_copy_e",
               "e_copy_add_v", "sddmm:e_div_v_copy_e"):
        assert dirs[f"agg.{op}"] == {"fwd", "bwd"}, op
    # no kernel takes the max: a plain route runs it, and its backward is
    # spanned too; the rank-3 sum runs on the kernel route both ways
    assert dirs["agg.e_copy_max_v"] == {"fwd", "bwd"}
    assert {e["args"]["route"] for e in agg
            if e["name"] == "agg.e_copy_max_v"} & {"kernel"} == set()
    assert dirs["agg.u_mul_e_add_v"] == {"fwd", "bwd"}
    assert {e["args"]["route"] for e in agg
            if e["name"] == "agg.u_mul_e_add_v"} == {"kernel"}
    assert obs.measured_events() == {}         # grad mode: no drift rows


def _plain_case(case, g, gen):
    """(call, reference without the span's Function, operands)."""
    import importlib
    br = importlib.import_module("repro_torch.core.binary_reduce")
    es = importlib.import_module("repro_torch.core.edge_softmax")
    from repro_torch.core.planner import get_plan_cache
    u = torch.randn(g.n_src, 4, generator=gen, requires_grad=True)
    e = torch.randn(g.n_edges, 4, generator=gen, requires_grad=True)
    kind, op, route = case
    if kind == "gspmm":
        spec = br.parse_op(op)
        ops = {"u": u, "e": e}
        lhs, rhs = ops[spec.lhs], ops.get(spec.rhs)
        ref = {"segment": lambda: br._execute_segment(g, spec, lhs, rhs),
               "push": lambda: br._execute_segment(g, spec, lhs, rhs,
                                                   push=True),
               "ell": lambda: br._gspmm_ell(
                   g, spec, get_plan_cache(g).ell(), lhs, rhs),
               "onehot": lambda: br._gspmm_onehot(g, spec, lhs, rhs)}[route]
        kw = {spec.lhs: lhs, **({spec.rhs: rhs} if rhs is not None else {})}
        return (lambda: br.gspmm(g, op, strategy=route, **kw)), ref, \
            [lhs] + ([rhs] if rhs is not None else [])
    if kind == "gsddmm":
        v = torch.randn(g.n_dst, 4, generator=gen, requires_grad=True)
        return (lambda: br.gsddmm(g, op, u=u, v=v, strategy=route)), \
            (lambda: br.BINARY_OPS["add"](*(
                br.take_rows(x, g.long(br.CALLER_INDEX[t]))
                for t, x in (("u", u), ("v", v))))), [u, v]
    if kind == "softmax":
        return (lambda: es.edge_softmax_fused(g, e, strategy=route)), \
            (lambda: es.edge_softmax_plain(g, e)), [e]
    el = torch.randn(g.n_src, 2, generator=gen, requires_grad=True)
    er = torch.randn(g.n_dst, 2, generator=gen, requires_grad=True)
    z = torch.randn(g.n_src, 2, 3, generator=gen, requires_grad=True)
    return (lambda: es.fused_attention(g, el, er, z, strategy=route)), \
        (lambda: es.fused_attention_plain(g, el, er, z, 0.2)), [el, er, z]


@pytest.mark.parametrize("case", [
    ("gspmm", "u_copy_max_v", "segment"), ("gspmm", "u_mul_e_add_v", "push"),
    ("gspmm", "u_mul_e_max_v", "ell"), ("gspmm", "u_copy_add_v", "onehot"),
    ("gsddmm", "u_add_v_copy_e", "gather"),
    ("softmax", "edge_softmax", "fused"), ("attention", "attn:fused",
                                           "fused")])
def test_plain_route_backward_is_spanned(case):
    g = _graph(30, 150)
    call, ref, ins = _plain_case(case, g, torch.Generator().manual_seed(3))
    out = call()
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(out, ins, ct)
    want = torch.autograd.grad(ref(), ins, ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    kind, op, route = case
    name = {"gsddmm": f"agg.sddmm:{op}"}.get(kind, f"agg.{op}")
    bwd = [e for e in _named(name) if e["args"]["dir"] == "bwd"]
    assert len(bwd) == 1 and bwd[0]["args"]["route"] == route
    with pytest.raises(RuntimeError):       # no second derivative
        out = call()
        (d,) = torch.autograd.grad(out, ins[:1], torch.ones_like(out),
                                   create_graph=True)
        d.sum().backward()


def test_graph_build_spans():
    g = _graph(50, 321)
    (h,) = _named("graph.host_index")
    assert h["args"]["n_edges"] == 321
    assert _named("graph.upload")[0]["args"]["n_edges"] == 321
    reverse(g)
    assert len(_named("graph.host_index")) == 2
    make_bundle(g)
    assert _named("gnn.make_bundle")[0]["args"]["n_edges"] == 321


def _server():
    g, model, _, x, _ = _tiny_app("gat")
    return GNNServer("gat", model, g, x.numpy(), mode="layerwise",
                     device="cpu")


def test_refresh_store_closes_after_refresh():
    srv = _server()
    for _ in range(2):
        srv.refresh()
        last = obs.trace_events()[-4:]
        assert last[-1]["name"] == "serve.refresh_store"
        assert "serve.refresh" in [e["name"] for e in last]
    ref, store = _named("serve.refresh")[-1], _named(
        "serve.refresh_store")[-1]
    assert ref["ts"] + ref["dur"] <= store["ts"] + 1


def test_refresh_issues_one_fence(monkeypatch):
    srv = _server()
    srv.refresh()
    calls = _count_fences(monkeypatch)
    for _ in range(3):
        srv.refresh()
    assert calls["fence"] == 3               # serve.refresh's own, alone
    assert len([e for e in obs.trace_events()
                if e["name"].startswith("agg.")]) >= 3 * 6
