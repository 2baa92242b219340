"""Port parity for the plan-event stream and the drift report
(``repro_torch/obs/events.py``) against the JAX package's
(``repro/obs/events.py``): the schemas letter for letter, ``family_of``,
the same synthetic events giving the same report (per family and dtype
scales, outliers, exclusions), and the port's own paths recording
predicted and measured rows — without a fence per op inside a training
step.
"""
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.core import from_coo, gspmm, planner
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.models.gnn import gcn, sage
from repro_torch.models.gnn.common import make_bundle
from repro_torch.models.gnn.train import train_sampled
from repro_torch.obs import events as E
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")


@pytest.fixture(autouse=True)
def _clean_events():
    obs.clear_events()
    jax_obs.clear_events()
    yield
    obs.clear_events()
    jax_obs.clear_events()


# --------------------------------------------------------------------- #
# schemas
# --------------------------------------------------------------------- #
def test_schemas_are_jax_letter_for_letter():
    assert obs.PLAN_EVENT_FIELDS == jax_obs.PLAN_EVENT_FIELDS == (
        "op", "family", "requested", "chosen", "count",
        "predicted_cost", "measured_calls", "measured_total_s",
        "measured_mean_s", "dtype")
    assert obs.DRIFT_FIELDS == jax_obs.DRIFT_FIELDS == (
        "op", "family", "requested", "chosen", "predicted_cost",
        "measured_calls", "measured_mean_s", "family_scale", "ratio",
        "drifted", "dtype")
    assert planner.drift_report is obs.drift_report
    assert planner.plan_events is obs.plan_events


@pytest.mark.parametrize("op", ["u_copy_add_v", "block:u_copy_add_v",
                                "block_bwd:u_copy_add_v", "hetero:u_w_mean_v",
                                "sddmm:u_add_v_copy_e", "attn:fused",
                                "serve:infer", "partitioned:train",
                                "fam:x", "gone:x", "t:passthrough"])
def test_family_of_matches_jax(op):
    assert obs.family_of(op) == jax_obs.family_of(op)


def test_rows_have_exact_keys():
    obs.plan_event("block:u_copy_add_v", "auto", "segment",
                   predicted_cost=10.0)
    obs.measured_event("block:u_copy_add_v", 0.01)
    (row,) = obs.plan_events()
    assert tuple(row) == obs.PLAN_EVENT_FIELDS
    assert (row["family"], row["count"], row["measured_calls"]) == (
        "block", 1, 1)
    assert row["measured_mean_s"] == pytest.approx(0.01)
    (drift,) = obs.drift_report()
    assert tuple(drift) == obs.DRIFT_FIELDS


def test_plan_event_keyed_by_dtype():
    for dt in ("float32", "bfloat16"):
        obs.plan_event("block:u_copy_add_v", "auto", "segment",
                       predicted_cost=10.0, dtype=dt)
    rows = obs.plan_events()
    assert {r["dtype"] for r in rows} == {"float32", "bfloat16"}
    assert all(r["count"] == 1 for r in rows)


# --------------------------------------------------------------------- #
# the drift report on JAX's synthetic events
# --------------------------------------------------------------------- #
def _per_family_dtype(mod):
    for i, cost in enumerate((10.0, 20.0, 40.0)):
        mod.plan_event(f"fam:f32op{i}", "auto", "a", predicted_cost=cost,
                       dtype="float32")
        mod.measured_event(f"fam:f32op{i}", cost * 1e-3)
        mod.plan_event(f"fam:b16op{i}", "auto", "a", predicted_cost=cost,
                       dtype="bfloat16")
        mod.measured_event(f"fam:b16op{i}", cost * 1e-1)


def _outlier(mod):
    for i, cost in enumerate((10.0, 20.0, 40.0)):
        mod.plan_event(f"fam:op{i}", "auto", "a", predicted_cost=cost)
        mod.measured_event(f"fam:op{i}", cost * 1e-3)
    mod.plan_event("fam:bad", "auto", "a", predicted_cost=10.0)
    mod.measured_event("fam:bad", 10.0 * 1e-3 * 100)


def _single(mod):
    mod.plan_event("gone:x", "auto", "a", predicted_cost=100.0)
    mod.measured_event("gone:x", 1.0)


def _excluded(mod):
    mod.plan_event("fam:nopred", "auto", "a")
    mod.measured_event("fam:nopred", 0.01)
    mod.plan_event("fam:nomeas", "auto", "a", predicted_cost=3.0)


def _mixed(mod):
    _outlier(mod)
    mod.plan_event("serve:infer", "auto", "layerwise", predicted_cost=5.0)
    mod.measured_event("serve:infer", 0.002)
    mod.plan_event("block:u_copy_add_v", "auto", "ell", predicted_cost=7.0,
                   dtype="float32")
    mod.plan_event("block:u_copy_add_v", "auto", "ell", predicted_cost=9.0,
                   dtype="float32")
    mod.measured_event("block:u_copy_add_v", 0.003)


@pytest.mark.parametrize("events", [_per_family_dtype, _outlier, _single,
                                    _excluded, _mixed])
@pytest.mark.parametrize("threshold", [2.0, 4.0])
def test_drift_report_matches_jax(events, threshold):
    events(obs)
    events(jax_obs)
    got = obs.drift_report(threshold)
    want = jax_obs.drift_report(threshold)
    assert [tuple(r.items()) for r in obs.plan_events()] == [
        tuple(r.items()) for r in jax_obs.plan_events()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-12), k
            else:
                assert g[k] == w[k], k


def test_drift_semantics():
    _per_family_dtype(obs)
    assert not any(r["drifted"] for r in obs.drift_report(4.0))
    obs.clear_events()
    _outlier(obs)
    rows = obs.drift_report(4.0)
    assert {r["op"] for r in rows if r["drifted"]} == {"fam:bad"}
    assert rows[0]["op"] == "fam:bad"
    obs.clear_events()
    _single(obs)
    (r,) = obs.drift_report()
    assert r["ratio"] == pytest.approx(1.0) and not r["drifted"]
    obs.clear_events()
    _excluded(obs)
    assert obs.drift_report() == []
    with pytest.raises(ValueError):
        obs.drift_report(threshold=1.0)


def test_disabled_is_a_noop():
    prev = obs.set_enabled(False)
    try:
        obs.plan_event("dead:x", "auto", "a", predicted_cost=1.0)
        obs.measured_event("dead:x", 1.0)
        assert E.timed("dead:x", lambda: 7) == 7
    finally:
        obs.set_enabled(prev)
    assert obs.plan_events() == []
    assert obs.measured_events() == {}


def test_timed_passes_value_through():
    assert E.timed("t:passthrough", lambda: 41 + 1) == 42
    assert obs.plan_events() == []        # measured only: no plan row
    obs.plan_event("t:passthrough", "auto", "x", predicted_cost=1.0)
    (r,) = obs.plan_events()
    assert r["measured_calls"] == 1


# --------------------------------------------------------------------- #
# the port's paths record both halves
# --------------------------------------------------------------------- #
def _graph():
    rng = np.random.default_rng(0)
    n, m = 64, 400
    return from_coo(rng.integers(0, n, m), rng.integers(0, n, m),
                    n_src=n, n_dst=n, device="cpu")


def test_gspmm_emits_predicted_and_measured():
    g = _graph()
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():                   # eager inference: timed
        gspmm(g, "u_copy_add_v", u=x)
    rows = [r for r in obs.plan_events() if r["op"] == "u_copy_add_v"]
    assert rows and rows[0]["predicted_cost"] is not None
    assert rows[0]["measured_calls"] == 1
    assert rows[0]["dtype"] == "float32"
    assert "u_copy_add_v" in {r["op"] for r in obs.drift_report()}


def test_a_call_autograd_records_is_not_timed():
    """With grad mode on (a training step's calls) an op plans but is
    never fenced or timed, as JAX never times an op under a trace —
    also on inputs that need no grad; under ``torch.no_grad`` it is
    timed."""
    g = _graph()
    x = torch.randn(64, 8, requires_grad=True)
    gspmm(g, "u_copy_add_v", u=x).sum().backward()
    gspmm(g, "u_copy_add_v", u=x.detach())
    assert "u_copy_add_v" not in obs.measured_events()
    assert planner.last_plan("u_copy_add_v") is not None
    with torch.no_grad():
        gspmm(g, "u_copy_add_v", u=x)
    assert obs.measured_events()["u_copy_add_v"]["calls"] == 1


@pytest.mark.parametrize("app", ["gcn", "sage"])
def test_full_graph_step_records_no_gspmm_measurement(app):
    g, feats, labels, train_mask, _, n_cls = make_node_dataset(
        "tiny", device="cpu")
    mod = {"gcn": gcn, "sage": sage}[app]
    model = mod.init(torch.Generator().manual_seed(0), feats.shape[1], 8,
                     n_cls, device="cpu")
    obs.clear_events()                  # the dataset's labels ran gspmm
    logits = mod.forward(model, make_bundle(g), torch.from_numpy(feats),
                         strategy="kernel", train=True)
    logits.sum().backward()
    fams = {obs.family_of(op) for op in obs.measured_events()}
    assert "gspmm" not in fams and "sddmm" not in fams


def test_sampled_train_emits_block_and_bwd_measurements():
    rng = np.random.default_rng(0)
    n, m = 80, 300
    g = from_coo(rng.integers(0, n, m), rng.integers(0, n, m), n_src=n,
                 n_dst=n, device="cpu")
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    model = sage.init(torch.Generator().manual_seed(0), 8, 8, 3,
                      device="cpu")
    train_sampled(sage.forward_blocks, model, g, feats, labels,
                  np.arange(60), fanouts=(2, 2), batch_size=32, epochs=1,
                  max_batches=2)
    fams = {r["family"] for r in obs.drift_report()}
    assert {"block", "block_bwd"} <= fams


def test_pack_builds_are_counted():
    g = _graph()
    name = "planner.pack_builds.ell"
    before = obs.snapshot().get(name, {"value": 0})["value"]
    planner.get_plan_cache(g).ell()
    planner.get_plan_cache(g).ell()
    snap = obs.snapshot()
    assert snap[name]["value"] == before + 1
    assert snap["planner.pad_ratio.ell"]["value"] >= 1.0
