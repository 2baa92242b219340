"""Port parity for relation-fused execution (``repro_torch/core/hetero.py``).

* ``from_rels`` / ``from_typed`` build RelGraphs whose arrays equal the
  JAX package's, an empty relation and ``n_rel = 0`` included.
* ``hetero_gspmm`` matches JAX (pinned to ``fused`` / ``loop``: JAX's
  ``auto`` consults its planner) at 1e-5 for every operand form (plain
  ``u``, ``w``, ``basis`` / ``coeff``, 3-D ``u``; with and without ``e``)
  × sum / mean / max / min × fused / loop, and the port's ``kernel`` route
  (B1 over the relation-expanded graph, here through the wrappers' plain
  versions) matches too for sum and mean; so do the gradients, against
  ``jax.grad`` through JAX's custom VJP, and the relation-batched
  pre-transform branch.
* ``hetero_block_gspmm`` matches JAX at 2e-4 on blocks both packages
  sample alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hetero as jax_hetero
from repro.core import from_coo as jax_from_coo
from repro.core.hetero import caller_coo as jax_caller_coo
from repro.core.hetero import from_rels as jax_from_rels
from repro.core.hetero import from_typed as jax_from_typed
from repro.core.hetero import hetero_block_gspmm as jax_hetero_block_gspmm
from repro.core.hetero import hetero_gspmm as jax_hetero_gspmm
from repro.data import NeighborSampler as JaxSampler
from repro_torch import obs
from repro_torch.core import from_coo
from repro_torch.core import hetero
from repro_torch.core.hetero import (caller_coo, from_rels, from_typed,
                                     hetero_block_gspmm, hetero_gspmm)
from repro_torch.data import NeighborSampler
from repro_torch.kernels.spmm import ops as spmm_ops
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
N, D_IN, D_OUT, N_BASES = 40, 6, 5, 3
# skew plus one empty relation, as tests/core/test_hetero.py
SIZES = (30, 0, 5, 17)
GRAPH_FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src",
                "perm_src", "eid_inv")
REL_FIELDS = ("rel", "mean_norm", "perm_rel", "rev_perm", "rev_src",
              "rev_dst", "rev_rel")
FORMS = ("plain", "w", "basis", "u3")
REDUCES = ("sum", "mean", "max", "min")


def _rels(seed=0, n=N, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, s), rng.integers(0, n, s)) for s in sizes]


_cache = {}


def _pair():
    """(JAX RelGraph, port RelGraph) over the same relations."""
    if "rg" not in _cache:
        rels = _rels()
        _cache["rg"] = (jax_from_rels(rels, n_src=N, n_dst=N),
                        from_rels(rels, n_src=N, n_dst=N, device="cpu"))
    return _cache["rg"]


def _operands(form, with_e, n_rel, n_edges, seed=1):
    """numpy operands of one form: u, and w / basis+coeff, and e."""
    rng = np.random.default_rng(seed)
    ops = {}
    if form == "u3":
        ops["u"] = rng.standard_normal((N, n_rel, D_OUT)).astype(np.float32)
    else:
        ops["u"] = rng.standard_normal((N, D_IN)).astype(np.float32)
    if form == "w":
        ops["w"] = rng.standard_normal((n_rel, D_IN, D_OUT)).astype(
            np.float32) * 0.5
    if form == "basis":
        ops["basis"] = rng.standard_normal((N_BASES, D_IN, D_OUT)).astype(
            np.float32) * 0.5
        ops["coeff"] = rng.standard_normal((n_rel, N_BASES)).astype(
            np.float32) * 0.5
    if with_e:
        ops["e"] = (rng.random(n_edges) + 0.5).astype(np.float32)
    return ops


def _width(form):
    return D_IN if form == "plain" else D_OUT


def _jax_out(jrg, ops, reduce, strategy):
    return np.asarray(jax_hetero_gspmm(
        jrg, **{k: jnp.asarray(v) for k, v in ops.items()}, reduce=reduce,
        strategy=strategy))


def _port_out(trg, ops, reduce, strategy):
    return hetero_gspmm(trg, **{k: torch.from_numpy(v) for k, v in
                                ops.items()}, reduce=reduce,
                        strategy=strategy).numpy()


# --------------------------------------------------------------------- #
# structure
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["skewed", "one_relation", "no_relation"])
def test_relgraph_arrays_equal_jax(case):
    rels = {"skewed": _rels(), "one_relation": _rels(sizes=(25,)),
            "no_relation": []}[case]
    jrg = jax_from_rels(rels, n_src=N, n_dst=N)
    trg = from_rels(rels, n_src=N, n_dst=N, device="cpu")
    assert (trg.n_rel, trg.rel_sizes, trg.rel_ptr, trg.signature) == (
        jrg.n_rel, jrg.rel_sizes, jrg.rel_ptr, jrg.signature)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(trg.g.host, f),
                                      np.asarray(getattr(jrg.g, f)),
                                      err_msg=f)
    for f in REL_FIELDS:
        np.testing.assert_array_equal(getattr(trg, f).numpy(),
                                      np.asarray(getattr(jrg, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(trg.host[f], getattr(trg, f).numpy())
    for a, b in zip(caller_coo(trg.g), jax_caller_coo(jrg.g)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_from_typed_equals_jax_and_checks_ids():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, N, 50), rng.integers(0, N, 50)
    rel = rng.integers(0, 4, 50)
    jrg = jax_from_typed(src, dst, rel, n_src=N, n_dst=N, n_rel=6)
    trg = from_typed(src, dst, rel, n_src=N, n_dst=N, n_rel=6, device="cpu")
    assert trg.rel_sizes == jrg.rel_sizes and trg.n_rel == 6
    for f in REL_FIELDS:
        np.testing.assert_array_equal(getattr(trg, f).numpy(),
                                      np.asarray(getattr(jrg, f)))
    with pytest.raises(ValueError):
        from_typed(src, dst, rel, n_src=N, n_dst=N, n_rel=3, device="cpu")


def test_expanded_graph_keeps_caller_order():
    """Source ``src·R + rel`` per caller edge, destinations unchanged."""
    _, trg = _pair()
    gx = trg.expanded()
    src, dst = caller_coo(trg.g)
    rel = np.concatenate([np.full(s, r) for r, s in enumerate(SIZES)])
    xs, xd = caller_coo(gx)
    np.testing.assert_array_equal(xs, src * trg.n_rel + rel)
    np.testing.assert_array_equal(xd, dst)
    assert (gx.n_src, gx.n_dst) == (N * trg.n_rel, N)
    assert trg.expanded() is gx
    np.testing.assert_array_equal(
        trg.mean_norm_caller.numpy(),
        trg.mean_norm.numpy()[trg.g.host.eid_inv])


def test_to_device_keeps_arrays():
    _, trg = _pair()
    assert trg.to("cpu") is trg
    moved = hetero._from_host(trg.g, trg.host, trg.n_rel, trg.rel_sizes)
    for f in REL_FIELDS:
        assert torch.equal(getattr(moved, f), getattr(trg, f))


# --------------------------------------------------------------------- #
# values
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["fused", "loop", "kernel"])
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("with_e", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_hetero_gspmm_matches_jax(form, with_e, reduce, strategy):
    jrg, trg = _pair()
    ops = _operands(form, with_e, trg.n_rel, trg.n_edges)
    if strategy == "kernel" and reduce in ("max", "min"):
        with pytest.raises(NotImplementedError):
            _port_out(trg, ops, reduce, strategy)
        return
    ref = _jax_out(jrg, ops, reduce, "loop" if strategy == "loop"
                   else "fused")
    got = _port_out(trg, ops, reduce, strategy)
    assert got.shape == (N, _width(form))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("form", ["w", "u3"])
def test_pre_transform_branch_matches_jax(form, strategy, monkeypatch):
    """Above ``_EDGE_MODE_ELEMS`` the ``w`` form gathers from the
    relation-batched pre-transform: both packages' switch at 0."""
    monkeypatch.setattr(jax_hetero, "_EDGE_MODE_ELEMS", 0)
    monkeypatch.setattr(hetero, "_EDGE_MODE_ELEMS", 0)
    jrg, trg = _pair()
    ops = _operands(form, True, trg.n_rel, trg.n_edges, seed=5)
    np.testing.assert_allclose(_port_out(trg, ops, "mean", strategy),
                               _jax_out(jrg, ops, "mean", "fused"),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("strategy", ["fused", "loop", "kernel", "auto"])
@pytest.mark.parametrize("form", FORMS)
def test_no_relation_gives_zero_rows(form, strategy):
    """``n_rel = 0`` (and so no edge): JAX's zero output."""
    jrg = jax_from_rels([], n_src=N, n_dst=N)
    trg = from_rels([], n_src=N, n_dst=N, device="cpu")
    ops = _operands(form, False, 0, 0)
    got = _port_out(trg, ops, "mean", strategy)
    np.testing.assert_array_equal(got, np.zeros((N, _width(form)),
                                                np.float32))
    np.testing.assert_array_equal(got, _jax_out(jrg, ops, "mean", "fused"))


def test_auto_takes_the_plain_route_on_the_cpu(monkeypatch):
    """``auto`` is the kernel only for a CUDA operand: on the CPU no
    wrapper runs."""
    _, trg = _pair()
    calls = []
    monkeypatch.setattr(spmm_ops, "spmm_plain",
                        lambda *a, **k: calls.append(1))
    ops = _operands("basis", True, trg.n_rel, trg.n_edges)
    out = _port_out(trg, ops, "mean", "auto")
    assert calls == [] and out.shape == (N, D_OUT)


@pytest.mark.parametrize("form", FORMS)
def test_kernel_route_runs_b1_on_the_expanded_graph(form, monkeypatch):
    """One B1 call per aggregation: on the relation-expanded graph for a
    table form, on the fused graph for the plain ``u[src]`` form."""
    _, trg = _pair()
    graphs = []
    plain = spmm_ops.spmm_plain

    def counting(g, *a, **k):
        graphs.append(g)
        return plain(g, *a, **k)
    monkeypatch.setattr(spmm_ops, "spmm_plain", counting)
    _port_out(trg, _operands(form, True, trg.n_rel, trg.n_edges), "mean",
              "kernel")
    assert graphs == [trg.g if form == "plain" else trg.expanded()]


def test_strategy_errors():
    _, trg = _pair()
    u = torch.zeros(N, D_IN)
    with pytest.raises(ValueError, match="unknown hetero strategy"):
        hetero_gspmm(trg, u, strategy="nope")
    with pytest.raises(ValueError):
        hetero_gspmm(trg, u, reduce="prod")
    with pytest.raises(ValueError):
        hetero_gspmm(trg, u, basis=torch.zeros(2, D_IN, 3))
    with pytest.raises(ValueError):
        hetero_gspmm(trg, torch.zeros(N, 2, 3))


def test_segment_pins_the_loop():
    jrg, trg = _pair()
    ops = _operands("w", True, trg.n_rel, trg.n_edges)
    np.testing.assert_allclose(_port_out(trg, ops, "sum", "segment"),
                               _jax_out(jrg, ops, "sum", "segment"),
                               rtol=TOL, atol=TOL)


def test_hetero_event_is_recorded():
    _, trg = _pair()
    obs.clear_events()
    ops = _operands("w", False, trg.n_rel, trg.n_edges)
    _port_out(trg, ops, "mean", "kernel")
    _port_out(trg, ops, "mean", "fused")
    assert obs.measured_events()["hetero:u_w_mean_v"]["calls"] == 2


# --------------------------------------------------------------------- #
# gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["fused", "loop", "kernel"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("with_e", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_hetero_grads_match_jax(form, with_e, reduce, strategy):
    """∂(Σ out·ct) w.r.t. every operand against ``jax.grad`` of JAX's
    fused route (its custom gather VJP)."""
    jrg, trg = _pair()
    ops = _operands(form, with_e, trg.n_rel, trg.n_edges, seed=7)
    ct = np.random.default_rng(8).standard_normal(
        (N, _width(form))).astype(np.float32)
    names = sorted(ops)

    def jloss(*vals):
        out = jax_hetero_gspmm(jrg, **dict(zip(names, vals)), reduce=reduce,
                               strategy="fused")
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ops[k]) for k in names))
    ts = {k: torch.from_numpy(ops[k]).requires_grad_() for k in names}
    out = hetero_gspmm(trg, **ts, reduce=reduce, strategy=strategy)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                              [ts[k] for k in names])
    for k, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=k)


# --------------------------------------------------------------------- #
# relational blocks
# --------------------------------------------------------------------- #
def _blocks():
    """One 2-layer minibatch, sampled alike by both packages from the
    merged typed graph, with the features' block inputs."""
    if "blocks" not in _cache:
        rels = _rels(seed=11, sizes=(60, 25, 0, 40))
        src = np.concatenate([s for s, _ in rels])
        dst = np.concatenate([d for _, d in rels])
        rel = np.concatenate([np.full(len(s), r) for r, (s, _)
                              in enumerate(rels)])
        seeds = np.arange(0, 24, 3)
        labels = np.zeros(len(seeds), np.int64)
        jmb = JaxSampler(jax_from_coo(src, dst, n_src=N, n_dst=N), [3, 2],
                         batch_size=8, seed=4, edge_rel=rel).sample(seeds,
                                                                    labels)
        tmb = NeighborSampler(from_coo(src, dst, n_src=N, n_dst=N,
                                       device="cpu"), [3, 2], batch_size=8,
                              seed=4, edge_rel=rel, device="cpu").sample(
            seeds, labels)
        _cache["blocks"] = (jmb, tmb)
    return _cache["blocks"]


@pytest.mark.parametrize("strategy", ["auto", "ell", "segment", "kernel"])
@pytest.mark.parametrize("layer", [0, 1])
def test_hetero_block_gspmm_matches_jax(layer, strategy):
    jmb, tmb = _blocks()
    jb, tb = jmb.blocks[layer], tmb.blocks[layer]
    np.testing.assert_array_equal(tb.rel.numpy(), np.asarray(jb.rel))
    rng = np.random.default_rng(12 + layer)
    u = rng.standard_normal((tb.bg.g.n_src, D_IN)).astype(np.float32)
    w = rng.standard_normal((4, D_IN, D_OUT)).astype(np.float32)
    ref = jax_hetero_block_gspmm(jb.bg, jb.rel, jnp.asarray(u),
                                 jnp.asarray(w), norm=jb.rel_norm)
    got = hetero_block_gspmm(tb.bg, tb.rel, torch.from_numpy(u),
                             torch.from_numpy(w), norm=tb.rel_norm,
                             strategy=strategy)
    assert got.shape == (tb.bg.n_dst_real, D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
