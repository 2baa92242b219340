"""Port parity for the relational backwards (``repro_torch/core/hetero.py``).

* The plain fused route's sum and mean differentiate through
  ``_HeteroFusedRev``, the port of JAX's ``_hetero_fused_rev`` custom
  VJP: its grads against ``jax.grad`` at 1e-5 for every operand form,
  with and without ``e``, in both message branches (per-edge ``W``
  indexing and the relation-batched pre-transform); one sorted segment
  reduce, no scatter. ``loop`` and max / min keep autograd, as in JAX.
* The apps' plain edge ops (``gsddmm``'s canonical route: GC-MC's
  decoder, LGNN's Pᵀx) differentiate by sorted reduces too, with no
  ``index_add_`` (their values against JAX: ``tests/test_torch_grads.py``).
* ``hetero_block_gspmm`` grads (∂u, ∂w) against ``jax.grad`` of JAX's
  with ``bwd_strategy`` gather and scatter, on both layers of one
  minibatch both packages sample alike, at 2e-4: the gather backward
  after a plain forward (JAX's ``_hetero_block_rev``) and after a kernel
  forward (B1 over the block's relation-expanded Gᵀ, here through the
  wrapper's plain version). The expanded Gᵀ the sampler builds from its
  draw equals the one built on first use, and pad edges add nothing.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import from_coo as jax_from_coo
from repro.core import hetero as jax_hetero
from repro.core.hetero import from_rels as jax_from_rels
from repro.core.hetero import hetero_block_gspmm as jax_hetero_block_gspmm
from repro.core.hetero import hetero_gspmm as jax_hetero_gspmm
from repro.data import NeighborSampler as JaxSampler
from repro_torch import obs
from repro_torch.core import from_coo, gsddmm
from repro_torch.core import hetero
from repro_torch.core import strategies as S
from repro_torch.core.hetero import (block_expanded_reverse, caller_coo,
                                     from_rels, hetero_block_gspmm,
                                     hetero_gspmm)
from repro_torch.data import NeighborSampler
from repro_torch.kernels.spmm import ops as spmm_ops
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
BLOCK_TOL = 2e-4
N, D_IN, D_OUT, N_BASES = 40, 6, 5, 3
SIZES = (30, 0, 5, 17)          # skew plus one empty relation
FORMS = ("plain", "w", "basis", "u3")
GRAPH_FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src",
                "perm_src", "eid_inv")

_cache = {}


def _rels(seed=0, n=N, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, s), rng.integers(0, n, s)) for s in sizes]


def _pair():
    if "rg" not in _cache:
        rels = _rels()
        _cache["rg"] = (jax_from_rels(rels, n_src=N, n_dst=N),
                        from_rels(rels, n_src=N, n_dst=N, device="cpu"))
    return _cache["rg"]


def _operands(form, with_e, n_rel, n_edges, seed):
    rng = np.random.default_rng(seed)
    ops = {"u": rng.standard_normal(
        (N, n_rel, D_OUT) if form == "u3" else (N, D_IN)).astype(np.float32)}
    if form == "w":
        ops["w"] = (rng.standard_normal((n_rel, D_IN, D_OUT)) * 0.5).astype(
            np.float32)
    if form == "basis":
        ops["basis"] = (rng.standard_normal((N_BASES, D_IN, D_OUT))
                        * 0.5).astype(np.float32)
        ops["coeff"] = (rng.standard_normal((n_rel, N_BASES))
                        * 0.5).astype(np.float32)
    if with_e:
        ops["e"] = (rng.random(n_edges) + 0.5).astype(np.float32)
    return ops


def _fused_grads(form, with_e, reduce, seed=21):
    """(port grads, JAX grads, port output) of Σ out·ct over every operand,
    both on the fused route."""
    jrg, trg = _pair()
    ops = _operands(form, with_e, trg.n_rel, trg.n_edges, seed)
    ct = np.random.default_rng(seed + 1).standard_normal(
        (N, D_IN if form == "plain" else D_OUT)).astype(np.float32)
    names = sorted(ops)

    def jloss(*vals):
        out = jax_hetero_gspmm(jrg, **dict(zip(names, vals)), reduce=reduce,
                               strategy="fused")
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ops[k]) for k in names))
    ts = {k: torch.from_numpy(ops[k]).requires_grad_() for k in names}
    out = hetero_gspmm(trg, **ts, reduce=reduce, strategy="fused")
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                              [ts[k] for k in names])
    return dict(zip(names, got)), dict(zip(names, want)), out


# --------------------------------------------------------------------- #
# the fused route's gather VJP
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("with_e", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_fused_gather_vjp_matches_jax(form, with_e, reduce):
    got, want, out = _fused_grads(form, with_e, reduce)
    assert type(out.grad_fn).__name__ == "_HeteroFusedRevBackward"
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("with_e", [False, True])
def test_fused_gather_vjp_pre_transform_branch(with_e, reduce, monkeypatch):
    """Above ``_EDGE_MODE_ELEMS`` the ``w`` form's forward gathers from
    the relation-batched pre-transform; the backward is the same."""
    monkeypatch.setattr(jax_hetero, "_EDGE_MODE_ELEMS", 0)
    monkeypatch.setattr(hetero, "_EDGE_MODE_ELEMS", 0)
    got, want, out = _fused_grads("w", with_e, reduce, seed=31)
    assert type(out.grad_fn).__name__ == "_HeteroFusedRevBackward"
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("form", ["w", "basis", "u3", "plain"])
def test_fused_backward_is_one_sorted_reduce(form, monkeypatch):
    """Every operand's adjoint comes from ONE ``pull_segment`` over the
    reverse table (the ∂e of a mean reads no reduce at all), and no
    ``index_add_`` runs in the backward."""
    _, trg = _pair()
    ops = _operands(form, True, trg.n_rel, trg.n_edges, seed=41)
    ts = {k: torch.from_numpy(v).requires_grad_() for k, v in ops.items()}
    out = hetero_gspmm(trg, **ts, reduce="mean", strategy="fused")
    calls = []
    pull = S.pull_segment
    monkeypatch.setattr(S, "pull_segment",
                        lambda *a, **k: calls.append(a[2]) or pull(*a, **k))
    monkeypatch.setattr(torch.Tensor, "index_add_", None)
    torch.autograd.grad(out.sum(), list(ts.values()))
    assert calls == [N if form == "plain" else N * trg.n_rel]


@pytest.mark.parametrize("case", ["loop", "max", "min"])
def test_loop_and_extrema_keep_autograd(case):
    """As in JAX: the per-relation loop and the extrema differentiate by
    autograd, and still match ``jax.grad``."""
    jrg, trg = _pair()
    ops = _operands("w", False, trg.n_rel, trg.n_edges, seed=51)
    strategy, reduce = ("loop", "sum") if case == "loop" else ("fused", case)
    names = sorted(ops)

    def jloss(*vals):
        return jnp.sum(jax_hetero_gspmm(
            jrg, **dict(zip(names, vals)), reduce=reduce,
            strategy=strategy) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(*(jnp.asarray(ops[k])
                                              for k in names))
    ts = {k: torch.from_numpy(ops[k]).requires_grad_() for k in names}
    out = hetero_gspmm(trg, **ts, reduce=reduce, strategy=strategy)
    assert "HeteroFusedRev" not in type(out.grad_fn).__name__
    got = torch.autograd.grad((out ** 2).sum(), [ts[k] for k in names])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_fused_route_without_grad_runs_plain():
    """No operand needs a gradient: the plain forward, no Function."""
    _, trg = _pair()
    ops = _operands("basis", True, trg.n_rel, trg.n_edges, seed=61)
    out = hetero_gspmm(trg, **{k: torch.from_numpy(v) for k, v in
                               ops.items()}, reduce="mean", strategy="fused")
    assert out.grad_fn is None


@pytest.mark.parametrize("name", ["u_dot_v_add_e", "u_add_v_copy_e",
                                  "u_div_v_copy_e", "e_mul_v_copy_e",
                                  "u_copy_copy_e"])
def test_canonical_gsddmm_backward_is_scatter_free(name, monkeypatch):
    """The canonical route's backward: sorted reduces, no ``index_add_``,
    equal to the caller-order gather route's autograd."""
    _, trg = _pair()
    g = trg.g
    rng = np.random.default_rng(81)
    rows = {"u": g.n_src, "v": g.n_dst, "e": g.n_edges}
    targets = [t for t in name.split("_")[::2][:2] if t in rows]
    if "copy_copy" in name:
        targets = targets[:1]
    ops = {t: torch.from_numpy((rng.random((rows[t], 4)) + 0.5).astype(
        np.float32)).requires_grad_() for t in targets}
    ct = torch.from_numpy(rng.standard_normal(
        (g.n_edges, 1 if "dot" in name else 4)).astype(np.float32))
    want = torch.autograd.grad(gsddmm(g, name, strategy="gather", **ops),
                               list(ops.values()), ct)
    out = gsddmm(g, name, strategy="canonical", **ops)
    assert type(out.grad_fn).__name__ == "_CanonicalGsddmmBackward"
    monkeypatch.setattr(torch.Tensor, "index_add_", None)
    got = torch.autograd.grad(out, list(ops.values()), ct)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


# --------------------------------------------------------------------- #
# the relational block VJP
# --------------------------------------------------------------------- #
def _typed_edges():
    rels = _rels(seed=11, sizes=(60, 25, 0, 40))
    src = np.concatenate([s for s, _ in rels])
    dst = np.concatenate([d for _, d in rels])
    rel = np.concatenate([np.full(len(s), r) for r, (s, _)
                          in enumerate(rels)])
    return src, dst, rel


def _blocks():
    """One 2-layer minibatch sampled alike by both packages from the
    merged typed graph; the port's sampler builds each block's Gᵀ and
    relation-expanded Gᵀ from its draw."""
    if "blocks" not in _cache:
        src, dst, rel = _typed_edges()
        seeds = np.arange(0, 24, 3)
        labels = np.zeros(len(seeds), np.int64)
        jmb = JaxSampler(jax_from_coo(src, dst, n_src=N, n_dst=N), [3, 2],
                         batch_size=8, seed=4, edge_rel=rel).sample(seeds,
                                                                    labels)
        tmb = NeighborSampler(from_coo(src, dst, n_src=N, n_dst=N,
                                       device="cpu"), [3, 2], batch_size=8,
                              seed=4, edge_rel=rel, device="cpu",
                              reverse=True).sample(seeds, labels)
        _cache["blocks"] = (jmb, tmb)
    return _cache["blocks"]


def _block_operands(tb, layer, poison=0.0):
    rng = np.random.default_rng(70 + layer)
    u = rng.standard_normal((tb.bg.g.n_src, D_IN)).astype(np.float32)
    u[-1] = poison                          # the dummy source slot
    w = (rng.standard_normal((4, D_IN, D_OUT)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((tb.bg.n_dst_real, D_OUT)).astype(np.float32)
    return u, w, ct


def _port_block_grads(tb, u, w, ct, strategy, bwd):
    tu = torch.from_numpy(u).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = hetero_block_gspmm(tb.bg, tb.rel, tu, tw, norm=tb.rel_norm,
                             strategy=strategy, bwd_strategy=bwd)
    du, dw = torch.autograd.grad(out, (tu, tw), torch.from_numpy(ct))
    return out, du.numpy(), dw.numpy()


@pytest.mark.parametrize("strategy", ["ell", "segment", "kernel"])
@pytest.mark.parametrize("bwd", ["gather", "scatter"])
@pytest.mark.parametrize("layer", [0, 1])
def test_block_grads_match_jax(layer, bwd, strategy):
    jmb, tmb = _blocks()
    jb, tb = jmb.blocks[layer], tmb.blocks[layer]
    u, w, ct = _block_operands(tb, layer)

    def jloss(uu, ww):
        out = jax_hetero_block_gspmm(jb.bg, jb.rel, uu, ww, norm=jb.rel_norm,
                                     bwd_strategy=bwd)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(w))
    out, du, dw = _port_block_grads(tb, u, w, ct, strategy, bwd)
    name = type(out.grad_fn).__name__
    assert (name == "_HeteroBlockGatherBackward") == (bwd == "gather")
    for got, ref, what in ((du, want[0], "du"), (dw, want[1], "dw")):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, np.asarray(ref), rtol=BLOCK_TOL,
                                   atol=BLOCK_TOL * scale, err_msg=what)


@pytest.mark.parametrize("strategy", ["ell", "kernel"])
@pytest.mark.parametrize("layer", [0, 1])
def test_block_gather_pads_add_nothing(layer, strategy):
    """A finite poison in the dummy source slot changes no gradient: pad
    edges carry norm 0 and leave the dummy destination row, whose
    cotangent is zero."""
    _, tmb = _blocks()
    tb = tmb.blocks[layer]
    clean = _block_operands(tb, layer)
    dirty = _block_operands(tb, layer, poison=1e3)
    _, du0, dw0 = _port_block_grads(tb, *clean, strategy, "gather")
    _, du1, dw1 = _port_block_grads(tb, *dirty, strategy, "gather")
    np.testing.assert_array_equal(dw1, dw0)
    np.testing.assert_array_equal(du1[:-1], du0[:-1])


@pytest.mark.parametrize("layer", [0, 1])
def test_kernel_gather_runs_b1_on_the_expanded_reverse(layer, monkeypatch):
    """After a kernel forward the gather backward is ONE B1 call, over
    the relation-expanded Gᵀ the sampler built from its draw."""
    _, tmb = _blocks()
    tb = tmb.blocks[layer]
    gx = block_expanded_reverse(tb.bg, tb.rel, 4)
    u, w, ct = _block_operands(tb, layer)
    tu = torch.from_numpy(u).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = hetero_block_gspmm(tb.bg, tb.rel, tu, tw, norm=tb.rel_norm,
                             strategy="kernel", bwd_strategy="gather")
    graphs = []
    plain = spmm_ops.spmm_plain
    monkeypatch.setattr(spmm_ops, "spmm_plain", lambda g, *a, **k: (
        graphs.append(g), plain(g, *a, **k))[1])
    torch.autograd.grad(out, (tu, tw), torch.from_numpy(ct))
    assert graphs == [gx]


@pytest.mark.parametrize("layer", [0, 1])
def test_expanded_reverse_from_draw_equals_first_use(layer):
    """The sampler's host build equals the one made from ``bg.g`` and
    ``rel`` on first use: edges ``dst → src·R + rel`` in caller order."""
    _, tmb = _blocks()
    tb = tmb.blocks[layer]
    R = 4
    from_draw = block_expanded_reverse(tb.bg, tb.rel, R)
    fresh = block_expanded_reverse(tb.bg, tb.rel.clone(), R)
    assert fresh is not from_draw
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(fresh.host, f),
                                      getattr(from_draw.host, f), err_msg=f)
    src, dst = caller_coo(tb.bg.g)
    xs, xd = caller_coo(fresh)
    np.testing.assert_array_equal(xs, dst)
    np.testing.assert_array_equal(xd, src * R + tb.rel.numpy())
    assert (fresh.n_src, fresh.n_dst) == (tb.bg.g.n_dst, tb.bg.g.n_src * R)


def test_block_gather_needs_the_reverse():
    """Gather is available once the block has its Gᵀ, as in JAX: a
    serving sampler's block (none built) differentiates by scatter."""
    src, dst, rel = _typed_edges()
    seeds = np.arange(0, 24, 3)
    tmb = NeighborSampler(from_coo(src, dst, n_src=N, n_dst=N, device="cpu"),
                          [3, 2], batch_size=8, seed=9, edge_rel=rel,
                          device="cpu").sample(seeds, np.zeros(8, np.int64))
    tb = tmb.blocks[1]
    u, w, ct = _block_operands(tb, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, *_ = _port_block_grads(tb, u, w, ct, "ell", "gather")
    assert type(out.grad_fn).__name__ != "_HeteroBlockGatherBackward"


def test_block_backward_event_is_recorded():
    _, tmb = _blocks()
    tb = tmb.blocks[1]
    obs.clear_events()
    _port_block_grads(tb, *_block_operands(tb, 1), "kernel", "gather")
    ev = obs.measured_events()
    assert ev["block:e_copy_add_v"]["calls"] == 1
    assert ev["block_bwd:e_copy_add_v"]["calls"] == 1
