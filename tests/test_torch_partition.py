"""Port parity for partitioned execution (``repro_torch/core/partition.py``
and the planner's ring half) against the JAX package's emulated ring
(``repro/core/partition.py`` with ``mesh=None``), on the CPU:

* ``build_partition``: every array (``to_pad``, ``from_pad``, the
  (S, S, eb) bucket arrays), ``eb_ij`` and the stats equal to JAX's, for
  every mode and S ∈ {1, 2, 3, 5}, and on the power-law R-MAT ``hash``
  leg; the layout converters;
* the stage graphs: every real slot once, pads never, launches per pass;
* the ring ops (``ring_gspmm`` with a scalar and a per-head weight,
  ``local_gspmm``, ``ring_gspmm_delayed``, ``ring_edge_values``,
  ``bucket_softmax``, ``fused_attention_partitioned``, gspmm's ring
  route), forward and backward within 2e-4 of JAX's, on the kernel route
  (the wrappers' plain versions here) and the plain route;
* the int8 ring within one quantization step of JAX's, with the byte
  counters equal;
* JAX's delayed-halo semantics (``tests/core/test_partition.py``);
* ``estimate_cost("ring", ...)`` equal to JAX's on the ``cpu`` row, with
  and without partition stats and int8; ``PlanCache.partition``;
  ``use_ring``; a mesh raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import from_coo as jax_from_coo
from repro.core import partition as jp
from repro.core import planner as jplanner
from repro.core.binary_reduce import _gspmm_ring as jax_gspmm_ring
from repro.core.binary_reduce import parse_op as jax_parse_op
from repro.core.edge_softmax import (
    fused_attention_partitioned as jax_fused_attention_partitioned)
from repro.data import rmat_graph as jax_rmat_graph
from repro.obs import metrics as jax_metrics
from repro_torch.core import from_coo, gspmm, parse_op, planner
from repro_torch.core import partition as tp
from repro_torch.core.binary_reduce import _gspmm_ring
from repro_torch.core.edge_softmax import fused_attention_partitioned
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.obs import metrics
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 2e-4
ROUTES = ("kernel", "plain")


def _pair(n=48, nnz=300, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    return (jax_from_coo(src, dst, n_src=n, n_dst=n),
            from_coo(src, dst, n_src=n, n_dst=n, device="cpu"))


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().double().numpy(), want,
                               rtol=tol, atol=tol * scale)


def _jax_vjp(fn, args, ct):
    """``fn(*args)`` and the grads of ``Σ fn(*args)·ct`` w.r.t. every
    arg, jitted: JAX's eager path compiles each small op of the emulated
    ring anew per shape, ~10× the time of one compile."""
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


def _both_partitions(S, mode, seed=0, n=48, nnz=300):
    jg, tg = _pair(n, nnz, seed)
    return jg, tg, jp.build_partition(jg, S, mode), tp.build_partition(
        tg, S, mode)


# --------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------- #
def _assert_plan_equal(jpg, tpg):
    for name in ("to_pad", "from_pad", "src_local", "dst_local", "eid",
                 "mask"):
        want = np.asarray(getattr(jpg, name))
        np.testing.assert_array_equal(getattr(tpg.host, name), want)
        np.testing.assert_array_equal(getattr(tpg, name).numpy(), want)
    for name in ("n_shards", "rows", "eb", "n", "n_edges", "mode", "eb_ij",
                 "n_pad"):
        assert getattr(tpg, name) == getattr(jpg, name), name
    assert dataclasses.asdict(tpg.stats) == dataclasses.asdict(jpg.stats)


@pytest.mark.parametrize("mode", tp.PARTITION_MODES)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
def test_build_partition_equal_to_jax(mode, n_shards):
    _, _, jpg, tpg = _both_partitions(n_shards, mode, n=41, nnz=260)
    _assert_plan_equal(jpg, tpg)


@pytest.mark.parametrize("shape", [(33, 20, 200), (40, 40, 0), (30, 30, 7)])
def test_build_partition_rectangular_and_sparse(shape):
    n_src, n_dst, nnz = shape
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, n_src, nnz), rng.integers(0, n_dst, nnz)
    jg = jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    for S in (2, 3):
        _assert_plan_equal(jp.build_partition(jg, S, "contiguous"),
                           tp.build_partition(tg, S, "contiguous"))


def test_build_partition_powerlaw_hash_leg():
    """The benchmark's power-law leg (R-MAT 2^13 nodes, 60,000 edges,
    seed 13, hash at S = 8)."""
    src, dst, n = rmat_graph(13, 60_000, seed=13)
    jsrc, jdst, jn = jax_rmat_graph(13, 60_000, seed=13)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    jpg = jp.build_partition(jax_from_coo(jsrc, jdst, n_src=jn, n_dst=jn),
                             8, "hash")
    tpg = tp.build_partition(from_coo(src, dst, n_src=n, n_dst=n,
                                      device="cpu"), 8, "hash")
    _assert_plan_equal(jpg, tpg)


def test_unknown_mode_and_bad_shards_raise():
    _, tg = _pair()
    with pytest.raises(ValueError, match="unknown partition mode"):
        tp.build_partition(tg, 2, "metis")
    with pytest.raises(ValueError, match="n_shards"):
        tp.build_partition(tg, 0)


@pytest.mark.parametrize("mode", tp.PARTITION_MODES)
def test_layout_converters_match_jax(mode):
    jg, tg, jpg, tpg = _both_partitions(3, mode, seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 5)).astype(np.float32)
    w = rng.normal(size=(tg.n_edges, 2)).astype(np.float32)
    xp = tpg.scatter_nodes(torch.from_numpy(x))
    _close(xp, jpg.scatter_nodes(jnp.asarray(x)), 0)
    _close(tpg.gather_nodes(xp), x, 0)
    wb = tpg.scatter_edges(torch.from_numpy(w))
    _close(wb, jpg.scatter_edges(jnp.asarray(w)), 0)
    _close(tpg.gather_edges(wb), w, 0)
    labels = torch.from_numpy(rng.integers(0, 4, 48))
    assert torch.equal(tpg.gather_nodes(tpg.scatter_nodes(labels)), labels)


# --------------------------------------------------------------------- #
# the stage graphs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", tp.PARTITION_MODES)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
def test_stage_plan_covers_every_real_slot_once(mode, n_shards):
    _, tg, _, pg = _both_partitions(n_shards, mode)
    plan = tp.stage_plan(pg)
    assert plan is tp.stage_plan(pg)                      # built once
    real = np.flatnonzero(pg.host.mask.reshape(-1))
    slots = np.concatenate([p.slots.numpy() for p in plan.stages])
    np.testing.assert_array_equal(np.sort(slots), real)
    assert sorted(p.stage for p in plan.stages) == [
        s for s in range(n_shards)
        if any(pg.eb_ij[(j + s) % n_shards][j] for j in range(n_shards))]
    off = plan.remote.slots.numpy() if plan.remote is not None else []
    loc = plan.local.slots.numpy() if plan.local is not None else []
    np.testing.assert_array_equal(np.sort(np.concatenate([off, loc])),
                                  real)
    np.testing.assert_array_equal(np.sort(plan.everything.slots.numpy()),
                                  real)
    h, S, rows, eb = pg.host, pg.n_shards, pg.rows, pg.eb
    for p in plan.stages + (plan.everything,):
        s = p.slots.numpy()
        i, j, k = s // (S * eb), (s // eb) % S, s % eb
        np.testing.assert_array_equal(p.g.host.src[p.g.host.eid_inv],
                                      j * rows + h.src_local[i, j, k])
        np.testing.assert_array_equal(p.g.host.dst[p.g.host.eid_inv],
                                      i * rows + h.dst_local[i, j, k])
        if p.stage >= 0:
            assert ((i - j) % S == p.stage).all()


@pytest.fixture
def launches(monkeypatch):
    """Each wrapper's plain branch stands in for its kernel on the CPU:
    a dict counting those calls, by kernel."""
    counts = {}

    def counting(module, name, key):
        plain = getattr(module, name)

        def wrapped(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return plain(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    counting(spmm_ops, "spmm_plain", "spmm_csr")
    counting(sddmm_ops, "sddmm_plain", "sddmm_csr")
    counting(br_ops, "binary_reduce_plain", "binary_reduce_csr")
    counting(es_ops, "edge_softmax_plain", "edge_softmax_csr")
    return counts


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_kernel_route_launches_per_pass(n_shards, launches):
    """B1 per non-empty diagonal forward, B1 on each reverse (∂x) and B3
    per diagonal (∂w) backward; the plain route launches nothing."""
    _, tg, _, pg = _both_partitions(n_shards, "contiguous")
    ns = len(tp.stage_plan(pg).stages)
    x = torch.randn(pg.n_pad, 4, requires_grad=True)
    w = pg.scatter_edges(torch.rand(tg.n_edges)).requires_grad_()
    out = tp.ring_gspmm(pg, x, w, strategy="kernel")
    assert launches == {"spmm_csr": ns}
    torch.autograd.grad(out.sum(), (x, w))
    assert launches == {"spmm_csr": 2 * ns, "sddmm_csr": ns}
    launches.clear()
    out = tp.ring_gspmm(pg, x, w, strategy="plain")
    torch.autograd.grad(out.sum(), (x, w))
    assert launches == {}
    stale = torch.zeros(pg.n_pad, 4)
    for refresh, want in ((True, 2), (False, 1)):
        launches.clear()
        tp.ring_gspmm_delayed(pg, x, w.detach(), stale, refresh,
                              strategy="kernel")
        assert launches == {"spmm_csr": want}, refresh


# --------------------------------------------------------------------- #
# the ring ops against JAX's emulated ring
# --------------------------------------------------------------------- #
CASES = [(S, mode) for S in (1, 2, 3) for mode in ("contiguous", "hash")]


def _operands(tpg, n_edges, d, seed, head=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(48, d) if head is None else (48, head, d)).astype(
        np.float32)
    w = rng.random(size=(n_edges,) if head is None
                   else (n_edges, head)).astype(np.float32) + 0.1
    c = rng.normal(size=(tpg.n_pad,) + x.shape[1:]).astype(np.float32)
    return x, w, c


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("S,mode", CASES)
@pytest.mark.parametrize("head", [None, 3])
def test_ring_gspmm_and_grads_match_jax(S, mode, route, head):
    jg, tg, jpg, tpg = _both_partitions(S, mode, seed=4)
    x, w, c = _operands(tpg, tg.n_edges, 5, 5, head)
    jx, jw = jpg.scatter_nodes(jnp.asarray(x)), jpg.scatter_edges(
        jnp.asarray(w))
    want, (jdx, jdw) = _jax_vjp(lambda a, b: jp.ring_gspmm(jpg, a, b),
                                (jx, jw), jnp.asarray(c))
    tx = tpg.scatter_nodes(torch.from_numpy(x)).requires_grad_()
    tw = tpg.scatter_edges(torch.from_numpy(w)).requires_grad_()
    got = tp.ring_gspmm(tpg, tx, tw, strategy=route)
    _close(got, want)
    dx, dw = torch.autograd.grad((got * torch.from_numpy(c)).sum(),
                                 (tx, tw))
    _close(dx, jdx)
    _close(dw, jdw)
    _close(tp.ring_reference(tpg, tx.detach(), tw.detach()), want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("S,mode", CASES)
def test_local_and_delayed_match_jax(S, mode, route):
    jg, tg, jpg, tpg = _both_partitions(S, mode, seed=6)
    x, w, c = _operands(tpg, tg.n_edges, 4, 7)
    jx, jw = jpg.scatter_nodes(jnp.asarray(x)), jpg.scatter_edges(
        jnp.asarray(w))
    tx = tpg.scatter_nodes(torch.from_numpy(x)).requires_grad_()
    tw = tpg.scatter_edges(torch.from_numpy(w))
    ct = torch.from_numpy(c)
    jc = jnp.asarray(c)
    loc = tp.local_gspmm(tpg, tx, tw, strategy=route)
    want, (jdx,) = _jax_vjp(lambda z: jp.local_gspmm(jpg, z, jw), (jx,), jc)
    _close(loc, want)
    _close(torch.autograd.grad((loc * ct).sum(), tx)[0], jdx)
    _close(tp.offdiag_weights(tpg, tw), jp.offdiag_weights(jpg, jw), 0)
    for refresh in (True, False):
        out, remote = tp.ring_gspmm_delayed(tpg, tx, tw, ct, refresh,
                                            strategy=route)
        jremote = jp.ring_gspmm_delayed(jpg, jx, jw, jc, refresh)[1]
        jout, (jdx,) = _jax_vjp(lambda z: jp.ring_gspmm_delayed(
            jpg, z, jw, jc, refresh)[0], (jx,), jc)
        _close(out, jout)
        _close(remote, jremote)
        assert not remote.requires_grad
        _close(torch.autograd.grad((out * ct).sum(), tx)[0], jdx)


@pytest.mark.parametrize("route", ROUTES)
def test_delayed_halo_semantics(route):
    """JAX's ``test_delayed_halo_semantics``: refresh=True is exact; a
    stale step is local(new x) + the old remote, the remote passes
    through unchanged, and its gradient is the local part's alone."""
    _, tg = _pair(seed=4)
    pg = tp.build_partition(tg, 3, "contiguous")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(tg.n_src, 4)).astype(np.float32))
    w = pg.scatter_edges(torch.ones(tg.n_edges))
    xp = pg.scatter_nodes(x)
    kw = dict(strategy=route)
    exact = tp.ring_gspmm(pg, xp, w, **kw)
    out, stale = tp.ring_gspmm_delayed(pg, xp, w, torch.zeros_like(xp), True,
                                       **kw)
    torch.testing.assert_close(out, exact, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        tp.local_gspmm(pg, xp, w, **kw)
        + tp.ring_gspmm(pg, xp, tp.offdiag_weights(pg, w), **kw),
        exact, rtol=1e-5, atol=1e-6)
    x2 = (xp * 2.0).requires_grad_()
    out2, stale2 = tp.ring_gspmm_delayed(pg, x2, w, stale, False, **kw)
    torch.testing.assert_close(out2, tp.local_gspmm(pg, x2, w, **kw)
                               + stale, rtol=1e-5, atol=1e-6)
    assert torch.equal(stale2, stale)
    g_stale = torch.autograd.grad(out2.sum(), x2)[0]
    g_local = torch.autograd.grad(tp.local_gspmm(pg, x2, w, **kw).sum(),
                                  x2)[0]
    torch.testing.assert_close(g_stale, g_local, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("S,mode", CASES)
def test_edge_values_and_softmax_match_jax(S, mode, route):
    jg, tg, jpg, tpg = _both_partitions(S, mode, seed=8)
    rng = np.random.default_rng(9)
    H = 3
    el = rng.normal(size=(48, H)).astype(np.float32)
    er = rng.normal(size=(48, H)).astype(np.float32)
    c = rng.normal(size=(S, S, jpg.eb, H)).astype(np.float32)
    jel, jer = jpg.scatter_nodes(jnp.asarray(el)), jpg.scatter_nodes(
        jnp.asarray(er))
    tel = tpg.scatter_nodes(torch.from_numpy(el)).requires_grad_()
    ter = tpg.scatter_nodes(torch.from_numpy(er)).requires_grad_()
    vals = tp.ring_edge_values(tpg, tel, ter, strategy=route)
    jvals, jgrads = _jax_vjp(lambda a, b: jp.ring_edge_values(jpg, a, b),
                             (jel, jer), jnp.asarray(c))
    _close(vals, jvals)
    grads = torch.autograd.grad((vals * torch.from_numpy(c)).sum(),
                                (tel, ter))
    for got, want in zip(grads, jgrads):
        _close(got, want)
    logits = torch.from_numpy(np.array(jvals)).requires_grad_()
    alpha = tp.bucket_softmax(tpg, logits, strategy=route)
    jalpha, (jdl,) = _jax_vjp(lambda z: jp.bucket_softmax(jpg, z), (jvals,),
                              jnp.asarray(c))
    _close(alpha, jalpha)
    _close(torch.autograd.grad((alpha * torch.from_numpy(c)).sum(),
                               logits)[0], jdl)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("S,mode", CASES)
def test_fused_attention_partitioned_matches_jax(S, mode, route):
    jg, tg, jpg, tpg = _both_partitions(S, mode, seed=10)
    rng = np.random.default_rng(11)
    H, F = 2, 4
    el, er = (rng.normal(size=(48, H)).astype(np.float32) for _ in "lr")
    z = rng.normal(size=(48, H, F)).astype(np.float32)
    c = rng.normal(size=(tpg.n_pad, H, F)).astype(np.float32)
    jin = [jpg.scatter_nodes(jnp.asarray(a)) for a in (el, er, z)]
    tin = [tpg.scatter_nodes(torch.from_numpy(a)).requires_grad_()
           for a in (el, er, z)]
    out = fused_attention_partitioned(tpg, *tin, strategy=route)
    jout, jgrads = _jax_vjp(
        lambda *a: jax_fused_attention_partitioned(jpg, *a), jin,
        jnp.asarray(c))
    _close(out, jout)
    assert planner.last_plan("attn:fused", "ring") == "ring"
    grads = torch.autograd.grad((out * torch.from_numpy(c)).sum(), tin)
    for got, want in zip(grads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("op", ["u_copy_add_v", "u_copy_mean_v",
                                "u_mul_e_add_v", "u_mul_e_mean_v"])
@pytest.mark.parametrize("S", [2, 3])
def test_gspmm_ring_route_matches_jax(op, S):
    jg, tg = _pair(seed=12)
    rng = np.random.default_rng(13)
    u = rng.normal(size=(48, 6)).astype(np.float32)
    e = rng.random(size=(tg.n_edges, 1)).astype(np.float32)
    jpg = jplanner.get_plan_cache(jg).partition(S, "contiguous")
    tpg = planner.get_plan_cache(tg).partition(S, "contiguous")
    jspec, tspec = jax_parse_op(op), parse_op(op)
    want = jax_gspmm_ring(jg, jspec, jpg, jnp.asarray(u),
                          jnp.asarray(e) if jspec.op == "mul" else None)
    got = _gspmm_ring(tg, tspec, tpg, torch.from_numpy(u),
                      torch.from_numpy(e) if tspec.op == "mul" else None)
    _close(got, want)
    _close(got, gspmm(tg, op, u=torch.from_numpy(u),
                      e=torch.from_numpy(e), strategy="segment"))


# --------------------------------------------------------------------- #
# int8 exchanges
# --------------------------------------------------------------------- #
def _counters(snap):
    return {k: snap[k]["value"] for k in ("comm.ring.raw_bytes",
                                          "comm.ring.wire_bytes",
                                          "comm.ring.pad_slots")}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("S,dtype", [(4, "float32"), (2, "float32"),
                                     (4, "bfloat16")])
def test_int8_ring_matches_jax_with_equal_counters(S, dtype, route):
    """JAX's 4-shard int8 leg: the output within one quantization step
    of JAX's (the dequantized payloads are equal; sums differ by
    rounding), the residual too, raw / wire ≥ 3 at fp32, and the byte
    counters of one call equal to JAX's."""
    rng = np.random.default_rng(14)
    n, m = 96, 600
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    jg = jax_from_coo(src, dst, n_src=n, n_dst=n)
    tg = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    jpg = jp.build_partition(jg, S, "contiguous")
    tpg = tp.build_partition(tg, S, "contiguous")
    x = rng.normal(size=(n, 16)).astype(np.float32)
    r = (rng.normal(size=(tpg.n_pad, 16)) * 0.01).astype(np.float32)
    jx = jpg.scatter_nodes(jnp.asarray(x)).astype(dtype)
    tx = tpg.scatter_nodes(torch.from_numpy(x)).to(getattr(torch, dtype))
    jw = jnp.where(jpg.mask, 1.0, 0.0)
    tw = tpg.mask.float()
    prev, jprev = metrics.set_enabled(True), jax_metrics.set_enabled(True)
    try:
        metrics.reset_metrics()
        jax_metrics.reset_metrics()
        out, res = tp.ring_gspmm(tpg, tx, tw, comm="int8",
                                 residual=torch.from_numpy(r),
                                 strategy=route)
        jout, jres = jax.jit(lambda a, b: jp.ring_gspmm(
            jpg, a, jw, comm="int8", residual=b))(jx, jnp.asarray(r))
        got, want = _counters(metrics.snapshot()), _counters(
            jax_metrics.snapshot())
    finally:
        metrics.set_enabled(prev)
        jax_metrics.set_enabled(jprev)
    assert got == want
    if dtype == "float32":
        assert got["comm.ring.raw_bytes"] / got["comm.ring.wire_bytes"] >= 3
    step = float(np.abs(np.asarray(jx, np.float32)).max() + 0.1) / 127
    deg = int(np.bincount(dst, minlength=n).max())
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(res, jres, tol)
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=step * deg * (1 if dtype == "float32"
                                                  else 4))
    if dtype == "float32":
        _close(out, want, 1e-5)


def test_int8_needs_residual_and_checks_comm():
    _, tg = _pair()
    pg = tp.build_partition(tg, 2)
    x, w = torch.randn(pg.n_pad, 3), pg.mask.float()
    with pytest.raises(ValueError, match="residual"):
        tp.ring_gspmm(pg, x, w, comm="int8")
    with pytest.raises(ValueError, match="comm must be"):
        tp.ring_gspmm(pg, x, w, comm="fp8")
    with pytest.raises(ValueError, match="residual"):
        tp.ring_gspmm_delayed(pg, x, w, x, True, comm="int8")
    with pytest.raises(ValueError, match="ring strategy"):
        tp.ring_gspmm(pg, x, w, strategy="segment")


@pytest.mark.parametrize("route", ROUTES)
def test_int8_delayed_stale_step_moves_no_bytes(route):
    _, tg = _pair(seed=15)
    pg = tp.build_partition(tg, 3)
    x, w = torch.randn(pg.n_pad, 4), pg.mask.float()
    r = torch.zeros(pg.n_pad, 4)
    prev = metrics.set_enabled(True)
    try:
        metrics.reset_metrics()
        out, remote, r2 = tp.ring_gspmm_delayed(pg, x, w, x, False,
                                                comm="int8", residual=r,
                                                strategy=route)
        snap = metrics.snapshot()
    finally:
        metrics.set_enabled(prev)
    assert "comm.ring.wire_bytes" not in snap
    assert r2 is r and torch.equal(remote, x)


# --------------------------------------------------------------------- #
# the planner's ring half
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("comm", [None, "none", "int8"])
def test_ring_cost_matches_jax(comm, dtype):
    jg, tg = _pair(200, 1500, seed=16)
    js, ts = jplanner.compute_stats(jg), planner.compute_stats(tg)
    for S in (2, 4):
        jst = jp.build_partition(jg, S, "hash").stats
        tst = tp.build_partition(tg, S, "hash").stats
        for d in (1, 16, 602):
            for rs in ((None, None), (jst, tst)):
                want = jplanner.estimate_cost(
                    "ring", js, d, backend="cpu", ring_stats=rs[0],
                    dtype=getattr(jnp, dtype), comm=comm)
                got = planner.estimate_cost(
                    "ring", ts, d, "cpu", getattr(torch, dtype),
                    ring_stats=rs[1], comm=comm)
                assert got == pytest.approx(want, rel=1e-12), (S, d)
    assert (planner.estimate_cost("ring", ts, 16, "cpu", comm="int8")
            < planner.estimate_cost("ring", ts, 16, "cpu", comm="none"))


def test_plan_cache_partition_is_memoized():
    _, tg = _pair(seed=3)
    cache = planner.get_plan_cache(tg)
    before = planner.pack_build_totals().get("partition", 0)
    a = cache.partition(3, "contiguous")
    assert cache.partition(3, "contiguous") is a
    assert cache.peek_partition(3, "contiguous") is a
    assert cache.peek_partition(4, "contiguous") is None
    assert cache.partition(3, "hash") is not a
    assert planner.pack_build_totals()["partition"] == before + 2


def test_ring_supports_matches_jax():
    rng = np.random.default_rng(17)
    u = rng.normal(size=(10, 4)).astype(np.float32)
    e1 = rng.normal(size=(20, 1)).astype(np.float32)
    e4 = rng.normal(size=(20, 4)).astype(np.float32)
    for op in ("u_copy_add_v", "u_copy_mean_v", "u_copy_max_v",
               "u_mul_e_add_v", "u_add_e_add_v", "e_copy_add_v",
               "v_copy_add_u", "u_mul_e_mean_v"):
        for e in (e1, e4):
            lhs = e if op.startswith("e") else u
            want = jplanner.supports("ring", jax_parse_op(op),
                                     jnp.asarray(lhs), jnp.asarray(e))
            assert planner.supports("ring", parse_op(op),
                                    torch.from_numpy(lhs),
                                    torch.from_numpy(e)) == want, op


def test_use_ring_without_a_group_never_qualifies():
    _, tg = _pair(seed=18)
    u = torch.randn(48, 4)
    with planner.use_ring(None) as ctx:
        assert ctx is None and planner.active_ring() is None
        assert planner.plan_gspmm(tg, parse_op("u_copy_add_v"), u, None,
                                  requested="auto").strategy != "ring"
    assert planner.active_ring() is None


def test_use_ring_with_a_process_group(tmp_path):
    """A one-process gloo group makes ``ring`` a candidate (a square
    graph, a supported spec) and sets the context's shard count; gspmm's
    ring route runs the mesh ring on it, equal to the segment route."""
    import torch.distributed as dist

    _, tg = _pair(seed=19)
    u = torch.randn(48, 4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        group = dist.new_group([0])
        with planner.use_ring(group, comm="int8") as ctx:
            assert ctx.n_shards == 1 and ctx.comm == "int8"
            plan = planner.plan_gspmm(tg, parse_op("u_copy_add_v"), u, None,
                                      requested="ring")
            assert plan.strategy == "ring" and plan.reason == "pinned"
            out = gspmm(tg, "u_copy_add_v", u=u, strategy="ring")
        torch.testing.assert_close(out, gspmm(tg, "u_copy_add_v", u=u,
                                              strategy="segment"))
        assert planner.active_ring() is None
    finally:
        dist.destroy_process_group()


def test_mesh_raises_everywhere():
    """A ``mesh`` that is not a process group raises ``TypeError`` in every
    entry point; without one the bundle's sharding is a no-op."""
    from repro_torch.models.gnn.common import (make_partitioned_bundle,
                                               shard_partitioned)

    _, tg = _pair(seed=20)
    pg = tp.build_partition(tg, 2)
    x, w = torch.randn(pg.n_pad, 3), pg.mask.float()
    mesh = object()
    for call in (lambda: tp.ring_gspmm(pg, x, w, mesh=mesh),
                 lambda: tp.ring_gspmm_delayed(pg, x, w, x, True, mesh=mesh),
                 lambda: tp.ring_edge_values(pg, x, x, mesh=mesh),
                 lambda: tp.bucket_softmax(pg, w[..., None], mesh=mesh),
                 lambda: tp.local_gspmm(pg, x, w, mesh=mesh),
                 lambda: make_partitioned_bundle(tg, 2, mesh=mesh)):
        with pytest.raises(TypeError, match="ProcessGroup"):
            call()
    pb = make_partitioned_bundle(tg, 2)
    assert shard_partitioned(pb) is pb
    assert shard_partitioned(pb, x)[1] is x
