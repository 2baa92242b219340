"""Port parity for the block VJP (``core/blocks.py``'s ``bwd_strategy``),
the block Gᵀ the trainer's sampler builds, the planner's block backward
rows and the segment route's scatter-free backward (``core/binary_reduce``
``_SegmentGspmm``).

Both packages sample the same blocks (one seed, bit-identical); every
value and gradient is held against ``jax.grad`` of the JAX function at
1e-5. The block batch holds a destination with no in-edge at all and
rows under the fan-out, so pad slots and the dummy row are on every path.
The port's ``"kernel"`` strategy runs here through the wrappers' plain
versions (CPU tensors), which checks the routing of its backward onto B1
/ B3 / B4 over the block's G and Gᵀ; the card holds the kernels
themselves (chip_smoke.py, phase ``train_sampled``). Bit-identity over
two calls is a property of the card, which the CPU cannot show.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_gspmm as jax_block_gspmm
from repro.core import from_coo as jax_from_coo
from repro.core import gspmm as jax_gspmm
from repro.core import planner as jax_planner
from repro.core.binary_reduce import parse_op as jax_parse_op
from repro.data import NeighborSampler as JaxSampler
from repro_torch.core import from_coo, gspmm, parse_op
from repro_torch.core import graph as port_graph
from repro_torch.core import planner
from repro_torch.core.blocks import block_gspmm
from repro_torch.core.graph import reverse
from repro_torch.data import NeighborSampler
from repro_torch.obs import events
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
N_U, N_V, NNZ, D = 20, 15, 60, 4
TEMPLATES = ("u_copy_{}_v", "u_mul_e_{}_v", "e_copy_{}_v", "u_add_v_{}_v")
REDUCERS = ("add", "mean", "max", "min")
# specs the kernel route (B1 / B4) computes: sum / mean, no v operand
KERNEL_SPECS = ("u_copy", "u_mul_e", "e_copy")

_cache = {}


def _block():
    """(JAX block, port block, rng): one batch of 6 at fan-out
    max-in-degree // 2 over a graph with unique edges and one extra
    destination with no in-edge, which is the batch's first seed."""
    if "blk" not in _cache:
        rng = np.random.default_rng(3)
        src, dst = random_edges(rng, N_U, N_V, NNZ, unique=True)
        jg = jax_from_coo(src, dst, n_src=N_U, n_dst=N_V + 1)
        tg = from_coo(src, dst, n_src=N_U, n_dst=N_V + 1, device="cpu")
        fanout = max(2, int(np.asarray(jg.in_degrees).max()) // 2)
        seeds = np.concatenate([[N_V], rng.permutation(N_V)[:5]])
        lab = np.zeros(6, np.int64)
        jbg = JaxSampler(jg, [fanout], 6, seed=0).sample(seeds, lab).blocks[0]
        tbg = NeighborSampler(tg, [fanout], 6, seed=0, device="cpu",
                              reverse=True).sample(seeds, lab).blocks[0]
        assert int(np.asarray(jbg.bg.real_deg)[0]) == 0
        _cache["blk"] = (jbg, tbg)
    return _cache["blk"]


def _operands(bg, rng):
    return {"u": rng.normal(size=(bg.g.n_src, D)).astype(np.float32),
            "v": rng.normal(size=(bg.g.n_dst, D)).astype(np.float32),
            "e": rng.uniform(0.5, 1.5, size=(bg.g.n_edges, 1))
            .astype(np.float32)}


def _jax_value_and_grads(bg, name, args, ct):
    def f(a):
        return jnp.sum(jax_block_gspmm(bg, name, **a, strategy="segment",
                                       bwd_strategy="scatter") * ct)

    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    val = jax_block_gspmm(bg, name, **jargs, strategy="segment",
                          bwd_strategy="scatter")
    return np.asarray(val), {k: np.asarray(v)
                             for k, v in jax.grad(f)(jargs).items()}


def _port_value_and_grads(bg, name, args, ct, strategy, bwd):
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in args.items()}
    out = block_gspmm(bg, name, **targs, strategy=strategy,
                      bwd_strategy=bwd)
    grads = torch.autograd.grad(out, list(targs.values()),
                                torch.from_numpy(ct))
    return out.detach().numpy(), {k: g.numpy()
                                  for k, g in zip(targs, grads)}


@pytest.mark.parametrize("bwd", ["gather", "scatter"])
@pytest.mark.parametrize("red", REDUCERS)
@pytest.mark.parametrize("template", TEMPLATES)
def test_block_vjp_matches_jax_grad(template, red, bwd):
    """Every block strategy × reducer × backward: values and grads of
    every operand against ``jax.grad`` of the JAX ``block_gspmm``."""
    jblk, tblk = _block()
    name = template.format(red)
    spec = parse_op(name)
    rng = np.random.default_rng(10 * TEMPLATES.index(template)
                                + REDUCERS.index(red))
    ops = _operands(jblk.bg, rng)
    args = {k: ops[k] for k in [spec.lhs] + ([spec.rhs] if spec.rhs else [])}
    out_w = 1 if spec.lhs == "e" and spec.rhs is None else D
    ct = rng.normal(size=(jblk.bg.n_dst_real, out_w)).astype(np.float32)
    ref, ref_g = _jax_value_and_grads(jblk.bg, name, args, ct)
    strategies = ["ell", "segment"]
    if template.rsplit("_", 2)[0] in KERNEL_SPECS and red in ("add",
                                                              "mean"):
        strategies.append("kernel")
    for s in strategies:
        out, got = _port_value_and_grads(tblk.bg, name, args, ct, s, bwd)
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {s}+{bwd}")
        for k in ref_g:
            np.testing.assert_allclose(got[k], ref_g[k], rtol=TOL, atol=TOL,
                                       err_msg=f"d{k}: {name} {s}+{bwd}")


def test_block_rank3_vjp_matches_jax_grad():
    """GAT's per-head aggregation (u (n, H, F), e (E, H, 1)) on the uniform
    pull, both backwards, against ``jax.grad``."""
    jblk, tblk = _block()
    rng = np.random.default_rng(8)
    args = {"u": rng.normal(size=(jblk.bg.g.n_src, 3, 5)).astype(np.float32),
            "e": rng.uniform(0.1, 1, size=(jblk.bg.g.n_edges, 3, 1))
            .astype(np.float32)}
    ct = rng.normal(size=(jblk.bg.n_dst_real, 3, 5)).astype(np.float32)
    ref, ref_g = _jax_value_and_grads(jblk.bg, "u_mul_e_add_v", args, ct)
    for bwd in ("gather", "scatter"):
        out, got = _port_value_and_grads(tblk.bg, "u_mul_e_add_v", args, ct,
                                         "ell", bwd)
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
        for k in ref_g:
            np.testing.assert_allclose(got[k], ref_g[k], rtol=TOL, atol=TOL,
                                       err_msg=f"d{k} {bwd}")


@pytest.mark.parametrize("strategy", ["ell", "segment", "kernel"])
def test_block_pad_poison_invariance(strategy):
    """Poisoning every pad source slot's features and every pad edge's
    weight changes no gradient of the gather backward (pad edges pull the
    dummy row's zero cotangent); pad edges' ∂e is exactly 0 (port of
    tests/data/test_sampler.py:251)."""
    rng = np.random.default_rng(3)
    src, dst = random_edges(rng, 40, 40, 160)
    g = from_coo(src, dst, n_src=40, n_dst=40, device="cpu")
    sampler = NeighborSampler(g, [3], 8, seed=1, device="cpu", reverse=True)
    blk = sampler.sample(rng.permutation(40)[:8],
                         np.zeros(8, np.int64)).blocks[0]
    bg = blk.bg
    n_real = int(bg.real_deg.sum())
    assert n_real < bg.g.n_edges and (blk.src_ids_host < 0).any()
    u = rng.normal(size=(bg.g.n_src, 6)).astype(np.float32)
    e = rng.normal(size=(bg.g.n_edges, 1)).astype(np.float32)
    ct = torch.from_numpy(rng.normal(size=(bg.n_dst_real, 6))
                          .astype(np.float32))

    def grads(u, e):
        u, e = (torch.from_numpy(a).requires_grad_() for a in (u, e))
        out = block_gspmm(bg, "u_mul_e_add_v", u=u, e=e, strategy=strategy,
                          bwd_strategy="gather")
        return [t.numpy() for t in torch.autograd.grad(out, (u, e), ct)]

    pu = u.copy()
    pu[blk.src_ids_host < 0] = 1e9
    pe = e.copy()
    pe[n_real:] = -1e9
    du, de = grads(u, e)
    du_p, de_p = grads(pu, pe)
    np.testing.assert_array_equal(du, du_p)
    np.testing.assert_array_equal(de[:n_real], de_p[:n_real])
    np.testing.assert_array_equal(de_p[n_real:], 0.0)


@pytest.mark.parametrize("fanouts", [[3], [2, 40], [5, 5]])
def test_block_reverse_bit_equal_to_reverse(fanouts):
    """The Gᵀ the trainer's sampler builds from its draw is bit-equal to
    ``core.graph.reverse`` of the same block graph, and its canonical
    order is JAX's reverse table."""
    rng = np.random.default_rng(11)
    src, dst = random_edges(rng, 60, 60, 500)
    tg = from_coo(src, dst, n_src=60, n_dst=60, device="cpu")
    jg = jax_from_coo(src, dst, n_src=60, n_dst=60)
    seeds, lab = np.arange(0, 40, 6), np.zeros(7, np.int64)
    tmb = NeighborSampler(tg, fanouts, 8, seed=2, device="cpu",
                          reverse=True).sample(seeds, lab)
    jmb = JaxSampler(jg, fanouts, 8, seed=2).sample(seeds, lab)
    for tb, jb in zip(tmb.blocks, jmb.blocks):
        g = tb.bg.g
        assert tb.bg.has_reverse
        fresh = from_coo(g.host.src[g.host.eid_inv],
                         g.host.dst[g.host.eid_inv], n_src=g.n_src,
                         n_dst=g.n_dst, device="cpu")
        want, got = reverse(fresh), reverse(g)
        assert got is not want
        assert (got.n_src, got.n_dst, got.n_edges) == (
            want.n_src, want.n_dst, want.n_edges)
        for f in port_graph._INDEX_FIELDS:
            np.testing.assert_array_equal(getattr(got.host, f),
                                          getattr(want.host, f), err_msg=f)
            assert getattr(got.host, f).dtype == getattr(want.host, f).dtype
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in ("rev_src", "rev_dst", "rev_eid"):
            np.testing.assert_array_equal(getattr(tb.bg, f).numpy(),
                                          np.asarray(getattr(jb.bg, f)))


# --------------------------------------------------------------------- #
# the planner's block backward rows
# --------------------------------------------------------------------- #
PLAN_SIGS = [(56, 7, 42, 6), (4_000, 500, 3_000, 6), (200_000, 20_000,
                                                      200_000, 10)]


@pytest.mark.parametrize("sig", PLAN_SIGS)
@pytest.mark.parametrize("name", ["u_copy_mean_v", "u_mul_e_add_v",
                                  "e_copy_max_v", "u_copy_mul_v"])
def test_plan_block_vjp_matches_jax_on_cpu(sig, name):
    """'auto' on the CPU chooses what the JAX cost model chooses. On CUDA
    the fitted row prices the scatter (push, 0.706) below segment, so a
    plain forward's backward is the scatter; after a kernel forward auto
    takes the gather wherever the spec allows it."""
    for d in (1, 16, 602):
        want = jax_planner.plan_block_vjp(sig, jax_parse_op(name), d)
        got = planner.plan_block_vjp(sig, parse_op(name), d)
        assert got == want, (sig, name, d)
        cuda = planner.plan_block_vjp(sig, parse_op(name), d,
                                      device="cuda")
        assert cuda == "scatter"
        cuda = planner.plan_block_vjp(sig, parse_op(name), d,
                                      device="cuda", kernel_forward=True)
        assert cuda == ("scatter" if name == "u_copy_mul_v" else "gather")


def test_plan_block_vjp_pinned():
    spec = parse_op("u_copy_mul_v")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert planner.plan_block_vjp((9, 3, 6, 2), spec, 4,
                                      requested="gather") == "scatter"
    assert any("falling back" in str(x.message) for x in w)
    assert planner.plan_block_vjp((9, 3, 6, 2), parse_op("u_copy_add_v"),
                                  4, requested="scatter") == "scatter"
    assert planner.plan_block_vjp((9, 3, 6, 2), parse_op("u_copy_add_v"),
                                  4, requested="gather",
                                  gather_available=False) == "scatter"
    with pytest.raises(ValueError):
        planner.plan_block_vjp((9, 3, 6, 2), spec, 4, requested="push")
    _, tblk = _block()
    with pytest.raises(ValueError):
        block_gspmm(tblk.bg, "u_copy_add_v", u=torch.zeros(
            tblk.bg.g.n_src, 2), bwd_strategy="push")


def test_block_calls_are_timed():
    """An eager block call records one ``block:<op>`` event, its backward
    one ``block_bwd:<op>`` event, under both backwards."""
    _, tblk = _block()
    for bwd in ("gather", "scatter"):
        events.clear_events()
        u = torch.randn(tblk.bg.g.n_src, 3, requires_grad=True)
        out = block_gspmm(tblk.bg, "u_copy_add_v", u=u, strategy="ell",
                          bwd_strategy=bwd)
        out.sum().backward()
        got = events.measured_events()
        assert got["block:u_copy_add_v"]["calls"] == 1
        assert got["block_bwd:u_copy_add_v"]["calls"] == 1
        with torch.no_grad():
            block_gspmm(tblk.bg, "u_copy_add_v", u=u, strategy="ell")
        assert events.measured_events()["block:u_copy_add_v"]["calls"] == 2
    events.clear_events()


# --------------------------------------------------------------------- #
# C4: the segment route's scatter-free backward
# --------------------------------------------------------------------- #
# (op, lhs shape, rhs shape or None): sums and means onto v and u, with
# u / v / e operands, scalar and vector e, and GAT's rank-3 aggregation
SEGMENT_OPS = [("u_copy_add_v", (6,), None), ("u_copy_mean_v", (6,), None),
               ("u_mul_e_add_v", (6,), (1,)), ("u_mul_e_mean_v", (6,), (6,)),
               ("u_mul_e_add_v", (4, 5), (4, 1)),
               ("u_add_v_add_v", (3,), (3,)), ("u_div_e_mean_v", (3,), (1,)),
               ("e_sub_u_add_v", (3,), (3,)), ("e_copy_add_v", (4,), None),
               ("u_dot_v_add_v", (3,), (3,)), ("v_copy_add_u", (5,), None),
               ("u_mul_e_mean_u", (5,), (1,))]


@pytest.mark.parametrize("op,ls,rs", SEGMENT_OPS)
def test_segment_route_grads_match_jax(op, ls, rs):
    """``gspmm(strategy="segment")`` differentiates through
    ``_SegmentGspmm`` (sorted reduces, no ``index_add_``), and its grads
    equal ``jax.grad`` of the JAX segment route at 1e-5, on a graph with
    empty rows on both sides."""
    rng = np.random.default_rng(5)
    n, m, nnz = 30, 24, 140
    src, dst = rng.integers(0, n - 4, nnz), rng.integers(0, m - 3, nnz)
    jg = jax_from_coo(src, dst, n_src=n, n_dst=m)
    tg = from_coo(src, dst, n_src=n, n_dst=m, device="cpu")
    spec = parse_op(op)
    rows = {"u": n, "v": m, "e": nnz}
    args = {spec.lhs: rng.normal(size=(rows[spec.lhs],) + ls)}
    if rs is not None:
        args[spec.rhs] = rng.uniform(0.5, 1.5, size=(rows[spec.rhs],) + rs)
    args = {k: v.astype(np.float32) for k, v in args.items()}
    out_rows = m if spec.out == "v" else n
    ct = rng.normal(size=(out_rows,) + (ls if spec.op != "dot" else (1,))
                    ).astype(np.float32)

    def f(a):
        return jnp.sum(jax_gspmm(jg, op, **a, strategy="segment") * ct)

    ref = jax.grad(f)({k: jnp.asarray(v) for k, v in args.items()})
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in args.items()}
    out = gspmm(tg, op, **targs, strategy="segment")
    assert type(out.grad_fn).__name__ == "_SegmentGspmmBackward"
    got = torch.autograd.grad(out, list(targs.values()),
                              torch.from_numpy(ct))
    for k, g in zip(targs, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"d{k} of {op}")


# --------------------------------------------------------------------- #
# C6 on blocks: a dot whose operand widths broadcast
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("red", ["add", "mean"])
@pytest.mark.parametrize("pair", [("u", "v"), ("v", "u"), ("u", "e"),
                                  ("e", "v")], ids="".join)
@pytest.mark.parametrize("widths", [((4,), (1,)), ((1,), (4,)),
                                    ((2, 3), (2, 1))],
                         ids=["4-1", "1-4", "23-21"])
def test_block_segment_broadcast_dot_grads_match_jax(widths, pair, red):
    """ROADMAP C6 on a sampled block: ``block_gspmm(strategy="segment",
    bwd_strategy="scatter")`` on ``<l>_dot_<r>`` with widths that
    broadcast matches ``jax.grad`` of the JAX block route at 1e-5, each
    grad at its operand's shape."""
    jblk, tblk = _block()
    bg = jblk.bg
    name = f"{pair[0]}_dot_{pair[1]}_{red}_v"
    rows = {"u": bg.g.n_src, "v": bg.g.n_dst, "e": bg.g.n_edges}
    rng = np.random.default_rng(21)
    args = {t: rng.normal(size=(rows[t],) + w).astype(np.float32)
            for t, w in zip(pair, widths)}
    ct = rng.normal(size=(bg.n_dst_real,) + widths[0][:-1] + (1,)
                    ).astype(np.float32)
    ref, ref_g = _jax_value_and_grads(bg, name, args, ct)
    out, got = _port_value_and_grads(tblk.bg, name, args, ct, "segment",
                                     "scatter")
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    for k in ref_g:
        assert got[k].shape == args[k].shape
        np.testing.assert_allclose(got[k], ref_g[k], rtol=TOL, atol=TOL,
                                   err_msg=f"d{k}: {name}")
