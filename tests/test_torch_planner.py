"""Port parity for the planner (``repro_torch/core/planner.py``) against
the JAX package's (``repro/core/planner.py``), on the CPU, where both read
JAX's ``cpu`` rows.

Decisions are compared under the names' mapping ``pallas ↔ kernel``;
predicted costs to relative 1e-12 (the same formula on the same row):

* ``compute_stats`` on R-MAT / uniform / empty / zero-in-degree graphs;
* ``estimate_cost`` for every strategy but ``ring`` (A12), fp32 and bf16;
* ``supports("kernel")`` is ``kernels/dispatch.kernel_supports`` on every
  spec, and JAX's ``supports("pallas")`` on fp32 operands;
* ``plan_gspmm`` on ``tests/core/test_planner.py``'s grids, auto and the
  pinned fallbacks, with the one-time warning;
* every row of ``tests/core/test_planner_golden.py``'s block, sddmm and
  attention grids;
* ``plan_hetero`` on relational signatures, auto and every pinned name;
* autotune measuring once and caching;
* the ``cuda`` row asked on the host (``device="cuda"``): the kernel at
  every main-path shape of ``chip_smoke.py``, segment for max / min;
* the slice: GCN / SAGE / GAT forward, a full-graph loss and its grads
  and a sampled batch's, and an R-GCN forward, under ``auto`` on both
  sides, outputs at 1e-5 (2e-4 sampled) and the plan logs equal.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import from_coo as jax_from_coo
from repro.core import gspmm as jax_gspmm
from repro.core import parse_op as jax_parse_op
from repro.core import planner as jp
from repro.core.hetero import from_rels as jax_from_rels
from repro.data import NeighborSampler as JaxSampler
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import rgcn as jax_rgcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import block_features as jax_block_features
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.common import pad_features as jax_pad_features
from repro.data.synthetic import relational_graph as jax_relational_graph
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.core import (block_gspmm, from_coo, gspmm, parse_op,
                              planner as tp)
from repro_torch.core.blocks import serve_block_signature
from repro_torch.core.graph import add_self_loops
from repro_torch.core.hetero import from_rels
from repro_torch.data import NeighborSampler
from repro_torch.data.synthetic import make_node_dataset, rmat_graph
from repro_torch.kernels.dispatch import kernel_supports
from repro_torch.models.gnn import gat, gcn, rgcn, sage
from repro_torch.models.gnn.common import (block_features, from_jax_params,
                                           make_bundle, pad_features,
                                           to_jax_params)
from repro_torch.substrate.nn import cross_entropy_loss
from tests.core.test_planner import REDUCERS, TABLE2
from tests.core.test_planner_golden import (ATTN_GOLDEN, ATTN_POWERLAW,
                                            ATTN_SHAPES, GOLDEN, OPS, SHAPES,
                                            SDDMM_GOLDEN, SDDMM_OPS,
                                            SDDMM_SHAPES, WIDTHS)
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

REL = 1e-12
TOL = 1e-5
SAMPLED_TOL = 2e-4
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}


def to_port(name):
    """A JAX strategy name as the port names it."""
    return "kernel" if name == "pallas" else name


def to_jax(name):
    return "pallas" if name == "kernel" else name


@pytest.fixture(autouse=True)
def _fresh_plans():
    """Empty plan memos and logs on both sides, cost mode."""
    for mod in (jp, tp):
        mod.set_mode("cost")
        mod.clear_plan_log()
        mod.clear_block_plans()
        mod.clear_sddmm_plans()
        mod.clear_hetero_plans()
        mod.clear_serve_plans()
    yield
    for mod in (jp, tp):
        mod.set_mode("cost")


def _pair(src, dst, n_src, n_dst):
    return (jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst),
            from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu"))


def _graph_case(kind):
    rng = np.random.default_rng(1)
    if kind == "rmat":
        src, dst, n = rmat_graph(9, 3000, seed=0)
        return _pair(src, dst, n, n)
    if kind == "uniform":
        return _pair(rng.integers(0, 200, 1500), rng.integers(0, 150, 1500),
                     200, 150)
    if kind == "empty":
        e = np.zeros(0, np.int64)
        return _pair(e, e, 10, 12)
    # zero in-degree rows: destinations only in the lower half
    return _pair(rng.integers(0, 80, 600), rng.integers(0, 40, 600), 80, 80)


# --------------------------------------------------------------------- #
# statistics and the cost model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["rmat", "uniform", "empty",
                                  "zero_in_degree"])
def test_compute_stats_matches_jax(kind):
    jg, tg = _graph_case(kind)
    want = dataclasses.asdict(jp.compute_stats(jg))
    assert dataclasses.asdict(tp.compute_stats(tg)) == want
    assert dataclasses.asdict(tp.get_plan_cache(tg).stats) == want
    for cap in (8, 64):
        assert (dataclasses.asdict(tp.compute_stats(tg, cap))
                == dataclasses.asdict(jp.compute_stats(jg, cap)))
    deg = np.asarray(tg.host.in_degrees)
    assert (tp.ell_rowcomplete_padding(deg)
            == jp.ell_rowcomplete_padding(deg))


def test_set_ell_cap_recomputes_stats():
    jg, tg = _graph_case("rmat")
    cache = tp.get_plan_cache(tg)
    cache.set_ell_cap(16)
    assert (dataclasses.asdict(cache.stats)
            == dataclasses.asdict(jp.compute_stats(jg, 16)))
    cache.set_ell_cap(64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["push", "segment", "ell", "onehot",
                                      "kernel"])
def test_estimate_cost_matches_jax(strategy, dtype):
    for kind in ("rmat", "uniform", "empty"):
        jg, tg = _graph_case(kind)
        js, ts = jp.compute_stats(jg), tp.compute_stats(tg)
        for d in (1, 7, 64, 602):
            want = jp.estimate_cost(to_jax(strategy), js, d, backend="cpu",
                                    dtype=getattr(jnp, dtype))
            got = tp.estimate_cost(strategy, ts, d, "cpu",
                                   getattr(torch, dtype))
            assert got == pytest.approx(want, rel=REL), (kind, d)
    with pytest.raises(NotImplementedError, match="A12"):
        tp.estimate_cost("ring", ts, 4)


def test_block_stats_match_jax():
    for sig in ((968, 88, 880, 10), (64, 16, 80, 5), (1, 0, 0, 3)):
        assert (dataclasses.asdict(tp.block_stats(*sig))
                == dataclasses.asdict(jp.block_stats(*sig)))


# --------------------------------------------------------------------- #
# support predicates
# --------------------------------------------------------------------- #
def _all_specs():
    names = []
    for red in ("add", "max", "min", "mul", "mean"):
        for out in ("u", "v"):
            for lhs in ("u", "v", "e"):
                names.append(f"{lhs}_copy_{red}_{out}")
                for op in ("add", "sub", "mul", "div", "dot"):
                    for rhs in ("u", "v", "e"):
                        if rhs != lhs:
                            names.append(f"{lhs}_{op}_{rhs}_{red}_{out}")
    return names


def test_kernel_supports_is_dispatch_and_jax_pallas():
    """``supports("kernel")`` equals ``kernel_supports`` on every spec of
    the lattice and operand form, and JAX's ``supports("pallas")`` on the
    fp32 rank-2 operands whose widths the kernels take (JAX's predicate
    checks neither dtype nor width)."""
    forms = {"w4": ((5, 4), (7, 4)), "w1": ((5, 4), (7, 1)),
             "w3": ((5, 4), (7, 3)), "rank3": ((5, 2, 4), (7, 2, 4))}
    for name in _all_specs():
        spec, jspec = parse_op(name), jax_parse_op(name)
        for form, (ls, rs) in forms.items():
            for dt in (torch.float32, torch.float64):
                lhs = torch.zeros(ls, dtype=dt)
                rhs = None if spec.rhs is None else torch.zeros(rs, dtype=dt)
                got = tp.supports("kernel", spec, lhs, rhs)
                assert got == kernel_supports(spec, lhs, rhs), (name, form)
                # JAX's predicate checks neither dtype nor widths: compare
                # where the kernels' width rule holds
                if dt != torch.float32 or not (
                        form == "w4" or (form == "w1" and spec.rhs == "e")):
                    continue
                jl = jnp.zeros(ls)
                jr = None if spec.rhs is None else jnp.zeros(rs)
                assert got == jp.supports("pallas", jspec, jl, jr), name
                for s in ("push", "segment", "ell", "onehot"):
                    assert (tp.supports(s, spec, lhs, rhs)
                            == jp.supports(s, jspec, jl, jr)), (name, s)


# --------------------------------------------------------------------- #
# gspmm plans
# --------------------------------------------------------------------- #
def _operands(rng, n_u, n_v, nnz, d, lead=()):
    def draw(shape):
        return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    return draw((n_u,) + lead + (d,)), draw((n_v,) + lead + (d,)), \
        draw((nnz,) + lead + (d,))


def _plan_both(jg, tg, name, data, requested="auto"):
    """(port plan, JAX plan, port predicted, JAX predicted)."""
    spec, jspec = parse_op(name), jax_parse_op(name)
    lhs = data[spec.lhs]
    rhs = None if spec.rhs is None else data[spec.rhs]
    if rhs is not None and rhs.ndim == 1:
        rhs = rhs[:, None]
    tl = torch.from_numpy(lhs)
    tr = None if rhs is None else torch.from_numpy(rhs)
    jl = jnp.asarray(lhs)
    jr = None if rhs is None else jnp.asarray(rhs)
    got = tp.plan_gspmm(tg, spec, tl, tr, requested=to_port(requested))
    want = jp.plan_gspmm(jg, jspec, jl, jr, requested=requested)
    d = int(np.prod(lhs.shape[1:]))
    cost = (tp.estimate_cost(got.strategy, tp.get_plan_cache(tg).stats, d),
            jp.estimate_cost(want.strategy, jp.get_plan_cache(jg).stats, d,
                             backend="cpu"))
    return got.strategy, want.strategy, cost


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_gspmm_matches_jax_table2(seed):
    rng = np.random.default_rng(seed)
    n_u, n_v, nnz = [(30, 20, 120), (80, 80, 1200), (200, 150, 3000)][seed]
    jg, tg = _pair(rng.integers(0, n_u, nnz), rng.integers(0, n_v, nnz),
                   n_u, n_v)
    for lead in ((), (2,)):
        U, V, E = _operands(rng, n_u, n_v, nnz, 7, lead)
        data = {"u": U, "v": V, "e": E}
        names = [n for n in TABLE2 if not n.endswith("_e")]
        names += [f"{x}_{red}_v" for red in REDUCERS
                  for x in ("u_copy", "u_mul_e", "e_copy")]
        for name in names:
            got, want, (c_got, c_want) = _plan_both(jg, tg, name, data)
            assert got == to_port(want), (name, lead)
            assert c_got == pytest.approx(c_want, rel=REL)


def test_plan_gspmm_matches_jax_wide():
    """The JAX test's graph where the cost model picks ell (d = 64)."""
    rng = np.random.default_rng(5)
    jg, tg = _pair(rng.integers(0, 1000, 6000), rng.integers(0, 1000, 6000),
                   1000, 1000)
    x = rng.normal(size=(1000, 64)).astype(np.float32)
    got, want, _ = _plan_both(jg, tg, "u_copy_add_v", {"u": x})
    assert got == want == "ell"


FALLBACKS = [("u_copy_max_v", "pallas"), ("u_dot_v_add_v", "pallas"),
             ("e_copy_add_v", "onehot"), ("u_copy_min_v", "onehot"),
             ("v_copy_add_u", "ell"), ("u_copy_add_v", "ring"),
             ("u_copy_prod_v", "pallas"), ("u_copy_add_v", "pallas"),
             ("u_mul_e_add_v", "onehot")]


@pytest.mark.parametrize("name,requested", FALLBACKS)
def test_pinned_fallbacks_match_jax(name, requested, fresh_fallback_warnings):
    rng = np.random.default_rng(3)
    jg, tg = _pair(rng.integers(0, 40, 200), rng.integers(0, 30, 200), 40, 30)
    U, V, E = _operands(rng, 40, 30, 200, 6)
    E = E[:, :1]
    data = {"u": U, "v": V, "e": E}
    spec = parse_op(name)
    kw = {t: data[t] for t in (spec.lhs, spec.rhs) if t is not None}
    falls = requested == "ring" or not jp.supports(
        requested, jax_parse_op(name), jnp.asarray(data[spec.lhs]),
        None if spec.rhs is None else jnp.asarray(data[spec.rhs]))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = gspmm(tg, name, strategy=requested,
                    **{k: torch.from_numpy(x) for k, x in kw.items()})
        gspmm(tg, name, strategy=requested,
              **{k: torch.from_numpy(x) for k, x in kw.items()})
    ours = [x for x in w if "falling back" in str(x.message)]
    assert len(ours) == (1 if falls else 0)
    ref = jax_gspmm(jg, name, strategy=requested,
                    **{k: jnp.asarray(x) for k, x in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert (tp.last_plan(name, to_port(requested))
            == to_port(jp.last_plan(name, requested)))


def test_unknown_strategy_raises():
    jg, tg = _graph_case("uniform")
    with pytest.raises(ValueError, match="unknown strategy"):
        gspmm(tg, "u_copy_add_v", u=torch.zeros(200, 2), strategy="nope")
    with pytest.raises(ValueError, match="unknown planner mode"):
        tp.set_mode("fast")


# --------------------------------------------------------------------- #
# the golden grids of tests/core/test_planner_golden.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kernel_ok", [False, True])
def test_block_plans_match_jax_golden(kernel_ok):
    """Every block grid point plans JAX's forward + backward (the kernel
    qualifying or not: on the CPU's row it never wins), at JAX's
    predicted costs."""
    for batch, fanout in SHAPES:
        sig = (batch * (fanout + 1), batch, batch * fanout, fanout)
        for op in OPS:
            spec, jspec = parse_op(op), jax_parse_op(op)
            for d in WIDTHS:
                fwd = tp.plan_block_gspmm(sig, spec, d, kernel_ok=kernel_ok)
                bwd = tp.plan_block_vjp(sig, spec, d)
                key = f"b{batch}_f{fanout}_{op}_d{d}"
                assert f"{fwd}+{bwd}" == GOLDEN[key], key
                st, jst = tp.block_stats(*sig), jp.block_stats(*sig)
                assert tp.estimate_cost(fwd, st, d) == pytest.approx(
                    jp.estimate_cost(fwd, jst, d, backend="cpu"), rel=REL)
                assert tp._block_bwd_cost(bwd, sig, d) == pytest.approx(
                    jp._block_bwd_cost(bwd, sig, d, "cpu"), rel=REL)
                assert jp.plan_block_gspmm(sig, jspec, d) == fwd


def test_sddmm_and_attention_plans_match_jax_golden():
    for sig in SDDMM_SHAPES:
        for op in SDDMM_OPS:
            spec = parse_op(op)
            for d in (1, 16):
                lhs = torch.zeros(1, d)
                rhs = None if spec.rhs is None else torch.zeros(1, d)
                key = f"E{sig[2]}_{op}_d{d}"
                got = tp.plan_sddmm(sig, spec, d, lhs_data=lhs, rhs_data=rhs)
                assert got == to_port(SDDMM_GOLDEN[key]), key
                got = tp.plan_sddmm(sig, spec, d,
                                    lhs_data=torch.zeros(1, 2, d),
                                    rhs_data=rhs)
                assert got == to_port(SDDMM_GOLDEN[key + "_nopallas"]), key
                for s in ("canonical", "gather", "kernel"):
                    assert tp._sddmm_cost(s, sig[2], d) == pytest.approx(
                        jp._sddmm_cost(to_jax(s), sig[2], d, "cpu"), rel=REL)
    for n_src, n_dst, n_edges, h, f in ATTN_SHAPES:
        sig = (n_src, n_dst, n_edges)
        assert (tp.plan_attention(sig, h, f, kernel_ok=False)
                == ATTN_GOLDEN[f"E{n_edges}_h{h}_f{f}"])
        got = tp.plan_attention(sig, h, f, kernel_ok=True,
                                padded_slots=n_edges * 4)
        assert got == to_port(ATTN_GOLDEN[f"E{n_edges}_h{h}_f{f}_pack"])
    for key, sig, h, f, slots in ATTN_POWERLAW:
        got = tp.plan_attention(sig, h, f, kernel_ok=True,
                                padded_slots=slots)
        assert got == to_port(ATTN_GOLDEN[key]), key
        for s in ("fused", "kernel"):
            assert tp._attn_cost(s, sig[2], h * f, "cpu", slots) == \
                pytest.approx(jp._attn_cost(to_jax(s), sig[2], h * f, "cpu",
                                            slots), rel=REL)


# --------------------------------------------------------------------- #
# relational plans
# --------------------------------------------------------------------- #
def _relgraphs(skewed):
    rng = np.random.default_rng(2)
    n = 300
    sizes = (2000, 40, 60, 30, 50) if skewed else (400,) * 8
    rels = [(rng.integers(0, n, s), rng.integers(0, n, s)) for s in sizes]
    return (jax_from_rels(rels, n_src=n, n_dst=n),
            from_rels(rels, n_src=n, n_dst=n, device="cpu"))


HETERO_NAMES = ("auto", "fused", "loop", "ell", "segment", "onehot",
                "pallas", "ring", "push")


@pytest.mark.parametrize("skewed", [False, True])
def test_plan_hetero_matches_jax(skewed, fresh_fallback_warnings):
    jrg, trg = _relgraphs(skewed)
    jstats = jrg.cache.stats
    tstats = tp.get_plan_cache(trg.g).stats
    assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
    assert tuple(trg.signature) == tuple(jrg.signature)
    for op in ("u_w_mean_v", "u_w_sum_v", "u_e_sum_v", "u_max_v"):
        for d in (4, 16, 32):
            for req in HETERO_NAMES:
                want = jp.plan_hetero(jrg.signature, op, d, requested=req,
                                      stats=jstats)
                for kernel_ok in (False, True):
                    # hetero reads 'pallas' as JAX does: a loop pin (C7)
                    got = tp.plan_hetero(trg.signature, op, d,
                                         requested=req,
                                         stats=tstats, kernel_ok=kernel_ok)
                    assert got == want, (op, d, req, kernel_ok)
                assert tp._hetero_cost(got, trg.signature, d, "cpu",
                                       tstats) == pytest.approx(
                    jp._hetero_cost(want, jrg.signature, d, "cpu", jstats),
                    rel=REL)
    with pytest.warns(UserWarning, match="falling back to 'fused'"):
        assert tp.plan_hetero(trg.signature, "u_max_v", 4,
                              requested="kernel", stats=tstats) == "fused"


# --------------------------------------------------------------------- #
# autotune
# --------------------------------------------------------------------- #
def test_autotune_measures_once_and_caches(monkeypatch):
    rng = np.random.default_rng(9)
    jg, tg = _pair(rng.integers(0, 300, 2500), rng.integers(0, 300, 2500),
                   300, 300)
    x = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    calls = []
    real = tp._measure
    monkeypatch.setattr(tp, "_measure",
                        lambda runner, s: calls.append(s) or real(runner, s))
    ref = gspmm(tg, "u_copy_add_v", u=x, strategy="segment")
    tp.set_mode("autotune")
    out1 = gspmm(tg, "u_copy_add_v", u=x)
    first = list(calls)
    out2 = gspmm(tg, "u_copy_add_v", u=x)
    assert sorted(first) == sorted(["kernel", "onehot", "ell", "segment"])
    assert calls == first                           # cached: no re-measure
    winner = tp.last_plan("u_copy_add_v")
    assert list(tp.get_plan_cache(tg)._autotuned.values()) == [winner]
    for out in (out1, out2):
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_block_autotune_measures_once_per_signature(monkeypatch):
    (jg, *_), (tg, *_) = _data("tiny")
    mb = NeighborSampler(tg, [4], 8, seed=0, device="cpu").sample(
        np.arange(8), np.zeros(8, np.int64))
    bg = mb.blocks[0].bg
    u = torch.randn(bg.g.n_src, 6, generator=torch.Generator().manual_seed(0))
    ref = block_gspmm(bg, "u_copy_mean_v", u=u, strategy="segment")
    calls = []
    real = tp._measure
    monkeypatch.setattr(tp, "_measure",
                        lambda runner, s: calls.append(s) or real(runner, s))
    tp.set_mode("autotune")
    for _ in range(2):
        out = block_gspmm(bg, "u_copy_mean_v", u=u)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert sorted(calls) == ["ell", "kernel", "segment"]
    assert tp.last_plan("block:u_copy_mean_v") in ("ell", "segment",
                                                    "kernel")


# --------------------------------------------------------------------- #
# the cuda row, asked on the host
# --------------------------------------------------------------------- #
_memo = {}


def _reddit_like():
    """``reddit-like``'s graph (R-MAT 2^16, 600k edges, self-loops, seed
    0) on the CPU; the planner reads only its host degrees."""
    if "reddit" not in _memo:
        src, dst, n = rmat_graph(16, 600_000, seed=0)
        src, dst = add_self_loops(src, dst, n)
        _memo["reddit"] = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    return _memo["reddit"]


# (op, width of the node / edge operand, width of the edge operand): the
# main path's node-output shapes on reddit-like (chip_smoke.B1_MAIN,
# TRAIN_B1, B4_SHAPES)
CUDA_GSPMM = [("u_mul_e_add_v", 16, 1), ("u_mul_e_add_v", 32, 1),
              ("u_mul_e_add_v", 41, 1), ("u_copy_add_v", 32, None),
              ("u_copy_add_v", 41, None), ("u_copy_mean_v", 602, None),
              ("u_copy_mean_v", 32, None), ("e_copy_add_v", 4, None),
              ("e_copy_add_v", 1, None), ("e_copy_mean_v", 4, None),
              ("u_mul_e_add_v", 32, 32), ("u_div_e_mean_v", 41, 1)]
CUDA_EXTREMA = [("u_copy_max_v", 16), ("e_copy_max_v", 4),
                ("e_copy_max_v", 1), ("u_copy_min_v", 16)]


def test_cuda_row_keeps_the_kernels_on_the_main_path():
    g = _reddit_like()
    stats = tp.get_plan_cache(g).stats
    for op, d, de in CUDA_GSPMM:
        spec = parse_op(op)
        lhs = torch.zeros(1, d if spec.lhs != "e" else d)
        rhs = None if de is None else torch.zeros(1, de)
        got = tp.plan_gspmm(g, spec, lhs, rhs, device="cuda").strategy
        assert got == "kernel", (op, d, de)
    for op, d in CUDA_EXTREMA:
        got = tp.plan_gspmm(g, parse_op(op), torch.zeros(1, d), None,
                            device="cuda").strategy
        assert got == "segment", (op, d)
    # GAT's rank-3 sum (no kernel takes it) stays on segment too
    got = tp.plan_gspmm(g, parse_op("u_mul_e_add_v"), torch.zeros(1, 4, 16),
                        torch.zeros(1, 4, 1), device="cuda").strategy
    assert got == "segment"
    sig = (g.n_src, g.n_dst, g.n_edges)
    for op, lt, rt in (("u_add_v_copy_e", "u", "v"),
                       ("e_sub_v_copy_e", "e", "v"),
                       ("e_div_v_copy_e", "e", "v"),
                       ("u_dot_v_copy_e", "u", "v"),
                       ("u_copy_add_e", "u", None)):
        for d in (4, 1, 16, 41):
            spec = parse_op(op)
            rhs = None if rt is None else torch.zeros(1, d)
            got = tp.plan_sddmm(sig, spec, 1 if spec.op == "dot" else d,
                                lhs_data=torch.zeros(1, d), rhs_data=rhs,
                                device="cuda")
            assert got == "kernel", (op, d)
    for h, f in ((4, 32), (1, 41), (4, 16)):
        assert tp.plan_attention(sig, h, f, kernel_ok=True,
                                 padded_slots=stats.ragged_padded_slots,
                                 device="cuda") == "kernel"
    for d in (16, 41, 602):
        assert not tp.get_plan_cache(g).prefers_ell(d, "cuda")


def test_cuda_row_keeps_the_block_and_hetero_kernels():
    """The fan-out classes (chip_smoke: 8 / 32 / 128 at fan-out 10, two
    layers), the sampled runs' blocks ((10, 10) × 64, (15, 10) × 512) and
    R-GCN's relational shapes: the kernel where it takes the operands,
    and after a kernel forward the gather backward."""
    sigs = [s for cls in (8, 32, 128)
            for s in serve_block_signature(cls, 10, 2)]
    sigs += list(serve_block_signature(64, (10, 10)))
    sigs += list(serve_block_signature(512, (15, 10)))
    for sig in sigs:
        for op, d in (("u_copy_mean_v", 602), ("u_copy_mean_v", 100),
                      ("u_copy_mean_v", 64), ("u_mul_e_add_v", 41),
                      ("u_mul_e_add_v", 16), ("e_copy_add_v", 4),
                      ("e_copy_add_v", 1), ("e_copy_add_v", 32)):
            spec = parse_op(op)
            fwd = tp.plan_block_gspmm(sig, spec, d, device="cuda",
                                      kernel_ok=True)
            assert fwd == "kernel", (sig, op, d)
            bwd = tp.plan_block_vjp(sig, spec, d, device="cuda",
                                    kernel_forward=True,
                                    scatter_available=False)
            assert bwd == "gather", (sig, op, d)
        for op in ("e_copy_max_v",):
            fwd = tp.plan_block_gspmm(sig, parse_op(op), 4, device="cuda",
                                      kernel_ok=False)
            assert fwd in ("segment", "ell")
    for sig, d in (((5000, 5000, 200_000, 8), 32), ((5000, 5000, 200_000, 8),
                                                    4), ((4096, 4096, 40_000,
                                                         8), 32)):
        for op in ("u_w_mean_v", "u_w_sum_v"):
            assert tp.plan_hetero(sig, op, d, device="cuda",
                                  kernel_ok=True) == "kernel"


# --------------------------------------------------------------------- #
# the slice, end to end under auto
# --------------------------------------------------------------------- #
def _data(name):
    if name not in _memo:
        _memo[name] = (jax_make_node_dataset(name),
                       make_node_dataset(name, device="cpu"))
    return _memo[name]


def _params(app, d_in, n_classes):
    p = JAX_APPS[app].init(jax.random.PRNGKey(7), d_in, 16, n_classes)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _close_tree(got, ref, tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                                   atol=tol * scale)


def _logs_equal():
    """Both plan logs, JAX's names mapped, as {(op, requested): set of
    chosen}: JAX plans a traced op once per trace, the port per call, so
    the counts differ and the decisions must not."""
    def norm(log):
        return {(op, to_port(req)): {to_port(c) for c in chosen}
                for (op, req), chosen in log.items()}
    got, want = norm(tp.plan_log()), norm(jp.plan_log())
    assert got == want


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_slice_under_auto_matches_jax(app):
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _data("tiny")
    p, tree = _params(app, jf.shape[1], n_cls)
    jb, bundle = jax_make_bundle(jg), make_bundle(tg)
    model = from_jax_params(app, tree, device="cpu")
    x = torch.from_numpy(tf)

    # forward
    got = PORT_APPS[app].infer(model, bundle, x)
    want = JAX_APPS[app].infer(p, jb, jnp.asarray(jf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)

    # one full-graph loss and its grads
    def jax_loss(params):
        logits = JAX_APPS[app].forward(params, jb, jnp.asarray(jf),
                                       train=True, rng=jax.random.PRNGKey(0),
                                       drop=0.0)
        return jax_ce(logits, jnp.asarray(jl), jnp.asarray(jtr))

    jloss, jgrads = jax.value_and_grad(jax_loss)(p)
    logits = PORT_APPS[app].forward(model, bundle, x, train=True,
                                    gen=torch.Generator().manual_seed(0),
                                    drop=0.0)
    loss = cross_entropy_loss(logits, torch.from_numpy(tl).long(),
                              torch.from_numpy(ttr))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads, TOL)

    # one sampled batch
    ids = np.nonzero(np.asarray(jtr))[0][5:21]
    lab = np.asarray(jl)[ids]
    jmb = JaxSampler(jg, [4, 4], 16, seed=3).sample(ids, lab)
    tmb = NeighborSampler(tg, [4, 4], 16, seed=3, device="cpu",
                          reverse=True).sample(ids, lab)
    jfeats = jax_pad_features(jf)

    def jax_sampled_loss(params):
        out = JAX_APPS[app].forward_blocks(
            params, jmb.blocks, jax_block_features(jfeats, jmb.input_ids),
            train=True, rng=jax.random.PRNGKey(0), drop=0.0)
        return jax_ce(out, jmb.labels, jmb.label_mask)

    jloss, jgrads = jax.value_and_grad(jax_sampled_loss)(p)
    model = from_jax_params(app, tree, device="cpu")
    feats = pad_features(tf, "cpu")
    out = PORT_APPS[app].forward_blocks(
        model, tmb.blocks, block_features(feats, tmb.input_ids), train=True,
        gen=torch.Generator().manual_seed(0), drop=0.0)
    loss = cross_entropy_loss(out, tmb.labels, tmb.label_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=SAMPLED_TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads, SAMPLED_TOL)
    _logs_equal()


def test_slice_rgcn_forward_under_auto_matches_jax():
    n, r = 60, 3
    rels = jax_relational_graph(n, r, 150, seed=5)
    x = np.random.default_rng(6).standard_normal((n, 8)).astype(np.float32)
    params = jax_rgcn.init(jax.random.PRNGKey(3), 8, 12, 4, r)
    want = jax_rgcn.forward(params, jax_rgcn.build_relgraph(rels, n),
                            jnp.asarray(x))
    model = from_jax_params("rgcn", jax.tree_util.tree_map(np.asarray,
                                                           params),
                            device="cpu")
    got = rgcn.infer(model, rgcn.build_relgraph(rels, n, device="cpu"),
                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _logs_equal()
    assert any(op.startswith("hetero:") for op, _ in tp.plan_log())


def test_plan_serve_logs_and_memoizes():
    sig = (65_536, 627_774, 8, 2)
    for mod in (tp, jp):
        mod.clear_serve_plans()
    for cls, exp in ((8, 9_680), (128, 154_880)):
        s = (sig[0], sig[1], cls, sig[3])
        assert (tp.plan_serve(s, expansion_edges=exp)
                == jp.plan_serve(s, expansion_edges=exp))
    assert set(tp.plan_log()) == {("serve:infer", "auto")}
    assert tp._serve_cost("layerwise", sig, 9_680, 1024) == \
        jp._serve_cost("layerwise", sig, 9_680, 1024)
