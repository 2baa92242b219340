"""Port parity for mixed precision: ``optim/precision.py`` and the
lattice's bf16 dtype rules.

* The ``Precision`` API against JAX's: the presets, ``parse`` and its
  ``ValueError`` cases, ``mixed``, ``tag``, ``cast_tree`` (floating leaves
  only) and ``cast_logits``.
* Each op the bf16 training steps run, on bf16 features (fp32 where the
  lattice keeps a weight fp32), against JAX's op on the same values: the
  output dtype equals JAX's, and the values agree within
  :data:`BF16_TOL` × max|JAX| (JAX's documented bf16 tolerance,
  ``tests/launch/test_mixed_precision.py``). The port's plain routes and
  its kernel routes (the wrappers' plain versions here) are both held to
  it: they accumulate in fp32 and round once, where JAX's bf16 segment
  sums round as XLA's CPU reduction does.
* Each kernel's plain version on bf16 inputs against a float64
  reference of the same inputs, element by element within
  2⁻⁸·|ref| + 1e-5·max|ref| (one bf16 rounding at the store): the
  bound the card holds each bf16 kernel to (``chip_smoke.py`` phase 17).
* The planner's ``cuda:bf16`` row, asked on the host, takes the kernel at
  every main-path op of a bf16 step; a plan event records ``bfloat16``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_gspmm as jax_block_gspmm
from repro.core import edge_softmax as jax_edge_softmax
from repro.core import from_coo as jax_from_coo
from repro.core import gsddmm as jax_gsddmm
from repro.core import gspmm as jax_gspmm
from repro.core.hetero import from_rels as jax_from_rels
from repro.core.hetero import hetero_gspmm as jax_hetero_gspmm
from repro.data import NeighborSampler as JaxSampler
from repro.optim import Precision as JaxPrecision
from repro.optim import cast_logits as jax_cast_logits
from repro.optim import cast_tree as jax_cast_tree
from repro_torch import obs
from repro_torch.core import (block_gspmm, edge_softmax, from_coo, gsddmm,
                              gspmm, parse_op, planner)
from repro_torch.core.hetero import from_rels, hetero_gspmm
from repro_torch.data import NeighborSampler
from repro_torch.kernels.binary_reduce.ops import binary_reduce_plain
from repro_torch.kernels.sddmm.ops import sddmm_plain
from repro_torch.kernels.spmm.ops import spmm_plain
from repro_torch.optim import Precision, accum_dtype, cast_logits, cast_tree
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

BF16_TOL = 2e-2
REF_REL = 2.0 ** -8          # bf16's unit roundoff: one rounding
N, NNZ, D = 70, 500, 6
_cache = {}


def _graphs():
    """Both packages' graph: nodes 60..69 have no in-edge."""
    if "g" not in _cache:
        rng = np.random.default_rng(5)
        src, dst = rng.integers(0, N, NNZ), rng.integers(0, N - 10, NNZ)
        _cache["g"] = (jax_from_coo(src, dst, n_src=N, n_dst=N),
                       from_coo(src, dst, n_src=N, n_dst=N, device="cpu"))
    return _cache["g"]


def _bf16(a):
    """A numpy array rounded to bf16: (JAX bf16, port bf16), same bits."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _f32(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _check(got: torch.Tensor, ref, what=""):
    """``got``'s dtype equals JAX's; its values are within
    :data:`BF16_TOL`·max|JAX|."""
    ref = jnp.asarray(ref)
    assert str(got.dtype).replace("torch.", "") == ref.dtype.name, (
        what, got.dtype, ref.dtype)
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), r, rtol=0,
                               atol=BF16_TOL * float(np.abs(r).max()),
                               err_msg=what)


# --------------------------------------------------------------------- #
# the Precision API
# --------------------------------------------------------------------- #
def test_precision_presets_match_jax():
    for name in ("fp32", "bf16"):
        for comm in ("none", "int8"):
            j, t = JaxPrecision.parse(name, comm), Precision.parse(name, comm)
            assert t.tag() == j.tag()
            assert t.mixed == j.mixed
            assert t.comm == j.comm
            assert str(t.compute).replace("torch.", "") == \
                jnp.dtype(j.compute).name
            assert str(t.accum).replace("torch.", "") == \
                jnp.dtype(j.accum).name
    assert Precision.bf16("int8").tag() == "bf16+int8"
    assert Precision.fp32() == Precision() == Precision.parse("fp32")
    assert Precision.bf16() == Precision.parse("bf16")


@pytest.mark.parametrize("name,comm", [("fp16", "none"), ("bf32", "none"),
                                       ("bf16", "gzip"), ("fp32", "fp8")])
def test_precision_parse_errors_match_jax(name, comm):
    with pytest.raises(ValueError) as jerr:
        JaxPrecision.parse(name, comm)
    with pytest.raises(ValueError) as terr:
        Precision.parse(name, comm)
    assert str(terr.value) == str(jerr.value)


def test_cast_tree_and_logits_match_jax():
    rng = np.random.default_rng(0)
    w, b = rng.normal(size=(3, 4)).astype(np.float32), np.arange(4)
    jt = jax_cast_tree({"layers": [{"w": jnp.asarray(w),
                                    "ids": jnp.asarray(b)}],
                        "scale": (jnp.asarray(w[0]),)}, jnp.bfloat16)
    tt = cast_tree({"layers": [{"w": torch.from_numpy(w),
                                "ids": torch.from_numpy(b)}],
                    "scale": (torch.from_numpy(w[0]),)}, torch.bfloat16)
    assert tt["layers"][0]["w"].dtype == torch.bfloat16
    assert tt["layers"][0]["ids"].dtype == torch.int64     # ints pass
    assert isinstance(tt["scale"], tuple)
    np.testing.assert_array_equal(
        tt["layers"][0]["w"].float().numpy(),
        np.asarray(jt["layers"][0]["w"].astype(jnp.float32)))
    assert jnp.asarray(jt["layers"][0]["ids"]).dtype.kind == "i"
    logits = cast_logits(tt["layers"][0]["w"])
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(
        logits.numpy(), np.asarray(jax_cast_logits(jt["layers"][0]["w"])))
    assert accum_dtype(torch.bfloat16) == torch.float32
    assert accum_dtype(torch.float64) == torch.float64


def test_cast_is_differentiable_into_fp32_masters():
    w = torch.randn(5, 3, requires_grad=True)
    loss = cast_logits(cast_tree(w, torch.bfloat16) * 2).sum()
    (g,) = torch.autograd.grad(loss, [w])
    assert g.dtype == torch.float32
    torch.testing.assert_close(g, torch.full_like(w, 2.0))


# --------------------------------------------------------------------- #
# per-op parity in bf16
# --------------------------------------------------------------------- #
GSPMM_OPS = ["u_copy_add_v", "u_copy_mean_v", "u_mul_e_add_v",
             "e_copy_add_v", "u_div_e_add_v"]


def _gspmm_operands(op, rng):
    """JAX and port operands of ``op``: bf16 features, the scalar weight
    of ``u_mul_e`` in fp32 (GCN's norms)."""
    spec = parse_op(op)
    ops_j, ops_t = {}, {}
    for t in (spec.lhs, spec.rhs):
        if t is None:
            continue
        rows = NNZ if t == "e" else N
        if spec.op == "mul" and t == "e":
            ops_j[t], ops_t[t] = _f32(rng.random((rows, 1)) + 0.1)
        elif spec.op == "div" and t == "e":
            ops_j[t], ops_t[t] = _bf16(rng.random((rows, D)) + 0.5)
        else:
            ops_j[t], ops_t[t] = _bf16(rng.standard_normal((rows, D)))
    return ops_j, ops_t


@pytest.mark.parametrize("strategy", ["segment", "kernel"])
@pytest.mark.parametrize("op", GSPMM_OPS)
def test_gspmm_bf16_matches_jax(op, strategy):
    jg, tg = _graphs()
    ops_j, ops_t = _gspmm_operands(op, np.random.default_rng(1))
    ref = jax_gspmm(jg, op, strategy="segment", **ops_j)
    _check(gspmm(tg, op, strategy=strategy, **ops_t), ref, op)


@pytest.mark.parametrize("strategy", ["gather", "canonical", "kernel"])
@pytest.mark.parametrize("op", ["u_add_v_copy_e", "e_div_v_copy_e",
                                "u_dot_v_copy_e"])
def test_gsddmm_bf16_matches_jax(op, strategy):
    jg, tg = _graphs()
    rng = np.random.default_rng(2)
    spec = parse_op(op)
    ops_j, ops_t = {}, {}
    for t in (spec.lhs, spec.rhs):
        a = rng.standard_normal((NNZ if t == "e" else N, D))
        if spec.op == "div" and t == "v":
            a = np.abs(a) + 0.5
        ops_j[t], ops_t[t] = _bf16(a)
    ref = jax_gsddmm(jg, op, strategy="gather", **ops_j)
    _check(gsddmm(tg, op, strategy=strategy, **ops_t), ref, op)


@pytest.mark.parametrize("strategy", ["segment", "kernel"])
def test_edge_softmax_bf16_matches_jax(strategy):
    jg, tg = _graphs()
    lj, lt = _bf16(np.random.default_rng(3).standard_normal((NNZ, 4)) * 2)
    _check(edge_softmax(tg, lt, strategy=strategy),
           jax_edge_softmax(jg, lj, strategy="segment"), "edge_softmax")


@pytest.mark.parametrize("strategy", ["ell", "segment", "kernel"])
@pytest.mark.parametrize("op", ["u_copy_mean_v", "u_mul_e_add_v",
                                "e_copy_add_v"])
def test_block_gspmm_bf16_matches_jax(op, strategy):
    jg, tg = _graphs()
    seeds, lab = np.asarray([3, 7, 11, 64, 20, 9]), np.zeros(6, np.int64)
    jmb = JaxSampler(jg, [4], 8, seed=0).sample(seeds, lab)
    tmb = NeighborSampler(tg, [4], 8, seed=0, device="cpu",
                          reverse=True).sample(seeds, lab)
    jbg, tbg = jmb.blocks[0].bg, tmb.blocks[0].bg
    rng = np.random.default_rng(4)
    spec = parse_op(op)
    ops_j, ops_t = {}, {}
    for t in (spec.lhs, spec.rhs):
        if t is None:
            continue
        rows = tbg.g.n_edges if t == "e" else tbg.g.n_src
        if spec.op == "mul" and t == "e":
            ops_j[t], ops_t[t] = _f32(rng.random((rows, 1)) + 0.1)
        else:
            ops_j[t], ops_t[t] = _bf16(rng.standard_normal((rows, D)))
    ref = jax_block_gspmm(jbg, op, strategy="segment", **ops_j)
    _check(block_gspmm(tbg, op, strategy=strategy, **ops_t), ref, op)


HETERO_FORMS = [("plain", "sum"), ("w", "sum"), ("basis", "mean"),
                ("w", "mean")]


@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("form,reduce", HETERO_FORMS)
def test_hetero_gspmm_bf16_matches_jax(form, reduce, strategy):
    rng = np.random.default_rng(6)
    R = 3
    rels = [(rng.integers(0, N, 120), rng.integers(0, N, 120))
            for _ in range(R)]
    jrg = jax_from_rels(rels, n_src=N, n_dst=N)
    trg = from_rels(rels, n_src=N, n_dst=N, device="cpu")
    uj, ut = _bf16(rng.standard_normal((N, D)))
    kj, kt = {}, {}
    if form == "w":
        kj["w"], kt["w"] = _bf16(rng.standard_normal((R, D, 5)) * 0.3)
    elif form == "basis":
        kj["basis"], kt["basis"] = _bf16(rng.standard_normal((2, D, 5)))
        kj["coeff"], kt["coeff"] = _bf16(rng.standard_normal((R, 2)))
    ref = jax_hetero_gspmm(jrg, uj, reduce=reduce, strategy="fused", **kj)
    _check(hetero_gspmm(trg, ut, reduce=reduce, strategy=strategy, **kt),
           ref, f"{form} {reduce}")


# --------------------------------------------------------------------- #
# each kernel's plain version on bf16 inputs against float64
# --------------------------------------------------------------------- #
def _within_one_rounding(got: torch.Tensor, ref: torch.Tensor):
    assert got.dtype == torch.bfloat16
    err = (got.double() - ref).abs()
    bound = REF_REL * ref.abs() + 1e-5 * float(ref.abs().max())
    assert bool((err <= bound).all()), float((err - bound).max())


def _double(*ts):
    return tuple(t.double() if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in ts)


@pytest.mark.parametrize("weighted,mean", [(True, False), (False, True),
                                           (False, False)])
def test_spmm_plain_bf16_within_one_rounding(weighted, mean):
    _, tg = _graphs()
    rng = np.random.default_rng(7)
    B = _bf16(rng.standard_normal((N, 33)))[1]
    w = (torch.from_numpy(rng.random(NNZ).astype(np.float32))
         if weighted else None)
    args = (tg, B, w, mean)
    _within_one_rounding(spmm_plain(*args), spmm_plain(*_double(*args)))


@pytest.mark.parametrize("op,lt,rt,d", [
    ("add", "u", "v", 4), ("sub", "e", "v", 4), ("div", "e", "v", 1),
    ("mul", "e", "v", 4), ("dot", "u", "v", 16), ("copy", "v", None, 4)])
def test_sddmm_plain_bf16_within_one_rounding(op, lt, rt, d):
    _, tg = _graphs()
    rng = np.random.default_rng(8)
    rows = {"u": N, "v": N, "e": NNZ}
    lhs = _bf16(rng.standard_normal((rows[lt], d)))[1]
    args = (tg, op, lt, lhs)
    if rt is not None:
        rhs = rng.standard_normal((rows[rt], d))
        rhs = _bf16(np.abs(rhs) + 0.5 if op == "div" else rhs)[1]
        args += (rt, rhs)
    _within_one_rounding(sddmm_plain(*args), sddmm_plain(*_double(*args)))


@pytest.mark.parametrize("binop,d,de,mean", [
    ("copy_rhs", 4, 4, False), ("copy_rhs", 1, 1, False),
    ("mul", 8, 8, False), ("div", 5, 1, True), ("add", 4, 4, True)])
def test_binary_reduce_plain_bf16_within_one_rounding(binop, d, de, mean):
    _, tg = _graphs()
    rng = np.random.default_rng(9)
    E = rng.standard_normal((NNZ, de))
    E = _bf16(np.abs(E) + 0.5 if binop == "div" else E)[1]
    B = (None if binop == "copy_rhs"
         else _bf16(rng.standard_normal((N, d)))[1])
    args = (tg, B, E, binop, mean)
    _within_one_rounding(binary_reduce_plain(*args),
                         binary_reduce_plain(*_double(*args)))


# --------------------------------------------------------------------- #
# the planner's cuda:bf16 row and the plan events
# --------------------------------------------------------------------- #
def test_cuda_bf16_row_takes_the_kernel_at_every_main_path_op():
    """Asked on the host for the card (``device="cuda"``), with bf16
    features: the kernel at every op a bf16 step runs on B1 / B3 / B4,
    and the cpu:bf16 row never (JAX's: its kernel entry is 512)."""
    from repro_torch.data.synthetic import make_node_dataset

    g = make_node_dataset("pubmed-like", device="cpu")[0]
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.random((g.n_edges, 1)).astype(np.float32))
    for op, d in (("u_mul_e_add_v", 16), ("u_mul_e_add_v", 41),
                  ("u_copy_mean_v", 500), ("u_copy_add_v", 16),
                  ("e_copy_add_v", 4), ("e_copy_add_v", 1)):
        spec = parse_op(op)
        rows = g.n_edges if spec.lhs == "e" else g.n_src
        lhs = torch.zeros(rows, d, dtype=torch.bfloat16)
        rhs = w if spec.rhs == "e" else None
        assert planner.plan_gspmm(g, spec, lhs, rhs,
                                  device="cuda").strategy == "kernel", op
        assert planner.plan_gspmm(g, spec, lhs, rhs).strategy != "kernel"
    sig = (g.n_src, g.n_dst, g.n_edges)
    for op, d in (("u_add_v_copy_e", 4), ("e_sub_v_copy_e", 4),
                  ("e_div_v_copy_e", 1), ("u_dot_v_copy_e", 16),
                  ("v_copy_add_e", 4)):
        spec = parse_op(op)
        kw = {t: torch.zeros(g.n_edges if t == "e" else g.n_src, d,
                             dtype=torch.bfloat16)
              for t in (spec.lhs, spec.rhs) if t is not None}
        assert planner.plan_sddmm(sig, spec, d, lhs_data=kw[spec.lhs],
                                  rhs_data=kw.get(spec.rhs),
                                  device="cuda") == "kernel", op
    stats = planner.get_plan_cache(g).stats
    for d in (16, 500):
        costs = {r: planner.estimate_cost(r, stats, d, "cuda",
                                          torch.bfloat16)
                 for r in ("kernel", "segment", "push", "ell")}
        assert min(costs, key=costs.get) == "kernel", costs


def test_plan_events_record_bfloat16():
    _, tg = _graphs()
    u = torch.randn(N, D).bfloat16()
    prev = obs.set_enabled(True)
    try:
        obs.clear_events()
        gspmm(tg, "u_copy_add_v", u=u, strategy="segment")
        events = [e for e in obs.plan_events()
                  if e["op"] == "u_copy_add_v"]
    finally:
        obs.set_enabled(prev)
    assert events and events[-1]["dtype"] == "bfloat16"
