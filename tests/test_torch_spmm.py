"""Port parity for the Copy-Reduce kernel module (B1) and ``gspmm``.

On the CPU the kernel wrapper ``spmm_csr`` runs its plain PyTorch version
(``index_select`` + ``index_add_``); it is held against the JAX oracle
``repro.kernels.spmm.ref.spmm_ref`` and the JAX Pallas kernel (interpret
mode), and the port's ``gspmm`` against JAX ``gspmm(strategy="segment")``
for the four specs the kernel serves, at 1e-5 (fp32 sums taken in another
order). The CUDA branch is exercised on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gspmm as jax_gspmm
from repro.core import planner as jax_planner
from repro.kernels.spmm.ops import spmm as jax_spmm_pallas
from repro.kernels.spmm.ref import spmm_ref
from repro_torch.core import from_coo, gspmm, planner
from repro_torch.core.binary_reduce import STRATEGIES, copy_reduce, parse_op
from repro_torch.kernels.dispatch import kernel_supports
from repro_torch.kernels.spmm.ops import spmm, spmm_csr, spmm_plain
from tests.graphgen import random_graph
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
# (n_src, n_dst, nnz, d): rectangular, empty rows, narrow and odd widths
SHAPES = [(60, 40, 300, 32), (50, 120, 90, 41), (30, 30, 400, 7),
          (80, 16, 500, 64)]
B1_SPECS = ("u_copy_add_v", "u_copy_mean_v", "u_mul_e_add_v",
            "u_mul_e_mean_v")


def _case(n_src, n_dst, nnz, d, seed=0):
    rng = np.random.default_rng(seed + nnz)
    jg, src, dst = random_graph(rng, n_src, n_dst, nnz)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    B = rng.normal(size=(n_src, d)).astype(np.float32)
    w = rng.normal(size=(nnz,)).astype(np.float32)
    return jg, tg, B, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
@pytest.mark.parametrize("n_src,n_dst,nnz,d", SHAPES)
def test_plain_matches_oracle_and_pallas(n_src, n_dst, nnz, d, reduce_op,
                                         weighted):
    jg, tg, B, w = _case(n_src, n_dst, nnz, d)
    wj = jnp.asarray(w) if weighted else None
    ref = np.asarray(spmm_ref(jg.src, jg.dst, jnp.asarray(B), n_dst,
                              reduce_op,
                              weight=None if wj is None
                              else jnp.take(wj, jg.eid)))
    pallas = np.asarray(jax_spmm_pallas(jg, jnp.asarray(B), reduce_op,
                                        weight=wj))
    got = spmm(tg, torch.from_numpy(B), reduce_op,
               weight=torch.from_numpy(w) if weighted else None).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    if (tg.host.in_degrees == 0).any():
        assert not got[tg.host.in_degrees == 0].any()  # empty rows are 0


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, tg, B, w = _case(60, 40, 300, 32)
    Bt = torch.from_numpy(B)
    wc = torch.from_numpy(w)[tg.long("eid")]
    before = spmm_csr.launches
    for mean in (False, True):
        torch.testing.assert_close(spmm_csr(tg, Bt, wc, mean),
                                   spmm_plain(tg, Bt, wc, mean),
                                   rtol=0, atol=0)
    assert spmm_csr.launches == before


@pytest.mark.parametrize("op", B1_SPECS)
@pytest.mark.parametrize("n_src,n_dst,nnz,d", SHAPES)
def test_gspmm_matches_jax_segment(op, n_src, n_dst, nnz, d):
    jg, tg, B, w = _case(n_src, n_dst, nnz, d, seed=5)
    kw_j = dict(u=jnp.asarray(B))
    kw_t = dict(u=torch.from_numpy(B))
    if "_e_" in op:
        kw_j["e"] = jnp.asarray(w)[:, None]
        kw_t["e"] = torch.from_numpy(w)[:, None]
    ref = np.asarray(jax_gspmm(jg, op, strategy="segment", **kw_j))
    for strategy in STRATEGIES:
        got = gspmm(tg, op, strategy=strategy, **kw_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{op}/{strategy}")


@pytest.mark.parametrize("op", ["u_sub_v_add_u", "u_copy_add_u",
                                "u_add_v_mean_v", "e_copy_add_v"])
def test_segment_path_covers_other_node_outputs(op):
    """The plain path is general: other ⊗ and out='u' match JAX too."""
    jg, tg, B, w = _case(40, 40, 200, 8, seed=9)
    data = {"u": B, "v": B, "e": np.repeat(w[:, None], 8, axis=1)}
    spec = parse_op(op)
    names = [t for t in (spec.lhs, spec.rhs) if t is not None]
    ref = np.asarray(jax_gspmm(jg, op, strategy="segment",
                               **{t: jnp.asarray(data[t]) for t in names}))
    got = gspmm(tg, op, strategy="segment",
                **{t: torch.from_numpy(data[t]) for t in names}).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_copy_reduce_mean_matches_jax():
    from repro.core import copy_reduce as jax_copy_reduce
    jg, tg, B, _ = _case(50, 120, 90, 16)
    ref = np.asarray(jax_copy_reduce(jg, jnp.asarray(B), "mean"))
    got = copy_reduce(tg, torch.from_numpy(B), "mean").numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_kernel_supports_exactly_the_b1_specs():
    """The B1 specs are covered; so, since B4, is a vector edge operand
    of the node's width — but not one of another width, a max, a
    v-operand, or a type the kernels do not take."""
    u = torch.zeros(4, 3)
    e1, e2, e3 = torch.zeros(5, 1), torch.zeros(5, 2), torch.zeros(5, 3)
    for op in B1_SPECS:
        assert kernel_supports(parse_op(op), u, e1)
    assert kernel_supports(parse_op("u_mul_e_add_v"), u, e3)
    assert not kernel_supports(parse_op("u_mul_e_add_v"), u, e2)
    assert not kernel_supports(parse_op("u_copy_max_v"), u, None)
    assert not kernel_supports(parse_op("u_add_v_add_v"), u, u)
    assert not kernel_supports(parse_op("u_copy_add_v"), u.double(), None)


def test_queued_strategies_and_outputs_raise(fresh_fallback_warnings):
    """'pallas' names the kernel route; 'ring' (ROADMAP A12) and a spec no
    kernel covers under 'kernel' fall back down the planner's chain with
    a warning, to what JAX's planner picks (its 'pallas' for the port's
    'kernel'); edge outputs, the max reducer and the push / ell / onehot
    routes compute."""
    jg, tg, B, w = _case(30, 30, 400, 7)
    u = torch.from_numpy(B)
    ref = np.asarray(jax_gspmm(jg, "u_copy_add_v", u=jnp.asarray(B),
                               strategy="segment"))
    got = gspmm(tg, "u_copy_add_v", u=u, strategy="pallas").numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert planner.last_plan("u_copy_add_v", "kernel") == "kernel"
    with pytest.warns(UserWarning, match="falling back"):
        got = gspmm(tg, "u_copy_add_v", u=u, strategy="ring").numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    jax_gspmm(jg, "u_copy_add_v", u=jnp.asarray(B), strategy="ring")
    assert (planner.last_plan("u_copy_add_v", "ring")
            == jax_planner.last_plan("u_copy_add_v", "ring"))
    for strategy in ("push", "ell", "onehot"):
        got = gspmm(tg, "u_copy_add_v", u=u, strategy=strategy).numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=strategy)
    with pytest.warns(UserWarning, match="falling back"):
        got = gspmm(tg, "u_add_v_add_v", u=u, v=u, strategy="kernel")
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_gspmm(jg, "u_add_v_add_v", u=jnp.asarray(B),
                                          v=jnp.asarray(B), strategy="pallas")),
        rtol=TOL, atol=TOL)
    assert (planner.last_plan("u_add_v_add_v", "kernel")
            == jax_planner.last_plan("u_add_v_add_v", "pallas"))
    for op in ("u_add_v_copy_e", "u_copy_max_v"):
        ref = np.asarray(jax_gspmm(jg, op, u=jnp.asarray(B),
                                   v=jnp.asarray(B), strategy="segment"))
        got = gspmm(tg, op, u=u, v=u, strategy="segment").numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_operand_checks_reject_what_the_kernels_cannot_take():
    from repro_torch.kernels.common import check_operand
    dev = torch.device("cpu")
    ok = torch.zeros(4, 3)
    check_operand("k", "x", ok, torch.float32, (4, None), dev)
    bad = [(ok.double(), TypeError), (ok[:, :2], ValueError),
           (torch.zeros(3, 4).t(), ValueError),
           (torch.zeros(4, 3, requires_grad=True), NotImplementedError)]
    for t, err in bad:
        with pytest.raises(err):
            check_operand("k", "x", t, torch.float32, (4, 3), dev)
    with pytest.raises(ValueError, match="expected cuda"):
        check_operand("k", "x", torch.zeros(4, 3), torch.float32, (4, 3),
                      torch.device("cuda"))


def test_build_rejects_unknown_sources():
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build(["not_a_kernel"])
    assert set(_build.SOURCES) == {
        p.stem for p in (_build.CSRC).glob("*.cu")}
