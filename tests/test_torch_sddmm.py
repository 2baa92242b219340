"""Port parity for the gSDDMM kernel module (B3) and ``gsddmm``.

On the CPU the kernel wrapper ``sddmm_csr`` runs its plain PyTorch
version (gather into canonical order, ⊗, un-permute by ``eid_inv``). Both
are held against the JAX Pallas kernel (``repro.kernels.sddmm.ops.sddmm``,
interpret mode, over the canonical streams the JAX package gathers) and
its ``ref.py`` oracle, for every ⊗, width broadcast and operand target
pair, on a random graph with zero-degree rows and duplicate edges and on
a small R-MAT graph. The port's ``gsddmm`` is held against JAX
``gsddmm``. Tolerance 1e-5 (fp32); 1e-4 for ``div``, as the JAX kernel
tests use. ``emulate_caller_order`` mirrors the CUDA kernel's walk
(``sddmm_csr.cu``: caller edge e reads ``lhs[ia[e]] ⊗ rhs[ib[e]]``, no
``eid``) and must give the plain version's bits for every op but dot. The
CUDA branch is exercised on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gsddmm as jax_gsddmm
from repro.core.graph import from_coo as jax_from_coo
from repro.kernels.sddmm.ops import sddmm as jax_sddmm_pallas
from repro.kernels.sddmm.ref import sddmm_ref
from repro_torch.core import from_coo, gspmm, gsddmm, parse_op
from repro_torch.core.binary_reduce import SDDMM_FOR, SDDMM_STRATEGIES
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.dispatch import sddmm_kernel_supports
from repro_torch.kernels.common import graph_index_ptrs
from repro_torch.kernels.sddmm.ops import (CALLER_INDEX, sddmm_csr,
                                           sddmm_plain)
from tests.graphgen import random_edges
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")


def _graphs():
    """(name, src, dst, n_src, n_dst): random with zero-degree rows and
    duplicate edges, and a small power-law R-MAT graph."""
    rng = np.random.default_rng(21)
    src, dst = random_edges(rng, 90, 70, 300)
    yield "random", src, dst, 90, 70
    src, dst, n = rmat_graph(8, 2000, seed=4)
    yield "rmat", src, dst, n, n


GRAPHS = {name: rest for name, *rest in _graphs()}
ROWS = {"u": 0, "v": 1, "e": 2}     # index into (n_src, n_dst, n_edges)
OPS = ("add", "sub", "mul", "div", "dot", "copy")


def _tol(op):
    return 1e-4 if op == "div" else 1e-5


def _case(name, lt, lw, rt, rw, op, seed=0):
    src, dst, n_src, n_dst = GRAPHS[name]
    jg = jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    sizes = (n_src, n_dst, len(src))
    rng = np.random.default_rng(seed + 7 * lw + rw)
    lhs = rng.normal(size=(sizes[ROWS[lt]], lw)).astype(np.float32)
    rhs = rng.normal(size=(sizes[ROWS[rt]], rw)).astype(np.float32)
    if op == "div":   # keep divisors away from 0
        rhs = (np.sign(rhs) * (0.5 + np.abs(rhs))).astype(np.float32)
    return jg, tg, lhs, rhs


def _jax_canonical(jg, target, x):
    idx = {"u": jg.src, "v": jg.dst, "e": jg.eid}[target]
    return jnp.take(jnp.asarray(x), idx, axis=0)


# (op, operand targets, widths): every ⊗ over the GAT widths and their
# broadcasts on the path's target pairs; copy once per target and width
KERNEL_CASES = (
    [(op, t, w) for op in OPS[:-1] for t in ("uv", "ev", "ue")
     for w in ((4, 4), (4, 1), (1, 4), (7, 7))]
    + [("copy", t + t, (w, w)) for t in "uve" for w in (4, 1, 7)])


@pytest.mark.parametrize("op,targets,widths", KERNEL_CASES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_and_wrapper_match_pallas_and_oracle(graph, op, targets,
                                                   widths):
    lt, rt = targets
    lw, rw = widths
    jg, tg, lhs, rhs = _case(graph, lt, lw, rt, rw, op)
    lv = _jax_canonical(jg, lt, lhs)
    rv = None if op == "copy" else _jax_canonical(jg, rt, rhs)
    pallas = np.asarray(jnp.take(jax_sddmm_pallas(lv, rv, op), jg.eid_inv,
                                 axis=0))
    oracle = np.asarray(jnp.take(sddmm_ref(lv, rv, op), jg.eid_inv, axis=0))
    args = (tg, op, lt, torch.from_numpy(lhs))
    if op != "copy":
        args += (rt, torch.from_numpy(rhs))
    for got in (sddmm_csr(*args), sddmm_plain(*args)):
        assert got.shape == oracle.shape
        for ref in (pallas, oracle):
            np.testing.assert_allclose(got.numpy(), ref, rtol=_tol(op),
                                       atol=_tol(op))


GSDDMM_OPS = ["u_add_v_copy_e", "e_sub_v_copy_e", "e_div_v_copy_e",
              "u_dot_v_add_e", "u_copy_add_e", "v_mul_e_copy_e",
              "e_mul_u_copy_e"]


@pytest.mark.parametrize("op_name", GSDDMM_OPS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gsddmm_matches_jax(graph, op_name):
    spec = parse_op(op_name)
    rt = spec.rhs or "u"
    jg, tg, lhs, rhs = _case(graph, spec.lhs, 4, rt, 4, spec.op, seed=3)
    data = {spec.lhs: lhs}
    if spec.rhs is not None:
        data[spec.rhs] = rhs
    for jstrat in ("canonical", "gather"):
        ref = np.asarray(jax_gsddmm(jg, op_name, strategy=jstrat,
                                    **{k: jnp.asarray(x)
                                       for k, x in data.items()}))
        for strategy in SDDMM_STRATEGIES:
            got = gsddmm(tg, op_name, strategy=strategy,
                         **{k: torch.from_numpy(x) for k, x in data.items()})
            np.testing.assert_allclose(got.numpy(), ref, rtol=_tol(spec.op),
                                       atol=_tol(spec.op),
                                       err_msg=f"{op_name}/{strategy}")


def test_gsddmm_widens_1d_operands_like_jax():
    jg, tg, lhs, rhs = _case("random", "u", 1, "v", 1, "add")
    ref = np.asarray(jax_gsddmm(jg, "u_add_v_copy_e", u=jnp.asarray(lhs[:, 0]),
                                v=jnp.asarray(rhs[:, 0])))
    got = gsddmm(tg, "u_add_v_copy_e", u=torch.from_numpy(lhs[:, 0]),
                 v=torch.from_numpy(rhs[:, 0]))
    assert got.shape == ref.shape == (tg.n_edges, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_gspmm_delegates_edge_outputs_with_the_jax_name_mapping(
        fresh_fallback_warnings):
    """gspmm's edge outputs equal gsddmm's under the mapped strategy; a
    pinned 'kernel' reaches the kernel path, and on operands B3 does not
    take (rank 3) falls back to the canonical stream with a warning, as
    JAX's 'pallas' does; 'pallas' names the kernel route."""
    assert SDDMM_FOR == {"auto": "auto", "kernel": "kernel",
                         "segment": "gather", "push": "gather",
                         "ell": "canonical", "onehot": "canonical"}
    _, tg, lhs, rhs = _case("random", "u", 4, "v", 4, "sub")
    u, v = torch.from_numpy(lhs), torch.from_numpy(rhs)
    for strategy, mapped in SDDMM_FOR.items():
        torch.testing.assert_close(
            gspmm(tg, "u_sub_v_copy_e", u=u, v=v, strategy=strategy),
            gsddmm(tg, "u_sub_v_copy_e", u=u, v=v, strategy=mapped),
            rtol=0, atol=0)
    u3, v3 = u.reshape(-1, 2, 2), v.reshape(-1, 2, 2)
    with pytest.warns(UserWarning, match="falling back to 'canonical'"):
        got = gspmm(tg, "u_add_v_copy_e", u=u3, v=v3, strategy="kernel")
    torch.testing.assert_close(got, gsddmm(tg, "u_add_v_copy_e", u=u3, v=v3,
                                           strategy="canonical"),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        gsddmm(tg, "u_add_v_copy_e", u=u, v=v, strategy="pallas"),
        gsddmm(tg, "u_add_v_copy_e", u=u, v=v, strategy="kernel"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown sddmm strategy"):
        gsddmm(tg, "u_add_v_copy_e", u=u, v=v, strategy="segment")
    with pytest.raises(ValueError, match="edge outputs"):
        gsddmm(tg, "u_add_v_add_v", u=u, v=v)


def test_kernel_supports_rank2_fp32_matching_or_broadcast_widths():
    a4, a1, a3 = torch.zeros(5, 4), torch.zeros(5, 1), torch.zeros(5, 3)
    add, copy = parse_op("u_add_v_copy_e"), parse_op("u_copy_add_e")
    assert sddmm_kernel_supports(add, a4, a4)
    assert sddmm_kernel_supports(add, a4, a1)
    assert sddmm_kernel_supports(add, a1, a4)
    assert sddmm_kernel_supports(copy, a3, None)
    assert not sddmm_kernel_supports(add, a4, a3)
    assert not sddmm_kernel_supports(add, a4.double(), a4)
    assert not sddmm_kernel_supports(add, a4[:, :, None], a4)
    assert not sddmm_kernel_supports(parse_op("u_add_v_add_v"), a4, a4)


def test_wrapper_on_cpu_counts_nothing_and_checks_arguments():
    _, tg, lhs, rhs = _case("random", "u", 4, "v", 4, "add")
    u, v = torch.from_numpy(lhs), torch.from_numpy(rhs)
    before = (sddmm_csr.launches, dict(sddmm_csr.op_launches))
    torch.testing.assert_close(sddmm_csr(tg, "add", "u", u, "v", v),
                               sddmm_plain(tg, "add", "u", u, "v", v),
                               rtol=0, atol=0)
    assert (sddmm_csr.launches, dict(sddmm_csr.op_launches)) == before
    with pytest.raises(ValueError, match="unknown op"):
        sddmm_csr(tg, "max", "u", u, "v", v)
    with pytest.raises(ValueError, match="needs an rhs"):
        sddmm_csr(tg, "add", "u", u)
    with pytest.raises(ValueError, match="takes no rhs"):
        sddmm_csr(tg, "copy", "u", u, "v", v)


def emulate_caller_order(tg, op, lt, lhs, rt=None, rhs=None):
    """B3 as the CUDA source computes it: caller edge e reads row
    ``src_caller[e]`` of a ``u`` operand, ``dst_caller[e]`` of a ``v``
    operand and row e of an ``e`` operand, and applies ⊗ (width 1
    broadcasts); dot sums j = 0, 1, … in order."""
    def rows(target, x):
        name = CALLER_INDEX[target]
        return x if name is None else x[getattr(tg, name).long()]

    a = rows(lt, lhs)
    if op == "copy":
        return a.clone()
    b = rows(rt, rhs)
    if op == "dot":
        a, b = torch.broadcast_tensors(a, b)
        acc = torch.zeros(a.shape[0])
        for j in range(a.shape[1]):
            acc = acc + a[:, j] * b[:, j]
        return acc[:, None]
    return {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
            "div": torch.div}[op](a, b)


# every ⊗ on GAT's target pairs at widths 4 and 1 with broadcast, copy of
# each target
EMULATION_CASES = (
    [(op, t, w) for op in OPS[:-1] for t in ("uv", "ev")
     for w in ((4, 4), (4, 1), (1, 4), (1, 1))]
    + [("copy", t + t, (w, w)) for t in "uve" for w in (4, 1)])


@pytest.mark.parametrize("op,targets,widths", EMULATION_CASES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_caller_order_walk_gives_the_plain_versions_bits(graph, op, targets,
                                                         widths):
    lt, rt = targets
    lw, rw = widths
    jg, tg, lhs, rhs = _case(graph, lt, lw, rt, rw, op, seed=11)
    args = (tg, op, lt, torch.from_numpy(lhs))
    if op != "copy":
        args += (rt, torch.from_numpy(rhs))
    got = emulate_caller_order(*args)
    plain = sddmm_plain(*args)
    assert got.shape == plain.shape
    if op == "dot":
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(got, plain)
    name = (f"{lt}_copy_add_e" if op == "copy"
            else f"{lt}_{op}_{rt}_copy_e")
    data = {lt: jnp.asarray(lhs)}
    if op != "copy":
        data[rt] = jnp.asarray(rhs)
    ref = np.asarray(jax_gsddmm(jg, name, strategy="gather", **data))
    np.testing.assert_allclose(got.numpy(), ref, rtol=_tol(op),
                               atol=_tol(op))


def test_graph_index_arrays_are_checked_once_per_graph():
    _, tg, _, _ = _case("random", "u", 4, "v", 4, "add")
    ptrs = graph_index_ptrs("k", tg)
    assert graph_index_ptrs("k", tg) is ptrs
    for name in ("src", "dst", "eid", "indptr_dst", "src_caller",
                 "dst_caller"):
        assert ptrs[name] == getattr(tg, name).data_ptr()
    bad = dataclasses.replace(tg, eid=tg.eid.long())
    with pytest.raises(TypeError, match="k: eid has dtype torch.int64"):
        graph_index_ptrs("k", bad)
