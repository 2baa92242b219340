"""Port parity for the Binary-Reduce kernel module (B4), the node-output
dispatch, and the reducers of ``pull_segment``.

On the CPU the kernel wrapper ``binary_reduce_csr`` runs its plain
PyTorch version. Both are held against the JAX Pallas kernel
(``repro.kernels.binary_reduce.ops.binary_reduce``, interpret mode) and
its ``ref.py`` oracle over every ⊗, sum/mean and a scalar edge operand,
on a random graph with zero-degree rows and duplicate edges and on a
small R-MAT graph. The port's ``gspmm`` is held against JAX ``gspmm``
(segment, and the Pallas route of ``repro/kernels/dispatch.py``) for the
specs the kernels take, including the ``e_⊗_u`` flip, and the new
``pull_segment`` reducers against JAX's, empty rows included. Tolerance
1e-5 (fp32 sums in another order); 1e-4 for ``div``, as the JAX kernel
tests use. The CUDA branch is exercised on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gspmm as jax_gspmm
from repro.core import planner as jax_planner
from repro.core import strategies as jax_strategies
from repro.core.graph import from_coo as jax_from_coo
from repro.kernels.binary_reduce.ops import binary_reduce as jax_br_pallas
from repro.kernels.binary_reduce.ref import binary_reduce_ref
from repro_torch.core import from_coo, gspmm, parse_op, planner
from repro_torch.core.binary_reduce import STRATEGIES, onehot_supports
from repro_torch.core.strategies import pull_segment
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels import dispatch
from repro_torch.kernels.binary_reduce.ops import (BINOPS, binary_reduce,
                                                   binary_reduce_csr,
                                                   binary_reduce_plain)
from tests.graphgen import random_edges
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")


def _graphs():
    """(name, src, dst, n_src, n_dst): random with zero-degree rows and
    duplicate edges, and a small power-law R-MAT graph."""
    rng = np.random.default_rng(31)
    src, dst = random_edges(rng, 80, 100, 300)
    yield "random", src, dst, 80, 100
    src, dst, n = rmat_graph(8, 2000, seed=5)
    yield "rmat", src, dst, n, n


GRAPHS = {name: rest for name, *rest in _graphs()}


def _tol(op):
    return 1e-4 if op == "div" else 1e-5


def _case(name, d, de, op, seed=0):
    src, dst, n_src, n_dst = GRAPHS[name]
    jg = jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    rng = np.random.default_rng(seed + 10 * d + de)
    B = rng.normal(size=(n_src, d)).astype(np.float32)
    E = rng.normal(size=(len(src), de)).astype(np.float32)
    if op == "div":   # keep divisors away from 0
        E = (np.sign(E) * (0.5 + np.abs(E))).astype(np.float32)
    return jg, tg, B, E


@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
@pytest.mark.parametrize("d,de", [(4, 4), (4, 1), (1, 1), (32, 32)])
@pytest.mark.parametrize("binop", sorted(BINOPS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_and_wrapper_match_pallas_and_oracle(graph, binop, d, de,
                                                   reduce_op):
    jg, tg, B, E = _case(graph, d, de, binop)
    Ej = jnp.asarray(E)
    pallas = np.asarray(jax_br_pallas(jg, jnp.asarray(B), Ej, binop=binop,
                                      reduce_op=reduce_op))
    e_canon = jnp.broadcast_to(jnp.take(Ej, jg.eid, axis=0),
                               (tg.n_edges, d))
    oracle = np.asarray(binary_reduce_ref(jg.src, jg.dst, jnp.asarray(B),
                                          e_canon, tg.n_dst, binop))
    mean = reduce_op == "mean"
    if mean:
        oracle = oracle / np.maximum(tg.host.in_degrees, 1)[:, None]
    Bt, Et = torch.from_numpy(B), torch.from_numpy(E)
    got = [binary_reduce_csr(tg, Bt, Et, binop, mean),
           binary_reduce_plain(tg, Bt, Et, binop, mean),
           binary_reduce(tg, Bt, Et, binop, reduce_op)]
    if binop == "copy_rhs" and de == d:     # the node operand is not read
        got.append(binary_reduce_csr(tg, None, Et, binop, mean))
    for out in got:
        for ref in (pallas, oracle):
            np.testing.assert_allclose(out.numpy(), ref, rtol=_tol(binop),
                                       atol=_tol(binop))
        empty = tg.host.in_degrees == 0
        assert not out.numpy()[empty].any()        # empty rows are 0


# every node-output spec the kernels take (repro/kernels/dispatch.py) and
# the kernel that takes it; scalar-weight mul goes to B1
ROUTES = [("u_copy_add_v", 4, "spmm"), ("u_copy_mean_v", 4, "spmm"),
          ("u_mul_e_add_v", 1, "spmm"), ("u_mul_e_mean_v", 1, "spmm"),
          ("e_copy_add_v", 4, "br"), ("e_copy_mean_v", 1, "br"),
          ("u_add_e_add_v", 4, "br"), ("u_sub_e_mean_v", 4, "br"),
          ("u_mul_e_add_v", 4, "br"), ("u_div_e_add_v", 1, "br"),
          ("e_add_u_mean_v", 4, "br"), ("e_mul_u_add_v", 4, "br")]


@pytest.mark.parametrize("op,de,kernel", ROUTES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gspmm_routes_like_jax_dispatch(graph, op, de, kernel, monkeypatch,
                                        fresh_fallback_warnings):
    spec = parse_op(op)
    jg, tg, B, E = _case(graph, 4, de, spec.op, seed=2)
    data = {"u": B, "e": E}
    names = [t for t in (spec.lhs, spec.rhs) if t is not None]
    kw_j = {t: jnp.asarray(data[t]) for t in names}
    kw_t = {t: torch.from_numpy(data[t]) for t in names}
    refs = [np.asarray(jax_gspmm(jg, op, strategy=s, **kw_j))
            for s in ("segment", "pallas")]
    lhs, rhs = (kw_t.get(t) for t in (spec.lhs, spec.rhs))
    for strategy in STRATEGIES:
        if strategy == "onehot" and not onehot_supports(spec, lhs, rhs):
            # the planner falls back down its chain, as JAX's does
            with pytest.warns(UserWarning, match="falling back to 'ell'"):
                got = gspmm(tg, op, strategy=strategy, **kw_t).numpy()
            np.testing.assert_allclose(
                got, np.asarray(jax_gspmm(jg, op, strategy="onehot", **kw_j)),
                rtol=_tol(spec.op), atol=_tol(spec.op))
            assert (planner.last_plan(op, "onehot")
                    == jax_planner.last_plan(op, "onehot") == "ell")
            continue
        got = gspmm(tg, op, strategy=strategy, **kw_t).numpy()
        for ref in refs:
            np.testing.assert_allclose(got, ref, rtol=_tol(spec.op),
                                       atol=_tol(spec.op),
                                       err_msg=f"{op}/{strategy}")
    calls = []
    for name in ("spmm", "binary_reduce"):
        real = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name,
                            lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    gspmm(tg, op, strategy="kernel", **kw_t)
    assert calls == ["spmm" if kernel == "spmm" else "binary_reduce"]


def test_e_op_u_flip_only_for_commutative_ops(fresh_fallback_warnings):
    """No kernel takes e_sub_u / e_div_u / u_add_v: a pinned 'kernel'
    falls back down the planner's chain with a warning, and 'auto' takes
    a plain route — both as JAX's planner does (its 'pallas' pinned)."""
    jg, tg, B, E = _case("random", 4, 4, "sub")
    u, e = torch.from_numpy(B), torch.from_numpy(E)
    v = torch.ones(tg.n_dst, 4)
    for op in ("e_sub_u_add_v", "e_div_u_add_v", "u_add_v_add_v"):
        spec = parse_op(op)
        kw = {"u": u, "v": v, "e": e}
        kw_j = {k: jnp.asarray(t.numpy()) for k, t in kw.items()}
        assert not dispatch.kernel_supports(spec, kw[spec.lhs], kw[spec.rhs])
        for ours, theirs in (("kernel", "pallas"), ("auto", "auto")):
            if ours == "kernel":
                with pytest.warns(UserWarning, match="falling back"):
                    got = gspmm(tg, op, strategy=ours, **kw)
            else:
                got = gspmm(tg, op, strategy=ours, **kw)
            ref = jax_gspmm(jg, op, strategy=theirs, **kw_j)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=_tol(spec.op), atol=_tol(spec.op))
            assert (planner.last_plan(op, ours)
                    == jax_planner.last_plan(op, theirs))
            assert planner.last_plan(op, ours) != "kernel"


def test_wrapper_on_cpu_counts_nothing_and_checks_arguments():
    _, tg, B, E = _case("random", 4, 4, "mul")
    Bt, Et = torch.from_numpy(B), torch.from_numpy(E)
    before = binary_reduce_csr.launches
    binary_reduce_csr(tg, Bt, Et, "mul")
    assert binary_reduce_csr.launches == before
    with pytest.raises(ValueError, match="unknown binop"):
        binary_reduce_csr(tg, Bt, Et, "max")
    with pytest.raises(ValueError, match="needs the node operand"):
        binary_reduce_csr(tg, None, Et, "add")
    with pytest.raises(ValueError, match="edge feature dim"):
        binary_reduce(tg, Bt, Et[:, :3], "add")
    with pytest.raises(ValueError, match="sum/mean"):
        binary_reduce(tg, Bt, Et, "add", "max")


@pytest.mark.parametrize("reduce_op,with_deg", [
    (r, w) for r in ("max", "min", "prod", "sum", "mean")
    for w in (True, False) if w or r != "mean"])   # mean needs the degrees
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pull_segment_reducers_match_jax(graph, reduce_op, with_deg):
    """Every reducer, on (E, d) and (E, H, F) messages, with an infinite
    message in the mix; empty rows as JAX gives them."""
    _, tg, _, E = _case(graph, 4, 4, "add", seed=8)
    msgs = [E, E.reshape(-1, 2, 2)]
    if reduce_op in ("max", "min"):
        E = E.copy()
        E[0, 0], E[1, 1] = np.inf, -np.inf
        msgs = [E, E.reshape(-1, 2, 2)]
    tgt = tg.host.dst.astype(np.int64)
    deg = tg.host.in_degrees
    for msg in msgs:
        ref = np.asarray(jax_strategies.pull_segment(
            jnp.asarray(msg), jnp.asarray(tgt), tg.n_dst, reduce_op,
            jnp.asarray(deg) if with_deg else None))
        got = pull_segment(torch.from_numpy(msg), torch.from_numpy(tgt),
                           tg.n_dst, reduce_op,
                           torch.from_numpy(deg) if with_deg else None)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown reduce op"):
        pull_segment(torch.from_numpy(E), torch.from_numpy(tgt), tg.n_dst,
                     "median")
