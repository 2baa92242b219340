"""Port parity for the edge-softmax kernel module (B5) and the two edge
softmaxes of ``core.edge_softmax``.

On the CPU the kernel wrapper ``edge_softmax_csr`` runs its plain
PyTorch version. Both are held against the JAX Pallas kernel
(``repro.kernels.edge_softmax.ops.edge_softmax``, interpret mode) and its
``ref.py`` oracle at H = 4 and 1 and for 1-D logits, on a random graph
with zero-degree rows and duplicate edges and on a small R-MAT graph. The
port's composed ``edge_softmax`` and single-pass ``edge_softmax_fused``
are held against JAX's under every strategy. Tolerance 1e-5 (fp32). The
CUDA branch is exercised on the card by ``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edge_softmax import edge_softmax as jax_edge_softmax
from repro.core.edge_softmax import edge_softmax_fused as jax_es_fused
from repro.core import planner as jax_planner
from repro.core.graph import from_coo as jax_from_coo
from repro.kernels.edge_softmax.ops import edge_softmax as jax_es_pallas
from repro.kernels.edge_softmax.ref import edge_softmax_ref
from repro_torch.core import (edge_softmax, edge_softmax_fused, from_coo,
                              planner)
from repro_torch.core.edge_softmax import ATTN_STRATEGIES
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.edge_softmax.ops import (edge_softmax_csr,
                                                  edge_softmax_plain)
from tests.graphgen import random_edges
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5


def _graphs():
    """(name, src, dst, n): random with zero-degree rows and duplicate
    edges, and a small power-law R-MAT graph."""
    rng = np.random.default_rng(41)
    src, dst = random_edges(rng, 90, 90, 200)
    yield "random", src, dst, 90
    src, dst, n = rmat_graph(8, 2000, seed=6)
    yield "rmat", src, dst, n


GRAPHS = {name: rest for name, *rest in _graphs()}


def _case(name, H, seed=0):
    src, dst, n = GRAPHS[name]
    jg = jax_from_coo(src, dst, n_src=n, n_dst=n)
    tg = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    rng = np.random.default_rng(seed + (H or 0))
    shape = (len(src),) if H is None else (len(src), H)
    return jg, tg, (3 * rng.normal(size=shape)).astype(np.float32)


def _row_sums_are_one(tg, alpha):
    a = alpha.reshape(tg.n_edges, -1)
    sums = np.zeros((tg.n_dst, a.shape[1]))
    np.add.at(sums, tg.host.dst, a[tg.host.eid])
    has = tg.host.in_degrees > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H", [4, 1, None])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_and_wrapper_match_pallas_and_oracle(graph, H):
    jg, tg, x = _case(graph, H)
    xj = jnp.asarray(x)
    pallas = np.asarray(jax_es_pallas(jg, xj))
    x2 = xj if H is not None else xj[:, None]
    dst_caller = jnp.take(jg.dst, jg.eid_inv)
    oracle = np.asarray(edge_softmax_ref(dst_caller, x2, tg.n_dst))
    oracle = oracle.reshape(pallas.shape)
    xt = torch.from_numpy(x if H is not None else x[:, None])
    for got in (edge_softmax_csr(tg, xt), edge_softmax_plain(tg, xt)):
        got = got.numpy().reshape(pallas.shape)
        for ref in (pallas, oracle):
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        _row_sums_are_one(tg, got)


@pytest.mark.parametrize("H", [4, 1, None])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_composed_and_fused_match_jax(graph, H):
    jg, tg, x = _case(graph, H, seed=5)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for jstrat in ("segment", "auto"):
        ref = np.asarray(jax_edge_softmax(jg, xj, strategy=jstrat))
        for strategy in ("auto", "segment", "kernel"):
            got = edge_softmax(tg, xt, strategy=strategy)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                       err_msg=f"composed/{strategy}")
    ref = np.asarray(jax_es_fused(jg, xj))
    for strategy in ATTN_STRATEGIES:
        got = edge_softmax_fused(tg, xt, strategy=strategy)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=f"fused/{strategy}")


def test_composed_max_runs_on_segment_under_kernel(monkeypatch,
                                                  fresh_fallback_warnings):
    """'kernel' goes to all five ops, as JAX hands its strategy on; no
    kernel computes the max, so it falls back down the planner's chain
    (to the blocked pull, where JAX's 'pallas' lands it) with a warning,
    and never raises."""
    mod = importlib.import_module("repro_torch.core.edge_softmax")
    jg, tg, x = _case("random", 4)
    seen = []
    real = mod.gspmm
    monkeypatch.setattr(mod, "gspmm", lambda g, op, **kw: seen.append(
        (op, kw["strategy"])) or real(g, op, **kw))
    with pytest.warns(UserWarning, match="falling back"):
        got = edge_softmax(tg, torch.from_numpy(x), strategy="kernel")
    assert seen == [("e_copy_max_v", "kernel"), ("e_sub_v_copy_e", "kernel"),
                    ("e_copy_add_v", "kernel"), ("e_div_v_copy_e", "kernel")]
    ref = jax_edge_softmax(jg, jnp.asarray(x), strategy="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert (planner.last_plan("e_copy_max_v", "kernel")
            == jax_planner.last_plan("e_copy_max_v", "pallas") == "ell")


def test_wrapper_on_cpu_counts_nothing_and_pallas_name_raises():
    _, tg, x = _case("random", 4)
    xt = torch.from_numpy(x)
    before = edge_softmax_csr.launches
    torch.testing.assert_close(edge_softmax_csr(tg, xt),
                               edge_softmax_plain(tg, xt), rtol=0, atol=0)
    assert edge_softmax_csr.launches == before
    torch.testing.assert_close(   # 'pallas' names the kernel route
        edge_softmax_fused(tg, xt, strategy="pallas"),
        edge_softmax_fused(tg, xt, strategy="kernel"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown strategy"):
        edge_softmax_fused(tg, xt, strategy="segment")
