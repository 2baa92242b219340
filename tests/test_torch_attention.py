"""Port parity for the fused-attention kernel module (B2) and
``core.fused_attention``.

On the CPU the kernel wrapper ``fused_attention_csr`` runs its plain
PyTorch version; it is held against the JAX Pallas megakernel
(``fused_attention(strategy="pallas")``, interpret mode), the JAX
canonical pipeline (``strategy="fused"``) and the oracle
``fused_attention_ref``, at 1e-5 — on random graphs with zero-degree
rows and on a small R-MAT power-law graph. The CUDA branch is exercised
on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edge_softmax import fused_attention as jax_fused_attention
from repro.core.graph import from_coo as jax_from_coo
from repro.kernels.edge_softmax.ref import fused_attention_ref
from repro_torch.core import fused_attention, from_coo
from repro_torch.data.synthetic import rmat_graph
from repro_torch.kernels.edge_softmax.ops import (fused_attention_csr,
                                                  fused_attention_plain)
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5


def _graphs():
    """(name, src, dst, n): random with zero-degree rows and duplicate
    edges, and a small power-law R-MAT graph."""
    rng = np.random.default_rng(11)
    src, dst = random_edges(rng, 80, 80, 150)
    yield "random", src, dst, 80
    src, dst, n = rmat_graph(8, 2000, seed=3)
    yield "rmat", src, dst, n


GRAPHS = {name: (s, d, n) for name, s, d, n in _graphs()}


def _inputs(name, H, F, seed=0):
    src, dst, n = GRAPHS[name]
    rng = np.random.default_rng(seed + H * 100 + F)
    el = rng.normal(size=(n, H)).astype(np.float32)
    er = rng.normal(size=(n, H)).astype(np.float32)
    z = rng.normal(size=(n, H, F)).astype(np.float32)
    jg = jax_from_coo(src, dst, n_src=n, n_dst=n)
    tg = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    return jg, tg, el, er, z


@pytest.mark.parametrize("H,F", [(4, 32), (1, 41), (2, 5)])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_matches_pallas_fused_and_oracle(graph, H, F):
    jg, tg, el, er, z = _inputs(graph, H, F)
    ja = (jnp.asarray(el), jnp.asarray(er), jnp.asarray(z))
    pallas = np.asarray(jax_fused_attention(jg, *ja, strategy="pallas"))
    fused = np.asarray(jax_fused_attention(jg, *ja, strategy="fused"))
    oracle = np.asarray(fused_attention_ref(jg.src, jg.dst, *ja, jg.n_dst))
    got = fused_attention_csr(tg, torch.from_numpy(el), torch.from_numpy(er),
                              torch.from_numpy(z), 0.2).numpy()
    for ref in (pallas, fused, oracle):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_zero_degree_rows_are_zero():
    jg, tg, el, er, z = _inputs("random", 2, 8)
    empty = tg.host.in_degrees == 0
    assert empty.sum() > 10
    got = fused_attention_plain(tg, torch.from_numpy(el),
                                torch.from_numpy(er), torch.from_numpy(z))
    assert torch.isfinite(got).all()
    assert not got.numpy()[empty].any()


def test_rmat_graph_is_power_law():
    src, dst, n = GRAPHS["rmat"]
    deg = np.bincount(dst, minlength=n)
    assert deg.max() > 10 * max(np.median(deg), 1)


@pytest.mark.parametrize("strategy", ["auto", "fused", "kernel"])
def test_core_strategies_agree_and_squeeze(strategy):
    jg, tg, el, er, z = _inputs("rmat", 1, 6)
    ref = np.asarray(jax_fused_attention(jg, jnp.asarray(el[:, 0]),
                                         jnp.asarray(er[:, 0]),
                                         jnp.asarray(z[:, 0]),
                                         strategy="fused"))
    got = fused_attention(tg, torch.from_numpy(el[:, 0]),
                          torch.from_numpy(er[:, 0]),
                          torch.from_numpy(z[:, 0]), strategy=strategy)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_wrapper_on_cpu_counts_nothing_and_pallas_name_raises():
    _, tg, el, er, z = _inputs("random", 1, 4)
    before = fused_attention_csr.launches
    fused_attention_csr(tg, torch.from_numpy(el), torch.from_numpy(er),
                        torch.from_numpy(z))
    assert fused_attention_csr.launches == before
    with pytest.raises(NotImplementedError, match="B2"):
        fused_attention(tg, torch.from_numpy(el), torch.from_numpy(er),
                        torch.from_numpy(z), strategy="pallas")
