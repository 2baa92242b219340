"""Port parity for int8 compression with error feedback
(``repro_torch/optim/compression.py``) against the JAX package's
(``repro/optim/compression.py``), on the same numpy inputs:

* ``int8_compress``: ``q`` equal element for element and the scales
  equal (both round half to even and divide in fp32), on fp32 and bf16
  inputs, ragged and exact block counts, all-zero blocks and ties;
* ``int8_decompress``, ``quantize_with_feedback`` and
  ``compress_payload`` (value and residual) within 1e-6;
* ``compress_payload``'s straight-through gradient, against ``jax.grad``;
* ``wire_bytes``, ``compressed_allreduce_terms`` and
  ``init_error_feedback``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim import compression as tc
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-6
SHAPES = [(5,), (256,), (300, 7), (3, 4, 50), (2, 256)]
BLOCK_STEP = 64     # every 64th tie is the block's maximum


def _input(shape, seed, kind):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    if kind == "zeros":
        x[...] = 0
    elif kind == "ties":        # k + 0.5 steps of a block's scale
        flat = x.reshape(-1)
        flat[:] = (np.arange(flat.size) % 9 - 4) + 0.5
        flat[::BLOCK_STEP] = 127.0
    elif kind == "spiky":
        x.reshape(-1)[::37] *= 1e4
    return x


@pytest.mark.parametrize("kind", ["normal", "zeros", "ties", "spiky"])
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_compress_equal_to_jax(shape, kind):
    x = _input(shape, 0, kind)
    jq, js = jc.int8_compress(jnp.asarray(x))
    tq, ts = tc.int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_compress_bf16_equal_to_jax(shape):
    x = _input(shape, 1, "normal")
    jq, js = jc.int8_compress(jnp.asarray(x).astype(jnp.bfloat16))
    tq, ts = tc.int8_compress(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", SHAPES)
def test_decompress_and_feedback_match_jax(shape):
    x = _input(shape, 2, "normal")
    r = (np.random.default_rng(3).normal(size=shape) * 0.01).astype(
        np.float32)
    jq, js = jc.int8_compress(jnp.asarray(x))
    tq, ts = tc.int8_compress(torch.from_numpy(x))
    np.testing.assert_allclose(
        tc.int8_decompress(tq, ts, shape, torch.float32).numpy(),
        np.asarray(jc.int8_decompress(jq, js, shape, jnp.float32)),
        rtol=TOL, atol=TOL)
    want = jc.quantize_with_feedback(jnp.asarray(x), jnp.asarray(r))
    got = tc.quantize_with_feedback(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 7), (64, 16)])
def test_compress_payload_matches_jax(shape, dtype):
    x = _input(shape, 4, "normal")
    r = (np.random.default_rng(5).normal(size=shape) * 0.01).astype(
        np.float32)
    jy, jr = jc.compress_payload(jnp.asarray(x).astype(dtype),
                                 jnp.asarray(r))
    ty, tr = tc.compress_payload(torch.from_numpy(x).to(
        getattr(torch, dtype)), torch.from_numpy(r))
    assert ty.dtype == getattr(torch, dtype) and tr.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=TOL,
                               atol=TOL)
    assert not tr.requires_grad


def test_compress_payload_is_straight_through():
    """The quantizer is the identity to autograd: ∂Σ(y·c)/∂x = c, and
    ``jax.grad`` of the same function agrees."""
    x = _input((300, 7), 6, "normal")
    c = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    r = np.zeros_like(x)

    def jf(z):
        return jnp.sum(jc.compress_payload(z, jnp.asarray(r))[0]
                       * jnp.asarray(c))

    xt = torch.from_numpy(x).requires_grad_()
    y, res = tc.compress_payload(xt, torch.from_numpy(r))
    (gt,) = torch.autograd.grad((y * torch.from_numpy(c)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), c, rtol=0, atol=0)
    np.testing.assert_allclose(gt.numpy(),
                               np.asarray(jax.grad(jf)(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    assert y.requires_grad and not res.requires_grad


@pytest.mark.parametrize("comm", ["none", "int8"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 10_000])
def test_wire_bytes_match_jax(n, itemsize, comm):
    assert tc.wire_bytes(n, itemsize, comm) == jc.wire_bytes(n, itemsize,
                                                              comm)


def test_allreduce_terms_and_feedback_state_match_jax():
    shapes = [(602, 16), (16,), (16, 41), (41,), (3, 5, 7)]
    rng = np.random.default_rng(8)
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jtree = {"layers": [{"w": jnp.asarray(a)} for a in leaves]}
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(a)) for a in leaves])
    want = jc.compressed_allreduce_terms(jtree)
    assert tc.compressed_allreduce_terms(module) == want
    assert tc.compressed_allreduce_terms(
        {"layers": [{"w": torch.from_numpy(a)} for a in leaves]}) == want
    state = tc.init_error_feedback(module)
    jstate = jc.init_error_feedback(jtree)
    assert [tuple(t.shape) for t in state.residual] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(jstate.residual)]
    assert all(t.dtype == torch.float32 and not t.any()
               for t in state.residual)
