"""The backward of ``blockwise_attention`` (``repro_torch.models.lm.layers``)
against JAX's (``repro.models.lm.layers``), whose scan body runs under
``jax.checkpoint(body, nothing_saveable)``.

Same seeded numpy inputs, the cases of ``test_torch_lm.py``'s
``blockwise_attention`` test (Skv = 37 in blocks of 8, padded; q at the
absolute offset 20, a 0-d tensor; causal with and without a cache length
of 30, and not causal; window 0 and 5):

* the gradients of ``sum(out · w)`` (a fixed random ``w``) with respect to
  q, k and v against ``jax.grad`` of JAX's: within 1e-5·max|JAX| + 1e-7
  in float32, within 2e-2·max|JAX| for bfloat16 inputs;
* two grad-enabled calls give bit-equal outputs and gradients, and a
  no-grad call the same output bits;
* each KV block's body runs under ``layers.remat`` exactly when gradients
  are recorded for q, k or v;
* what the forward leaves alive for the backward, at B = 1, H = 2,
  Sq = Skv = 1,024, head_dim 16, block 64 (16 KV blocks): the bytes made
  in the forward and alive after it (``launch.op_analysis.OpAnalysis``),
  output excluded, at most a quarter of every block's scores and
  probabilities (2 × 16 × 0.5 MB; about 2.3 MB of running accumulators
  remain), and no tensor autograd saved outside the checkpoints has a
  block's score shape (B, H, Sq, block).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import layers as jl
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models.lm import layers

CASES = [(causal, kv_len, window) for window in (0, 5)
         for causal, kv_len in ((True, 30), (True, None), (False, None))]
IDS = [f"causal={c}-kv_len={n}-window={w}" for c, n, w in CASES]


def _inputs():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, n, 3, 16)).astype(np.float32)
               for n in (4, 37, 37))
    w = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    return q, k, v, w


def _jax_grads(q, k, v, w, causal, kv_len, window, dtype):
    def loss(q, k, v):
        out = jl.blockwise_attention(
            q, k, v, causal=causal, window=window, q_offset=jnp.asarray(20),
            kv_len=None if kv_len is None else jnp.asarray(kv_len), block=8)
        return jnp.sum(out.astype(jnp.float32) * w), out

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return np.asarray(out.astype(jnp.float32)), [
        np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(q, k, v, w, causal, kv_len, window, dtype, grad=True):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_(grad)
                  for a in (q, k, v))
    out = layers.blockwise_attention(
        qt, kt, vt, causal=causal, window=window, q_offset=torch.tensor(20),
        kv_len=None if kv_len is None else torch.tensor(kv_len), block=8)
    if not out.requires_grad:
        return out, []
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [t.grad for t in (qt, kt, vt)]


def _held(got, ref, rel, floor, what):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * float(np.abs(ref).max()) + floor
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{what}: max err {err:.3g} > tol {tol:.3g}"


@pytest.mark.parametrize("dtype,rel,floor", [
    (torch.float32, 1e-5, 1e-7), (torch.bfloat16, 2e-2, 0.0)],
    ids=["float32", "bfloat16"])
@pytest.mark.parametrize("causal,kv_len,window", CASES, ids=IDS)
def test_grads_match_jax(causal, kv_len, window, dtype, rel, floor):
    q, k, v, w = _inputs()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out_j, grads_j = _jax_grads(q, k, v, w, causal, kv_len, window, jdtype)
    out_t, grads_t = _port(q, k, v, w, causal, kv_len, window, dtype)
    assert out_t.dtype == dtype
    _held(out_t, out_j, rel, floor, "out")
    for name, g_t, g_j in zip("qkv", grads_t, grads_j):
        assert g_t.dtype == dtype
        _held(g_t, g_j, rel, floor, f"d{name}")


@pytest.mark.parametrize("causal,kv_len,window", CASES, ids=IDS)
def test_calls_are_bit_equal(causal, kv_len, window):
    q, k, v, w = _inputs()
    a, b = (_port(q, k, v, w, causal, kv_len, window, torch.float32)
            for _ in range(2))
    for x, y in zip([a[0]] + a[1], [b[0]] + b[1]):
        assert torch.equal(x, y)
    with torch.no_grad():
        out, _ = _port(q, k, v, w, causal, kv_len, window, torch.float32)
    assert torch.equal(out, a[0])


def test_kv_body_checkpointed_while_grads_recorded(monkeypatch):
    """Skv = 37 in blocks of 8: five KV bodies, each through ``remat``
    when q, k or v records gradients, none otherwise."""
    calls = []
    remat = layers.remat

    def counted(fn, *args):
        calls.append(fn.keywords["i"])
        return remat(fn, *args)

    monkeypatch.setattr(layers, "remat", counted)
    q, k, v, w = _inputs()
    _port(q, k, v, w, True, None, 0, torch.float32)
    assert calls == [0, 1, 2, 3, 4]
    calls.clear()
    _port(q, k, v, w, True, None, 0, torch.float32, grad=False)
    with torch.no_grad():
        _port(q, k, v, w, True, None, 0, torch.float32)
    assert calls == []


def test_backward_keeps_no_block_scores():
    B, H, S, Dh, block = 1, 2, 1024, 16, 64
    nblk = S // block
    scores = B * H * S * block * 4          # one KV block's, float32
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen).requires_grad_()
               for _ in range(3))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with OpAnalysis() as oa, torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = layers.blockwise_attention(q, k, v, causal=True, block=block)
    held = oa.live - out.untyped_storage().nbytes()
    accumulators = nblk * B * H * S * (Dh + 2) * 4
    print(f"held {held / 1e6:.3f} MB of the {2 * nblk * scores / 1e6:.1f} MB "
          f"of every block's scores and probabilities; accumulators "
          f"{accumulators / 1e6:.3f} MB")
    assert held <= 2 * nblk * scores / 4, held
    assert (B, H, S, block) not in saved, saved
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
