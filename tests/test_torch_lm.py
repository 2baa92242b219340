"""Port parity for the LM stack's forward and serving paths
(``repro_torch.models.lm`` against ``repro.models.lm``).

Same numpy inputs (seeded), same weights (``from_jax_params`` of
``repro.models.lm.init_params`` at each smoke config), float32:

* per architecture: ``prefill`` logits and caches and two ``decode_step``
  logits and caches (through ``launch.steps``' prefill / decode steps)
  within 1e-4·max|JAX| + 1e-6;
* ``rope_angles`` with M-RoPE, ``blockwise_attention`` with a window, a
  cache length, a tensor ``q_offset`` and padding, ``ssd_chunked`` at
  Q ∈ {4, 8, 32} with and without a carried state, ``_causal_conv`` with
  and without a state, and the MoE routing (``gate_idx``, ``keep``) and
  output at capacity pressure (cf 0.5, so choices drop);
* the SSM / hybrid decode equal to the longer prefill (JAX's 2e-3);
* the serve CLI's greedy tokens equal to JAX's on the llama smoke config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_smoke_config
from repro.launch import serve as jax_serve
from repro.models.lm import layers as jl
from repro.models.lm import mamba2 as jm
from repro.models.lm import model as J
from repro_torch.launch import serve, steps
from repro_torch.models.lm import layers, mamba2, moe
from repro_torch.models.lm import model as T


def close(got, ref, what=""):
    """|got - ref| <= 1e-4·max|ref| + 1e-6, elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * float(np.abs(ref).max(initial=0.0)) + 1e-6
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max err {err:.3g} > tol {tol:.3g}"


def close_tree(got_tree, ref_tree, what=""):
    paths = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree_util.tree_leaves(got_tree)
    assert len(got) == len(paths), what
    for (path, ref), g in zip(paths, got):
        close(g, ref, f"{what}{jax.tree_util.keystr(path)}")


def batch_np(cfg, B=2, S=16, seed=0):
    """tests/models/test_arch_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["positions"] = np.broadcast_to(
            np.arange(S), (3, B, S)).astype(np.int32)
    return batch


_jax_init = jax.jit(J.init_params, static_argnums=1,
                    static_argnames="max_seq")


@functools.lru_cache(maxsize=None)
def jax_case(arch, max_seq=32):
    """(cfg, JAX params, port model on the CPU with the same weights)."""
    cfg = get_smoke_config(arch)
    params = _jax_init(jax.random.PRNGKey(0), cfg, max_seq=max_seq)
    model = T.from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, model


@pytest.mark.parametrize("arch,dtype", [("zamba2_2p7b", "float32"),
                                        ("whisper_medium", "bfloat16")])
def test_weights_round_trip_through_jax_tree(arch, dtype):
    """``from_jax_params`` of JAX's tree (bf16 leaves too) holds its
    values, and ``to_jax_tree`` gives back JAX's names and stacked
    shapes."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = _jax_init(jax.random.PRNGKey(0), cfg, max_seq=32)
    model = T.from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    tree = T.to_jax_tree(model)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_jax(arch):
    cfg, params, model = jax_case(arch)
    B, S, MAX = 2, 8, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mem_j = mem_t = pos_j = pos_t = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        mem_j = jax.jit(functools.partial(J.encode, cfg=cfg))(
            params, frames=jnp.asarray(frames))
        with torch.no_grad():
            mem_t = T.encode(model, torch.from_numpy(frames))
        close(mem_t, mem_j, "memory")
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S), (3, B, S)).astype(np.int32)
        pos_j, pos_t = jnp.asarray(pos), torch.from_numpy(pos)
    cj = J.init_cache(cfg, B, MAX, jnp.float32)
    ct = T.init_cache(cfg, B, MAX, torch.float32, "cpu")
    lj, cj = jax.jit(functools.partial(J.prefill, cfg=cfg))(
        params, tokens=jnp.asarray(tokens), cache=cj, positions=pos_j,
        memory=mem_j)
    extras = {"positions": pos_t, "memory": mem_t}
    lt, ct = steps.make_prefill_step(cfg)(model, torch.from_numpy(tokens),
                                          ct, extras)
    close(lt, lj, "prefill logits")
    close_tree(ct, cj, "prefill cache")
    decode = jax.jit(functools.partial(J.decode_step, cfg=cfg))
    decode_t = steps.make_decode_step(cfg)
    tok = jnp.argmax(lj, -1)
    for step in range(2):
        lj, cj = decode(params, token=tok, cache=cj,
                        pos=jnp.asarray(S + step), memory=mem_j)
        lt, ct = decode_t(model, torch.tensor(np.asarray(tok)), ct,
                          torch.tensor(S + step), extras)
        close(lt, lj, f"decode {step} logits")
        close_tree(ct, cj, f"decode {step} cache")
        tok = jnp.argmax(lj, -1)


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_2p7b"])
def test_ssm_decode_matches_prefill(arch):
    """Prefill then decode == the longer prefill (JAX's 2e-3)."""
    cfg, _, model = jax_case(arch)
    B, S, MAX = 1, 8, 16
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1)))
    full, _ = T.prefill(model, tokens,
                        T.init_cache(cfg, B, MAX, torch.float32, "cpu"))
    _, c2 = T.prefill(model, tokens[:, :S],
                      T.init_cache(cfg, B, MAX, torch.float32, "cpu"))
    step, _ = T.decode_step(model, tokens[:, S], c2, torch.tensor(S))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_rope_angles_mrope():
    rng = np.random.default_rng(3)
    pos3 = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)
    pos2 = pos3[0]
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    for pos, sec in ((pos3, (2, 3, 3)), (pos2, ())):
        aj = jl.rope_angles(jnp.asarray(pos), 16, 1e4, sec)
        at = layers.rope_angles(torch.from_numpy(pos), 16, 1e4, sec)
        close(at, aj, f"angles {sec}")
        close(layers.apply_rope(torch.from_numpy(x), at),
              jl.apply_rope(jnp.asarray(x), aj), "rotated")
    with pytest.raises(ValueError):
        layers.rope_angles(torch.from_numpy(pos3), 16, 1e4, (2, 3))


@pytest.mark.parametrize("window", [0, 5])
def test_blockwise_attention_window_cache_padding(window):
    """Skv = 37 in blocks of 8 (padded), q at absolute offset 20 (a 0-d
    tensor, as decode passes it), a cache length of 30."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 37, 3, 16)).astype(np.float32)
    v = rng.normal(size=(2, 37, 3, 16)).astype(np.float32)
    for causal, kv_len in ((True, 30), (True, None), (False, None)):
        ref = jl.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_offset=jnp.asarray(20),
            kv_len=None if kv_len is None else jnp.asarray(kv_len), block=8)
        got = layers.blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, window=window, q_offset=torch.tensor(20),
            kv_len=None if kv_len is None else torch.tensor(kv_len), block=8)
        close(got, ref, f"causal={causal} kv_len={kv_len}")


@pytest.mark.parametrize("Q", [4, 8, 32])
def test_ssd_chunked(Q):
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 37, 3, 4, 5
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    for init in (None, h0):
        yj, hj = jm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q,
                                h0=None if init is None else jnp.asarray(init))
        yt, ht = mamba2.ssd_chunked(
            *map(torch.from_numpy, (x, dt, A, Bm, Cm)), Q,
            h0=None if init is None else torch.from_numpy(init))
        close(yt, yj, "y")
        close(ht, hj, "final state")


def test_causal_conv_state_is_inputs():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 6, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for state in (None, st):
        yj, sj = jm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if state is None else jnp.asarray(state))
        yt, s_t = mamba2._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if state is None else torch.from_numpy(state))
        close(yt, yj, "conv out")
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(s_t.numpy(), x[:, -3:])


def _jax_routing(p, cfg, x):
    """JAX's routing (``repro/models/lm/moe.py:97-116``, one block)."""
    E, K = cfg.n_experts, cfg.top_k
    T_ = x.shape[0] * x.shape[1]
    Cb = max(1, int(K * T_ * cfg.capacity_factor / E))
    probs = jax.nn.softmax(x.reshape(T_, -1).astype(jnp.float32)
                           @ p["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx.reshape(-1), E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    return np.asarray(gate_idx), np.asarray(jnp.sum(pos * onehot, -1) < Cb)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "granite_moe_3b"])
def test_moe_routing_at_capacity_pressure(arch):
    from repro.models.lm import moe as jmoe
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=0.5)
    _, params, model = jax_case(arch)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    yj, auxj = jax.jit(functools.partial(jmoe.moe_apply, cfg=cfg))(
        p, x=jnp.asarray(x))
    pt = model.blocks[0].moe
    yt, auxt = moe.moe_apply(pt, cfg, torch.from_numpy(x))
    r = moe.moe_route(pt, cfg, torch.from_numpy(x).reshape(32, -1))
    gate_idx, keep = _jax_routing(p, cfg, jnp.asarray(x))
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert not keep.all(), "capacity 0.5 must drop choices"
    close(yt, yj, "y")
    close(auxt, auxj, "aux")


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    _, idx = moe._top_k(probs, 3)
    _, ref = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))


def test_serve_cli_greedy_tokens_match_jax(monkeypatch, capsys):
    """``serve.main`` on the llama smoke config, given JAX's weights for
    the seed, prints the sample line ``repro.launch.serve`` prints: at
    batch 1 and 6 tokens, every generated token."""
    argv = ["--arch", "llama3p2_3b", "--smoke", "--batch", "1",
            "--prompt-len", "12", "--gen", "6", "--seed", "3"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jax_serve.main()
    jax_line = [ln for ln in capsys.readouterr().out.splitlines()
                if "sample tokens" in ln]

    cfg = get_smoke_config("llama3p2_3b")
    params = _jax_init(jax.random.PRNGKey(3), cfg, max_seq=18)
    monkeypatch.setattr(serve, "init_params", lambda cfg, **kw:
                        T.from_jax_params(cfg, jax.tree.map(np.asarray,
                                                            params),
                                          kw["device"]))
    got = serve.main(argv + ["--device", "cpu"])["tokens"]
    port_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if "sample tokens" in ln]
    assert got.shape == (1, 6)
    assert port_line == jax_line == [
        f"[serve] sample tokens[0,:8] = {got[0].tolist()}"]
