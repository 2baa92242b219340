"""Transformer building blocks (port of ``repro/models/lm/layers.py``):
norms, RoPE / M-RoPE, GQA attention, MLP.

Each ``*_init`` builds an ``nn.Module`` whose parameters carry the JAX
tree's names (``wq``, ``w_gate``, ``scale``, ...) on an explicit device
and dtype, drawn from a ``torch.Generator`` (or left uninitialised when
``gen`` is None, for weights copied in afterwards); each ``*_apply`` is
the JAX function's math on such a module. Products promote their operands
as JAX does (``substrate.nn.matmul``).

Attention is blockwise (online softmax over KV chunks of ``block``), as
JAX's ``lax.scan``; sliding-window attention masks within the same loop.
JAX's sharding hints sit at JAX's sites (``_attn_parallel_mode`` picks
them from the ambient mesh); on plain tensors each is the identity. On a
process mesh the steps pass a ``tp.Split`` and :func:`attention_split` /
:func:`mlp_split` run the rank's share of the model axis's work.

A KV cache is updated IN PLACE (the JAX functions return a new one): the
caller's cache tensors hold the new entries afterwards. Positions, the
cache length and ``q_offset`` may be 0-d device tensors; nothing here
reads one back to the host.
"""
from __future__ import annotations

import functools
import types
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.transport import gather_along, reduce_from_group
from ...pjit_utils import ambient_mesh, axis_sizes, current_mesh, shard_hint
from ...substrate.nn import matmul
from .config import ModelConfig
from .tp import Split

__all__ = ["Norm", "Attention", "MLP", "normal", "norm_init", "norm_apply",
           "rope_freqs", "rope_angles", "apply_rope", "attention_init",
           "remat", "blockwise_attention", "attention_kv", "attention_apply",
           "attention_split", "mlp_init", "mlp_apply", "mlp_split"]


def _attn_parallel_mode(cfg: ModelConfig, seq_len: int) -> Optional[str]:
    """The attention sharding strategy for the ambient mesh: 'heads'
    (Megatron TP) when n_heads divides the model axis, else 'context'
    (q sharded on S over 'model', the small GQA K/V gathered) when the
    sequence covers the axis, else None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    m = axis_sizes(mesh).get("model", 1)
    if m <= 1:
        return None
    if cfg.n_heads % m == 0:
        return "heads"
    if seq_len >= m:
        return "context"
    return None


def normal(gen: Optional[torch.Generator], shape, scale: float,
           dtype: torch.dtype, device) -> nn.Parameter:
    """``N(0, 1)·scale`` drawn in float32 on ``device`` from ``gen`` and
    cast to ``dtype`` (JAX's ``(normal(k, shape) * s).astype(dtype)``);
    uninitialised when ``gen`` is None."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter((w * scale).to(dtype))


def _const(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), float32."""

    def __init__(self, d: int, kind: str, device):
        super().__init__()
        self.scale = _const((d,), 1.0, torch.float32, device)
        if kind != "rmsnorm":
            self.bias = _const((d,), 0.0, torch.float32, device)


def norm_init(d: int, kind: str, device) -> Norm:
    return Norm(d, kind, device)


def norm_apply(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if hasattr(p, "bias"):   # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = torch.square(xf - mu).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    else:                    # rmsnorm
        ms = torch.square(xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale
    return y.to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE (+ M-RoPE)
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """(B, S, head_dim/2) rotation angles.

    ``positions``: (B, S) for standard RoPE, or (3, B, S) for M-RoPE where
    the rows are (t, h, w) coordinates and ``sections`` splits the
    head_dim/2 frequency slots among them (qwen2-vl)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    if positions.dim() == 2:
        return positions[..., None].float() * freqs
    if not sections or sum(sections) != head_dim // 2:
        raise ValueError("M-RoPE sections must sum to head_dim/2")
    parts, off = [], 0
    for row, sec in enumerate(sections):
        parts.append(positions[row][..., None].float()
                     * freqs[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh), angles: (B, S, Dh/2). Rotates (even, odd) pairs."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
class Attention(nn.Module):
    """``wq`` (D, Hq, Dh), ``wk`` / ``wv`` (D, Hkv, Dh), ``wo`` (Hq, Dh, D)
    and, with ``qkv_bias``, ``bq`` / ``bk`` / ``bv``."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        D, Dh = cfg.d_model, cfg.head_dim
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        s = D ** -0.5
        self.wq = normal(gen, (D, Hq, Dh), s, dtype, device)
        self.wk = normal(gen, (D, Hkv, Dh), s, dtype, device)
        self.wv = normal(gen, (D, Hkv, Dh), s, dtype, device)
        self.wo = normal(gen, (Hq, Dh, D), s, dtype, device)
        if cfg.qkv_bias:
            self.bq = _const((Hq, Dh), 0.0, dtype, device)
            self.bk = _const((Hkv, Dh), 0.0, dtype, device)
            self.bv = _const((Hkv, Dh), 0.0, dtype, device)


def attention_init(cfg: ModelConfig, dtype, device, gen) -> Attention:
    return Attention(cfg, dtype, device, gen)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    return matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*groups, Dh) by head replication."""
    if groups == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


def remat(fn, *args):
    """``fn(*args)``, checkpointed while gradients are recorded: JAX's
    ``jax.checkpoint`` with ``nothing_saveable``, as
    ``torch.utils.checkpoint`` (non-reentrant). Only ``args`` are kept for
    the backward, which runs ``fn`` again. Two levels use it, nested as
    JAX nests its two: each block of the model (``model._attn_stack`` /
    ``_mamba_stack``) and, inside it, each KV block's body of
    :func:`blockwise_attention`. Neither draws random numbers, so no RNG
    state is kept. The recomputation, which the backward may run on
    another thread, sees the forward's ambient mesh."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh = current_mesh()

    def run(*a):
        with ambient_mesh(mesh):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _kv_block(q32, kblk, vblk, acc, m, denom, *, i: int, block: int, qpos,
              causal: bool, window: int, kv_len, Skv: int, pad: int,
              reduce_scores):
    """One KV block of :func:`blockwise_attention` (JAX's scan ``body``):
    the block's scores, masked, folded into the running ``(acc, m,
    denom)``. ``kblk`` / ``vblk`` come in their own dtype and are cast
    here, as JAX's body casts them; the scores and probabilities are
    locals, alive only while the body runs."""
    kpos = i * block + torch.arange(block, device=q32.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kblk.float())
    if reduce_scores is not None:
        s = reduce_scores(s)
    mask = torch.ones((q32.shape[1], block), dtype=torch.bool,
                      device=q32.device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    if pad:
        mask = mask & (kpos[None, :] < Skv)
    s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    denom = denom * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               vblk.float())
    return acc, m_new, denom


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0, q_offset=0,
                        kv_len: Optional[torch.Tensor] = None,
                        block: int = 512, scale_dim: Optional[int] = None,
                        reduce_scores=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``block``.

    q: (B, Sq, H, Dh); k/v: (B, Skv, H, Dh) (kv heads already repeated).
    ``q_offset``: absolute position of q[0] (an int or a 0-d tensor).
    ``kv_len``: optional valid length of the KV (cache decoding).
    ``window``: sliding-window size (0 = unlimited). Masked scores are
    -1e30, JAX's constant, so a chunk masked whole is wiped by the next
    chunk's correction exactly as in JAX. ``scale_dim``: the head dim of
    the 1/sqrt scale (default q's); ``reduce_scores``: applied to each
    block's scores before masking (the sum over 'model' of a head_dim
    split's partial q·k; only a decode call sets it, and a recompute
    would post it again, as GSPMD's remat does).

    Each KV block's body (:func:`_kv_block`) runs under :func:`remat`
    while gradients are recorded for q, k or v, as JAX's runs under
    ``jax.checkpoint(body, nothing_saveable)``: the backward keeps only
    the running ``(acc, m, denom)`` before each block and the block's
    inputs (views of k / v), and recomputes each block's scores and
    probabilities."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    dev = q.device
    nblk = -(-Skv // block)
    pad = nblk * block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q32 = q.float() * (scale_dim or Dh) ** -0.5
    qpos = q_offset + torch.arange(Sq, device=dev)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), -1e30, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    for i in range(nblk):
        body = functools.partial(
            _kv_block, i=i, block=block, qpos=qpos, causal=causal,
            window=window, kv_len=kv_len, Skv=Skv, pad=pad,
            reduce_scores=reduce_scores)
        xs = (q32, k[:, i * block:(i + 1) * block],
              v[:, i * block:(i + 1) * block], acc, m, denom)
        acc, m, denom = remat(body, *xs) if grad else body(*xs)
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)          # (B, Sq, H, Dh)


def attention_kv(p: Attention, cfg: ModelConfig, src: torch.Tensor):
    """K/V projection only (cross-attention K/V are projected once at
    prefill and read from the cache at decode)."""
    k = _proj(src, p.wk)
    v = _proj(src, p.wv)
    if hasattr(p, "bk"):
        k = k + p.bk
        v = v + p.bv
    return k, v


def _cache_write(cache: Dict, k: torch.Tensor, v: torch.Tensor):
    """Write k / v at ``cache["len"]`` onwards, in place; returns the
    whole cached K / V and the new length (a device tensor)."""
    idx = cache["len"]
    rows = (idx + torch.arange(k.shape[1], device=k.device)).long()
    cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
    new_len = idx + k.shape[1]
    cache["len"].copy_(new_len)
    return cache["k"], cache["v"], new_len


def attention_apply(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    angles: Optional[torch.Tensor], *, causal: bool = True,
                    memory: Optional[torch.Tensor] = None, kv_override=None,
                    cache: Optional[Dict] = None, q_offset=0,
                    block: int = 512) -> torch.Tensor:
    """Self- or cross-attention with an optional KV cache.

    ``memory``: encoder output for cross-attention (keys/values from it).
    ``kv_override``: precomputed (k, v) — skips the K/V projections.
    ``cache``: {"k", "v": (B, Smax, Hkv, Dh), "len": 0-d} — updated in
    place."""
    groups = cfg.n_heads // cfg.n_kv_heads
    q = _proj(x, p.wq)
    if hasattr(p, "bq"):
        q = q + p.bq
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = attention_kv(p, cfg, memory if memory is not None else x)
    mode = _attn_parallel_mode(cfg, q.shape[1])
    if mode == "heads":
        q = shard_hint(q, "data", None, "model", None)
        # GQA K/V heads rarely divide the axis: replicate them
        k = shard_hint(k, "data", None, None, None)
        v = shard_hint(v, "data", None, None, None)
    elif mode == "context":
        # context parallel: q sharded on sequence, K/V gathered (small)
        q = shard_hint(q, "data", "model", None, None)
        k = shard_hint(k, "data", None, None, None)
        v = shard_hint(v, "data", None, None, None)
    if angles is not None and memory is None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    kv_len = None
    if cache is not None:
        k, v, kv_len = _cache_write(cache, k, v)
    out = blockwise_attention(q, _repeat_kv(k, groups),
                              _repeat_kv(v, groups), causal=causal,
                              window=cfg.sliding_window, q_offset=q_offset,
                              kv_len=kv_len, block=block)
    return matmul(out.flatten(2), p.wo.reshape(-1, p.wo.shape[-1]))


# --------------------------------------------------------------------- #
# attention over the model axis (tp.Split)
# --------------------------------------------------------------------- #
def _split_kv(p: Attention, cfg: ModelConfig, src: torch.Tensor,
              sp: Split):
    """K / V of ``src`` in the split's compute layout: the rank's K/V
    heads, its head_dim slice, or every head (whole weights: for the
    rank's own share of the work, or, 'replicated', the same work on
    every rank)."""
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    if sp.kv_chunked:
        def w(t, d):
            return sp.tp(t, d, Hkv)
    elif sp.attn == "head_dim":
        def w(t, d):
            return sp.tp(t, d + 1, Dh)
    elif sp.attn == "replicated":
        def w(t, d):
            return t
    else:
        def w(t, d):
            return sp.part(t)
    k, v = _proj(src, w(p.wk, 1)), _proj(src, w(p.wv, 1))
    if hasattr(p, "bk"):
        k = k + w(p.bk, 0)
        v = v + w(p.bv, 0)
    return k, v


def _for_q_heads(k: torch.Tensor, cfg: ModelConfig, sp: Split
                 ) -> torch.Tensor:
    """K (or V) repeated for the query heads the rank runs: under 'heads'
    with every K/V head at hand, the ones its query heads read."""
    groups = cfg.n_heads // cfg.n_kv_heads
    if sp.attn != "heads" or sp.kv_chunked:
        return _repeat_kv(k, groups)
    q0, hq = sp.chunk(cfg.n_heads)
    kv0, kv1 = q0 // groups, (q0 + hq - 1) // groups + 1
    return _repeat_kv(k[:, :, kv0:kv1], groups).narrow(
        2, q0 - kv0 * groups, hq)


def _cache_shard(t: torch.Tensor, layout: Optional[int], cfg: ModelConfig,
                 sp: Split) -> torch.Tensor:
    """This rank's shard, in a cache sharded on heads (2) or head_dim (3)
    or whole, of K / V held in the compute layout."""
    if layout == 2 and t.shape[2] == cfg.n_kv_heads:
        return sp.tp(t, 2, cfg.n_kv_heads)
    if layout == 3 and t.shape[3] == cfg.head_dim:
        return sp.tp(t, 3, cfg.head_dim)
    return t


def _seq_shard_write(buf: torch.Tensor, t: torch.Tensor, start,
                     sp: Split) -> None:
    """Write ``t`` (B, S, H, Dh), at cache positions ``start`` onwards,
    into ``buf``: the rank's chunk (B, n, H, Dh) of a cache sharded on the
    sequence, which holds positions r·n … r·n + n - 1."""
    n, S = buf.shape[1], t.shape[1]
    j = sp.r * n + torch.arange(n, device=buf.device) - start
    ok = ((j >= 0) & (j < S))[None, :, None, None]
    rows = t.index_select(1, j.clamp(0, S - 1).long()).to(buf.dtype)
    buf.copy_(torch.where(ok, rows, buf))


def attention_split(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                    angles: Optional[torch.Tensor], sp: Split, *,
                    causal: bool = True, cache: Optional[Dict] = None,
                    q_offset=0, memory: Optional[torch.Tensor] = None,
                    cross: bool = False, block: int = 512) -> torch.Tensor:
    """The rank's share of self- or (``cross``) cross-attention under the
    split ``sp`` (``tp`` module docstring): ``x`` in the residual layout
    (the rank's rows under ``sp.sp``), the output in the same layout.

    ``cache``: the rank's shards of the layer's cache (``k`` / ``v`` /
    ``len``, or ``cross_k`` / ``cross_v``), written in place in their
    layouts ``sp.kv`` / ``sp.cross``. Where the cache holds what the rank
    attends over (its heads, its head_dim slice, or all) it attends over
    the cache, as one card does; else (a prefill writing a sequence- or
    head_dim-sharded cache) over the K / V it computed, which is the
    same from an empty cache. ``memory``: the encoder output, whole on
    every rank (cross-attention K / V from it; at decode they are read
    from the cache)."""
    Hq, Dh = cfg.n_heads, cfg.head_dim
    mode = sp.attn
    wo = p.wo.reshape(-1, p.wo.shape[-1])
    if mode == "heads":
        x = sp.enter(x)
        q = _proj(x, sp.tp(p.wq, 1, Hq))
        bq = sp.tp(p.bq, 0, Hq) if hasattr(p, "bq") else None
    elif mode == "head_dim":
        q = _proj(x, sp.tp(p.wq, 2, Dh))
        bq = sp.tp(p.bq, 1, Dh) if hasattr(p, "bq") else None
    else:
        wq = sp.part(p.wq) if mode == "context" else p.wq
        q = _proj(x, wq)
        bq = None if not hasattr(p, "bq") else (
            sp.part(p.bq) if mode == "context" else p.bq)
    if bq is not None:
        q = q + bq
    if mode == "context":
        q_offset = q_offset + sp.r * x.shape[1]
        if angles is not None:
            angles = sp.seq_chunk(angles)
    elif mode == "head_dim" and angles is not None:
        start, n = sp.chunk(Dh)
        angles = angles[..., start // 2:(start + n) // 2]
    kv_len = None
    if cross:
        if memory is not None:
            k, v = _split_kv(p, cfg, memory, sp)
            if cache is not None:
                cache["cross_k"].copy_(_cache_shard(k, sp.cross, cfg, sp))
                cache["cross_v"].copy_(_cache_shard(v, sp.cross, cfg, sp))
        else:
            k, v = cache["cross_k"], cache["cross_v"]
    else:
        k, v = _split_kv(p, cfg, x, sp)
        if angles is not None:
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        if mode == "context":
            k = gather_along(k, sp.group, 1)
            v = gather_along(v, sp.group, 1)
        if cache is not None:
            if sp.kv == 1:
                _seq_shard_write(cache["k"], k, cache["len"], sp)
                _seq_shard_write(cache["v"], v, cache["len"], sp)
                cache["len"].copy_(cache["len"] + k.shape[1])
            else:
                ks = _cache_shard(k, sp.kv, cfg, sp)
                vs = _cache_shard(v, sp.kv, cfg, sp)
                ck, cv, new_len = _cache_write(cache, ks, vs)
                if ks is k:     # the cache holds what this rank reads
                    k, v, kv_len = ck, cv, new_len
    reduce = None
    if mode == "head_dim":
        def reduce(s):
            return reduce_from_group(s, sp.group)
    out = blockwise_attention(q, _for_q_heads(k, cfg, sp),
                              _for_q_heads(v, cfg, sp), causal=causal,
                              window=cfg.sliding_window,
                              q_offset=q_offset, kv_len=kv_len, block=block,
                              scale_dim=Dh, reduce_scores=reduce)
    if mode == "heads":
        return sp.exit(matmul(out.flatten(2), sp.tp(p.wo, 0, Hq).reshape(
            -1, wo.shape[-1])))
    if mode == "head_dim":
        return reduce_from_group(matmul(out.flatten(2), sp.tp(
            p.wo, 1, Dh).reshape(-1, wo.shape[-1])), sp.group)
    return matmul(out.flatten(2), sp.part(wo) if mode == "context" else wo)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``,
    ``b_up``, ``w_down``, ``b_down``)."""

    def __init__(self, d: int, ff: int, act: str, dtype, device, gen):
        super().__init__()
        s_in, s_out = d ** -0.5, ff ** -0.5
        if act == "swiglu":
            self.w_gate = normal(gen, (d, ff), s_in, dtype, device)
            self.w_up = normal(gen, (d, ff), s_in, dtype, device)
            self.w_down = normal(gen, (ff, d), s_out, dtype, device)
        else:
            self.w_up = normal(gen, (d, ff), s_in, dtype, device)
            self.b_up = _const((ff,), 0.0, dtype, device)
            self.w_down = normal(gen, (ff, d), s_out, dtype, device)
            self.b_down = _const((d,), 0.0, dtype, device)


def mlp_init(d: int, ff: int, act: str, dtype, device, gen) -> MLP:
    return MLP(d, ff, act, dtype, device, gen)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "w_gate"):
        return matmul(F.silu(matmul(x, p.w_gate)) * matmul(x, p.w_up),
                      p.w_down)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(matmul(x, p.w_up) + p.b_up, approximate="tanh")
    return matmul(h, p.w_down) + p.b_down


def mlp_split(p: MLP, x: torch.Tensor, sp: Split) -> torch.Tensor:
    """The rank's share of the MLP under ``sp``: TP over d_ff when the
    axis divides it (the whole sequence in, the partial sums reduced to
    the residual layout, ``b_down`` added on the rank's rows), else the
    whole MLP on the rank's rows."""
    if not sp.mlp_tp:
        return mlp_apply(types.SimpleNamespace(**{
            n: sp.rows(t) for n, t in p.named_parameters()}), x)
    ff = sp.cfg.d_ff
    x = sp.enter(x)
    if hasattr(p, "w_gate"):
        h = F.silu(matmul(x, sp.tp(p.w_gate, 1, ff))) * matmul(
            x, sp.tp(p.w_up, 1, ff))
        return sp.exit(matmul(h, sp.tp(p.w_down, 0, ff)))
    h = F.gelu(matmul(x, sp.tp(p.w_up, 1, ff)) + sp.tp(p.b_up, 0, ff),
               approximate="tanh")
    return sp.exit(matmul(h, sp.tp(p.w_down, 0, ff))) + sp.rows(p.b_down)
