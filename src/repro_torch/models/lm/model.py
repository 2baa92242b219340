"""TransformerLM — one composable model for the ten assigned archs (port
of ``repro/models/lm/model.py``).

Families:
  dense   — uniform (attn + MLP) blocks (qwen2 / llama / internlm2)
  moe     — (attn + MoE) blocks (mixtral / granite-moe)
  ssm     — Mamba2 blocks (mamba2-1.3b)
  hybrid  — groups of Mamba2 blocks, each followed by ONE weight-shared
            attention block (every ``shared_attn_every`` layers; zamba2)
  encdec  — encoder stack + decoder stack with cross-attention (whisper;
            the frontend is a stub supplying frame embeddings)
  vlm     — dense with M-RoPE 3-D positions (qwen2-vl; stub frontend)

The model is an ``nn.Module`` (:class:`LM`) whose parameter names are the
JAX tree's, with one module per layer in a ``ModuleList`` where JAX stacks
the layers on a leading L axis; :func:`from_jax_params` and
:func:`to_jax_tree` carry weights across. JAX's
``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant) while
gradients are recorded, at JAX's two levels through one helper
(``layers.remat``): each block, and inside it each KV block's body of
``layers.blockwise_attention`` (JAX's ``jax.checkpoint(body,
nothing_saveable)``). Recomputing gives the same values, so it changes no
result (the recomputation runs under the ambient mesh of the forward,
which the MoE's token blocks read). JAX's residual and logits
sharding hints sit at JAX's sites; on plain tensors they are the
identity. On a process mesh the steps pass ``split=`` (a ``tp.Split``):
the blocks, the embedding, the head and the CE then run the rank's
share of the model axis's work (``tp`` module docstring): attention,
the MLP, the MoE FFN (``moe.moe_split``) and the Mamba2 mixer
(``mamba2.mamba2_split``, on the rank's shards of its state). There the
model is a ``launch.fsdp.ShardedLM`` of shards: each block's leaves are
gathered inside its checkpointed function (:func:`_gathered`), and the
other leaves at their use.

Caches (:func:`init_cache`) have JAX's layout, stacked per layer, and
:func:`prefill` / :func:`decode_step` update them IN PLACE and return them.
"""
from __future__ import annotations

import functools
import types
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.transport import (all_gather_cat, copy_to_group, gather_along,
                               gather_blocks, reduce_from_group)
from ...device import DeviceLike, resolve_device
from ...pjit_utils import shard_hint
from ...substrate.nn import matmul
from .config import ModelConfig
from .layers import (Attention, MLP, Norm, attention_apply, attention_kv,
                     attention_split, mlp_apply, mlp_split, norm_apply,
                     normal, remat as _remat, rope_angles)
from .mamba2 import Mamba2, mamba2_apply, mamba2_split
from .moe import MoE, moe_apply, moe_split
from .tp import Split

__all__ = ["LM", "lm_dtype", "init_params", "from_jax_params",
           "to_jax_tree", "from_jax_tree", "embed_tokens", "logits_fn",
           "chunked_ce_loss", "backbone", "encode", "loss_fn", "init_cache",
           "prefill", "decode_step"]

_STACKS = ("blocks", "enc_blocks")


def lm_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _residual_hint(h):
    """Residual-stream sharding between blocks: sequence-sharded over
    'model' (Megatron-SP), d_model-sharded for short (decode) calls. On a
    process mesh the split keeps the rank's rows of the sequence wherever
    the model axis divides it, else the whole residual on every 'model'
    rank (``tp`` module docstring): the layout changes no value."""
    if h.shape[1] >= 16:
        return shard_hint(h, "data", "model", None)
    return shard_hint(h, "data", None, "model")


# --------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------- #
class AttnBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp`` or ``moe``; a decoder block
    (``kind="cross"``) adds ``norm_x`` and ``xattn``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, gen):
        super().__init__()
        D = cfg.d_model
        self.norm1 = Norm(D, cfg.norm, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.norm2 = Norm(D, cfg.norm, device)
        if kind == "moe":
            self.moe = MoE(cfg, dtype, device, gen)
        else:
            self.mlp = MLP(D, cfg.d_ff, cfg.act, dtype, device, gen)
        if kind == "cross":
            self.norm_x = Norm(D, cfg.norm, device)
            self.xattn = Attention(cfg, dtype, device, gen)


class MambaBlock(nn.Module):
    """``norm`` and ``mixer``."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        self.norm = Norm(cfg.d_model, cfg.norm, device)
        self.mixer = Mamba2(cfg, dtype, device, gen)


_KIND = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "mamba",
         "hybrid": "mamba", "encdec": "cross"}


class LM(nn.Module):
    """The model of one config on ``device``; weights drawn there from a
    ``torch.Generator`` seeded with ``seed`` (``init=False`` leaves them
    uninitialised, for weights copied in). ``max_seq`` sizes the decoder's
    learned positions (encdec only), as JAX's ``init_params``."""

    def __init__(self, cfg: ModelConfig, *, max_seq: int = 0,
                 device: DeviceLike = "cuda", seed: int = 0,
                 init: bool = True):
        super().__init__()
        if cfg.family not in _KIND:
            raise ValueError(cfg.family)
        dev = resolve_device(device)
        dtype = lm_dtype(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed) if init else None
        D, V, kind = cfg.d_model, cfg.vocab, _KIND[cfg.family]
        self.cfg = cfg

        def block(k):
            return (MambaBlock(cfg, dtype, dev, gen) if k == "mamba"
                    else AttnBlock(cfg, k, dtype, dev, gen))

        self.embed = normal(gen, (V, D), 0.02, dtype, dev)
        self.final_norm = Norm(D, cfg.norm, dev)
        if not cfg.tie_embeddings:
            self.lm_head = normal(gen, (V, D), 0.02, dtype, dev)
        self.blocks = nn.ModuleList(block(kind) for _ in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared = block("dense")
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                block("dense") for _ in range(cfg.n_enc_layers))
            self.enc_pos = normal(gen, (cfg.enc_seq, D), 0.02, dtype, dev)
            self.dec_pos = normal(gen, (max(max_seq, 8), D), 0.02, dtype,
                                  dev)
            self.enc_final_norm = Norm(D, cfg.norm, dev)

    @property
    def head(self) -> torch.Tensor:
        """The output table: ``lm_head``, or ``embed`` when tied."""
        return self.lm_head if hasattr(self, "lm_head") else self.embed


def init_params(cfg: ModelConfig, *, seed: int = 0, max_seq: int = 0,
                device: DeviceLike = "cuda") -> LM:
    """JAX's ``init_params(key, cfg, max_seq=)``: a new :class:`LM`."""
    return LM(cfg, max_seq=max_seq, device=device, seed=seed)


# --------------------------------------------------------------------- #
# weights carried across: JAX's tree stacks layers on a leading L axis
# --------------------------------------------------------------------- #
def _jax_path(name: str):
    """``blocks.3.attn.wq`` -> (("blocks", "attn", "wq"), 3)."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def to_jax_tree(model: LM, tensors=None, stack=torch.stack) -> Dict:
    """JAX's parameter tree of ``model`` (nested dicts, layers stacked):
    of its parameters, or of ``tensors``, one per parameter in
    ``model.parameters()`` order (grads, AdamW moments); ``stack`` makes a
    stacked leaf of its layers' values (a mesh state stacks shards)."""
    if tensors is None:
        tensors = [p.detach() for p in model.parameters()]
    tree: Dict = {}
    stacks: Dict = {}
    for (name, _), t in zip(model.named_parameters(), tensors):
        path, layer = _jax_path(name)
        if layer is None:
            _put(tree, path, t)
        else:
            stacks.setdefault(path, []).append(t)
    for path, ts in stacks.items():
        _put(tree, path, stack(ts))
    return tree


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def from_jax_tree(model: LM, tree: Dict, shapes=None) -> list:
    """The inverse of :func:`to_jax_tree`: one tensor per parameter of
    ``model``, in ``model.parameters()`` order, from a tree of tensors or
    numpy arrays (JAX's bfloat16 ones too), each checked against its
    parameter's shape or its entry of ``shapes`` (a mesh state's local
    shard shapes)."""
    out = []
    if shapes is None:
        shapes = [p.shape for p in model.parameters()]
    for (name, _), shape in zip(model.named_parameters(), shapes):
        path, layer = _jax_path(name)
        leaf = functools.reduce(lambda t, k: t[k], path, tree)
        if isinstance(leaf, np.ndarray):
            leaf = (torch.tensor(leaf.view(np.int16)).view(torch.bfloat16)
                    if leaf.dtype.name == "bfloat16" else torch.tensor(leaf))
        if layer is not None:
            leaf = leaf[layer]
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(leaf.shape)}, "
                             f"model wants {tuple(shape)}")
        out.append(leaf)
    return out


def from_jax_params(cfg: ModelConfig, tree: Dict,
                    device: DeviceLike = "cuda") -> LM:
    """The port's model holding JAX's parameter tree ``tree`` (numpy
    arrays or tensors, layers stacked, ``"shared"`` unstacked)."""
    max_seq = tree["dec_pos"].shape[0] if "dec_pos" in tree else 0
    model = LM(cfg, max_seq=max_seq, device=device, init=False)
    with torch.no_grad():
        for p, v in zip(model.parameters(), from_jax_tree(model, tree)):
            p.copy_(v)
    return model


# --------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------- #
def _norm(p: Norm, h, split: Optional[Split]):
    """``norm_apply``; on the residual's rows under a split, its scale and
    bias enter through ``Split.part``."""
    if split is None or not split.sp:
        return norm_apply(p, h)
    return norm_apply(types.SimpleNamespace(**{
        n: split.part(t) for n, t in p.named_parameters()}), h)


def _attn_block_split(bp: AttnBlock, cfg: ModelConfig, h, angles, split,
                      *, causal, memory, cache, q_offset):
    h = h + attention_split(bp.attn, cfg, _norm(bp.norm1, h, split), angles,
                            split, causal=causal, cache=cache,
                            q_offset=q_offset)
    if hasattr(bp, "xattn"):
        h = h + attention_split(bp.xattn, cfg, _norm(bp.norm_x, h, split),
                                None, split, causal=False, cache=cache,
                                memory=memory, cross=True)
    x = _norm(bp.norm2, h, split)
    if hasattr(bp, "moe"):
        y, aux = moe_split(bp.moe, cfg, x, split)
    else:
        y, aux = mlp_split(bp.mlp, x, split), h.new_zeros(
            (), dtype=torch.float32)
    return h + y, aux


def _gathered(bp):
    """A block's parameters for this call: ``bp`` itself, or, for a block
    of a mesh step's ``launch.fsdp.ShardedLM`` (a handle), its leaves
    gathered now. The block functions call this first, inside the
    function :func:`_remat` checkpoints: the gathered leaves are dropped
    when the block returns, and its recompute gathers them again."""
    gather = getattr(bp, "gather", None)
    return bp if gather is None else gather()


def _attn_block(bp: AttnBlock, cfg: ModelConfig, h, angles, *, causal=True,
                memory=None, cache=None, q_offset=0, split=None):
    """Returns (h, aux). A decoder block's cross-attention K/V are
    projected from ``memory`` (and written to the cache when there is
    one) or, at decode, read from the cache. Under ``split``, the rank's
    share (``_attn_block_split``)."""
    bp = _gathered(bp)
    if split is not None:
        return _attn_block_split(bp, cfg, h, angles, split, causal=causal,
                                 memory=memory, cache=cache,
                                 q_offset=q_offset)
    x = norm_apply(bp.norm1, h)
    h = h + attention_apply(bp.attn, cfg, x, angles, causal=causal,
                            cache=cache, q_offset=q_offset)
    if hasattr(bp, "xattn"):
        x = norm_apply(bp.norm_x, h)
        if memory is not None:
            xk, xv = attention_kv(bp.xattn, cfg, memory)
            if cache is not None:
                cache["cross_k"].copy_(xk)
                cache["cross_v"].copy_(xv)
        else:
            xk, xv = cache["cross_k"], cache["cross_v"]
        h = h + attention_apply(bp.xattn, cfg, x, None, causal=False,
                                kv_override=(xk, xv))
    x = norm_apply(bp.norm2, h)
    if hasattr(bp, "moe"):
        y, aux = moe_apply(bp.moe, cfg, x)
    else:
        y, aux = mlp_apply(bp.mlp, x), h.new_zeros((), dtype=torch.float32)
    return _residual_hint(h + y), aux


def _mamba_block(bp: MambaBlock, cfg: ModelConfig, h, state=None,
                 split=None):
    bp = _gathered(bp)
    if split is not None:
        return h + mamba2_split(bp.mixer, cfg, _norm(bp.norm, h, split),
                                split, state)
    return _residual_hint(
        h + mamba2_apply(bp.mixer, cfg, norm_apply(bp.norm, h), state))


def _layer(caches: Optional[Dict], i: int) -> Optional[Dict]:
    """Layer ``i``'s view of a stacked cache (writes go through)."""
    if caches is None:
        return None
    return {k: v[i] for k, v in caches.items()}


def _attn_stack(model: LM, blocks, h, angles, *, causal=True, memory=None,
                caches=None, q_offset=0, split=None):
    cfg = model.cfg
    aux = h.new_zeros((), dtype=torch.float32)
    for i, bp in enumerate(blocks):
        fn = functools.partial(_attn_block, bp, cfg, causal=causal,
                               memory=memory, cache=_layer(caches, i),
                               q_offset=q_offset, split=split)
        h, a = _remat(fn, h, angles)
        aux = aux + a
    return h, aux


def _mamba_stack(model: LM, blocks, h, states=None, split=None):
    for i, bp in enumerate(blocks):
        h = _remat(functools.partial(
            _mamba_block, bp, model.cfg, state=_layer(states, i),
            split=split), h)
    return h


# --------------------------------------------------------------------- #
# embedding / logits / loss
# --------------------------------------------------------------------- #
def embed_tokens(model: LM, tokens: torch.Tensor,
                 split: Optional[Split] = None) -> torch.Tensor:
    """The token embeddings; under ``split`` in the residual layout: from
    the rank's vocabulary rows (zeros for the other tokens, the sum over
    'model' scattered to the rows), or, from a table held whole, the
    rows' tokens looked up."""
    if split is None:
        return _residual_hint(F.embedding(tokens.long(), model.embed))
    table, V = model.embed, model.cfg.vocab
    if table.shape[0] != V:
        v0, n = split.chunk(V)
        t = tokens.long() - v0
        e = F.embedding(t.clamp(0, n - 1), table)
        inside = ((t >= 0) & (t < n))[..., None]
        return split.exit(torch.where(inside, e, e.new_zeros(())))
    if split.sp:
        tokens = split.seq_chunk(tokens)
    return F.embedding(tokens.long(), split.rows(table))


def _vocab_rows(model: LM, split: Split):
    """The head table's rows of the rank's vocabulary slice and the
    slice's first token id."""
    table, V = model.head, model.cfg.vocab
    v0, n = split.chunk(V)
    if table.shape[0] != V:
        return table, v0
    return split.part(table).narrow(0, v0, n), v0


def _split_logits(model: LM, h: torch.Tensor, split: Split) -> torch.Tensor:
    """(B, V) float32 logits of ``h`` (B, D), whole on every 'model'
    rank: each rank's vocabulary slice, gathered (serving)."""
    table, v0 = _vocab_rows(model, split)
    part = matmul(h, table.t()).float()
    width = -(-model.cfg.vocab // split.m)
    part = F.pad(part, (0, width - part.shape[-1]))
    return all_gather_cat([part], split.group, [1])[0][:, :model.cfg.vocab]


def _pos_rows(table: torch.Tensor, S: int, split: Optional[Split]):
    """Learned positions 0 … S - 1 in the residual layout."""
    if split is None or not split.sp:
        return table[None, :S]
    start, n = split.chunk(S)
    return split.part(table).narrow(0, start, n)[None]


def logits_fn(model: LM, h: torch.Tensor) -> torch.Tensor:
    return shard_hint(matmul(h, model.head.t()).float(), "data", None,
                      "model")


def chunked_ce_loss(model: LM, h: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512, split: Optional[Split] = None
                    ) -> torch.Tensor:
    """Mean CE over the labels >= 0, the (B, c, V) logits of one chunk of
    ``chunk`` positions at a time. The label's logit is gathered where
    JAX sums ``logits · one_hot`` (the same value: one term plus zeros).
    Under ``split`` each rank computes its vocabulary slice's logits of
    the whole sequence: the log-sum-exp is that of the ranks'
    log-sum-exps, the label's logit the sum of the ranks' (zero off
    their slice); the loss is the same on every 'model' rank."""
    if split is not None:
        return _chunked_ce_split(model, h, labels, chunk, split)
    S = h.shape[1]
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        logits = logits_fn(model, h[:, c0:c0 + chunk])
        lx = labels[:, c0:c0 + chunk].long()
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(-1, lx.clamp(min=0)[..., None])[..., 0]
        valid = (lx >= 0).float()
        tot = tot + torch.sum((lse - lab) * valid)
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1.0)


def _chunked_ce_split(model: LM, h, labels, chunk: int, split: Split):
    h = split.enter(h)
    table, v0 = _vocab_rows(model, split)
    n = table.shape[0]
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, h.shape[1], chunk):
        logits = matmul(h[:, c0:c0 + chunk], table.t()).float()
        lx = labels[:, c0:c0 + chunk].long()
        lse = torch.logsumexp(gather_blocks(torch.logsumexp(
            logits, dim=-1)[..., None], split.group, -1), dim=-1)
        t = lx - v0
        lab = logits.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
        lab = reduce_from_group(torch.where((t >= 0) & (t < n), lab,
                                            lab.new_zeros(())), split.group)
        valid = (lx >= 0).float()
        tot = tot + torch.sum((lse - lab) * valid)
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1.0)


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _positions_default(B: int, S: int, device, offset=0) -> torch.Tensor:
    return (torch.arange(S, device=device) + offset).expand(B, S)


def backbone(model: LM, h: torch.Tensor, positions: torch.Tensor, *,
             caches=None, q_offset=0, memory=None, split=None):
    """Shared trunk: blocks -> final norm.

    positions: (B, S) or (3, B, S) for M-RoPE. caches: the family's
    cache (:func:`init_cache`), updated in place. Returns (h, aux_loss,
    caches). Under ``split``, ``h`` is in the residual layout, the caches
    are the rank's shards."""
    cfg = model.cfg
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec"):
        angles = (None if fam == "encdec" else   # encdec: learned positions
                  rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections))
        h, aux = _attn_stack(model, model.blocks, h, angles, causal=True,
                             memory=memory, caches=caches, q_offset=q_offset,
                             split=split)
        return _norm(model.final_norm, h, split), aux, caches
    zero = h.new_zeros((), dtype=torch.float32)
    if fam == "ssm":
        h = _mamba_stack(model, model.blocks, h, caches, split)
        return _norm(model.final_norm, h, split), zero, caches
    # hybrid: each group of Mamba2 blocks, then the shared attention block
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    every = cfg.shared_attn_every
    m_states, a_caches = (None, None) if caches is None else (
        caches["mamba"], caches["attn"])
    for gi in range(cfg.n_layers // every):
        h = _mamba_stack(model, model.blocks[gi * every:(gi + 1) * every], h,
                         _layer(m_states, gi), split)
        h, _ = _attn_block(model.shared, cfg, h, angles, causal=True,
                           cache=_layer(a_caches, gi), q_offset=q_offset,
                           split=split)
    return _norm(model.final_norm, h, split), zero, caches


def encode(model: LM, frames: torch.Tensor, split: Optional[Split] = None
           ) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, enc_seq, D). Under
    ``split`` (the decoder's) the encoder runs its own split over
    enc_seq and the memory comes back whole on every 'model' rank, its
    gradient summed over 'model' where the decoder's attention uses it
    for each rank's share."""
    if split is None:
        h = shard_hint(frames + model.enc_pos[None, :frames.shape[1]],
                       "data", None, "model")
        h, _ = _attn_stack(model, model.enc_blocks, h, None, causal=False)
        return norm_apply(model.enc_final_norm, h)
    S = frames.shape[1]
    esp = split.for_seq(S)
    h = (esp.seq_chunk(frames) if esp.sp else frames) + _pos_rows(
        model.enc_pos, S, esp)
    h, _ = _attn_stack(model, model.enc_blocks, h, None, causal=False,
                       split=esp)
    h = _norm(model.enc_final_norm, h, esp)
    shared = split.attn in ("heads", "context")
    if esp.sp:
        return (gather_along if shared else gather_blocks)(h, esp.group, 1)
    return copy_to_group(h, esp.group) if shared else h


def loss_fn(model: LM, batch: Dict, split: Optional[Split] = None
            ) -> torch.Tensor:
    """Training loss. batch keys: tokens (B, S) int, optionally labels,
    plus per family: encdec frames (B, enc_seq, D); vlm positions
    (3, B, S). ``split``: the rank's share over a process mesh (its
    rows of the batch, every 'model' rank the same rows)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = tokens, batch["labels"]
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    h = embed_tokens(model, inputs, split)
    memory = None
    if cfg.family == "encdec":
        memory = encode(model, batch["frames"].to(h.dtype), split)
        h = h + _pos_rows(model.dec_pos, S, split)
    if cfg.family == "vlm":
        positions = batch["positions"]
        if "labels" not in batch:
            positions = positions[:, :, :-1]
    else:
        positions = _positions_default(B, S, h.device)
    h, aux, _ = backbone(model, h, positions, memory=memory, split=split)
    return chunked_ce_loss(model, h, labels, split=split) + 0.01 * aux


# --------------------------------------------------------------------- #
# serving: prefill + decode with caches
# --------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device: DeviceLike = "cuda") -> Dict:
    """JAX's cache tree, zeroed on ``device``: per layer K / V over
    ``max_seq`` and a length (attention), conv and SSM states (Mamba2),
    cross K / V (encdec); hybrid: {"mamba": per group and layer, "attn":
    per group}."""
    dev = resolve_device(device)
    Hkv, Dh, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(n):
        return {"k": zeros((n, batch, max_seq, Hkv, Dh)),
                "v": zeros((n, batch, max_seq, Hkv, Dh)),
                "len": zeros((n,), torch.int32)}

    def mamba_state(*n):
        di, N = cfg.d_inner, cfg.ssm_state
        return {"conv": zeros((*n, batch, cfg.ssm_conv - 1, di + 2 * N)),
                "ssm": zeros((*n, batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                             torch.float32)}

    if cfg.family == "encdec":
        c = attn_cache(L)
        c["cross_k"] = zeros((L, batch, cfg.enc_seq, Hkv, Dh))
        c["cross_v"] = zeros((L, batch, cfg.enc_seq, Hkv, Dh))
        return c
    if cfg.family in ("dense", "vlm", "moe"):
        return attn_cache(L)
    if cfg.family == "ssm":
        return mamba_state(L)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        return {"mamba": mamba_state(L // every, every),
                "attn": attn_cache(L // every)}
    raise ValueError(cfg.family)


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, cache: Dict, *,
            positions=None, memory=None, split=None):
    """Run the prompt through the model, filling ``cache`` in place.

    Returns (last-position logits (B, V) float32, cache). Under
    ``split``: the rank's share, its cache shards written (a mesh prefill
    starts from an empty cache), the logits whole on every 'model'
    rank."""
    B, S = tokens.shape
    h = embed_tokens(model, tokens, split)
    if model.cfg.family == "encdec":
        h = h + _pos_rows(model.dec_pos, S, split)
    if positions is None:
        positions = _positions_default(B, S, h.device)
    h, _, cache = backbone(model, h, positions, caches=cache, q_offset=0,
                           memory=memory, split=split)
    if split is None:
        return matmul(h[:, -1], model.head.t()).float(), cache
    last = (all_gather_cat([h[:, -1:]], split.group, [1])[0] if split.sp
            else h)[:, -1]
    return _split_logits(model, last, split), cache


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cache: Dict, pos, *,
                memory=None, split=None):
    """One decode step. token: (B,) int; pos: the absolute position, a
    0-d tensor on the model's device (or an int).

    Returns (logits (B, V) float32, cache); under ``split`` as
    :func:`prefill`."""
    B = token.shape[0]
    h = embed_tokens(model, token[:, None], split)
    pos = torch.as_tensor(pos, device=h.device)
    if model.cfg.family == "encdec":
        h = h + model.dec_pos.index_select(0, pos.reshape(1).long())[None]
    shape = (3, B, 1) if model.cfg.family == "vlm" else (B, 1)
    h, _, cache = backbone(model, h, pos.expand(shape), caches=cache,
                           q_offset=pos, memory=memory, split=split)
    if split is not None:
        return _split_logits(model, h[:, 0], split), cache
    return matmul(h[:, 0], model.head.t()).float(), cache
