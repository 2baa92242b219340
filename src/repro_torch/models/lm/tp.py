"""The model axis's compute split of the LM over a process mesh: what
GSPMD derives from JAX's specs (``repro/launch/shardings.py``) and hints
(``repro/models/lm/layers.py``, ``model.py``) for the ranks along
'model'.

:func:`make_split` builds a :class:`Split` per call from the config, the
process mesh and the call's sequence length (None on one card, under a
``MeshShape`` and on a model axis of 1: nothing is split there). Under a
split, with ``m`` ranks on 'model' and this rank at ``r``:

* **the residual stream** between blocks is the rank's chunk of the
  sequence (``sp``, Megatron-SP) when ``m`` divides the sequence, else
  whole on every 'model' rank (decode, odd lengths): norms, biases after
  a reduction and learned positions run on the rank's rows. (JAX's hint
  shards the sequence from 16 positions up and d_model below; a layout
  changes no value.)
* **attention** (``attn``), as ``layers._attn_parallel_mode`` and
  ``shardings.cache_specs`` choose it:
  'heads' — Megatron TP: the rank's ``Hq/m`` query heads (``wq``,
  ``bq`` column chunks, ``wo`` row chunk, the partial outputs reduced);
  its K/V heads when ``m`` divides ``Hkv``, else every K/V head computed
  and the ones its query heads read taken (JAX's hint replicates them);
  'context' — q on the rank's sequence chunk (its rows), K/V computed
  for the chunk and all-gathered, causal at the chunk's offset;
  'head_dim' — decode on a cache sharded on head_dim: q·k partial over
  the rank's Dh slice (RoPE on its pairs), the scores summed over
  'model'; 'replicated' — nothing fits: every rank computes the whole.
* **the dense MLP** is TP over d_ff when ``m`` divides it (``w_gate``,
  ``w_up``, ``b_up`` column chunks, ``w_down`` row chunk), else it runs
  whole on the rank's rows.
* **the embedding and the head** are vocab-parallel: a rank looks up the
  tokens of its vocabulary rows (zeros elsewhere; the sum over 'model'
  scattered to the rows) and computes the logits of its vocabulary
  slice, the CE's log-sum-exp and label logit combined over 'model'.
* **the MoE FFN** (``moe``), as JAX's ``moe._block_layout`` and the
  expert specs choose it: 'slots' — a small expert FFN
  (``moe.small_ffn``) on a sequence ``m`` divides: JAX's (data, model)
  token block is the rank's residual rows, routed and run there with the
  weights whole; 'ep' — expert parallelism where ``m`` divides E: the
  routing whole on the rank's data rows, the rank running only its
  ``E/m`` experts' slots; 'ff' — big experts otherwise: every expert's
  slots with the rank's chunk of d_ff (``w_gate`` / ``w_up`` column
  chunks, ``w_down`` row chunk); the partial outputs of 'ep' / 'ff'
  reduced; 'replicated' — a small FFN on a sequence ``m`` does not
  divide (decode), or big experts neither E nor d_ff divide: the whole
  FFN on every rank.
* **the Mamba2 mixer** (``mixer``): 'heads' when ``m`` divides the SSM
  heads (the rank's ``z`` / ``dt`` columns and heads, ``out_proj`` row
  chunk, its ``ssm`` state shard; the partial outputs reduced), else
  'whole'. Its depthwise conv (``conv``): 'heads' in a train or prefill
  call under the 'heads' mixer — on the ``x`` channels of the rank's
  heads and on all of ``B`` / ``C``, ``conv_w`` / ``conv_b`` whole, no
  collective (a prefill writes the rank's ``conv`` state chunk from its
  last inputs); 'chunk' in a decode, or under 'whole', when ``m``
  divides the ``[x | B | C]`` channels — on the rank's contiguous chunk
  of them (``conv_w`` / ``conv_b`` / the ``conv`` state chunks, JAX's
  specs), its output gathered over 'model'; else 'whole', on every
  channel. So a serve call reads and writes its own ``conv`` / ``ssm``
  shards and gathers no state.

A leaf the split runs on its 'model' chunk (:meth:`Split.chunk_dim`)
reaches the model as that chunk where its stored shard is sharded there
alone, else whole (:meth:`Split.tp` then takes the chunk). Gradients:
a leaf's gradient on a rank is COMPLETE for the rank's data rows. A
chunk's is by construction; a whole leaf used for the rank's own share
of the work (its rows, heads or vocabulary slice) enters through
:meth:`Split.part` (``transport.copy_to_group``: its gradient summed
over 'model'), and one used for the same work on every 'model' rank
enters as it is. So the step sums every gradient over the batch axes
only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ...core.transport import (copy_to_group, gather_along,
                               reduce_from_group, reduce_scatter_along)
from ...pjit_utils import axis_index, axis_sizes, is_process_mesh, owned_chunk
from .config import ModelConfig

__all__ = ["Split", "make_split"]

_HEADS = {"wq": 1, "bq": 0, "wo": 0}
_KV_HEADS = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}
_HEAD_DIM = {"wq": 2, "wk": 2, "wv": 2, "bq": 1, "bk": 1, "bv": 1, "wo": 1}
_MLP = {"w_gate": 1, "w_up": 1, "b_up": 0, "w_down": 0}
_MOE = {"ep": {"w_gate": 0, "w_up": 0, "w_down": 0},
        "ff": {"w_gate": 2, "w_up": 2, "w_down": 1}}
_CONV = {"conv_w": 1, "conv_b": 0}


@dataclasses.dataclass(frozen=True)
class Split:
    """One call's split (module docstring). ``kv`` / ``cross``: the
    per-layer cache leaf's (B, S, H, Dh) dim sharded over 'model' (1
    sequence, 2 heads, 3 head_dim, None whole), of the self- and the
    cross-attention K / V; ``kind``: the call's ("train", "prefill" or
    "decode")."""
    cfg: ModelConfig
    mesh: Any
    group: Any
    m: int
    r: int
    sp: bool
    attn: str
    kv: Optional[int] = None
    cross: Optional[int] = None
    kind: str = "train"

    @property
    def mlp_tp(self) -> bool:
        return self.cfg.d_ff % self.m == 0

    @property
    def kv_chunked(self) -> bool:
        """Does the rank compute only its own K/V heads ('heads', ``m``
        dividing Hkv)?"""
        return self.attn == "heads" and self.cfg.n_kv_heads % self.m == 0

    @property
    def moe(self) -> str:
        """The MoE FFN's mode (module docstring)."""
        from . import moe       # moe imports layers, which imports this

        cfg = self.cfg
        if moe.small_ffn(cfg):
            return "slots" if self.sp else "replicated"
        if cfg.n_experts % self.m == 0:
            return "ep"
        return "ff" if cfg.d_ff % self.m == 0 else "replicated"

    @property
    def mixer(self) -> str:
        """The Mamba2 mixer's mode: 'heads' or 'whole'."""
        return "heads" if self.cfg.ssm_heads % self.m == 0 else "whole"

    @property
    def conv(self) -> str:
        """The Mamba2 conv's mode: 'heads', 'chunk' or 'whole' (module
        docstring)."""
        if self.mixer == "heads" and self.kind != "decode":
            return "heads"
        channels = self.cfg.d_inner + 2 * self.cfg.ssm_state
        return "chunk" if channels % self.m == 0 else "whole"

    def for_seq(self, seq_len: int) -> "Split":
        """The split of a stack over ``seq_len`` positions (the
        encoder's)."""
        return make_split(self.cfg, self.mesh, seq_len)

    def chunk_dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` (``model.named_parameters``) the
        split runs on its 'model' chunk, or None (used whole)."""
        parts = name.split(".")
        leaf, mod = parts[-1], (parts[-2] if len(parts) > 1 else "")
        if mod in ("attn", "xattn"):
            if self.attn == "heads":
                dims = dict(_HEADS, **(_KV_HEADS if self.kv_chunked else {}))
                return dims.get(leaf)
            if self.attn == "head_dim":
                return _HEAD_DIM.get(leaf)
            return None
        if mod == "mlp" and self.mlp_tp:
            return _MLP.get(leaf)
        if mod == "moe":
            return _MOE.get(self.moe, {}).get(leaf)
        if mod == "mixer":
            if leaf == "out_proj":
                return 0 if self.mixer == "heads" else None
            return _CONV.get(leaf) if self.conv == "chunk" else None
        if name in ("embed", "lm_head"):
            return 0
        return None

    def chunk(self, n: int) -> Tuple[int, int]:
        """``(start, size)`` of the rank's block of a dim of ``n``."""
        return owned_chunk(n, self.m, self.r)

    def part(self, w: torch.Tensor) -> torch.Tensor:
        """A whole tensor used for the rank's own share of the work: its
        gradient is summed over 'model'."""
        if torch.is_grad_enabled() and w.requires_grad:
            return copy_to_group(w, self.group)
        return w

    def rows(self, w: torch.Tensor) -> torch.Tensor:
        """A whole leaf applied to the residual stream's rows."""
        return self.part(w) if self.sp else w

    def tp(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """The rank's chunk of ``w`` along ``dim`` (``full`` long whole):
        ``w`` itself when the step handed the chunk, else taken from the
        whole."""
        if w.shape[dim] != full:
            return w
        start, n = self.chunk(full)
        return self.part(w).narrow(dim, start, n)

    def seq_chunk(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's chunk of ``t``'s sequence dim."""
        start, n = self.chunk(t.shape[dim])
        return t.narrow(dim, start, n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual layout → the whole sequence, for work each rank
        does its share of (its gradient summed over 'model')."""
        if self.sp:
            return gather_along(x, self.group, 1)
        return copy_to_group(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Each rank's partial sum → their sum in the residual layout."""
        if self.sp:
            return reduce_scatter_along(y, self.group, 1)
        return reduce_from_group(y, self.group)


def make_split(cfg: ModelConfig, mesh, seq_len: int, kind: str = "train",
               kv: Optional[int] = None, cross: Optional[int] = None
               ) -> Optional[Split]:
    """The split of a ``kind`` call over ``seq_len`` positions on
    ``mesh`` (module docstring); a decode's attention follows its cache's
    layout ``kv``. None where nothing is split."""
    if not is_process_mesh(mesh):
        return None
    m = axis_sizes(mesh).get("model", 1)
    if m == 1:
        return None
    sp = seq_len % m == 0
    if kind == "decode":
        attn = {2: "heads", 3: "head_dim"}.get(kv, "replicated")
    elif cfg.n_heads % m == 0:
        attn = "heads"
    else:
        attn = "context" if sp else "replicated"
    return Split(cfg, mesh, mesh.get_group("model"), m,
                 axis_index(mesh, "model"), sp, attn, kv, cross, kind)
