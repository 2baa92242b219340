"""Parameter / state / batch sharding rules (port of
``repro/launch/shardings.py``: FSDP × TP, optional EP), onto DTensor
placements.

Every rule is a CHAIN of candidates; the first whose divisibility holds
on the actual mesh wins. E.g. attention wq (D, H, Dh) prefers
heads-on-'model' (Megatron TP) but falls back to head_dim-on-'model' when
H doesn't divide the axis, and finally to fused FSDP×TP on D.

  * TP on 'model': heads / FFN inner / vocab.
  * FSDP (ZeRO-3) on 'data' ('pod','data' across pods): the other large
    dim; optimizer moments inherit the parameter spec.
  * EP: expert dim on 'model' when divisible.

A spec is JAX's ``PartitionSpec`` as a tuple (per dim ``None``, an axis
name or a tuple of names), equal entry for entry to JAX's; a mesh is a
``DeviceMesh`` or a ``pjit_utils.MeshShape``. :func:`to_placements`
replaces JAX's ``to_named``: per mesh dim ``Shard(d)`` where its axis
sits in dim ``d``'s entry, else ``Replicate()``. A rank's shard shape is
JAX's ``NamedSharding(mesh, spec).shard_shape``; which rank holds which
chunk need not be: an entry such as ``("model", "data")`` runs against
the mesh order, and DTensor chunks it in mesh order.

The rules place the STATE. The port's mesh steps (``launch/steps.py``)
gather it once a step into the rank's working copy, split the batch over
'data' and the compute over 'model' (``models/lm/tp.py``: TP and
context-parallel attention, the TP MLP, the vocab-parallel embedding and
head, the sequence-parallel residual, the MoE's expert-parallel, ff-TP
and slot splits, the Mamba2 mixer over its heads), as GSPMD derives it
from these specs and the model's hints. ``moe.small_ffn`` is the one
test of a small expert FFN that these rules, the MoE's token blocks and
the split read.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..models.lm.config import ModelConfig
from ..models.lm import moe
from ..pjit_utils import axis_sizes, shard_shape, to_placements

__all__ = ["pick_spec", "param_specs", "model_specs", "batch_specs",
           "cache_specs", "resolve_axis", "to_placements", "shard_shape",
           "map_tree"]

Axis = Any  # None | str | tuple[str, ...]
Candidate = Tuple[Axis, ...]

# (name, rank) -> candidate chain (logical axes; 'data' expands to
# ('pod','data') on multi-pod meshes).
_RULES: Dict[tuple, List[Candidate]] = {
    ("embed", 2): [("model", "data"), (None, ("model", "data")),
                   (None, "model")],
    ("lm_head", 2): [("model", "data"), (None, ("model", "data")),
                     (None, "model")],
    ("enc_pos", 2): [(None, "model")],
    ("dec_pos", 2): [(None, "model")],
    # attention
    ("wq", 3): [("data", "model", None), ("data", None, "model"),
                (("data", "model"), None, None)],
    ("wk", 3): [("data", "model", None), ("data", None, "model"),
                (("data", "model"), None, None)],
    ("wv", 3): [("data", "model", None), ("data", None, "model"),
                (("data", "model"), None, None)],
    ("wo", 3): [("model", None, "data"), (None, "model", "data"),
                (None, None, ("data", "model"))],
    ("bq", 2): [("model", None), (None, "model")],
    ("bk", 2): [("model", None), (None, "model")],
    ("bv", 2): [("model", None), (None, "model")],
    # dense mlp
    ("w_gate", 2): [("data", "model"), (None, "model")],
    ("w_up", 2): [("data", "model"), (None, "model")],
    ("w_down", 2): [("model", "data"), ("model", None)],
    ("b_up", 1): [("model",)],
    ("b_down", 1): [(None,)],
    # moe (rank 3, experts-first)
    ("router", 2): [("data", None), (None, None)],
    ("w_gate", 3): [(None, "data", "model"), (None, None, "model")],
    ("w_up", 3): [(None, "data", "model"), (None, None, "model")],
    ("w_down", 3): [(None, "model", "data"), (None, "model", None)],
    # mamba2
    ("in_proj", 2): [("data", "model"), (None, "model")],
    ("out_proj", 2): [("model", "data"), ("model", None)],
    ("conv_w", 2): [(None, "model")],
    ("conv_b", 1): [("model",)],
    ("A_log", 1): [(None,)],
    ("dt_bias", 1): [(None,)],
    ("skip_D", 1): [(None,)],
    # norms
    ("scale", 1): [(None,)],
    ("bias", 1): [(None,)],
}

_MOE_EP_RULES: Dict[tuple, List[Candidate]] = {
    ("w_gate", 3): [("model", "data", None)],
    ("w_up", 3): [("model", "data", None)],
    ("w_down", 3): [("model", None, "data")],
}

_STACKS = ("blocks", "enc_blocks")


def _expand(mesh, axis: Axis) -> Optional[Tuple[str, ...]]:
    """Logical -> flat tuple of physical mesh axis names."""
    if axis is None:
        return None
    if isinstance(axis, str):
        axis = (axis,)
    pod = "pod" in axis_sizes(mesh)
    out = []
    for a in axis:
        if a == "data" and pod:
            out.extend(("pod", "data"))
        else:
            out.append(a)
    return tuple(out)


def _axis_size(mesh, axes: Optional[Tuple[str, ...]]) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes or ():
        n *= sizes[a]
    return n


def _fits(mesh, shape: Sequence[int], cand: Candidate) -> bool:
    for dim, axis in zip(shape, cand):
        sz = _axis_size(mesh, _expand(mesh, axis))
        if sz > 1 and dim % sz != 0:
            return False
    return True


def _to_spec(mesh, cand: Candidate) -> tuple:
    entries = []
    for axis in cand:
        flat = _expand(mesh, axis)
        if flat is None:
            entries.append(None)
        elif len(flat) == 1:
            entries.append(flat[0])
        else:
            entries.append(tuple(flat))
    return tuple(entries)


def pick_spec(mesh, shape: Sequence[int], candidates: List[Candidate], *,
              stacked: bool = False) -> tuple:
    body = shape[1:] if stacked else shape
    for cand in candidates:
        if _fits(mesh, body, cand):
            spec = _to_spec(mesh, cand)
            return ((None,) + spec) if stacked else spec
    return (None,) * len(shape)


def map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of nested dicts (a spec tree's
    leaves are its spec tuples)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_shape: Any, cfg: Optional[ModelConfig], mesh,
                fsdp: bool = True) -> Any:
    """The spec tree of JAX's parameter tree (nested dicts, layers
    stacked on a leading L under ``blocks`` / ``enc_blocks``; leaves
    anything with a ``.shape``: ``steps.eval_param_shapes``'s meta
    tensors, ``lm.to_jax_tree``'s tensors, numpy arrays)."""
    model_axis = axis_sizes(mesh).get("model", 1)
    use_ep = (cfg is not None and cfg.n_experts > 0
              and cfg.n_experts % model_axis == 0)
    # tiny expert FFNs: replicate the weights, let the slot dim carry
    # the parallelism
    small = cfg is not None and cfg.n_experts > 0 and moe.small_ffn(cfg)

    def spec_for(names, leaf):
        name = names[-1]
        stacked = any(n in _STACKS for n in names)
        rank = len(leaf.shape) - (1 if stacked else 0)
        rules = dict(_RULES)
        if use_ep:
            rules.update(_MOE_EP_RULES)
        if small and rank == 3 and name in ("w_gate", "w_up", "w_down"):
            rules[(name, 3)] = [(None, "data", None), (None, None, None)]
        cands = rules.get((name, rank), [(None,) * rank])
        if not fsdp:
            cands = [tuple(None if c == "data" else c for c in cand)
                     for cand in cands]
        return pick_spec(mesh, tuple(leaf.shape), cands, stacked=stacked)

    return map_tree(spec_for, params_shape)


def model_specs(model, specs: Any) -> List[tuple]:
    """One spec per parameter of the port's ``LM`` ``model``, in
    ``model.parameters()`` order, from ``specs`` (:func:`param_specs` of
    JAX's stacked tree): a per-layer parameter takes its stacked leaf's
    spec without the leading ``None``."""
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in _STACKS
        node = specs
        for k in ((parts[0],) + tuple(parts[2:])) if stacked else parts:
            node = node[k]
        out.append(tuple(node[1:]) if stacked else tuple(node))
    return out


# --------------------------------------------------------------------- #
# batch / cache
# --------------------------------------------------------------------- #
def _data_if_divisible(mesh, B: int) -> Axis:
    ax = _expand(mesh, "data")
    return "data" if B % _axis_size(mesh, ax) == 0 else None


def batch_specs(cfg: ModelConfig, kind: str, mesh,
                batch_size: Optional[int] = None) -> Dict[str, tuple]:
    """Input sharding: batch on ('pod','data') when divisible."""
    d = "data" if batch_size is None else _data_if_divisible(mesh,
                                                             batch_size)

    def s(*axes):
        return _to_spec(mesh, axes)

    if kind == "train":
        spec = {"tokens": s(d, None), "labels": s(d, None)}
    elif kind == "prefill":
        spec = {"tokens": s(d, None)}
    else:
        spec = {"tokens": s(d)}
    if cfg.family == "encdec":
        spec["frames"] = s(d, None, None)
    if cfg.family == "vlm" and kind != "decode":
        spec["positions"] = s(None, d, None)
    return spec


def cache_specs(cfg: ModelConfig, mesh, batch_size: Optional[int] = None,
                seq_len: Optional[int] = None, kind: str = "prefill") -> Any:
    """KV cache / SSM state sharding: batch on data; heads on model when
    the Q-head count divides the axis (TP attention). Otherwise:
      * prefill — cache SEQUENCE dim on model (context-parallel attention);
      * decode — head_dim on model."""
    d = "data" if batch_size is None else _data_if_divisible(mesh,
                                                             batch_size)
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m = axis_sizes(mesh).get("model", 1)
    if Hq % m == 0 and Hkv % m == 0:
        s_ax, h_ax, dh_ax = None, "model", None
    elif (kind == "prefill" and seq_len is not None
          and seq_len % m == 0):
        s_ax, h_ax, dh_ax = "model", None, None
    elif Dh % m == 0:
        s_ax, h_ax, dh_ax = None, None, "model"
    else:
        s_ax = h_ax = dh_ax = None

    def attn_spec():
        kv = _to_spec(mesh, (None, d, s_ax, h_ax, dh_ax))
        spec = {"k": kv, "v": kv, "len": (None,)}
        if cfg.family == "encdec":
            spec["cross_k"] = _to_spec(mesh, (None, d, None, h_ax, dh_ax))
            spec["cross_v"] = _to_spec(mesh, (None, d, None, h_ax, dh_ax))
        return spec

    def mamba_spec(extra_lead=0):
        H = cfg.ssm_heads
        conv_c = cfg.d_inner + 2 * cfg.ssm_state
        h_ok = "model" if H % m == 0 else None
        c_ok = "model" if conv_c % m == 0 else None
        lead = (None,) * extra_lead
        return {"conv": _to_spec(mesh, lead + (None, d, None, c_ok)),
                "ssm": _to_spec(mesh, lead + (None, d, h_ok, None, None))}

    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        return attn_spec()  # encdec adds cross-KV entries above
    if cfg.family == "ssm":
        return mamba_spec()
    if cfg.family == "hybrid":
        return {"mamba": mamba_spec(extra_lead=1), "attn": attn_spec()}
    raise ValueError(cfg.family)


def resolve_axis(mesh, name):
    """Logical -> physical single-axis resolve (JAX's, kept for dryrun)."""
    flat = _expand(mesh, name)
    if flat is None:
        return None
    return flat[0] if len(flat) == 1 else tuple(flat)
