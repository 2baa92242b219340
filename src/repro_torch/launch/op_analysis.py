"""Op-count analysis of one torch step, for the dry run and the roofline
(the counterpart of ``repro/launch/hlo_analysis.py`` and of
``repro/launch/dryrun.py``'s ``parse_collective_bytes``).

torch produces no HLO text to parse. It needs no trip counts either:
eager torch dispatches every loop iteration, every layer and every
recomputed block, so a count of what dispatches is trip-aware by
construction. :class:`OpAnalysis` is a ``TorchDispatchMode`` that sees
each dispatched op (forward, backward and collectives; real, fake or
meta tensors alike) and records:

* FLOPs, by ``torch.utils.flop_counter``'s formula registry (matmuls,
  convolutions, attention): the ops JAX's ``_dot_flops`` counts;
* an HBM-traffic estimate: Σ (operand + result) bytes of each dispatched
  op, every tensor argument and every returned tensor once per op at its
  logical size. JAX's ``hbm_bytes_est`` is the same sum over TOP-LEVEL
  HLO ops after fusion, a fusion counting only its own operands and
  result; eager torch runs every op as its own kernel, so an elementwise
  chain XLA would fuse counts each intermediate here. View ops (which
  move no data) and host reads of a scalar (``_local_scalar_dense``) add
  nothing;
* the operand bytes of every collective, under JAX's kind names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and by JAX's convention: an all-gather's
  operand is the shard sent, a reduce-scatter's the whole input. Both
  the ``c10d.*`` ops (``torch.distributed``'s calls, which the port's
  ``core/transport.py`` makes) and the ``_c10d_functional.*`` ones are
  counted;
* the peak of live bytes allocated inside the mode (storages created by
  its ops, released when their last tensor dies): the step's transient
  memory beyond its arguments; with ``peak_sites=True``, also what was
  alive at that peak, by the op and the port's call site that made each
  storage (:meth:`OpAnalysis.peak_sites`; every op then reads its stack);
* apart, the bytes of copies between the host and a device (within the
  HBM estimate): a ``gloo`` group's staging, which the ``nccl`` and
  ``fake`` transports do not make.

:meth:`OpAnalysis.analyze` returns JAX's keys (``flops_hlo``,
``hbm_bytes_est``, ``collective_bytes``, ``collective_total``);
:meth:`OpAnalysis.top_collectives` the largest collective sites, each
named by the parameter or cache leaves its operand was copied from
(:meth:`OpAnalysis.name` registers them), by the port's call site and by
its operand's dtype (a reduction's is the dtype it sums in; the port's
gathers move ``uint8`` bytes).
"""
from __future__ import annotations

import os
import traceback
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..pjit_utils import local_nbytes

__all__ = ["OpAnalysis", "COLLECTIVES", "collective_kind"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# an op's operand argument, by schema name (c10d and functional ops)
_OPERAND_ARGS = ("input_tensors", "input_tensor", "inputs", "input",
                 "tensors", "tensor", "self")
# ops whose result is its inputs' bytes moved, not computed: the
# parameter / cache names on their inputs carry over to their results
_MOVES = {"clone", "_to_copy", "cat", "stack", "copy_"}
# in-place ops that overwrite their first argument whole: not a read
_OVERWRITES = {"copy_", "zero_", "fill_"}
_NO_BYTES = {"_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size"}
_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def collective_kind(func) -> Optional[str]:
    """JAX's kind name of a collective op, or None."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "allgather" in name or "all_gather" in name:
        return "all-gather"
    if "allreduce" in name or "all_reduce" in name:
        return "all-reduce"
    if "alltoall" in name or "all_to_all" in name:
        return "all-to-all"
    if name in ("send", "isend"):
        return "collective-permute"
    return None


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _operand(func, args, kwargs):
    """The operand argument of a collective op (by its schema name)."""
    names = [a.name for a in func._schema.arguments]
    for want in _OPERAND_ARGS:
        if want in names:
            i = names.index(want)
            return args[i] if i < len(args) else kwargs.get(want)
    return args[0] if args else None


def _site() -> str:
    """The innermost frame of the port's code outside the transport and
    the gathers (who asked for the collective)."""
    skip = ("transport.py", "pjit_utils.py", "op_analysis.py")
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(_SRC) and not fr.filename.endswith(skip):
            return f"{os.path.relpath(fr.filename, _SRC)}:{fr.name}"
    return ""


class OpAnalysis(TorchDispatchMode):
    """Count FLOPs, bytes and collectives of the ops dispatched while
    active (``with OpAnalysis() as oa: step(...)``; see the module
    docstring). Launches made outside the ``with`` are not seen."""

    def __init__(self, peak_sites: bool = False):
        super().__init__()
        self._by_site = peak_sites
        self._site_live: Dict[str, int] = {}
        self._peak_by_site: Dict[str, int] = {}
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.coll_bytes: Dict[str, int] = {}
        self.coll_counts: Dict[str, int] = {}
        self.sites: Dict[tuple, int] = {}
        self.live = self.peak = 0
        self.host_copy_bytes = 0
        self._names = WeakIdKeyDictionary()    # storage -> leaf names
        self._owned = WeakIdKeyDictionary()    # storages made in the mode
        self._read = WeakIdKeyDictionary()     # storages an op read

    # -- names ------------------------------------------------------- #
    def name(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Name tensors (a parameter's or cache leaf's local shard) so the
        collectives moving their bytes can be told apart."""
        for n, t in tensors.items():
            t = t.to_local() if hasattr(t, "to_local") else t
            self._names.setdefault(t.untyped_storage(), set()).add(n)

    def _names_of(self, ts) -> set:
        out = set()
        for t in ts:
            out |= self._names.get(t.untyped_storage(), set())
        return out

    def was_read(self, t: torch.Tensor) -> bool:
        """Did an op read ``t``'s storage (as an operand, not through a
        view alone, not as the destination it overwrote whole)? JAX's jit
        keeps only the arguments its program reads (``keep_unused``
        False): the dry run counts an argument's bytes only if it was
        read."""
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.untyped_storage() in self._read

    # -- the mode ---------------------------------------------------- #
    def _track(self, t: torch.Tensor, seen: set, where: str = "") -> None:
        """Count ``t``'s storage as live if an op here made it (not an
        input's, which an in-place op or a view returns); ``where``: the
        op and site that made it (``peak_sites``)."""
        st = t.untyped_storage()
        if id(st) in seen or st in self._owned:
            return
        n = st.nbytes()
        self._owned[st] = n
        self.live += n
        if self._by_site:
            self._site_live[where] = self._site_live.get(where, 0) + n
        if self.live > self.peak:
            self.peak = self.live
            if self._by_site:
                self._peak_by_site = dict(self._site_live)
        weakref.finalize(st, self._release, n, where)

    def _release(self, n: int, where: str = "") -> None:
        self.live -= n
        if self._by_site:
            self._site_live[where] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            operand = list(_tensors(_operand(func, args, kwargs)))
            nb = sum(local_nbytes(t) for t in operand)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nb
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            key = (kind, nb, tuple(sorted(self._names_of(operand))), _site(),
                   str(operand[0].dtype).replace("torch.", "")
                   if operand else "")
            self.sites[key] = self.sites.get(key, 0) + 1
        if not func.is_view and name not in _NO_BYTES:
            nb = sum(local_nbytes(t) for t in ins + outs)
            self.hbm_bytes += nb
            if name in ("_to_copy", "copy_") and len(
                    {t.device.type for t in ins + outs}) > 1:
                self.host_copy_bytes += nb
            written = {id(t) for t in _tensors(kwargs.get("out"))}
            if name in _OVERWRITES:
                written.add(id(args[0]))
            for t in ins:
                if id(t) not in written:
                    self._read[t.untyped_storage()] = True
        if name in _MOVES or kind is not None:
            # a collective's results carry its operand's leaves
            names = self._names_of(operand if kind is not None else
                                   ins[1:] if name == "copy_" else ins)
            if names:
                for t in outs:
                    self._names.setdefault(t.untyped_storage(),
                                           set()).update(names)
        seen = {id(t.untyped_storage()) for t in ins}
        where = (f"{_site()} {name}".strip() if self._by_site and outs
                 else "")
        for t in outs:
            self._track(t, seen, where)
        return out

    # -- results ----------------------------------------------------- #
    def analyze(self) -> Dict[str, object]:
        """JAX's ``hlo_analysis.analyze`` keys, plus the op count, the
        collectives' counts and the peak of live bytes made here."""
        return {"flops_hlo": float(self.flops),
                "hbm_bytes_est": float(self.hbm_bytes),
                "collective_bytes": {k: float(v)
                                     for k, v in self.coll_bytes.items()},
                "collective_total": float(sum(self.coll_bytes.values())),
                "collective_counts": dict(self.coll_counts),
                "ops": self.ops, "peak_live_bytes": self.peak,
                "host_copy_bytes": float(self.host_copy_bytes),
                "entry": "dispatched ops"}

    def peak_sites(self, k: Optional[int] = 12) -> List[dict]:
        """What was alive at the peak of live bytes (``peak_sites=True``):
        the ``k`` largest (op, site) pairs that made it, with their
        bytes."""
        rows = [{"site": w, "bytes": n}
                for w, n in self._peak_by_site.items() if n > 0]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:k]

    def top_collectives(self, k: Optional[int] = 12) -> List[dict]:
        """The ``k`` largest collective sites by total bytes (every site
        for None): kind, dtype, bytes each, count, total, the leaves their
        operand carries (where known) and the port's call site."""
        rows = []
        for (kind, nb, names, site, dtype), n in self.sites.items():
            label = ", ".join(names[:4]) + (
                f", … (+{len(names) - 4})" if len(names) > 4 else "")
            rows.append({"kind": kind, "dtype": dtype, "bytes_each": nb,
                         "count": n, "bytes_total": nb * n, "names": label,
                         "site": site})
        rows.sort(key=lambda r: -r["bytes_total"])
        return rows[:k]
