"""Transport over a ``torch.distributed`` process group: the mesh ring's
(one vertex shard per rank; ``core/partition.py``, the trainers) and the
LM mesh step's (``launch/steps.py``: a sharded leaf gathered over the
sub-groups of its mesh dims, the whole-mesh gradient all-reduce).

Every rank runs the same program on its own shard, so every rank posts
the same sends and receives in the same order. The transport is chosen by
the group's backend, never by catching an error:

* ``nccl`` — device tensors go straight through;
* ``gloo`` — tensors stage through host memory: ``.cpu()`` before a send
  or a collective, ``.to(device)`` after a receive (on one card, S ranks
  share the card and talk through the host);
* ``fake`` — ``torch.distributed``'s fake backend, which only the dry run
  (``launch/dryrun.py``) starts: the same c10d calls as ``nccl``, with
  device tensors, on a group whose collectives move nothing and return at
  once, so an op count sees every collective a step issues at its real
  size. A real group never has this backend.

Any other backend raises. A send's tensor is held until its request is
waited on. A receive that never comes fails after the group's timeout
(``init_process_group(timeout=...)``): a mismatched send is an error,
not a hang.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["process_group", "rank_of", "Hop", "all_reduce_sum",
           "all_gather_rows", "all_gather_cat", "take_block",
           "gather_blocks"]


def process_group(mesh):
    """``mesh`` as a process group: None stays None; anything that is not
    a ``torch.distributed`` ``ProcessGroup`` raises ``TypeError``."""
    if mesh is None:
        return None
    import torch.distributed as dist

    if not (dist.is_available() and isinstance(mesh, dist.ProcessGroup)):
        raise TypeError(f"mesh must be a torch.distributed ProcessGroup (one "
                        f"shard per rank) or None, not {type(mesh).__name__}")
    return mesh


def rank_of(group) -> int:
    """This process's rank in ``group``."""
    import torch.distributed as dist

    return dist.get_rank(group)


def _via_host(group) -> bool:
    """Does ``group``'s backend move tensors through host memory?"""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "nccl":
        return False
    if backend == "gloo":
        return True
    if backend == "fake":
        return False
    raise ValueError(f"no ring transport for backend {backend!r}: the mesh "
                     f"ring runs on nccl or gloo (the dry run on fake)")


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.cpu() if host else t


class Hop:
    """One ring hop, posted at construction: each of ``tensors`` goes to
    the rank ``step`` places ahead in ``group``, and as many tensors of
    the same shapes and dtypes come from the rank ``step`` places behind,
    the k-th under tag ``tag + k``. :meth:`wait` returns them on the
    device of the tensors sent."""

    def __init__(self, group, tensors: Sequence[torch.Tensor], step: int,
                 tag: int):
        import torch.distributed as dist

        host = _via_host(group)
        me, S = dist.get_rank(group), dist.get_world_size(group)
        to = dist.get_global_rank(group, (me + step) % S)
        frm = dist.get_global_rank(group, (me - step) % S)
        self._devices = [t.device for t in tensors]
        self._sent = [_wire(t, host) for t in tensors]
        self._recv = [torch.empty_like(t) for t in self._sent]
        ops = ([dist.P2POp(dist.isend, t, to, group, tag + k)
                for k, t in enumerate(self._sent)]
               + [dist.P2POp(dist.irecv, t, frm, group, tag + k)
                  for k, t in enumerate(self._recv)])
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        self._sent = None
        return [t.to(d) for t, d in zip(self._recv, self._devices)]


def all_reduce_sum(tensors: Sequence[torch.Tensor], group,
                   dtype: torch.dtype = None) -> List[torch.Tensor]:
    """The element-wise sum over ``group`` of each of ``tensors``, in one
    collective over their flat concatenation in ``dtype`` (default the
    first tensor's), each returned in its own dtype; every rank gets the
    same bits."""
    import torch.distributed as dist

    if not tensors:
        return []
    host = _via_host(group)
    flat = torch.empty(sum(t.numel() for t in tensors),
                       dtype=dtype or tensors[0].dtype,
                       device=tensors[0].device)
    at = 0
    for t in tensors:
        flat[at:at + t.numel()].copy_(t.detach().reshape(-1))
        at += t.numel()
    buf = flat.cpu() if host else flat
    dist.all_reduce(buf, group=group)
    flat = buf.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), concatenated along
    dim 0 in rank order."""
    return all_gather_cat([t], group, [0])[0]


def all_gather_cat(tensors: Sequence[torch.Tensor], group,
                   dims: Sequence[int]) -> List[torch.Tensor]:
    """Every rank's ``tensors[k]`` (one shape per k on every rank)
    concatenated along ``dims[k]`` in group-rank order, for every k in
    one collective: the tensors' bytes, each padded to 8, gathered as one
    ``uint8`` buffer (any dtype mix; the bits arrive unchanged)."""
    import torch.distributed as dist

    if not tensors:
        return []
    host = _via_host(group)
    dev = tensors[0].device
    blocks, sizes = [], []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        sizes.append(b.numel())
        pad = -b.numel() % 8
        blocks += [b, b.new_zeros(pad)] if pad else [b]
    buf = _wire(torch.cat(blocks), host)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    parts = [p.to(dev) for p in parts]
    out, at = [], 0
    for t, d, n in zip(tensors, dims, sizes):
        out.append(torch.cat([p[at:at + n].view(t.dtype).reshape(t.shape)
                              for p in parts], dim=d))
        at += n + (-n % 8)
    return out


def _block(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    n = t.shape[0] // dist.get_world_size(group)
    me = dist.get_rank(group)
    return t[me * n:(me + 1) * n]


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole; its adjoint
    gathers every rank's block gradient back into the whole."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return _block(t, group).clone()

    @staticmethod
    def backward(ctx, ct):
        return None, all_gather_rows(ct.contiguous(), ctx.group)


class _GatherBlocks(torch.autograd.Function):
    """Every rank's block, concatenated (the same whole on every rank);
    its adjoint is this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, ct):
        return None, _block(ct, ctx.group).clone()


def take_block(t: torch.Tensor, group) -> torch.Tensor:
    """Rank r's r-th of ``t`` along dim 0 (``t`` the same on every rank;
    differentiable: the gradient of the whole is gathered)."""
    return _TakeBlock.apply(group, t)


def gather_blocks(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, the same
    whole on every rank (differentiable: each rank's gradient is its
    block of the whole's)."""
    return _GatherBlocks.apply(group, t)
