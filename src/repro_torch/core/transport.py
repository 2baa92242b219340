"""Transport over a ``torch.distributed`` process group: the mesh ring's
(one vertex shard per rank; ``core/partition.py``, the trainers) and the
LM mesh step's (``launch/fsdp.py``: a block's sharded leaves gathered
over the sub-groups of their mesh dims, their gradients reduce-scattered
over the batch axes; ``launch/steps.py``: the rest summed over them;
``models/lm/tp.py``: the activations of the model axis's compute split).

The split's collectives are ``torch.autograd.Function`` s, each the
adjoint of another: :func:`copy_to_group` (identity, its gradient summed
over the group), :func:`reduce_from_group` (a sum over the group, its
gradient passed through), :func:`gather_along` (an all-gather along a
dim, its gradient reduce-scattered), :func:`reduce_scatter_along` (a
reduce-scatter along a dim, its gradient all-gathered), and
:func:`gather_blocks` / :func:`take_block` (an all-gather and a rank's
block of a value every rank holds whole, each the other's adjoint). Each
sum runs in its operand's dtype (bf16 where the model is bf16), as GSPMD
reduces a value in the dtype it has at the reduction; a value JAX holds in
float32 at that point is float32 here too. Gathers move the bits.

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
           "all_gather_rows", "all_gather_cat", "reduce_scatter_sum",
           "reduce_scatter_cat",
           "take_block", "gather_blocks", "copy_to_group",
           "reduce_from_group", "gather_along", "reduce_scatter_along"]


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


def reduce_scatter_sum(t: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
    """The element-wise sum over ``group`` of every rank's ``t`` (one
    shape on every rank), this rank's block of it along ``dim`` (blocks
    in group-rank order), summed in ``t``'s dtype."""
    return reduce_scatter_cat([t], group, [dim])[0]


def reduce_scatter_cat(tensors: Sequence[torch.Tensor], group,
                       dims: Sequence[int]) -> List[torch.Tensor]:
    """:func:`reduce_scatter_sum` of several tensors in one collective:
    this rank's block along ``dims[k]`` of the sum over ``group`` of every
    rank's ``tensors[k]`` (one shape per k on every rank), for every k,
    summed in their dtype (one dtype for all)."""
    import torch.distributed as dist

    if not tensors:
        return []
    host = _via_host(group)
    n = dist.get_world_size(group)
    rows = [t.detach().movedim(d, 0).reshape(n, -1)
            for t, d in zip(tensors, dims)]
    x = (rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)).reshape(-1)
    out = x.new_empty(x.numel() // n)
    if host:
        buf = out.cpu()
        dist.reduce_scatter_tensor(buf, x.cpu(), group=group)
        out = buf.to(x.device)
    else:
        dist.reduce_scatter_tensor(out, x, group=group)
    got, at = [], 0
    for t, d, r in zip(tensors, dims, rows):
        shape = list(t.movedim(d, 0).shape)
        shape[0] //= n
        got.append(out[at:at + r.shape[1]].reshape(shape).movedim(0, d))
        at += r.shape[1]
    return got


def _block(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    import torch.distributed as dist

    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole; its adjoint
    gathers every rank's block gradient back into the whole."""

    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return _block(t, group, dim).clone()

    @staticmethod
    def backward(ctx, ct):
        return None, all_gather_cat([ct.contiguous()], ctx.group,
                                    [ctx.dim])[0], None


class _GatherBlocks(torch.autograd.Function):
    """Every rank's block, concatenated (the same whole on every rank);
    its adjoint is this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat([t], group, [dim])[0]

    @staticmethod
    def backward(ctx, ct):
        return None, _block(ct, ctx.group, ctx.dim).clone(), None


class _CopyToGroup(torch.autograd.Function):
    """The identity; its adjoint sums the gradient over the group (a
    value every rank holds whole, each rank using it for its own share
    of the work)."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return None, all_reduce_sum([ct], ctx.group)[0]


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group of every rank's partial value; its adjoint
    passes the gradient (the same on every rank) through."""

    @staticmethod
    def forward(ctx, group, t):
        return all_reduce_sum([t], group)[0]

    @staticmethod
    def backward(ctx, ct):
        return None, ct


class _GatherAlong(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated; its adjoint sums
    the ranks' gradients of the whole and keeps this rank's block (each
    rank used the whole for its own share of the work)."""

    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat([t], group, [dim])[0]

    @staticmethod
    def backward(ctx, ct):
        return None, reduce_scatter_sum(ct, ctx.group, ctx.dim), None


class _ReduceScatterAlong(torch.autograd.Function):
    """The sum over the group of every rank's partial value, this rank's
    block of it along ``dim``; its adjoint gathers the blocks' gradients
    into the whole."""

    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_sum(t, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return None, all_gather_cat([ct.contiguous()], ctx.group,
                                    [ctx.dim])[0], None


def take_block(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Rank r's r-th of ``t`` along ``dim`` (``t`` the same on every rank;
    differentiable: the gradient of the whole is gathered)."""
    return _TakeBlock.apply(group, t, dim)


def gather_blocks(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, the
    same whole on every rank (differentiable: each rank's gradient is its
    block of the whole's)."""
    return _GatherBlocks.apply(group, t, dim)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient is summed over ``group``."""
    return _CopyToGroup.apply(group, t)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, in ``t``'s dtype;
    its gradient passes through."""
    return _ReduceFromGroup.apply(group, t)


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``; its gradient is
    reduce-scattered back along ``dim``."""
    return _GatherAlong.apply(group, t, dim)


def reduce_scatter_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``;
    its gradient is all-gathered along ``dim``."""
    return _ReduceScatterAlong.apply(group, t, dim)
