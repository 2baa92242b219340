"""The model axis's split collectives (``repro_torch.core.transport``)
reduce in their operand's dtype, on 2 ``gloo`` ranks on the CPU.

One spawn of 2 ranks (``tests/test_torch_ring_mesh.py``'s harness) calls
``reduce_scatter_along``, ``reduce_from_group``, ``copy_to_group``'s
backward and ``gather_along``'s backward on tensors drawn from a numpy
seed per rank, in bfloat16 and in float32. Held: each result keeps its
input's dtype; a bfloat16 result equals the bfloat16 rounding of the two
ranks' exact sum (what a reduction in bfloat16 of two values gives), a
float32 one the float32 sum; ``op_analysis`` counts every reduction an
op posts in its input's dtype, and the bfloat16 reduce-scatter at half
the bytes of the float32 one.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_ring_mesh import gather_to_root, init_rank, spawn_ranks

WORLD = 2
SHAPE = (3, 8, 5)           # (B, S, D): dim 1 splits over the ranks
DTYPES = ("bfloat16", "float32")
OPS = ("reduce_scatter_along", "reduce_from_group", "copy_to_group_grad",
       "gather_along_grad")


def _inputs(rank: int, dtype: str) -> tuple:
    """Rank ``rank``'s value and cotangent (numpy seed per rank)."""
    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    dt = getattr(torch, dtype)
    return x.to(dt), g.to(dt)


def _calls(group, rank: int, dtype: str) -> dict:
    """Each op's result and the dtypes its reductions ran in (as
    ``op_analysis`` counts the operands)."""
    from repro_torch.core import transport as T
    from repro_torch.launch.op_analysis import OpAnalysis

    x, g = _inputs(rank, dtype)
    half = SHAPE[1] // WORLD

    def grad_of(apply, leaf):
        leaf = leaf.clone().requires_grad_(True)
        apply(leaf).backward(g)
        return leaf.grad

    ops = {"reduce_scatter_along":
           lambda: T.reduce_scatter_along(x, group, 1),
           "reduce_from_group": lambda: T.reduce_from_group(x, group),
           "copy_to_group_grad": lambda: grad_of(
               lambda t: T.copy_to_group(t, group), x),
           "gather_along_grad": lambda: grad_of(
               lambda t: T.gather_along(t, group, 1),
               x.narrow(1, rank * half, half))}
    out = {}
    for op, call in ops.items():
        with OpAnalysis() as oa:
            out[op] = call().detach()
        out[op + "/reduced_in"] = {r["dtype"]
                                   for r in oa.top_collectives(None)
                                   if r["kind"] != "all-gather"}
    return out


def _rank(rank: int, root: str) -> None:
    import torch.distributed as dist

    from repro_torch.core.transport import reduce_scatter_along
    from repro_torch.launch.op_analysis import OpAnalysis

    group = init_rank(rank, WORLD, root)
    try:
        res = {"rank": rank}
        for dtype in DTYPES:
            for op, t in _calls(group, rank, dtype).items():
                res[f"{op}/{dtype}"] = t
            with OpAnalysis() as oa:
                reduce_scatter_along(_inputs(rank, dtype)[0], group, 1)
            res[f"counted/{dtype}"] = (
                oa.analyze()["collective_bytes"],
                [(r["kind"], r["dtype"]) for r in oa.top_collectives(None)])
        got = gather_to_root(group, res)
        if rank == 0:
            with open(os.path.join(root, "out.pkl"), "wb") as f:
                pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("transport_dtype")
    spawn_ranks(_rank, WORLD, (str(root),))
    with open(root / "out.pkl", "rb") as f:
        return pickle.load(f)


def _want(op: str, rank: int, dtype: str) -> torch.Tensor:
    """The exact sum of the two ranks' values (or cotangents) in float64,
    rounded once to ``dtype``, of the block ``op`` returns on ``rank``."""
    key = 1 if op.endswith("_grad") else 0
    total = sum(_inputs(r, dtype)[key].double() for r in range(WORLD))
    if op in ("reduce_scatter_along", "gather_along_grad"):
        half = SHAPE[1] // WORLD
        total = total.narrow(1, rank * half, half)
    return total.to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_split_collective_sums_in_its_operand_dtype(ranks, op, dtype):
    for res in ranks:
        got = res[f"{op}/{dtype}"]
        assert got.dtype == getattr(torch, dtype), (op, got.dtype)
        want = _want(op, res["rank"], dtype)
        assert got.shape == want.shape
        assert torch.equal(got, want), (op, dtype, res["rank"])
        assert res[f"{op}/reduced_in/{dtype}"] == {dtype}, op


def test_op_analysis_counts_a_bf16_reduce_scatter_at_half_the_bytes(ranks):
    for res in ranks:
        bf16, kinds16 = res["counted/bfloat16"]
        fp32, kinds32 = res["counted/float32"]
        assert bf16["reduce-scatter"] * 2 == fp32["reduce-scatter"] > 0
        assert kinds16 == [("reduce-scatter", "bfloat16")]
        assert kinds32 == [("reduce-scatter", "float32")]
