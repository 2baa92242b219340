"""The kernels' costs reproduce the ``bound ms`` column of the port's
kernel table (PERF.md), measured on ``reddit-like`` with self-loops
(R-MAT seed 0: 65,536 nodes, 627,774 edges), so the roofline shares
divide by the same yardstick as that table."""
import pytest
import torch

from gnnbench.costs import binary_reduce_csr, sddmm_csr, spmm_csr
from gnnbench.costs.peaks import least_seconds


@pytest.fixture(scope="module")
def reddit_like():
    from repro_torch.core.graph import add_self_loops, from_coo
    from repro_torch.data.synthetic import rmat_graph
    src, dst, n = rmat_graph(16, 600_000, seed=0)
    src, dst = add_self_loops(src, dst, n)
    g = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    assert g.n_edges == 627_774
    return g


def meta(*shape):
    return torch.empty(shape, device="meta")




CASES = [
    # (kernel, arguments from the graph g, bound ms in the table)
    ("B1 d=602 mean", spmm_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 602), "weight": None, "mean": True},
     0.09504),
    ("B1 d=32 w-sum", spmm_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 32), "weight": meta(g.n_edges)},
     0.00659),
    ("B1 d=41 w-sum", spmm_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 41), "weight": meta(g.n_edges)},
     0.00799),
    ("B1 d=32 mean", spmm_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 32), "weight": None}, 0.00584),
    ("B3 add u,v d=4", sddmm_csr, lambda g: {
        "g": g, "op": "add", "lhs_target": "u", "lhs": meta(g.n_src, 4),
        "rhs_target": "v", "rhs": meta(g.n_dst, 4)}, 0.00512),
    ("B3 sub e,v d=4", sddmm_csr, lambda g: {
        "g": g, "op": "sub", "lhs_target": "e", "lhs": meta(g.n_edges, 4),
        "rhs_target": "v", "rhs": meta(g.n_dst, 4)}, 0.00706),
    ("B3 dot u,v d=4", sddmm_csr, lambda g: {
        "g": g, "op": "dot", "lhs_target": "u", "lhs": meta(g.n_src, 4),
        "rhs_target": "v", "rhs": meta(g.n_dst, 4)}, 0.00287),
    ("B3 copy u d=4", sddmm_csr, lambda g: {
        "g": g, "op": "copy", "lhs_target": "u", "lhs": meta(g.n_src, 4)},
     0.00406),
    ("B4 copy_rhs sum d=4", binary_reduce_csr, lambda g: {
        "g": g, "B": None, "E": meta(g.n_edges, 4)}, 0.00414),
    ("B4 copy_rhs sum d=1", binary_reduce_csr, lambda g: {
        "g": g, "B": None, "E": meta(g.n_edges, 1)}, 0.00166),
    ("B4 mul d=32", binary_reduce_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 32), "E": meta(g.n_edges, 32)}, 0.03057),
    ("B4 div d=41 E d=1", binary_reduce_csr, lambda g: {
        "g": g, "B": meta(g.n_src, 41), "E": meta(g.n_edges, 1)}, 0.00874),
]


@pytest.mark.parametrize("label,mod,args,bound_ms", CASES,
                         ids=[c[0] for c in CASES])
def test_bound_column(reddit_like, label, mod, args, bound_ms):
    nbytes, flops = mod.cost(mod.describe(args(reddit_like)))
    assert round(least_seconds(nbytes, flops) * 1e3, 5) == bound_ms


def test_dot_per_head_counts_each_head():
    """GAT's ∂α on the cells' graph (14,559,952 edges, 8 heads of 8):
    B3's dot per head writes one fp32 output a head, 466 MB a launch."""
    import numpy as np
    from types import SimpleNamespace
    n, e = 232_965, 14_559_952
    deg = np.ones(n, dtype=np.int64)
    g = SimpleNamespace(n_edges=e, host=SimpleNamespace(out_degrees=deg,
                                                        in_degrees=deg))
    args = {"g": g, "op": "dot", "lhs_target": "u", "lhs": meta(n, 64),
            "rhs_target": "v", "rhs": meta(n, 64), "heads": 8}
    c = sddmm_csr.describe(args)
    assert c["d_out"] == 8
    nbytes, flops = sddmm_csr.cost(c)
    rows = 4 * 2 * n * 64
    assert nbytes - rows - 4 * 2 * e == 4 * e * 8 == 465_918_464
    assert flops == 2.0 * e * 64
    one = sddmm_csr.cost(sddmm_csr.describe(dict(args, heads=1)))[0]
    assert nbytes - one == 4 * e * 7


def test_model_flops_sage_reddit():
    """About 0.33 TFLOP a SAGE step at Reddit's widths, 14.56M edges."""
    from gnnbench.costs import model_sage
    cfg = {"features": 602, "hidden": 256, "classes": 41, "layers": 2}
    step = model_sage.train_step(cfg, 232_965, 14_559_952)
    assert 3.2e11 < step < 3.5e11
    assert model_sage.forward(cfg, 232_965, 14_559_952) < step / 2
