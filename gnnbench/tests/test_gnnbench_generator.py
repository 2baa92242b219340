"""The generator: counts, determinism by seed, and the node data."""
import pytest
import torch

from gnnbench.data.graph import (derive_seed, glorot_leaves, node_data,
                                 rmat_edges)

N, E = 1000, 20_000


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_counts_and_simple_graph(seed):
    src, dst = rmat_edges(N, E, seed, "cpu")
    assert src.shape == dst.shape == (E + N,)
    assert int(src.min()) >= 0 and int(src.max()) < N
    body_s, body_d = src[:E], dst[:E]
    assert not bool((body_s == body_d).any())
    assert torch.unique(body_s * N + body_d).numel() == E
    assert torch.equal(src[E:], torch.arange(N))
    assert torch.equal(dst[E:], torch.arange(N))


def test_same_seed_same_graph_other_seed_other_graph():
    a = rmat_edges(N, E, 5, "cpu")
    b = rmat_edges(N, E, 5, "cpu")
    c = rmat_edges(N, E, 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_power_law_degrees():
    src, dst = rmat_edges(N, E, 1, "cpu", self_loops=False)
    deg = torch.bincount(dst, minlength=N).float()
    assert float(deg.max()) > 8 * float(deg.mean())


def test_too_many_edges_refused():
    with pytest.raises(ValueError):
        rmat_edges(10, 91, 0, "cpu")


def test_node_data():
    a = node_data(N, 12, 5, 600, 3, "cpu")
    b = node_data(N, 12, 5, 600, 3, "cpu")
    assert a["x"].shape == (N, 12) and a["x"].dtype == torch.float32
    assert int(a["train_mask"].sum()) == 600
    assert int(a["labels"].min()) >= 0 and int(a["labels"].max()) < 5
    for k in a:
        assert torch.equal(a[k], b[k])


def test_glorot_leaves():
    leaves = glorot_leaves({"w": (30, 10), "b": (10,)}, 4, "cpu")
    lim = (6.0 / 40) ** 0.5
    assert float(leaves["w"].abs().max()) <= lim
    assert not bool(leaves["b"].any())


def test_streams_differ():
    assert derive_seed(1, "graph") != derive_seed(1, "nodes")
    assert derive_seed(1, "graph") != derive_seed(2, "graph")
