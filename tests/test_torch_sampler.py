"""Port parity for the neighbor sampler (``repro_torch/data/sampler.py``).

The port draws the JAX sampler's numbers with the same numpy calls, so
one seed gives BIT-IDENTICAL blocks in both packages: the neighbor table
(``nbr``, ``nbr_eid``, ``nbr_mask``, ``real_deg``), the reverse table,
the block graph's COO and every derived index, ``src_ids``,
``gcn_norm``, the seeds / labels / label mask and the shape signature —
for seeds 0–2, a short final batch, ``reset``, fan-outs below and above
the max in-degree, and ``edge_rel`` tagging.
"""
import numpy as np
import pytest
import torch

from repro.core import from_coo as jax_from_coo
from repro.data import NeighborSampler as JaxSampler
from repro_torch.core import from_coo
from repro_torch.data import MiniBatch, NeighborSampler
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

GRAPH_FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src", "perm_src",
                "eid_inv")
BG_FIELDS = ("nbr", "nbr_eid", "nbr_mask", "real_deg", "rev_src", "rev_dst",
             "rev_eid")
# (fanouts, batch size): under, around and above the max in-degree
# (~16 on the graph below); two and three layers
CONFIGS = {"under": ([3, 5], 8), "mixed": ([2, 40], 7),
           "above": ([60, 60], 4), "deep": ([2, 3, 2], 7)}


def _graph(seed=11, n=60, nnz=500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, nnz)
    dst = rng.integers(0, n, nnz)
    return (jax_from_coo(src, dst, n_src=n, n_dst=n),
            from_coo(src, dst, n_src=n, n_dst=n, device="cpu"), rng)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_minibatch(got: MiniBatch, ref) -> None:
    """Every array of the port's minibatch equals JAX's, bit for bit."""
    assert got.shape_signature() == ref.shape_signature()
    for name in ("input_ids", "seed_ids", "labels", "label_mask"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(got.input_ids_host, _np(ref.input_ids))
    assert len(got.blocks) == len(ref.blocks)
    for li, (b, r) in enumerate(zip(got.blocks, ref.blocks)):
        assert (b.bg.n_dst_real, b.bg.fanout) == (r.bg.n_dst_real,
                                                  r.bg.fanout)
        for f in BG_FIELDS:
            np.testing.assert_array_equal(
                _np(getattr(b.bg, f)), _np(getattr(r.bg, f)),
                err_msg=f"block {li} {f}")
        assert (b.bg.g.n_src, b.bg.g.n_dst, b.bg.g.n_edges) == (
            r.bg.g.n_src, r.bg.g.n_dst, r.bg.g.n_edges)
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(
                b.bg.g.host.__dict__[f], _np(getattr(r.bg.g, f)),
                err_msg=f"block {li} graph {f}")
            np.testing.assert_array_equal(
                _np(getattr(b.bg.g, f)), _np(getattr(r.bg.g, f)))
        np.testing.assert_array_equal(_np(b.src_ids), _np(r.src_ids))
        np.testing.assert_array_equal(b.src_ids_host, _np(r.src_ids))
        np.testing.assert_array_equal(_np(b.gcn_norm), _np(r.gcn_norm))
        for f in ("rel", "rel_norm"):
            want = getattr(r, f)
            if want is None:
                assert getattr(b, f) is None
            else:
                np.testing.assert_array_equal(_np(getattr(b, f)),
                                              _np(want), err_msg=f)


def _epoch(sampler, ids, labels, drop_last=False):
    return list(sampler.batches(ids, labels, drop_last=drop_last))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_bit_identical(seed, config):
    """A whole shuffled epoch, its short final batch included."""
    jg, tg, rng = _graph()
    fanouts, batch = CONFIGS[config]
    ids = np.arange(0, 60, 2)          # 30 seeds: the last batch is short
    labels = rng.integers(0, 5, 60)[ids]
    ref = _epoch(JaxSampler(jg, fanouts, batch, seed=seed), ids, labels)
    got = _epoch(NeighborSampler(tg, fanouts, batch, seed=seed,
                                 device="cpu"), ids, labels)
    assert len(got) == len(ref) == -(-len(ids) // batch)
    assert not bool(_np(got[-1].label_mask).all())   # short and masked
    for mb, r in zip(got, ref):
        assert_same_minibatch(mb, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drop_last_and_sample_bit_identical(seed):
    """``drop_last=True`` epochs, then direct ``sample`` calls with
    duplicate and short seed lists, on the stream they leave behind."""
    jg, tg, rng = _graph(seed=3)
    js = JaxSampler(jg, [4, 4], 8, seed=seed)
    ts = NeighborSampler(tg, [4, 4], 8, seed=seed, device="cpu")
    ids = np.arange(60)
    labels = rng.integers(0, 5, 60)
    for mb, r in zip(_epoch(ts, ids, labels, True),
                     _epoch(js, ids, labels, True)):
        assert_same_minibatch(mb, r)
    for seeds in ([5, 5, 9, 0, 5], [59], list(range(8))):
        lab = np.zeros(len(seeds), np.int64)
        assert_same_minibatch(ts.sample(np.array(seeds), lab),
                              js.sample(np.array(seeds), lab))


def test_reset_replays_stream():
    jg, tg, rng = _graph()
    ids = np.arange(60)
    labels = rng.integers(0, 5, 60)
    ts = NeighborSampler(tg, [3, 5], 8, seed=42, device="cpu")
    first = _epoch(ts, ids, labels)
    ts.reset()
    replay = _epoch(ts, ids, labels)
    js = JaxSampler(jg, [3, 5], 8, seed=42)
    _epoch(js, ids, labels)
    js.reset(7)
    ts.reset(7)
    other = _epoch(ts, ids, labels)
    ref_other = _epoch(js, ids, labels)
    for a, b in zip(first, replay):
        assert_same_minibatch(a, b)
    for a, b in zip(other, ref_other):
        assert_same_minibatch(a, b)
    assert any((_np(a.seed_ids) != _np(b.seed_ids)).any()
               for a, b in zip(first, other))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_rel_tagging_bit_identical(seed):
    jg, tg, rng = _graph(seed=5)
    edge_rel = rng.integers(0, 3, jg.n_edges)
    js = JaxSampler(jg, [3, 4], 6, seed=seed, edge_rel=edge_rel)
    ts = NeighborSampler(tg, [3, 4], 6, seed=seed, edge_rel=edge_rel,
                         device="cpu")
    ids = np.arange(0, 60, 3)
    labels = np.zeros(60, np.int64)[ids]
    for mb, r in zip(_epoch(ts, ids, labels), _epoch(js, ids, labels)):
        assert mb.blocks[0].rel is not None
        assert_same_minibatch(mb, r)


def test_blocks_exact_above_max_in_degree():
    """Fan-out ≥ max in-degree keeps every in-edge: each real row's
    sampled sources are exactly its in-neighbours, and pad edges sit in
    the dummy row alone."""
    _, tg, _ = _graph()
    host = tg.host
    deg = np.diff(host.indptr_dst)
    ts = NeighborSampler(tg, [int(deg.max())], 10, seed=0, device="cpu")
    seeds = np.arange(10)
    mb = ts.sample(seeds, np.zeros(10, np.int64))
    (blk,) = mb.blocks
    bg = blk.bg
    np.testing.assert_array_equal(bg.real_deg.numpy(), deg[seeds])
    src_ids = blk.src_ids_host
    for j, v in enumerate(seeds):
        want = np.sort(host.src[host.indptr_dst[v]:host.indptr_dst[v + 1]])
        row = bg.nbr[j][bg.nbr_mask[j]].numpy()
        np.testing.assert_array_equal(np.sort(src_ids[row]), want)
    n_real = int(deg[seeds].sum())
    dst_c = bg.g.dst_caller.numpy()
    assert (dst_c[:n_real] < bg.n_dst_real).all()
    assert (dst_c[n_real:] == bg.n_dst_real).all()
    assert (blk.gcn_norm.numpy()[n_real:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_table_built_on_first_use(seed):
    """Sampling builds no reverse table (serving never reads one); the
    first read builds JAX's, bit for bit, and later reads reuse it. The
    trainer's sampler (``reverse=True``) builds it with each block."""
    jg, tg, _ = _graph(seed=7)
    seeds, lab = np.arange(0, 40, 5), np.zeros(8, np.int64)
    got = NeighborSampler(tg, [3, 5], 8, seed=seed,
                          device="cpu").sample(seeds, lab)
    ref = JaxSampler(jg, [3, 5], 8, seed=seed).sample(seeds, lab)
    built = NeighborSampler(tg, [3, 5], 8, seed=seed, device="cpu",
                            reverse=True).sample(seeds, lab)
    for b, r, t in zip(got.blocks, ref.blocks, built.blocks):
        assert not b.bg.has_reverse and t.bg.has_reverse
        for f in ("rev_src", "rev_dst", "rev_eid"):
            np.testing.assert_array_equal(_np(getattr(t.bg, f)),
                                          _np(getattr(r.bg, f)), err_msg=f)
        first = b.bg.rev_eid
        for f in ("rev_src", "rev_dst", "rev_eid"):
            assert getattr(b.bg, f).dtype == torch.int32
            np.testing.assert_array_equal(_np(getattr(b.bg, f)),
                                          _np(getattr(r.bg, f)), err_msg=f)
        assert b.bg.rev_eid is first


def test_sampler_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("host has a GPU: the default device is usable")
    _, tg, _ = _graph()
    with pytest.raises(RuntimeError, match="cuda"):
        NeighborSampler(tg, [2], 4)
