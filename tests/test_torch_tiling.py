"""Port parity for the blocked packs (``repro_torch.core.tiling``) and the
pack half of the planner's ``PlanCache``.

Each pack the port builds from the same numpy COO arrays must equal the
JAX package's array for array — values, dtypes and shapes — in the same
chunk order, with the same pad slots and masks: the degree-bucketed ELL
at several width caps, the row-complete ragged ELL, the uniform ELL and
the tile pack at several geometries. The graphs cover an empty graph,
destinations with no in-edge, a hub row far wider than the width cap,
and duplicate edges.
"""
import numpy as np
import pytest

from repro.core import tiling as jax_tiling
from repro.core.graph import from_coo as jax_from_coo
from repro_torch.core import planner, tiling
from repro_torch.core.graph import from_coo, reverse
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")


def _edges(kind):
    """(src, dst, n_src, n_dst) host COO of each test graph."""
    rng = np.random.default_rng(4)
    if kind == "empty":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 6, 9
    if kind == "zero_in_degree":    # destinations 60… have no in-edge
        src = rng.integers(0, 100, 300)
        return src, rng.integers(0, 60, 300), 100, 80
    if kind == "hub":               # row 3 holds 150 in-edges, dups too
        src = np.concatenate([rng.integers(0, 200, 150),
                              rng.integers(0, 200, 250)])
        dst = np.concatenate([np.full(150, 3), rng.integers(0, 120, 250)])
        return src, dst, 200, 130
    src = rng.integers(0, 150, 700)             # zipf: a degree tail
    return src, (rng.zipf(1.5, 700) - 1) % 140, 150, 140


GRAPHS = ("empty", "zero_in_degree", "hub", "skewed")
_memo = {}


def _graphs(kind):
    if kind not in _memo:
        src, dst, ns, nd = _edges(kind)
        _memo[kind] = (jax_from_coo(src, dst, n_src=ns, n_dst=nd),
                       from_coo(src, dst, n_src=ns, n_dst=nd, device="cpu"))
    return _memo[kind]


def _same(jarr, tarr, what):
    j, t = np.asarray(jarr), tarr.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, (what, j.dtype,
                                                        t.dtype, j.shape,
                                                        t.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _same_class(jc, tc, what):
    assert jc.width == tc.width, what
    for f in ("chunk_cols", "chunk_eids", "chunk_mask", "chunk_row"):
        _same(getattr(jc, f), getattr(tc, f), f"{what} {f}")


def _same_pack(jp, tp, what):
    assert jp.n_dst == tp.n_dst
    assert [c.width for c in jp.classes] == [c.width for c in tp.classes]
    for i, (jc, tc) in enumerate(zip(jp.classes, tp.classes)):
        _same_class(jc, tc, f"{what} class {i}")


@pytest.mark.parametrize("cap", [64, 8, 3, 1])
@pytest.mark.parametrize("kind", GRAPHS)
def test_ell_equals_jax(kind, cap):
    jg, tg = _graphs(kind)
    _same_pack(jax_tiling.build_ell(jg, cap), tiling.build_ell(tg, cap),
               f"ell cap {cap}")


@pytest.mark.parametrize("kind", GRAPHS)
def test_ell_ragged_equals_jax(kind):
    jg, tg = _graphs(kind)
    jp, tp = jax_tiling.build_ell_ragged(jg), tiling.build_ell_ragged(tg)
    _same_pack(jp, tp, "ragged")
    # whole rows, each row in its tightest power-of-two class
    for c in tp.classes:
        ln = c.chunk_mask.sum(1)
        assert (ln <= c.width).all()
        if c.width > 1:
            assert (ln > c.width // 2).all()


@pytest.mark.parametrize("kind", GRAPHS)
def test_ell_uniform_equals_jax(kind):
    jg, tg = _graphs(kind)
    width = int(max(tg.host.in_degrees.max(initial=0), 1)) + 2
    _same_class(jax_tiling.build_ell_uniform(jg, width),
                tiling.build_ell_uniform(tg, width), "uniform")
    if tg.n_edges:
        with pytest.raises(ValueError, match="max degree"):
            tiling.build_ell_uniform(tg, width - 3)


TILE_FIELDS = ("tile_m", "tile_k", "first_of_m", "dst_local", "src_local",
               "eids", "mask")
TILE_META = ("bm", "bk", "eb", "n_dst", "n_src", "n_tiles_m", "n_tiles_k",
             "n_buckets")


@pytest.mark.parametrize("geom", [(128, 128, 256), (16, 32, 8), (8, 8, 4)],
                         ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("kind", GRAPHS)
def test_tiles_equal_jax(kind, geom):
    jg, tg = _graphs(kind)
    jp, tp = jax_tiling.build_tiles(jg, *geom), tiling.build_tiles(tg, *geom)
    for f in TILE_FIELDS:
        _same(getattr(jp, f), getattr(tp, f), f)
    assert tuple(getattr(tp, f) for f in TILE_META) == tuple(
        getattr(jp, f) for f in TILE_META)


def test_hub_row_is_split_at_the_cap():
    """A row wider than the cap becomes cap-wide chunks in the cap's
    class, every edge in exactly one slot."""
    _, tg = _graphs("hub")
    pack = tiling.build_ell(tg, 64)
    cap_cls = [c for c in pack.classes if c.width == 64][0]
    rows = cap_cls.chunk_row.numpy()
    assert (rows == 3).sum() == 2            # 150 = 64 + 64 + 22
    eids = np.concatenate([c.chunk_eids.numpy()[c.chunk_mask.numpy()]
                           for c in pack.classes])
    np.testing.assert_array_equal(np.sort(eids), np.arange(tg.n_edges))
    assert pack.slots >= tg.n_edges


def test_plan_cache_builds_each_pack_once():
    src, dst, ns, nd = _edges("skewed")
    g = from_coo(src, dst, n_src=ns, n_dst=nd, device="cpu")
    cache = planner.get_plan_cache(g)
    assert planner.get_plan_cache(g) is cache
    assert cache.peek("ell") is None and cache.peek("tiles") is None
    assert cache.peek("ell_ragged") is None
    before = planner.pack_build_totals()
    ell = cache.ell()
    assert cache.ell() is ell and cache.ell(64) is ell
    assert cache.peek("ell") is ell
    tiles = cache.tiles()
    assert cache.tiles(128, 128, 256) is tiles
    assert cache.peek("tiles") is tiles
    small = cache.tiles(16, 16, 8)
    assert cache.tiles(16, 16, 8) is small and small is not tiles
    rag = cache.ell_ragged()
    assert cache.ell_ragged() is rag and cache.peek("ell_ragged") is rag
    width = int(g.host.in_degrees.max())
    uni = cache.ell_uniform(width)
    assert cache.ell_uniform(width) is uni
    after = planner.pack_build_totals()
    # kinds this test does not build (a partition built by an earlier
    # test in the process) stay out of the comparison
    built = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert built == {"ell": 1, "tiles": 2, "ell_ragged": 1,
                     "ell_uniform": 1}
    # a cap change re-slots: the old pack stays keyed by its cap
    cache.set_ell_cap(8)
    assert cache.peek("ell") is None
    e8 = cache.ell()
    assert [c.width for c in e8.classes] == [
        c.width for c in tiling.build_ell(g, 8).classes]
    assert cache.ell(64) is ell
    cache.set_ell_cap(64)
    assert cache.ell() is ell and cache.ell(8) is e8
    # every graph has its own cache; Gᵀ's packs are Gᵀ's
    rg = reverse(g)
    assert planner.get_plan_cache(rg) is not cache
    assert planner.get_plan_cache(rg).ell().n_dst == g.n_src
