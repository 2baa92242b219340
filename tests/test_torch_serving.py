"""Port parity for the serving slice as a whole.

* ``FeatureCache`` and ``MicroBatcher`` replay the same request sequences
  as the JAX package's, with identical accounting and batches.
* The port's ``GNNServer`` (device="cpu") serves the same rows as JAX's
  ``GNNServer`` for gcn/sage/gat at 1e-5, across batch splits, request
  orderings and duplicate ids; both serve GAT multipass.
* One ``RequestQueue`` session runs end to end through ``run_session``.
* Entry points called without ``device`` on a host with no GPU raise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import GNNServer as JaxServer
from repro.core import from_coo as jax_from_coo
from repro.core.serving import FeatureCache as JaxCache
from repro.core.serving import MicroBatcher as JaxBatcher
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro_torch.core import from_coo
from repro_torch.core.serving import (FeatureCache, GNNServer, MicroBatcher,
                                      hot_node_ids)
from repro_torch.data import RequestQueue, make_node_dataset
from repro_torch.launch.serve_gnn import (build_server,
                                          percentile_nearest_rank,
                                          run_session)
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import from_jax_params
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

N, D_IN, D_HID, K_IN = 100, 8, 8, 4
CLASSES = (4, 16)
APPS = ("gcn", "sage", "gat")
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
TOL = 1e-5

_built = {}


def _setup(app):
    """(JAX server, port server) on the same graph, features and params."""
    if app not in _built:
        rng = np.random.default_rng(17)
        feats = rng.standard_normal((N, D_IN)).astype(np.float32)
        src = rng.integers(0, N, (N, K_IN)).reshape(-1)
        dst = np.repeat(np.arange(N), K_IN)
        params = JAX_APPS[app].init(jax.random.PRNGKey(17), D_IN, D_HID, 5)
        jsrv = JaxServer(app, params, jax_from_coo(src, dst, n_src=N,
                                                   n_dst=N),
                         feats, mode="layerwise", classes=CLASSES,
                         cache_rows=32, pin_hot=8)
        model = from_jax_params(app, jax.tree_util.tree_map(np.asarray,
                                                            params),
                                device="cpu")
        tsrv = GNNServer(app, model, from_coo(src, dst, n_src=N, n_dst=N,
                                              device="cpu"),
                         feats, classes=CLASSES, cache_rows=32, pin_hot=8,
                         device="cpu")
        _built[app] = (jsrv, tsrv)
    return _built[app]


def _check(app, requests):
    jsrv, tsrv = _setup(app)
    ref = jsrv.serve(requests)
    got = tsrv.serve(requests)
    assert sorted(got) == sorted(ref)
    for rid, ids in requests:
        assert got[rid].shape == (len(np.atleast_1d(ids)), 5)
        np.testing.assert_allclose(got[rid], ref[rid], rtol=TOL, atol=TOL,
                                   err_msg=f"{app} rid={rid}")
    js, ts = jsrv._out_cache.stats(), tsrv._out_cache.stats()
    assert (ts.hits, ts.misses, ts.evictions, ts.pinned_hits, ts.size) == (
        js.hits, js.misses, js.evictions, js.pinned_hits, js.size)


@pytest.mark.parametrize("app", APPS)
def test_served_rows_match_jax_server(app):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, N, 12)
    _check(app, [(0, ids)])                                   # one request
    _check(app, [(i, ids[i:i + 1]) for i in range(len(ids))])  # singles
    _check(app, [(0, ids[:5]), (1, ids[5:7]), (2, ids[7:])])  # uneven
    for _ in range(3):                                        # orderings
        _check(app, [(0, ids[rng.permutation(len(ids))])])
    _check(app, [(0, np.array([7, 7, 3, 99, 3, 7, 0, 0]))])   # duplicates
    _check(app, [(0, [7, 3, 7]), (1, [3, 3]), (2, [7])])
    _check(app, [(0, rng.integers(0, N, 40))])                # oversize


def test_gat_server_serves_multipass():
    """Both servers' GAT tables are their package's multipass forward,
    and agree with each other at 1e-5."""
    jsrv, tsrv = _setup("gat")
    jsrv.serve([(0, [0])])
    tsrv.serve([(0, [0])])
    jref = jax_gat.infer(jsrv.params, jsrv._graph_arg,
                         jax.numpy.asarray(jsrv.feats), attn="multipass")
    np.testing.assert_array_equal(jsrv._out_cache.store, np.asarray(jref))
    tref = gat.infer(tsrv.model, tsrv.bundle, tsrv.x_device,
                     attn="multipass").numpy()
    np.testing.assert_array_equal(tsrv._out_cache.store, tref)
    np.testing.assert_allclose(tsrv._out_cache.store, jsrv._out_cache.store,
                               rtol=TOL, atol=TOL)


def test_no_new_signatures_in_steady_state():
    for app in APPS:
        _, srv = _setup(app)
        srv.warmup()
        before = srv.compiles
        rng = np.random.default_rng(6)
        for i in range(10):
            srv.serve([(i, rng.integers(0, N, rng.integers(1, 17)))])
        assert srv.compiles == before
        srv.tracker.assert_bounded()
        assert srv.mode_for_class(CLASSES[0]) == "layerwise"


def _cache_trace(rng, n_rows=32, n_ops=80):
    """Lookups over a skewed id distribution, updates and invalidations."""
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.75:
            k = int(rng.integers(1, 6))
            ids = np.where(rng.random(k) < 0.5, rng.integers(0, 4, k),
                           rng.integers(0, n_rows, k))
            ops.append(("lookup", ids))
        elif r < 0.93:
            ops.append(("update", rng.integers(0, n_rows,
                                               int(rng.integers(1, 4)))))
        else:
            ops.append(("invalidate", None if r > 0.97 else
                        rng.integers(0, n_rows, 2)))
    return ops


@pytest.mark.parametrize("capacity,n_pinned", [(4, 0), (4, 3), (0, 2),
                                               (100, 5)])
@pytest.mark.parametrize("seed", range(3))
def test_feature_cache_replays_jax_accounting(seed, capacity, n_pinned):
    store = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    pinned = np.arange(n_pinned)
    ours = FeatureCache(store.copy(), capacity, pinned=pinned)
    theirs = JaxCache(store.copy(), capacity, pinned=pinned)
    bump = 0.0
    for kind, ids in _cache_trace(np.random.default_rng(seed)):
        if kind == "lookup":
            np.testing.assert_array_equal(ours.lookup(ids),
                                          theirs.lookup(ids))
        elif kind == "update":
            bump += 1.0
            rows = store[ids] + bump
            ours.update(ids, rows)
            theirs.update(ids, rows)
        else:
            ours.invalidate(ids)
            theirs.invalidate(ids)
        assert list(ours._lru) == list(theirs._lru)
    assert ours.pinned_ids == theirs.pinned_ids
    assert [ours.resident(i) for i in range(32)] == [
        theirs.resident(i) for i in range(32)]
    a, b = ours.stats(), theirs.stats()
    for f in ("hits", "misses", "evictions", "pinned_hits", "size",
              "pinned", "capacity"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.hit_ratio == b.hit_ratio


def test_hot_node_ids_match_jax():
    from repro.core.serving import hot_node_ids as jax_hot
    deg = np.random.default_rng(0).integers(0, 9, 50)
    for k in (0, 5, 50, 99):
        np.testing.assert_array_equal(hot_node_ids(deg, k), jax_hot(deg, k))


@pytest.mark.parametrize("seed", range(4))
def test_micro_batcher_replays_jax(seed):
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, 1000, int(rng.integers(1, 40))))
            for i in range(30)]
    ours = MicroBatcher((4, 16, 32)).coalesce(reqs)
    theirs = JaxBatcher((4, 16, 32)).coalesce(reqs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.ids, b.ids)
        assert (a.n_real, a.cls, a.spans) == (b.n_real, b.cls, b.spans)


def test_request_queue_session_end_to_end():
    """build_server + run_session on the tiny preset: every response is
    the full forward's rows, no new signatures under load."""
    srv = build_server("gcn", "tiny", d_hidden=8, device="cpu")
    ref = gcn.infer(srv.model, srv.bundle, srv.x_device,
                    strategy="segment").numpy()
    res = run_session(srv, n_clients=3, requests_per_client=6,
                      ids_fn=lambda r: r.integers(0, srv.g.n_src, 4),
                      timeout=60.0)
    assert res["n_samples"] == len(res["responses"]) == 18
    assert res["recompiles_steady"] == 0
    assert res["p50_ms"] <= res["p99_ms"]
    for ids, rows in res["responses"]:
        np.testing.assert_allclose(rows, ref[ids], rtol=TOL, atol=TOL)


def test_request_queue_first_wins_and_close():
    rq = RequestQueue(max_wait=0.0)
    a = rq.submit([1, 2])
    b = rq.submit([3])
    assert a.set_result("x") and not a.set_error(RuntimeError("late"))
    rq.close(cancel_pending=True)
    assert a.result(timeout=1) == "x"
    with pytest.raises(RuntimeError, match="queue closed"):
        b.result(timeout=1)
    with pytest.raises(RuntimeError):
        rq.submit([4])
    assert list(rq) == []


def test_update_features_refreshes_the_table():
    _, tsrv = _setup("gcn")
    srv = GNNServer("gcn", tsrv.model, tsrv.g, tsrv.feats.copy(),
                    classes=CLASSES, cache_rows=32, pin_hot=8, device="cpu")
    ids = np.arange(10)
    before = srv.serve([(0, ids)])[0]
    srv.update_features([2], 10 + srv.feats[2])
    after = srv.serve([(1, ids)])[1]
    ref = gcn.infer(srv.model, srv.bundle,
                    torch.from_numpy(srv.feats)).numpy()
    np.testing.assert_allclose(after, ref[ids], rtol=TOL, atol=TOL)
    assert not np.allclose(before, after, atol=TOL)


def test_queued_modes_and_apps_raise():
    """Fan-out serving and R-GCN are ported (tests/test_torch_serving_fanout.py,
    test_torch_serving_rgcn.py): an unknown mode or app raises, and R-GCN
    without its relations."""
    _, tsrv = _setup("gcn")
    with pytest.raises(ValueError, match="unknown serve mode"):
        GNNServer("gcn", tsrv.model, tsrv.g, tsrv.feats, mode="push",
                  device="cpu")
    with pytest.raises(ValueError, match="rels"):
        GNNServer("rgcn", tsrv.model, tsrv.g, tsrv.feats, device="cpu")
    with pytest.raises(ValueError, match="unknown serve app"):
        GNNServer("gin", tsrv.model, tsrv.g, tsrv.feats, device="cpu")
    with pytest.raises(ValueError, match="unknown serve app"):
        build_server("gin", "tiny", device="cpu")


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile_nearest_rank(xs, 50) == 50
    assert percentile_nearest_rank(xs, 99) == 99
    assert percentile_nearest_rank([5.0], 99) == 5.0


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("host has a GPU: the default device is usable")
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: from_coo([0, 1], [1, 0]),
        lambda: make_node_dataset("tiny"),
        lambda: build_server("gcn", "tiny"),
        lambda: gcn.init(gen, 4, 4, 2),
        lambda: sage.init(gen, 4, 4, 2),
        lambda: gat.init(gen, 4, 4, 2),
        lambda: from_jax_params("gcn", {"layers": [
            {"w": np.zeros((2, 2), np.float32)}]}),
        lambda: GNNServer("gcn", _setup("gcn")[1].model, _setup("gcn")[1].g,
                          np.zeros((N, D_IN), np.float32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
