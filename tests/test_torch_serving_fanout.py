"""Port parity for fan-out serving (``GNNServer(mode="fanout")``) and the
serve planner (``repro_torch/core/planner.py``).

On the cases of tests/launch/test_serve_gnn.py (one request, batch
splits, request orderings, duplicate ids, zero steady-state signatures):

* at fan-out 2 (sampled: the graph's in-degree is 4) the port draws the
  JAX server's blocks, so its served rows equal JAX's served rows at
  1e-5, with the same feature-cache accounting;
* at the default fan-out (the max in-degree) the served rows equal the
  JAX full forward at 1e-5;
* ``mode="auto"`` resolves every class as the JAX server resolves it, on
  a grid of (graph, fanout, class, refresh_batches), and a server whose
  classes resolve to both modes serves JAX's rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GNNServer as JaxServer
from repro.core import from_coo as jax_from_coo
from repro.core import planner as jax_planner
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro_torch.core import from_coo, planner
from repro_torch.core.serving import GNNServer
from repro_torch.models.gnn.common import from_jax_params
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

N, D_IN, D_HID, K_IN = 100, 8, 8, 4
CLASSES = (4, 16)
APPS = ("gcn", "sage", "gat")
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
TOL = 1e-5
# fanout=None: the default (max in-degree, exact); 2: sampled
FANOUTS = (None, 2)

_built = {}


def _setup(app):
    """(src, dst, feats, JAX params, port model, JAX full-forward rows)."""
    if app not in _built:
        rng = np.random.default_rng(17)
        feats = rng.standard_normal((N, D_IN)).astype(np.float32)
        src = rng.integers(0, N, (N, K_IN)).reshape(-1)
        dst = np.repeat(np.arange(N), K_IN)
        params = JAX_APPS[app].init(jax.random.PRNGKey(17), D_IN, D_HID, 5)
        ref = np.asarray(JAX_APPS[app].infer(
            params, jax_make_bundle(jax_from_coo(src, dst, n_src=N,
                                                 n_dst=N)),
            jnp.asarray(feats)))
        model = from_jax_params(app, jax.tree_util.tree_map(np.asarray,
                                                            params),
                                device="cpu")
        _built[app] = (src, dst, feats, params, model, ref)
    return _built[app]


def _pair(app, fanout, **kw):
    """(JAX server, port server) on the same graph, features, params."""
    src, dst, feats, params, model, _ = _setup(app)
    opts = dict(classes=CLASSES, cache_rows=32, pin_hot=8, fanout=fanout)
    opts.update(kw)
    opts.setdefault("mode", "fanout")
    jsrv = JaxServer(app, params, jax_from_coo(src, dst, n_src=N, n_dst=N),
                     feats.copy(), **opts)
    tsrv = GNNServer(app, model, from_coo(src, dst, n_src=N, n_dst=N,
                                          device="cpu"),
                     feats.copy(), device="cpu", **opts)
    return jsrv, tsrv


_servers = {}


def _servers_for(app, fanout):
    if (app, fanout) not in _servers:
        _servers[(app, fanout)] = _pair(app, fanout)
    return _servers[(app, fanout)]


def _check(app, fanout, requests):
    """Both servers serve ``requests``; the port's rows equal JAX's served
    rows (and, at the default fan-out, JAX's full forward)."""
    jsrv, tsrv = _servers_for(app, fanout)
    ref_full = _setup(app)[5]
    ref = jsrv.serve(requests)
    got = tsrv.serve(requests)
    assert sorted(got) == sorted(ref)
    for rid, ids in requests:
        ids = np.atleast_1d(ids)
        assert got[rid].shape == (len(ids), 5)
        np.testing.assert_allclose(got[rid], ref[rid], rtol=TOL, atol=TOL,
                                   err_msg=f"{app} fanout={fanout} {rid}")
        if fanout is None:
            np.testing.assert_allclose(got[rid], ref_full[ids], rtol=TOL,
                                       atol=TOL)
    js, ts = jsrv.stats()["feat_cache"], tsrv.stats()["feat_cache"]
    assert (ts.hits, ts.misses, ts.evictions, ts.pinned_hits, ts.size) == (
        js.hits, js.misses, js.evictions, js.pinned_hits, js.size)
    assert tsrv.stats()["out_cache"] is None       # no refresh in fan-out
    assert tsrv.refreshes == 0


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("app", APPS)
def test_served_equals_jax(app, fanout):
    rng = np.random.default_rng(3)
    _check(app, fanout, [(0, rng.integers(0, N, 6))])


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("app", APPS)
def test_parity_across_batch_splits(app, fanout):
    ids = np.random.default_rng(4).integers(0, N, 12)
    _check(app, fanout, [(0, ids)])
    _check(app, fanout, [(i, ids[i:i + 1]) for i in range(len(ids))])
    _check(app, fanout, [(0, ids[:5]), (1, ids[5:7]), (2, ids[7:])])
    # a request larger than the largest class splits into chunks
    _check(app, fanout, [(0, np.random.default_rng(9).integers(0, N, 37))])


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("app", APPS)
def test_parity_across_request_orderings(app, fanout):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, N, 9)
    for _ in range(3):
        perm = rng.permutation(len(ids))
        _check(app, fanout, [(0, ids[perm])])


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("app", APPS)
def test_parity_with_duplicate_ids_in_one_batch(app, fanout):
    _check(app, fanout, [(0, np.array([7, 7, 3, 99, 3, 7, 0, 0]))])
    _check(app, fanout, [(0, [7, 3, 7]), (1, [3, 3]), (2, [7])])


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("app", APPS)
def test_zero_steady_state_signatures(app, fanout):
    jsrv, tsrv = _servers_for(app, fanout)
    for srv in (jsrv, tsrv):
        srv.warmup()
    before = tsrv.compiles
    rng = np.random.default_rng(6)
    for i in range(10):
        req = [(i, rng.integers(0, N, rng.integers(1, 17)))]
        np.testing.assert_allclose(tsrv.serve(req)[i], jsrv.serve(req)[i],
                                   rtol=TOL, atol=TOL)
    assert tsrv.compiles == before
    tsrv.tracker.assert_bounded()
    assert tsrv.tracker.limit == 2 * len(CLASSES)
    assert tsrv.tracker.seen == jsrv.tracker.seen
    assert all(sig[0] == "fanout" for sig in tsrv.tracker.seen)


def test_update_features_writes_through_the_feat_cache():
    jsrv, tsrv = _pair("gcn", 2)
    ids = np.arange(10)
    for srv in (jsrv, tsrv):
        srv.serve([(0, ids)])
    rows = 10 + _setup("gcn")[2][[2, 5]]
    for srv in (jsrv, tsrv):
        srv.update_features([2, 5], rows)
    ref = jsrv.serve([(1, ids)])[1]
    got = tsrv.serve([(1, ids)])[1]
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tsrv.feats[[2, 5]], rows)
    np.testing.assert_array_equal(tsrv.x_device[[2, 5]].numpy(), rows)


@pytest.mark.parametrize("app", APPS)
def test_auto_serves_both_modes_as_jax(app):
    """fan-out 3, 8 refresh batches: class 4 resolves to fanout and class
    16 to layerwise, in both packages; rows equal JAX's."""
    jsrv, tsrv = _pair(app, 3, mode="auto", refresh_batches=8)
    modes = {c: tsrv.mode_for_class(c) for c in CLASSES}
    assert modes == {c: jsrv.mode_for_class(c) for c in CLASSES}
    assert modes == {4: "fanout", 16: "layerwise"}
    ids = np.random.default_rng(8).integers(0, N, 30)
    reqs = [(0, ids[:3]), (1, ids[3:5]), (2, ids[5:20]), (3, ids[20:24]),
            (4, ids)]
    ref, got = jsrv.serve(reqs), tsrv.serve(reqs)
    for rid, _ in reqs:
        np.testing.assert_allclose(got[rid], ref[rid], rtol=TOL, atol=TOL)
    assert tsrv.stats()["mode_batches"]["fanout"] > 0
    assert tsrv.stats()["mode_batches"]["layerwise"] > 0
    assert tsrv.tracker.seen == jsrv.tracker.seen


# --------------------------------------------------------------------- #
# the serve planner
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("requested", ["auto", "layerwise", "fanout"])
def test_plan_serve_matches_jax(requested):
    for n_edges in (0, 400, 627_774, 10 ** 9):
        for cls in (1, 8, 32, 128):
            for layers in (1, 2, 3):
                for fan in (1, 2, 10, 4275):
                    exp = sum(s[2] for s in
                              planner_sig(cls, fan, layers))
                    for rb in (0, 1, 8, 1024):
                        sig = (65_536, n_edges, cls, layers)
                        assert planner.plan_serve(
                            sig, requested=requested, expansion_edges=exp,
                            refresh_batches=rb) == jax_planner.plan_serve(
                            sig, requested=requested, expansion_edges=exp,
                            refresh_batches=rb), (sig, exp, rb)
    with pytest.raises(ValueError, match="unknown serve mode"):
        planner.plan_serve((1, 1, 1, 1), requested="push",
                           expansion_edges=1)


def planner_sig(cls, fan, layers):
    from repro_torch.core.blocks import serve_block_signature
    return serve_block_signature(cls, fan, layers)


def test_reddit_like_plan_at_fanout_10():
    """The chip_smoke serve_auto expectation, by the formula: 627,774
    edges, 2 layers, 1,024 refresh batches, fan-out 10."""
    modes = {}
    for cls in (8, 32, 128):
        exp = sum(s[2] for s in planner_sig(cls, 10, 2))
        modes[cls] = planner.plan_serve((65_536, 627_774, cls, 2),
                                        expansion_edges=exp)
    assert modes == {8: "fanout", 32: "layerwise", 128: "layerwise"}
    exp_max = sum(s[2] for s in planner_sig(8, 4275, 2))
    assert planner.plan_serve((65_536, 627_774, 8, 2),
                              expansion_edges=exp_max) == "layerwise"


@pytest.mark.parametrize("graph", ["square", "skewed"])
def test_mode_for_class_matches_jax(graph):
    """``mode_for_class`` on a grid of (fanout, class, refresh_batches),
    on a uniform and a skewed graph; nothing is sampled."""
    src, dst, feats, params, model, _ = _setup("gcn")
    if graph == "skewed":
        rng = np.random.default_rng(2)
        src = rng.integers(0, N, 900)
        dst = np.minimum(rng.geometric(0.05, 900) - 1, N - 1)
    classes = (1, 4, 16, 64)
    for fanout in (None, 1, 2, 3, 9):
        for rb in (1, 8, 64, 1024):
            kw = dict(classes=classes, fanout=fanout, refresh_batches=rb,
                      cache_rows=8, pin_hot=2)
            jsrv = JaxServer("gcn", params,
                             jax_from_coo(src, dst, n_src=N, n_dst=N),
                             feats, **kw)
            tsrv = GNNServer("gcn", model,
                             from_coo(src, dst, n_src=N, n_dst=N,
                                      device="cpu"),
                             feats, device="cpu", **kw)
            assert tsrv.fanout == jsrv.fanout
            for c in classes:
                assert tsrv._expansion_edges(c) == jsrv._expansion_edges(c)
                assert tsrv.mode_for_class(c) == jsrv.mode_for_class(c), (
                    graph, fanout, rb, c)
            assert not tsrv._samplers           # nothing drawn to plan


def test_fanout_default_is_max_in_degree_and_lazy():
    src, dst, feats, _, model, _ = _setup("sage")
    srv = GNNServer("sage", model, from_coo(src, dst, n_src=N, n_dst=N,
                                            device="cpu"),
                    feats, mode="fanout", device="cpu")
    assert srv.fanout == K_IN
    assert srv._samplers == {} and srv._feat_cache is None
    srv.serve([(0, [1, 2])])
    assert list(srv._samplers) == [8]
    assert srv.stats()["feat_cache"].lookups > 0
    assert isinstance(srv.x_device, torch.Tensor)
