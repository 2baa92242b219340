"""Port parity for serving R-GCN (``GNNServer("rgcn", ..., rels=...)``).

* Layer-wise rows are the rows of ``rgcn.infer`` on the server's
  RelGraph, and JAX's.
* Fan-out at the default fan-out (every in-edge, with each edge's
  relation and per-relation mean weight from the sampler) gives the
  layer-wise rows at 1e-4; at fan-out 2 the port draws the JAX server's
  blocks, so its rows are the JAX server's.
* ``mode="auto"`` resolves every class as the JAX server does, and a
  server whose classes resolve to both modes serves JAX's rows.
* ``build_server("rgcn")`` stands up the JAX entry point's typed graph
  and features.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GNNServer as JaxServer
from repro.launch.serve_gnn import build_server as jax_build_server
from repro.models.gnn import rgcn as jax_rgcn
from repro_torch.core.serving import GNNServer
from repro_torch.launch.serve_gnn import build_server
from repro_torch.models.gnn import rgcn
from repro_torch.models.gnn.common import from_jax_params
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

N, D_IN, D_HID, N_REL = 100, 8, 8, 3
CLASSES = (4, 16)
TOL = 1e-5
# one request per class, a split batch, and a repeated id
REQUESTS = [[(0, np.array([3, 7]))], [(1, np.arange(5, 17))],
            [(2, np.array([1, 1, 40])), (3, np.arange(60, 80))]]

_built = {}


def _setup():
    """(rels, feats, JAX params, port model, JAX full-forward rows)."""
    if "rgcn" not in _built:
        rng = np.random.default_rng(17)
        feats = rng.standard_normal((N, D_IN)).astype(np.float32)
        rels = [(rng.integers(0, N, N * 2), rng.integers(0, N, N * 2))
                for _ in range(N_REL)]
        params = jax_rgcn.init(jax.random.PRNGKey(17), D_IN, D_HID, 5,
                               N_REL)
        ref = np.asarray(jax_rgcn.infer(
            params, jax_rgcn.build_relgraph(rels, N), jnp.asarray(feats)))
        model = from_jax_params("rgcn", jax.tree_util.tree_map(np.asarray,
                                                               params),
                                device="cpu")
        _built["rgcn"] = (rels, feats, params, model, ref)
    return _built["rgcn"]


def _servers(**kw):
    """(JAX server, port server) over the same typed graph and params."""
    rels, feats, params, model, _ = _setup()
    opts = dict(classes=CLASSES, cache_rows=32, pin_hot=8)
    opts.update(kw)
    return (JaxServer("rgcn", params, None, feats.copy(), rels=rels, **opts),
            GNNServer("rgcn", model, None, feats.copy(), rels=rels,
                      device="cpu", **opts))


def _serve_all(srv):
    return [srv.serve(r) for r in REQUESTS]


def _assert_rows(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for rid in g:
            np.testing.assert_allclose(g[rid], w[rid], rtol=tol, atol=tol)


def _ref_rows(table):
    return [{rid: table[ids] for rid, ids in r} for r in REQUESTS]


def test_layerwise_rows_equal_infer():
    *_, model, ref = _setup()
    _, srv = _servers(mode="layerwise")
    got = _serve_all(srv)
    table = rgcn.infer(model, srv.rg, srv.x_device).numpy()
    _assert_rows(got, _ref_rows(table), tol=0)
    _assert_rows(got, _ref_rows(ref))
    assert srv.refreshes == 1 and srv.mode_batches["fanout"] == 0


def test_fanout_at_full_fanout_equals_layerwise():
    _, fo = _servers(mode="fanout")
    _, lw = _servers(mode="layerwise")
    assert fo.fanout == int(fo.g.host.in_degrees.max())
    got = _serve_all(fo)
    _assert_rows(got, _serve_all(lw), tol=1e-4)
    _assert_rows(got, _ref_rows(_setup()[-1]), tol=1e-4)
    assert fo.refreshes == 0 and fo.mode_batches["layerwise"] == 0


def test_sampled_fanout_rows_equal_jax_server():
    jsrv, tsrv = _servers(mode="fanout", fanout=2)
    _assert_rows(_serve_all(tsrv), _serve_all(jsrv))
    assert len(tsrv.tracker.seen) == len(jsrv.tracker.seen)


@pytest.mark.parametrize("fanout", [None, 2])
@pytest.mark.parametrize("refresh_batches", [1, 8, 64, 1024])
def test_modes_match_jax(refresh_batches, fanout):
    jsrv, tsrv = _servers(mode="auto", fanout=fanout,
                          refresh_batches=refresh_batches)
    for cls in CLASSES:
        assert tsrv.mode_for_class(cls) == jsrv.mode_for_class(cls), cls


def test_auto_serves_both_modes_as_jax():
    jsrv, tsrv = _servers(mode="auto", fanout=6, refresh_batches=4)
    modes = {c: tsrv.mode_for_class(c) for c in CLASSES}
    assert set(modes.values()) == {"fanout", "layerwise"}, modes
    _assert_rows(_serve_all(tsrv), _serve_all(jsrv))
    assert all(tsrv.mode_batches[m] for m in ("fanout", "layerwise"))


def test_steady_state_meets_no_new_signature():
    _, srv = _servers(mode="fanout", fanout=2)
    srv.warmup()
    before = srv.compiles
    _serve_all(srv)
    _serve_all(srv)
    assert srv.compiles == before


def test_rgcn_needs_rels():
    *_, model, _ = _setup()
    with pytest.raises(ValueError, match="rels"):
        GNNServer("rgcn", model, None, np.zeros((N, D_IN), np.float32),
                  device="cpu")


def test_build_server_rgcn_matches_jax():
    jsrv = jax_build_server("rgcn", "tiny", mode="layerwise")
    tsrv = build_server("rgcn", "tiny", mode="layerwise", device="cpu")
    np.testing.assert_array_equal(tsrv.feats, jsrv.feats)
    for f in ("src", "dst", "eid"):
        np.testing.assert_array_equal(getattr(tsrv.g.host, f),
                                      np.asarray(getattr(jsrv.g, f)))
    assert tsrv.rg.signature == jsrv._rg.signature
    assert tsrv.n_layers == jsrv.n_layers and tsrv.fanout == jsrv.fanout
    out = tsrv.serve([(0, np.arange(10))])[0]
    assert out.shape == (10, 8) and np.isfinite(out).all()
    assert isinstance(tsrv.model, rgcn.RGCN)
    assert tuple(tsrv.model.layers[0].basis.shape) == tuple(
        jsrv.params["layers"][0]["basis"].shape)
    assert torch.equal(tsrv.x_device, torch.from_numpy(jsrv.feats))
