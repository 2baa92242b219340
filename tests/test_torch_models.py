"""Port parity for the slice's data and models.

* ``make_node_dataset("tiny")`` gives identical arrays in both packages.
* ``gcn`` / ``sage`` / ``gat.infer`` with ``from_jax_params`` (the JAX
  init carried across as numpy) match JAX's ``infer`` at 1e-5. GAT's
  default is multipass in both packages; each of its five ``attn`` modes
  matches JAX's at that mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_node_dataset as jax_make_node_dataset
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import (edge_norms, from_jax_params,
                                           make_bundle)
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src", "perm_src",
          "eid_inv")
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}

_cache = {}


def _tiny():
    """Both packages' tiny dataset (built inside a test, under the shim)."""
    if "tiny" not in _cache:
        _cache["tiny"] = (jax_make_node_dataset("tiny"),
                          make_node_dataset("tiny", device="cpu"))
    return _cache["tiny"]


def _params(app, d_in, n_classes):
    key = jax.random.PRNGKey(7)
    p = JAX_APPS[app].init(key, d_in, 16, n_classes)
    return p, jax.tree_util.tree_map(np.asarray, p)


def test_make_node_dataset_tiny_identical():
    (jg, jf, jl, jtr, jva, jn), (tg, tf, tl, ttr, tva, tn) = _tiny()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tg.host, f),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ttr, jtr)
    np.testing.assert_array_equal(tva, jva)
    assert tn == jn


def test_edge_norms_identical():
    (jg, *_), (tg, *_) = _tiny()
    jb = jax_make_bundle(jg)
    tb = make_bundle(tg)
    np.testing.assert_array_equal(tb.gcn_norm.numpy(),
                                  np.asarray(jb.gcn_norm))
    np.testing.assert_array_equal(tb.mean_norm.numpy(),
                                  np.asarray(jb.mean_norm))
    np.testing.assert_array_equal(edge_norms(tg)[0], np.asarray(jb.gcn_norm))


@pytest.mark.parametrize("app", ["gcn", "sage", "gat", "gat-multipass"])
def test_infer_matches_jax(app):
    """Default arguments on both sides; ``gat-multipass`` names the mode
    on both sides and checks it is the port's default."""
    (jg, jf, *_, n_cls), (tg, tf, *_) = _tiny()
    app, _, attn = app.partition("-")
    kw = {"attn": attn} if attn else {}
    p, tree = _params(app, jf.shape[1], n_cls)
    model = from_jax_params(app, tree, device="cpu")
    bundle, x = make_bundle(tg), torch.from_numpy(tf)
    got = PORT_APPS[app].infer(model, bundle, x, **kw).numpy()
    jb = jax_make_bundle(jg)
    refs = ([JAX_APPS[app].infer(p, jb, jnp.asarray(jf), attn=a)
             for a in ("fused", None)] if app == "gat" and not attn
            else [JAX_APPS[app].infer(p, jb, jnp.asarray(jf), **kw)])
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    if attn:
        torch.testing.assert_close(PORT_APPS[app].infer(model, bundle, x),
                                   torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_strategies_agree_on_cpu(app):
    """On the CPU 'kernel' runs the kernels' plain versions: bit for bit
    segment's wherever a kernel takes every op (GCN, SAGE); GAT's max
    falls back down the planner's chain to the blocked pull, and its
    rank-3 sum runs on the kernels' plain versions, which sum in another
    order. 'auto' runs the JAX cpu row's choice per
    op, so it matches JAX's auto (and its ELL pulls JAX's)."""
    (jg, jf, *_, n_cls), (tg, tf, *_) = _tiny()
    p, tree = _params(app, jf.shape[1], n_cls)
    model = from_jax_params(app, tree, device="cpu")
    bundle, x = make_bundle(tg), torch.from_numpy(tf)
    ref = PORT_APPS[app].infer(model, bundle, x, strategy="segment")
    got = PORT_APPS[app].infer(model, bundle, x, strategy="kernel")
    exact = 0 if app != "gat" else TOL
    torch.testing.assert_close(got, ref, rtol=exact, atol=exact)
    got = PORT_APPS[app].infer(model, bundle, x, strategy="auto")
    want = JAX_APPS[app].infer(p, jax_make_bundle(jg), jnp.asarray(jf),
                               strategy="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_infer_builds_no_autograd_graph():
    (_, jf, *_, n_cls), (tg, tf, *_) = _tiny()
    model = from_jax_params("gcn", _params("gcn", jf.shape[1], n_cls)[1],
                            device="cpu")
    out = gcn.infer(model, make_bundle(tg), torch.from_numpy(tf))
    assert not out.requires_grad


def test_gat_attn_modes():
    """Every mode matches JAX's ``infer`` at that mode; ``fused_softmax``
    keeps its meaning when ``attn`` is not given."""
    (jg, jf, *_, n_cls), (tg, tf, *_) = _tiny()
    p, tree = _params("gat", jf.shape[1], n_cls)
    model = from_jax_params("gat", tree, device="cpu")
    bundle, x = make_bundle(tg), torch.from_numpy(tf)
    jb = jax_make_bundle(jg)
    for attn in ("multipass", "softmax-fused", "fused", "pallas", "auto"):
        ref = np.asarray(jax_gat.infer(p, jb, jnp.asarray(jf), attn=attn))
        for strategy in ("auto", "segment", "kernel"):
            got = gat.infer(model, bundle, x, strategy=strategy, attn=attn)
            np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                       err_msg=f"{attn}/{strategy}")
    with torch.no_grad():
        torch.testing.assert_close(
            gat.forward(model, bundle, x, fused_softmax=True),
            gat.infer(model, bundle, x, attn="softmax-fused"), rtol=0, atol=0)
    with pytest.raises(ValueError):
        gat.infer(model, bundle, x, attn="bogus")
    with pytest.raises(ValueError):
        gat.infer(model, bundle, x, strategy="bogus")


def test_init_from_generator_is_deterministic():
    a = gat.init(torch.Generator().manual_seed(3), 8, 4, 3, device="cpu")
    b = gat.init(torch.Generator().manual_seed(3), 8, 4, 3, device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert [tuple(p.shape) for p in a.parameters()] == [
        (8, 16), (4, 4), (4, 4), (16, 3), (1, 3), (1, 3)]


def test_from_jax_params_rejects_unknown_app():
    with pytest.raises(ValueError):
        from_jax_params("gin", {"layers": []}, device="cpu")
