"""Port parity for the relational apps and their substrate.

* ``sbm_graph`` / ``bipartite_ratings`` / ``relational_graph`` give the
  JAX package's arrays, bit for bit.
* BatchNorm1d (biased variance, JAX's running-statistics update, both
  modes) and the Embedding lookup with its sorted-segment backward equal
  the JAX substrate's.
* R-GCN, GC-MC, MoNet and LGNN forwards with ``from_jax_params`` match
  the JAX forwards at 1e-5 on every route: the fused RelGraph pass
  (``fused``, ``loop`` and ``kernel``, the last through the wrappers'
  plain versions) and the pre-fusion loop / three-call paths; LGNN in
  both BatchNorm modes, its returned BatchNorm state included; the line
  graph and LGNN's RelGraph are bit-equal to JAX's.
* ``from_jax_params`` / ``to_jax_params`` round-trip each app's pytree.
* The kernel launches of one forward, counted on the CPU through the
  wrappers' plain branches, are ``chip_smoke.RELATIONAL_LAUNCHES``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RELATIONAL_LAUNCHES
from repro.core import from_coo as jax_from_coo
from repro.data import bipartite_ratings as jax_bipartite_ratings
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.data import relational_graph as jax_relational_graph
from repro.data import sbm_graph as jax_sbm_graph
from repro.models.gnn import gcmc as jax_gcmc
from repro.models.gnn import lgnn as jax_lgnn
from repro.models.gnn import monet as jax_monet
from repro.models.gnn import rgcn as jax_rgcn
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.substrate import batchnorm as jax_bn
from repro.substrate import embedding as jax_emb
from repro_torch.core import from_coo
from repro_torch.data import (bipartite_ratings, make_node_dataset,
                              relational_graph, sbm_graph)
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gcmc, lgnn, monet, rgcn
from repro_torch.models.gnn.common import (from_jax_params, make_bundle,
                                           to_jax_params)
from repro_torch.substrate.batchnorm import (BatchNorm1d, batchnorm1d_apply,
                                             batchnorm1d_init)
from repro_torch.substrate.embedding import embedding_lookup
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
ROUTES = ("fused", "loop", "kernel")

_cache = {}


def _cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------- #
# generators
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("gen", ["sbm", "bipartite", "relational"])
def test_generators_bit_identical(gen):
    if gen == "sbm":
        got = sbm_graph(200, 3, 0.1, 0.01, seed=4)
        want = jax_sbm_graph(200, 3, 0.1, 0.01, seed=4)
    elif gen == "bipartite":
        got = bipartite_ratings(80, 60, 900, 5, seed=2)
        want = jax_bipartite_ratings(80, 60, 900, 5, seed=2)
    else:
        got = [a for pair in relational_graph(300, 5, 77, seed=3)
               for a in pair]
        want = [a for pair in jax_relational_graph(300, 5, 77, seed=3)
                for a in pair]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# substrate
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((50, 7)) * 3 + 1).astype(np.float32)
    state = {"scale": rng.random(7).astype(np.float32) + 0.5,
             "bias": rng.standard_normal(7).astype(np.float32),
             "running_mean": rng.standard_normal(7).astype(np.float32),
             "running_var": rng.random(7).astype(np.float32) + 0.5}
    jy, jstate = jax_bn.batchnorm1d_apply(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x),
        train=train)
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    y, new = batchnorm1d_apply(ts, torch.from_numpy(x), train=train)
    _close(y, jy)
    for k in state:
        _close(new[k], jstate[k])
    mod = BatchNorm1d({k: v.clone() for k, v in ts.items()})
    my, mstate = mod(torch.from_numpy(x), train=train)
    assert torch.equal(my, y)
    mod.load_state(mstate)
    _close(mod.running_var, jstate["running_var"])
    init = batchnorm1d_init(7, device="cpu")
    for k, v in jax_bn.batchnorm1d_init(7).items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))


def test_embedding_matches_jax():
    """Forward rows, and the sorted-segment backward (repeated ids) equal
    ``jax.grad`` of the JAX lookup."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    ids = rng.integers(0, 30, (6, 9))
    ct = rng.standard_normal((6, 9, 4)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jax_emb.embedding_lookup(
        t, jnp.asarray(ids)) * ct))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = embedding_lookup(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    got, = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), t)
    _close(got, want)


# --------------------------------------------------------------------- #
# R-GCN
# --------------------------------------------------------------------- #
N_RG, R_RG = 60, 3


def _rgcn():
    def build():
        rels = jax_relational_graph(N_RG, R_RG, 150, seed=5)
        x = np.random.default_rng(6).standard_normal((N_RG, 8)).astype(
            np.float32)
        params = jax_rgcn.init(jax.random.PRNGKey(3), 8, 12, 4, R_RG)
        ref = np.asarray(jax_rgcn.forward(params, jax_rgcn.build_relgraph(
            rels, N_RG), jnp.asarray(x), strategy="fused"))
        return rels, x, params, ref
    return _cached("rgcn", build)


@pytest.mark.parametrize("route", ROUTES + ("per_relation_graphs",))
def test_rgcn_forward_matches_jax(route):
    rels, x, params, ref = _rgcn()
    model = from_jax_params("rgcn", _tree_np(params), device="cpu")
    if route == "per_relation_graphs":
        graphs = [from_coo(s, d, n_src=N_RG, n_dst=N_RG, device="cpu")
                  for s, d in rels]
        out = rgcn.infer(model, graphs, torch.from_numpy(x),
                         strategy="segment")
    else:
        rg = rgcn.build_relgraph(rels, N_RG, device="cpu")
        out = rgcn.infer(model, rg, torch.from_numpy(x), strategy=route)
    _close(out, ref)


def test_rgcn_merged_graph_equals_jax():
    rels, *_ = _rgcn()
    jg, jrel = jax_rgcn.merged_graph(rels, N_RG)
    g, rel = rgcn.merged_graph(rels, N_RG, device="cpu")
    np.testing.assert_array_equal(rel, np.asarray(jrel))
    for f in ("src", "dst", "eid"):
        np.testing.assert_array_equal(getattr(g.host, f),
                                      np.asarray(getattr(jg, f)))


# --------------------------------------------------------------------- #
# GC-MC
# --------------------------------------------------------------------- #
def _gcmc():
    def build():
        u, i, r = jax_bipartite_ratings(50, 40, 400, 4, seed=7)
        rng = np.random.default_rng(8)
        xu = rng.standard_normal((50, 10)).astype(np.float32)
        xi = rng.standard_normal((40, 9)).astype(np.float32)
        params = jax_gcmc.init(jax.random.PRNGKey(4), 10, 9, 12, 6, 4)
        graphs = (*jax_gcmc.build_level_relgraphs(u, i, r, 50, 40, 4),
                  jax_from_coo(u, i, n_src=50, n_dst=40))
        ref = np.asarray(jax_gcmc.forward(params, graphs, jnp.asarray(xu),
                                          jnp.asarray(xi), strategy="fused"))
        return (u, i, r), xu, xi, params, ref
    return _cached("gcmc", build)


@pytest.mark.parametrize("route", ROUTES + ("per_level_graphs",))
def test_gcmc_forward_matches_jax(route):
    (u, i, r), xu, xi, params, ref = _gcmc()
    model = from_jax_params("gcmc", _tree_np(params), device="cpu")
    g_all = from_coo(u, i, n_src=50, n_dst=40, device="cpu")
    if route == "per_level_graphs":
        fwd, bwd = gcmc.build_level_graphs(u, i, r, 50, 40, 4, device="cpu")
        strategy = "segment"
    else:
        fwd, bwd = gcmc.build_level_relgraphs(u, i, r, 50, 40, 4,
                                              device="cpu")
        strategy = route
    with torch.no_grad():
        out = gcmc.forward(model, (fwd, bwd, g_all), torch.from_numpy(xu),
                           torch.from_numpy(xi), strategy=strategy)
    assert out.shape == (400, 4)
    _close(out, ref)


# --------------------------------------------------------------------- #
# MoNet
# --------------------------------------------------------------------- #
def _monet():
    def build():
        jg, feats, *_ = jax_make_node_dataset("tiny")
        params = jax_monet.init(jax.random.PRNGKey(5), feats.shape[1], 16, 5,
                                n_kernels=2)
        ref = np.asarray(jax_monet.forward(params, jax_make_bundle(jg, krel=2),
                                           jnp.asarray(feats),
                                           strategy="fused"))
        return feats, params, ref
    return _cached("monet", build)


@pytest.mark.parametrize("route", ROUTES + ("per_kernel_loop",))
def test_monet_forward_matches_jax(route):
    feats, params, ref = _monet()
    g = make_node_dataset("tiny", device="cpu")[0]
    model = from_jax_params("monet", _tree_np(params), device="cpu")
    if route == "per_kernel_loop":
        bundle, strategy = make_bundle(g), "segment"
    else:
        bundle, strategy = make_bundle(g, krel=2), route
    assert (bundle.krel(2) is None) == (route == "per_kernel_loop")
    with torch.no_grad():
        out = monet.forward(model, bundle, torch.from_numpy(feats),
                            strategy=strategy)
    _close(out, ref)


def test_krel_relgraph_equals_jax():
    g = make_node_dataset("tiny", device="cpu")[0]
    jg = jax_make_node_dataset("tiny")[0]
    jrg = jax_make_bundle(jg, krel=3).cache.krel(3)
    trg = make_bundle(g, krel=3).krel(3)
    assert trg.rel_sizes == jrg.rel_sizes
    for f in ("rel", "mean_norm", "perm_rel", "rev_perm"):
        np.testing.assert_array_equal(getattr(trg, f).numpy(),
                                      np.asarray(getattr(jrg, f)))


# --------------------------------------------------------------------- #
# LGNN
# --------------------------------------------------------------------- #
N_LG = 60


def _lgnn_graphs():
    def build():
        src, dst, _ = jax_sbm_graph(N_LG, 2, 0.15, 0.02, seed=9)
        jg = jax_from_coo(src, dst, n_src=N_LG, n_dst=N_LG)
        jlg = jax_lgnn.build_line_graph(jg)
        g = from_coo(src, dst, n_src=N_LG, n_dst=N_LG, device="cpu")
        return jg, jlg, jax_lgnn.build_relgraph(jg, jlg), g
    return _cached("lgnn_graphs", build)


def test_line_graph_and_relgraph_equal_jax():
    jg, jlg, jrg, g = _lgnn_graphs()
    lg = lgnn.build_line_graph(g)
    assert (lg.n_src, lg.n_edges) == (jlg.n_src, jlg.n_edges)
    for f in ("src", "dst", "eid", "indptr_dst", "eid_inv"):
        np.testing.assert_array_equal(getattr(lg.host, f),
                                      np.asarray(getattr(jlg, f)), err_msg=f)
    rg = lgnn.build_relgraph(g, lg)
    assert rg.rel_sizes == jrg.rel_sizes
    for f in ("rel", "mean_norm", "rev_perm"):
        np.testing.assert_array_equal(getattr(rg, f).numpy(),
                                      np.asarray(getattr(jrg, f)))
    with pytest.raises(ValueError, match="too large"):
        lgnn.build_line_graph(g, max_out=lg.n_edges)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("route", ROUTES + ("three_calls",))
def test_lgnn_forward_matches_jax(route, train):
    jg, jlg, jrg, g = _lgnn_graphs()
    params = jax_lgnn.init(jax.random.PRNGKey(6), N_LG, 8, 10, 2)
    if not train:    # serve with running statistics that are not the init
        _, params = jax_lgnn.forward(params, jg, jlg, rg=jrg,
                                     strategy="fused")
    ref, new_params = jax_lgnn.forward(params, jg, jlg, rg=jrg,
                                       strategy="fused", train=train)
    model = from_jax_params("lgnn", _tree_np(params), device="cpu")
    lg = lgnn.build_line_graph(g)
    if route == "three_calls":
        rg, strategy = None, "segment"
    else:
        rg, strategy = lgnn.build_relgraph(g, lg), route
    with torch.no_grad():
        out, bn_state = lgnn.forward(model, g, lg, rg=rg, strategy=strategy,
                                     train=train)
    _close(out, ref)
    for st, jl in zip(bn_state, new_params["layers"]):
        for bn in ("bn_x", "bn_y"):
            for k in ("running_mean", "running_var"):
                _close(st[bn][k], jl[bn][k])
    model.load_bn_state(bn_state)
    back = to_jax_params(model)
    for tl, jl in zip(back["layers"], new_params["layers"]):
        _close(tl["bn_x"]["running_var"], jl["bn_x"]["running_var"])


# --------------------------------------------------------------------- #
# parameters and launches
# --------------------------------------------------------------------- #
def _jax_params(app):
    key = jax.random.PRNGKey(2)
    return {"rgcn": lambda: jax_rgcn.init(key, 6, 5, 3, 4),
            "gcmc": lambda: jax_gcmc.init(key, 6, 5, 4, 3, 5),
            "monet": lambda: jax_monet.init(key, 6, 5, 3, n_kernels=2),
            "lgnn": lambda: jax_lgnn.init(key, 20, 4, 5, 2)}[app]()


@pytest.mark.parametrize("app", ["rgcn", "gcmc", "monet", "lgnn"])
def test_params_round_trip(app):
    tree = _tree_np(_jax_params(app))
    back = to_jax_params(from_jax_params(app, tree, device="cpu"))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == treedef
    for a, b in zip(got, flat):
        np.testing.assert_array_equal(a, b)


def _count_launches(monkeypatch):
    counts = {}

    def counting(module, name, key):
        plain = getattr(module, name)

        def wrapped(*a, **kw):
            k = key(a) if callable(key) else key
            counts[k] = counts.get(k, 0) + 1
            return plain(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    counting(spmm_ops, "spmm_plain", "spmm_csr")
    counting(sddmm_ops, "sddmm_plain",
             lambda a: "sddmm_csr:copy" if a[1] == "copy" else "sddmm_csr")
    counting(br_ops, "binary_reduce_plain", "binary_reduce_csr")
    return counts


@pytest.mark.parametrize("app", ["rgcn", "gcmc", "monet", "lgnn"])
def test_forward_launches(app, monkeypatch):
    """Launches of one forward on the kernel route, the wrappers' plain
    branches standing in for the kernels; none on the fused route."""
    counts = _count_launches(monkeypatch)
    model = from_jax_params(app, _tree_np(_jax_params(app)), device="cpu")
    rng = np.random.default_rng(0)
    for strategy, want in (("kernel", RELATIONAL_LAUNCHES[app]),
                           ("fused", {})):
        counts.clear()
        with torch.no_grad():
            if app == "rgcn":
                rels = relational_graph(30, 4, 50)
                rgcn.forward(model, rgcn.build_relgraph(rels, 30, "cpu"),
                             torch.randn(30, 6), strategy=strategy)
            elif app == "gcmc":
                u, i, r = bipartite_ratings(20, 15, 90, 5)
                graphs = (*gcmc.build_level_relgraphs(u, i, r, 20, 15, 5,
                                                      device="cpu"),
                          from_coo(u, i, n_src=20, n_dst=15, device="cpu"))
                gcmc.forward(model, graphs, torch.randn(20, 6),
                             torch.randn(15, 5), strategy=strategy)
            elif app == "monet":
                src, dst = rng.integers(0, 25, 80), rng.integers(0, 25, 80)
                bundle = make_bundle(from_coo(src, dst, n_src=25, n_dst=25,
                                              device="cpu"), krel=2)
                monet.forward(model, bundle, torch.randn(25, 6),
                              strategy=strategy)
            else:
                src, dst, _ = sbm_graph(20, 2, 0.3, 0.05)
                g = from_coo(src, dst, n_src=20, n_dst=20, device="cpu")
                lg = lgnn.build_line_graph(g)
                lgnn.forward(model, g, lg, rg=lgnn.build_relgraph(g, lg),
                             strategy=strategy)
        assert counts == want, strategy
