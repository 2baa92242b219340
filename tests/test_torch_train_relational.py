"""Port parity for relational training: R-GCN, GC-MC, MoNet and LGNN
full-graph, and sampled R-GCN.

The JAX init is carried across by ``from_jax_params``, and each of the
port's parameters (or gradients) is held against the JAX leaf of the
same dotted name:

* one step's loss and grads per app against ``jax.grad`` at 1e-5
  (relative to the largest entry), on the plain fused route (its gather
  VJP) and on the kernel route (the wrappers' plain versions here, with
  the kernel routes' backwards): R-GCN's basis / coeff, GC-MC's encoder
  and decoder, MoNet's kernel weights, LGNN's embedding table;
* one AdamW step (global-norm clip included) on identical grads at 1e-6;
* 5 epochs of ``train_full_graph`` for R-GCN and MoNet, and 3 steps of
  ``make_loss_step`` on GC-MC's and LGNN's losses, against JAX's loss by
  loss at 1e-5 relative;
* LGNN's BatchNorm running statistics after a step equal those in the
  params JAX's forward returns;
* sampled R-GCN (2e-4, the sampled paths' tolerance): one step on every
  (strategy, bwd_strategy) path against JAX's, a 3-batch ``train_sampled``
  trajectory, and sampled = full graph at fan-out ≥ max in-degree;
* the kernel launches of one step, counted through the wrappers' plain
  branches, are ``chip_smoke.RELATIONAL_TRAIN_LAUNCHES``; the plain
  routes launch none.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RELATIONAL_TRAIN_LAUNCHES
from repro.core import from_coo as jax_from_coo
from repro.data import NeighborSampler as JaxSampler
from repro.data import bipartite_ratings as jax_bipartite_ratings
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.data import relational_graph as jax_relational_graph
from repro.data import sbm_graph as jax_sbm_graph
from repro.models.gnn import gcmc as jax_gcmc
from repro.models.gnn import lgnn as jax_lgnn
from repro.models.gnn import monet as jax_monet
from repro.models.gnn import rgcn as jax_rgcn
from repro.models.gnn.common import block_features as jax_block_features
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.common import pad_features as jax_pad_features
from repro.models.gnn.train import \
    make_sampled_train_step as jax_make_sampled_train_step
from repro.models.gnn.train import train_full_graph as jax_train_full_graph
from repro.models.gnn.train import train_sampled as jax_train_sampled
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.core import from_coo
from repro_torch.data import NeighborSampler
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gcmc, lgnn, monet, rgcn
from repro_torch.models.gnn.common import (block_features, from_jax_params,
                                           make_bundle, pad_features)
from repro_torch.models.gnn.train import (make_loss_step,
                                          make_sampled_train_step,
                                          train_full_graph, train_sampled)
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.substrate.nn import cross_entropy_loss
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
SAMPLED_TOL = 2e-4
APPS = ("rgcn", "gcmc", "monet", "lgnn")
JAX_APPS = {"rgcn": jax_rgcn, "gcmc": jax_gcmc, "monet": jax_monet,
            "lgnn": jax_lgnn}
N_RG, R_RG, N_LG = 60, 3, 60

_cache = {}


def _cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, dotted):
    """The leaf of a JAX params pytree at a port parameter's dotted
    name (``layers.0.basis``)."""
    for key in dotted.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else \
            tree[key]
    return np.array(tree)


def _close_named(model, jtree, tol, grads=False, what=""):
    """Every parameter of ``model`` (or its ``.grad``) against the JAX
    leaf of the same name, relative to the leaf's largest entry."""
    for name, p in model.named_parameters():
        if grads and p.grad is None:    # unreached by the loss: JAX's 0
            got = np.zeros(tuple(p.shape), np.float32)
        else:
            got = (p.grad if grads else p).detach().numpy()
        ref = _leaf(jtree, name)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {name}")


# --------------------------------------------------------------------- #
# each app's data, JAX loss and port loss
# --------------------------------------------------------------------- #
def _app(app):
    """``(jax_params, jax_loss(params), port_loss(model, strategy),
    port_data)`` of one app at a small size."""
    def build():
        key = jax.random.PRNGKey(3)
        rng = np.random.default_rng(8)
        if app == "rgcn":
            rels = jax_relational_graph(N_RG, R_RG, 150, seed=5)
            x = rng.standard_normal((N_RG, 8)).astype(np.float32)
            y = rng.integers(0, 4, N_RG)
            mask = rng.random(N_RG) < 0.6
            params = jax_rgcn.init(key, 8, 12, 4, R_RG)
            jrg = jax_rgcn.build_relgraph(rels, N_RG)
            trg = rgcn.build_relgraph(rels, N_RG, device="cpu")

            def jloss(p):
                return jax_ce(jax_rgcn.forward(p, jrg, jnp.asarray(x),
                                               strategy="fused"),
                              jnp.asarray(y), jnp.asarray(mask))

            def tloss(model, strategy):
                return cross_entropy_loss(
                    rgcn.forward(model, trg, torch.from_numpy(x),
                                 strategy=strategy),
                    torch.from_numpy(y), torch.from_numpy(mask))
            data = (jrg, trg, x, y, mask)
        elif app == "gcmc":
            u, i, r = jax_bipartite_ratings(50, 40, 400, 5, seed=7)
            xu = rng.standard_normal((50, 10)).astype(np.float32)
            xi = rng.standard_normal((40, 9)).astype(np.float32)
            params = jax_gcmc.init(key, 10, 9, 12, 6, 5)
            jgraphs = (*jax_gcmc.build_level_relgraphs(u, i, r, 50, 40, 5),
                       jax_from_coo(u, i, n_src=50, n_dst=40))
            tgraphs = (*gcmc.build_level_relgraphs(u, i, r, 50, 40, 5,
                                                   device="cpu"),
                       from_coo(u, i, n_src=50, n_dst=40, device="cpu"))

            def jloss(p):
                return jax_ce(jax_gcmc.forward(p, jgraphs, jnp.asarray(xu),
                                               jnp.asarray(xi),
                                               strategy="fused"),
                              jnp.asarray(r))

            def tloss(model, strategy):
                return gcmc.rating_loss(model, tgraphs, torch.from_numpy(xu),
                                        torch.from_numpy(xi),
                                        torch.from_numpy(r),
                                        strategy=strategy)
            data = (tgraphs, xu, xi, r)
        elif app == "monet":
            jg, feats, labels, tm, *_ = jax_make_node_dataset("tiny")
            tg = make_node_dataset("tiny", device="cpu")[0]
            params = jax_monet.init(key, feats.shape[1], 16, 5, n_kernels=2)
            jb = jax_make_bundle(jg, krel=2)
            tb = make_bundle(tg, krel=2)

            def jloss(p):
                return jax_ce(jax_monet.forward(p, jb, jnp.asarray(feats),
                                                strategy="fused"),
                              jnp.asarray(labels), jnp.asarray(tm))

            def tloss(model, strategy):
                return cross_entropy_loss(
                    monet.forward(model, tb, torch.from_numpy(feats),
                                  strategy=strategy),
                    torch.from_numpy(labels), torch.from_numpy(tm))
            data = (jb, tb, feats, labels, tm)
        else:
            src, dst, comm = jax_sbm_graph(N_LG, 2, 0.15, 0.02, seed=9)
            jg = jax_from_coo(src, dst, n_src=N_LG, n_dst=N_LG)
            jlg = jax_lgnn.build_line_graph(jg)
            jrg = jax_lgnn.build_relgraph(jg, jlg)
            g = from_coo(src, dst, n_src=N_LG, n_dst=N_LG, device="cpu")
            lg = lgnn.build_line_graph(g)
            rg = lgnn.build_relgraph(g, lg)
            params = jax_lgnn.init(key, N_LG, 8, 10, 2)

            def jloss(p):
                logits, _ = jax_lgnn.forward(p, jg, jlg, rg=jrg,
                                             strategy="fused", train=True)
                return jax_ce(logits, jnp.asarray(comm))

            def tloss(model, strategy):
                return lgnn.train_loss(model, g, lg, torch.from_numpy(comm),
                                       rg=rg, strategy=strategy)
            data = (jg, jlg, jrg, g, lg, rg, comm)
        return params, jloss, tloss, data
    return _cached(app, build)


def _model(app):
    return from_jax_params(app, _np(_app(app)[0]), device="cpu")


# --------------------------------------------------------------------- #
# one step's grads, the optimizer step, the launches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("app", APPS)
def test_step_grads_match_jax(app, strategy):
    params, jloss, tloss, _ = _app(app)
    jl, jgrads = jax.value_and_grad(jloss)(params)
    model = _model(app)
    loss = tloss(model, strategy)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    _close_named(model, jgrads, TOL, grads=True, what=strategy)
    if app == "lgnn":       # the embedding table's CR backward
        assert float(model.embed.grad.abs().sum()) > 0


@pytest.mark.parametrize("app", APPS)
def test_adamw_step_matches_jax(app):
    """Clip and AdamW on identical grads (JAX's), per parameter."""
    params, jloss, _, _ = _app(app)
    jgrads = jax.grad(jloss)(params)
    model = _model(app)
    names = [n for n, _ in model.named_parameters()]
    grads = [_leaf(jgrads, n) for n in names]
    vals = [_leaf(params, n) for n in names]
    j_init, j_update = jax_adamw(1e-2, weight_decay=5e-4)
    jg, _ = jax_clip([jnp.asarray(g) for g in grads], 5.0)
    jp = [jnp.asarray(v) for v in vals]
    jups, _ = j_update(jg, j_init(jp), jp, 0)
    want = jax_apply_updates(jp, jups)
    t_init, t_update = adamw(1e-2, weight_decay=5e-4)
    tp = list(model.parameters())
    tg, _ = clip_by_global_norm([torch.from_numpy(g) for g in grads], 5.0)
    with torch.no_grad():
        tups, _ = t_update(tg, t_init(tp), tp, 0)
        apply_updates(tp, tups)
    for n, a, b in zip(names, tp, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


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


@pytest.mark.parametrize("app", APPS)
def test_training_step_launches(app, monkeypatch):
    """One step's forward and backward on the kernel route launches
    ``RELATIONAL_TRAIN_LAUNCHES[app]`` (the plain branches stand in for
    the kernels); the plain fused route launches none."""
    counts = _count_launches(monkeypatch)
    _, _, tloss, _ = _app(app)
    model = _model(app)
    for strategy, want in (("kernel", RELATIONAL_TRAIN_LAUNCHES[app]),
                           ("fused", {})):
        counts.clear()
        torch.autograd.grad(tloss(model, strategy),
                            list(model.parameters()), allow_unused=True)
        assert counts == want, strategy


# --------------------------------------------------------------------- #
# trajectories
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("app", ["rgcn", "monet"])
def test_train_full_graph_trajectory_matches_jax(app, strategy):
    """5 epochs of ``train_full_graph`` on the app's bundle (R-GCN's
    RelGraph, MoNet's ``make_bundle(g, krel=2)``) against JAX's, loss by
    loss; MoNet at lr 3e-3, as the JAX suite trains it."""
    params, _, _, data = _app(app)
    lr = 3e-3 if app == "monet" else 1e-2
    if app == "rgcn":
        jrg, trg, x, y, mask = data
        jb, tb = jrg, trg
    else:
        jb, tb, x, y, mask = data
    _, jh = jax_train_full_graph(JAX_APPS[app].forward, params, jb, x, y,
                                 mask, strategy="fused", epochs=5, lr=lr)
    mod = {"rgcn": rgcn, "monet": monet}[app]
    _, th = train_full_graph(mod.forward, _model(app), tb, x, y, mask,
                             strategy=strategy, epochs=5, lr=lr)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=TOL)
    assert th["loss"][-1] < th["loss"][0]


@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("app", ["gcmc", "lgnn"])
def test_loss_step_trajectory_matches_jax(app, strategy):
    """3 steps of ``make_loss_step`` on GC-MC's ``rating_loss`` and
    LGNN's ``train_loss`` against a JAX loop of the same body
    (``jax.grad``, global-norm clip, AdamW), loss by loss."""
    params, jloss, tloss, _ = _app(app)
    j_init, j_update = jax_adamw(1e-2, weight_decay=5e-4)
    p, state, jl = params, j_init(params), []
    for i in range(3):
        loss, grads = jax.value_and_grad(jloss)(p)
        grads, _ = jax_clip(grads, 5.0)
        ups, state = j_update(grads, state, p, i)
        p = jax_apply_updates(p, ups)
        jl.append(float(loss))
    model = _model(app)
    init, step = make_loss_step(functools.partial(tloss,
                                                  strategy=strategy))
    opt, tl = init(model), []
    for i in range(3):
        opt, loss = step(model, opt, i)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("strategy", ["fused", "kernel"])
def test_lgnn_step_writes_jax_bn_state(strategy):
    """After one step the model's running statistics are those in the
    params JAX's train-mode forward returns."""
    params, _, tloss, (jg, jlg, jrg, *_) = _app("lgnn")
    _, new_params = jax_lgnn.forward(params, jg, jlg, rg=jrg,
                                     strategy="fused", train=True)
    model = _model("lgnn")
    before = {n: b.clone() for n, b in model.named_buffers()}
    init, step = make_loss_step(functools.partial(tloss, strategy=strategy))
    step(model, init(model), 0)
    for name, buf in model.named_buffers():
        assert not torch.equal(buf, before[name]), name
        np.testing.assert_allclose(buf.numpy(), _leaf(new_params, name),
                                   rtol=TOL, atol=TOL, err_msg=name)


# --------------------------------------------------------------------- #
# sampled R-GCN
# --------------------------------------------------------------------- #
N_S, R_S = 200, 5


def _sampled():
    def build():
        rels = jax_relational_graph(N_S, R_S, 400, seed=4)
        jgm, jrel = jax_rgcn.merged_graph(rels, N_S)
        tgm, trel = rgcn.merged_graph(rels, N_S, device="cpu")
        rng = np.random.default_rng(0)
        feats = rng.standard_normal((N_S, 12)).astype(np.float32)
        labels = rng.integers(0, 3, N_S)
        params = jax_rgcn.init(jax.random.PRNGKey(0), 12, 16, 3, n_rel=R_S)
        return rels, jgm, jrel, tgm, trel, feats, labels, params
    return _cached("sampled", build)


def _sampled_batch(fanouts=(4, 4), batch=32, seed=3):
    """(JAX minibatch, port minibatch) of one batch, sampled alike."""
    _, jgm, jrel, tgm, trel, _, labels, _ = _sampled()
    ids = np.arange(5, 5 + batch)
    jmb = JaxSampler(jgm, list(fanouts), batch, seed=seed,
                     edge_rel=jrel).sample(ids, labels[ids])
    tmb = NeighborSampler(tgm, list(fanouts), batch, seed=seed,
                          edge_rel=trel, device="cpu",
                          reverse=True).sample(ids, labels[ids])
    return jmb, tmb


SAMPLED_PATHS = [("kernel", "gather"), ("kernel", "scatter"),
                 ("ell", "gather"), ("ell", "scatter"),
                 ("segment", "gather")]


@pytest.mark.parametrize("path", SAMPLED_PATHS,
                         ids=["-".join(p) for p in SAMPLED_PATHS])
def test_sampled_rgcn_step_matches_jax(path):
    """One sampled step: loss, grads and the AdamW-updated parameters
    against JAX's ``make_sampled_train_step`` with the same backward."""
    *_, feats, _, params = _sampled()
    strategy, bwd = path
    jmb, tmb = _sampled_batch()
    jfeats = jax_pad_features(feats)

    def jax_loss(p):
        x = jax_block_features(jfeats, jmb.input_ids)
        logits = jax_rgcn.forward_blocks(p, jmb.blocks, x,
                                         strategy="segment",
                                         bwd_strategy=bwd)
        return jax_ce(logits, jmb.labels, jmb.label_mask)

    jl, jgrads = jax.value_and_grad(jax_loss)(params)
    jinit, jstep = jax_make_sampled_train_step(jax_rgcn.forward_blocks,
                                               "segment", bwd_strategy=bwd)
    p1, _, jl1 = jstep(params, jinit(params), 0, jmb, jfeats,
                       jax.random.PRNGKey(0))
    model = from_jax_params("rgcn", _np(params), device="cpu")
    tfeats = pad_features(feats, "cpu")
    logits = rgcn.forward_blocks(model, tmb.blocks,
                                 block_features(tfeats, tmb.input_ids),
                                 strategy=strategy, bwd_strategy=bwd)
    loss = cross_entropy_loss(logits, tmb.labels, tmb.label_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=SAMPLED_TOL)
    _close_named(model, jgrads, SAMPLED_TOL, grads=True, what="grads")
    init, step = make_sampled_train_step(rgcn.forward_blocks, strategy,
                                         bwd_strategy=bwd)
    _, loss1 = step(model, init(model), 0, tmb, tfeats,
                    torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss1.item(), float(jl1), rtol=SAMPLED_TOL)
    _close_named(model, p1, SAMPLED_TOL, what="params after one step")


def test_train_sampled_rgcn_trajectory_matches_jax():
    """Three batches of ``train_sampled`` (one an epoch), each package's
    relational sampler from one seed, loss by loss (three different
    batches: their losses need not fall)."""
    _, jgm, jrel, tgm, trel, feats, labels, params = _sampled()
    ids = np.arange(N_S)
    kw = dict(fanouts=(4, 4), batch_size=32, epochs=3, max_batches=1,
              seed=5)
    _, jhist = jax_train_sampled(
        jax_rgcn.forward_blocks, params, jgm, feats, labels, ids,
        sampler=JaxSampler(jgm, [4, 4], 32, seed=5, edge_rel=jrel), **kw)
    _, hist = train_sampled(
        rgcn.forward_blocks, from_jax_params("rgcn", _np(params),
                                             device="cpu"), tgm, feats,
        labels, ids, strategy="kernel",
        sampler=NeighborSampler(tgm, [4, 4], 32, seed=5, edge_rel=trel,
                                device="cpu", reverse=True), **kw)
    assert hist["n_batches"] == jhist["n_batches"] == [1, 1, 1]
    np.testing.assert_allclose(hist["loss"], jhist["loss"],
                               rtol=SAMPLED_TOL)


@pytest.mark.parametrize("path", [("kernel", "gather"), ("ell", "gather"),
                                  ("ell", "scatter")])
def test_sampled_rgcn_equals_full_when_fanout_covers_degree(path):
    """fan-out ≥ max in-degree ⇒ the sampled forward equals the fused
    full-graph forward on the seed rows, and so do the grads of a loss on
    those rows."""
    rels, _, _, tgm, trel, feats, labels, params = _sampled()
    strategy, bwd = path
    maxdeg = int(tgm.host.in_degrees.max())
    ids = np.arange(0, 64, 4)
    mb = NeighborSampler(tgm, [maxdeg, maxdeg], 16, seed=2, edge_rel=trel,
                         device="cpu", reverse=True).sample(ids, labels[ids])
    model = from_jax_params("rgcn", _np(params), device="cpu")
    ps = list(model.parameters())
    ct = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 3)).astype(np.float32))
    x = block_features(pad_features(feats, "cpu"), mb.input_ids)
    sampled = rgcn.forward_blocks(model, mb.blocks, x, strategy=strategy,
                                  bwd_strategy=bwd)
    rg = rgcn.build_relgraph(rels, N_S, device="cpu")
    full = rgcn.forward(model, rg, torch.from_numpy(feats),
                        strategy="kernel" if strategy == "kernel"
                        else "fused")[ids]
    np.testing.assert_allclose(sampled.detach().numpy(),
                               full.detach().numpy(), rtol=SAMPLED_TOL,
                               atol=SAMPLED_TOL)
    for a, b in zip(torch.autograd.grad(sampled, ps, ct),
                    torch.autograd.grad(full, ps, ct)):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SAMPLED_TOL,
                                   atol=SAMPLED_TOL * scale)


def test_sampled_rgcn_step_launches(monkeypatch):
    """One sampled R-GCN step on the kernel route launches
    ``RELATIONAL_TRAIN_LAUNCHES["rgcn_sampled"]``: B4 a block forward, B1
    over each block's relation-expanded Gᵀ backward; the plain pull
    launches none with either backward."""
    counts = _count_launches(monkeypatch)
    *_, feats, _, params = _sampled()
    _, tmb = _sampled_batch()
    model = from_jax_params("rgcn", _np(params), device="cpu")
    tfeats = pad_features(feats, "cpu")
    for strategy, bwd, want in (
            ("kernel", "gather", RELATIONAL_TRAIN_LAUNCHES["rgcn_sampled"]),
            ("ell", "gather", {}), ("ell", "scatter", {})):
        counts.clear()
        init, step = make_sampled_train_step(rgcn.forward_blocks, strategy,
                                             bwd_strategy=bwd)
        step(model, init(model), 0, tmb, tfeats,
             torch.Generator().manual_seed(1))
        assert counts == want, (strategy, bwd)
