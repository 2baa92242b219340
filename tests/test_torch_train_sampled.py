"""Port parity for sampled minibatch training (paper Fig. 3):
``make_sampled_train_step``, ``train_sampled`` and the apps'
``forward_blocks`` with ``train`` / ``gen`` / ``drop`` / ``bwd_strategy``.

Both packages sample the same minibatches for one seed (bit-identical
blocks), the JAX init is carried across by ``from_jax_params``, and
dropout runs at rate 0 on both sides (the packages' RNGs differ), as in
the JAX package's sampled tests. Tolerance 2e-4, the sampled paths'
(ROADMAP), relative to the largest entry:

* one step of each app — its loss, every parameter's gradient and the
  parameters after AdamW — on the kernel route (the wrappers' plain
  versions here, with the kernel routes' backward), the plain pull with
  autograd, and the plain pull with the gather backward;
* GAT's loss grads in each of the five ``attn`` modes;
* a 3-batch loss trajectory of ``train_sampled`` against JAX's;
* "sampled equals full when fan-out ≥ max in-degree"
  (``tests/data/test_sampler.py:287``) for the port's forward and grads;
* the kernel launches of one sampled step, counted through the wrappers'
  plain branches, are ``chip_smoke.TRAIN_SAMPLED_LAUNCHES`` (the counts
  the card checks), and the plain path makes none.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_SAMPLED_LAUNCHES
from repro.data import NeighborSampler as JaxSampler
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import block_features as jax_block_features
from repro.models.gnn.common import pad_features as jax_pad_features
from repro.models.gnn.train import \
    make_sampled_train_step as jax_make_sampled_train_step
from repro.models.gnn.train import train_sampled as jax_train_sampled
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.data import NeighborSampler
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import (block_features, from_jax_params,
                                           make_bundle, pad_features,
                                           to_jax_params)
from repro_torch.models.gnn.train import (make_sampled_train_step,
                                          train_sampled)
from repro_torch.substrate.nn import cross_entropy_loss
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 2e-4
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}
# (strategy, bwd_strategy) of the port's three paths: the kernel route,
# the plain pull differentiated by autograd, the plain pull with the
# gather backward
PATHS = [("kernel", "auto"), ("ell", "scatter"), ("ell", "gather")]

_cache = {}


def _data():
    """Both packages' ``tiny`` dataset (built under the shim)."""
    if "tiny" not in _cache:
        _cache["tiny"] = (jax_make_node_dataset("tiny"),
                          make_node_dataset("tiny", device="cpu"))
    return _cache["tiny"]


def _params(app, d_in, n_classes, seed=7):
    p = JAX_APPS[app].init(jax.random.PRNGKey(seed), d_in, 16, n_classes)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _close_tree(got, ref, what=""):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * scale,
                                   err_msg=what)


def _minibatches(fanouts=(4, 4), batch=16, seed=3):
    """(JAX minibatch, port minibatch) of one batch of train seeds."""
    (jg, _, jl, jtr, _, _), (tg, *_) = _data()
    ids = np.nonzero(np.asarray(jtr))[0][5:5 + batch]
    lab = np.asarray(jl)[ids]
    jmb = JaxSampler(jg, list(fanouts), batch, seed=seed).sample(ids, lab)
    tmb = NeighborSampler(tg, list(fanouts), batch, seed=seed, device="cpu",
                          reverse=True).sample(ids, lab)
    return jmb, tmb


@pytest.mark.parametrize("path", PATHS, ids=["-".join(p) for p in PATHS])
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_sampled_step_matches_jax(app, path):
    """One sampled step: loss, grads and AdamW-updated parameters against
    JAX's ``make_sampled_train_step`` (dropout 0)."""
    (_, jf, _, _, _, n_cls), (_, tf, *_) = _data()
    jmb, tmb = _minibatches()
    p, tree = _params(app, jf.shape[1], n_cls)
    jfwd = functools.partial(JAX_APPS[app].forward_blocks, drop=0.0)
    jfeats = jax_pad_features(jf)

    def jax_loss(params):
        x = jax_block_features(jfeats, jmb.input_ids)
        logits = jfwd(params, jmb.blocks, x, strategy="segment",
                      bwd_strategy="scatter", train=True,
                      rng=jax.random.PRNGKey(0))
        return jax_ce(logits, jmb.labels, jmb.label_mask)

    jloss, jgrads = jax.value_and_grad(jax_loss)(p)
    jinit, jstep = jax_make_sampled_train_step(jfwd, "segment",
                                               bwd_strategy="scatter")
    p1, _, jloss1 = jstep(p, jinit(p), 0, jmb, jfeats,
                          jax.random.PRNGKey(0))

    strategy, bwd = path
    fwd = functools.partial(PORT_APPS[app].forward_blocks, drop=0.0)
    model = from_jax_params(app, tree, device="cpu")
    feats = pad_features(tf, "cpu")
    logits = fwd(model, tmb.blocks, block_features(feats, tmb.input_ids),
                 strategy=strategy, bwd_strategy=bwd, train=True,
                 gen=torch.Generator().manual_seed(0))
    loss = cross_entropy_loss(logits, tmb.labels, tmb.label_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads, "grads")

    init, step = make_sampled_train_step(fwd, strategy, bwd_strategy=bwd)
    _, loss1 = step(model, init(model), 0, tmb, feats,
                    torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss1.item(), float(jloss1), rtol=TOL)
    _close_tree(to_jax_params(model), p1, "params after one step")


@pytest.mark.parametrize("strategy", ["kernel", "ell"])
@pytest.mark.parametrize("attn", ["multipass", "softmax-fused", "fused",
                                  "pallas", "auto"])
def test_sampled_gat_attn_modes_grads_match_jax(attn, strategy):
    """GAT's block forward in every ``attn`` mode: the loss's grads
    against ``jax.grad`` of JAX's ``forward_blocks`` in the same mode
    (its block path runs 'softmax-fused' multipass; the port's runs B5's
    plain version, whose dummy row no real row reads)."""
    (_, jf, _, _, _, n_cls), (_, tf, *_) = _data()
    jmb, tmb = _minibatches()
    p, tree = _params("gat", jf.shape[1], n_cls)
    jfeats = jax_pad_features(jf)

    def jax_loss(params):
        x = jax_block_features(jfeats, jmb.input_ids)
        logits = jax_gat.forward_blocks(params, jmb.blocks, x, attn=attn)
        return jax_ce(logits, jmb.labels, jmb.label_mask)

    jloss, jgrads = jax.value_and_grad(jax_loss)(p)
    model = from_jax_params("gat", tree, device="cpu")
    x = block_features(pad_features(tf, "cpu"), tmb.input_ids)
    logits = gat.forward_blocks(model, tmb.blocks, x, strategy=strategy,
                                attn=attn)
    loss = cross_entropy_loss(logits, tmb.labels, tmb.label_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads, attn)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_train_sampled_trajectory_matches_jax(app):
    """Three batches of ``train_sampled`` (one per epoch, the sampler's
    stream from one seed) against JAX's, loss by loss, and the history
    keys of JAX's."""
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _data()
    p, tree = _params(app, jf.shape[1], n_cls)
    ids = np.nonzero(np.asarray(jtr))[0]
    kw = dict(fanouts=(4, 4), batch_size=32, epochs=3, max_batches=1,
              seed=5)
    _, jhist = jax_train_sampled(
        functools.partial(JAX_APPS[app].forward_blocks, drop=0.0), p, jg,
        np.asarray(jf), np.asarray(jl), ids, **kw)
    model = from_jax_params(app, tree, device="cpu")
    _, hist = train_sampled(
        functools.partial(PORT_APPS[app].forward_blocks, drop=0.0), model,
        tg, tf, tl, ids, strategy="kernel", **kw)
    assert set(hist) == set(jhist)
    assert hist["n_batches"] == jhist["n_batches"] == [1, 1, 1]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=TOL)
    assert hist["loss"][-1] < hist["loss"][0]


@pytest.mark.parametrize("strategy", ["auto", "kernel", "ell"])
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_sampled_equals_full_when_fanout_covers_degree(app, strategy):
    """fan-out ≥ max in-degree ⇒ the blocks hold every in-edge ⇒ the
    sampled forward equals the full-graph forward on the seed rows, and
    so do the parameters' grads of a loss on those rows."""
    (*_, n_cls), (tg, tf, tl, ttr, _, _) = _data()
    maxdeg = int(tg.host.in_degrees.max())
    ids = np.nonzero(ttr)[0][:16]
    mb = NeighborSampler(tg, [maxdeg, maxdeg], 16, seed=4, device="cpu",
                         reverse=True).sample(ids, tl[ids])
    model = from_jax_params(app, _params(app, tf.shape[1], n_cls)[1],
                            device="cpu")
    params = list(model.parameters())
    ct = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, n_cls)).astype(np.float32))
    x = block_features(pad_features(tf, "cpu"), mb.input_ids)
    sampled = PORT_APPS[app].forward_blocks(model, mb.blocks, x,
                                            strategy=strategy)
    full_strategy = {"ell": "segment"}.get(strategy, strategy)
    full = PORT_APPS[app].forward(model, make_bundle(tg),
                                  torch.from_numpy(tf),
                                  strategy=full_strategy)[ids]
    np.testing.assert_allclose(sampled.detach().numpy(),
                               full.detach().numpy(), rtol=TOL, atol=2e-5)
    gs = torch.autograd.grad(sampled, params, ct)
    gf = torch.autograd.grad(full, params, ct)
    for a, b in zip(gs, gf):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL * scale)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_sampled_step_launches(app, monkeypatch):
    """Each wrapper's plain branch stands in for its kernel on the CPU:
    one sampled step (forward and backward, dropout on) on the kernel
    route launches ``TRAIN_SAMPLED_LAUNCHES[app]``; the plain paths
    (``"ell"``, either backward) launch nothing."""
    (*_, n_cls), (_, tf, *_) = _data()
    _, tmb = _minibatches()
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
    counting(es_ops, "edge_softmax_plain", "edge_softmax_csr")
    counting(es_ops, "fused_attention_plain", "fused_attention_csr")
    model = from_jax_params(app, _params(app, tf.shape[1], n_cls)[1],
                            device="cpu")
    feats = pad_features(tf, "cpu")
    for strategy, bwd, want in (("kernel", "auto",
                                 TRAIN_SAMPLED_LAUNCHES[app]),
                                ("ell", "scatter", {}),
                                ("ell", "gather", {})):
        counts.clear()
        init, step = make_sampled_train_step(PORT_APPS[app].forward_blocks,
                                             strategy, bwd_strategy=bwd)
        step(model, init(model), 0, tmb, feats,
             torch.Generator().manual_seed(1))
        assert counts == want, (strategy, bwd)


def test_sampled_dropout_draws_from_gen():
    """``train=True`` with a generator drops units (two seeds differ, one
    seed repeats); ``train=False`` or no generator is deterministic."""
    (*_, n_cls), (_, tf, *_) = _data()
    _, tmb = _minibatches()
    model = from_jax_params("sage", _params("sage", tf.shape[1], n_cls)[1],
                            device="cpu")
    x = block_features(pad_features(tf, "cpu"), tmb.input_ids)

    def run(**kw):
        with torch.no_grad():
            return sage.forward_blocks(model, tmb.blocks, x, **kw)

    a = run(train=True, gen=torch.Generator().manual_seed(1))
    b = run(train=True, gen=torch.Generator().manual_seed(1))
    c = run(train=True, gen=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(), run(train=True))
