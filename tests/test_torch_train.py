"""Port parity for full-graph training: the loss's gradients, the loss,
accuracy, dropout, the optimizers and schedules, one train step, and a
loss trajectory of ``train_full_graph``.

* The whole loss of GCN, SAGE and GAT (each ``attn`` mode), with the JAX
  init carried across by ``from_jax_params`` and the port's gradients
  carried back by ``to_jax_params``, against ``jax.grad`` at 1e-5 (fp32,
  relative to the largest gradient entry). Dropout cannot match JAX's
  RNG, so both sides run ``train=True`` at ``drop=0``.
* One AdamW step on identical gradients at 1e-6.
* 5 epochs of ``train_full_graph`` (dropout 0) on ``tiny`` and
  ``pubmed-like`` against JAX's at the tolerance :data:`TRAJ_TOL` states.
* The kernel launches of one training step, counted on the CPU through
  the wrappers' plain branches, are ``chip_smoke.TRAIN_LAUNCHES`` — the
  counts the chip run checks on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_LAUNCHES
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.train import make_train_step as jax_make_train_step
from repro.models.gnn.train import train_full_graph as jax_train_full_graph
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import global_norm as jax_global_norm
from repro.optim import schedules as jax_schedules
from repro.optim import sgd as jax_sgd
from repro.substrate.nn import accuracy as jax_accuracy
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import (from_jax_params, make_bundle,
                                           to_jax_params)
from repro_torch.models.gnn.train import make_train_step, train_full_graph
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               global_norm, schedules, sgd)
from repro_torch.substrate.nn import accuracy, cross_entropy_loss, dropout
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}
# the loss trajectory over 5 epochs, relative: fp32's tolerance. AdamW
# moves every weight by ≈ lr·sign(g) at step 1, so a gradient entry at
# rounding level could flip sign between the packages and move its weight
# by 2·lr; on these datasets no entry does: the losses agree to ≤ 2.6e-7
# relative over the 5 epochs (all six runs, on this suite's CPU)
TRAJ_TOL = 1e-5

_cache = {}


def _data(name):
    """Both packages' dataset ``name`` (built inside a test, under the
    shim); the port's on the CPU."""
    if name not in _cache:
        _cache[name] = (jax_make_node_dataset(name),
                        make_node_dataset(name, device="cpu"))
    return _cache[name]


def _params(app, d_in, n_classes, seed=7):
    p = JAX_APPS[app].init(jax.random.PRNGKey(seed), d_in, 16, n_classes)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _close_tree(got, ref, tol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


# --------------------------------------------------------------------- #
# the loss and its gradients, per app
# --------------------------------------------------------------------- #
GRAD_CASES = ([(app, None, s) for app in ("gcn", "sage")
               for s in ("auto", "kernel", "segment")]
              + [("gat", a, s) for a in ("multipass", "softmax-fused",
                                         "fused", "pallas", "auto")
                 for s in ("auto", "kernel", "segment")])


@pytest.mark.parametrize("app,attn,strategy", GRAD_CASES)
def test_loss_grads_match_jax(app, attn, strategy):
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _data("tiny")
    p, tree = _params(app, jf.shape[1], n_cls)
    kw = {} if attn is None else {"attn": attn}
    jb = jax_make_bundle(jg)

    def jax_loss(params):
        logits = JAX_APPS[app].forward(
            params, jb, jnp.asarray(jf), strategy="segment", train=True,
            rng=jax.random.PRNGKey(0), drop=0.0, **kw)
        return jax_ce(logits, jnp.asarray(jl), jnp.asarray(jtr))

    jloss, jgrads = jax.value_and_grad(jax_loss)(p)
    model = from_jax_params(app, tree, device="cpu")
    bundle = make_bundle(tg)
    logits = PORT_APPS[app].forward(
        model, bundle, torch.from_numpy(tf), strategy=strategy, train=True,
        gen=torch.Generator().manual_seed(0), drop=0.0, **kw)
    loss = cross_entropy_loss(logits, torch.from_numpy(tl),
                              torch.from_numpy(ttr))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads)
    _close_tree(to_jax_params(model), p, tol=0)


def test_to_jax_params_inverts_from_jax_params():
    for app in ("gcn", "sage", "gat"):
        _, tree = _params(app, 8, 3)
        back = to_jax_params(from_jax_params(app, tree, device="cpu"))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        _close_tree(back, tree, tol=0)


# --------------------------------------------------------------------- #
# launches per training step, counted on the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_training_step_launches(app, monkeypatch):
    """Each wrapper's plain branch stands in for its kernel on the CPU:
    count those calls over one forward and backward with strategy
    "kernel" (dropout on), and none with "segment". (On the card "auto"
    is "kernel"; on the CPU it takes the plain routes.)"""
    (*_, n_cls), (tg, tf, tl, ttr, *_) = _data("tiny")
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
    bundle = make_bundle(tg)
    for strategy, want in (("kernel", TRAIN_LAUNCHES[app]),
                           ("segment", {})):
        counts.clear()
        logits = PORT_APPS[app].forward(
            model, bundle, torch.from_numpy(tf), strategy=strategy,
            train=True, gen=torch.Generator().manual_seed(1))
        torch.autograd.grad(cross_entropy_loss(
            logits, torch.from_numpy(tl), torch.from_numpy(ttr)),
            list(model.parameters()))
        assert counts == want, strategy


# --------------------------------------------------------------------- #
# loss, accuracy, dropout
# --------------------------------------------------------------------- #
def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50)
    for mask in (rng.random(50) < 0.5, np.zeros(50, bool), None):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.from_numpy(mask)
        args_j = (jnp.asarray(logits), jnp.asarray(labels), jm)
        args_t = (torch.from_numpy(logits), torch.from_numpy(labels), tm)
        np.testing.assert_allclose(float(cross_entropy_loss(*args_t)),
                                   float(jax_ce(*args_j)), rtol=TOL)
        assert float(accuracy(*args_t)) == float(jax_accuracy(*args_j))


def test_dropout():
    x = torch.randn(400, 30)
    gen = torch.Generator().manual_seed(3)
    assert dropout(gen, x, 0.5, False) is x
    assert dropout(gen, x, 0.0, True) is x
    a = dropout(torch.Generator().manual_seed(4), x, 0.25, True)
    b = dropout(torch.Generator().manual_seed(4), x, 0.25, True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(a[kept], x[kept] / 0.75, rtol=0, atol=0)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_forward_dropout_follows_the_generator(app):
    (*_, n_cls), (tg, tf, *_) = _data("tiny")
    model = from_jax_params(app, _params(app, tf.shape[1], n_cls)[1],
                            device="cpu")
    bundle, x = make_bundle(tg), torch.from_numpy(tf)
    fwd = PORT_APPS[app].forward

    def run(seed, **kw):
        with torch.no_grad():
            return fwd(model, bundle, x, train=True,
                       gen=torch.Generator().manual_seed(seed), **kw)

    ref = PORT_APPS[app].infer(model, bundle, x)
    torch.testing.assert_close(run(0, drop=0.0), ref, rtol=0, atol=0)
    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.equal(run(5), run(6))
    with torch.no_grad():       # train without a generator: no dropout
        torch.testing.assert_close(fwd(model, bundle, x, train=True), ref,
                                   rtol=0, atol=0)


# --------------------------------------------------------------------- #
# optimizers and schedules
# --------------------------------------------------------------------- #
def _leaves(rng, shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


SHAPES = [(602, 16), (16,), (4, 16), (1, 41)]


@pytest.mark.parametrize("step_i", [0, 4])
def test_adamw_step_matches_jax(step_i):
    """One AdamW step on identical params, grads and moments, at 1e-6."""
    rng = np.random.default_rng(step_i)
    params, grads = _leaves(rng, SHAPES), _leaves(rng, SHAPES)
    mu = _leaves(rng, SHAPES)
    nu = [np.abs(a) for a in _leaves(rng, SHAPES)]
    j_init, j_update = jax_adamw(1e-2, weight_decay=5e-4)
    t_init, t_update = adamw(1e-2, weight_decay=5e-4)
    jstate = j_init([jnp.asarray(p) for p in params])._replace(
        mu=[jnp.asarray(a) for a in mu], nu=[jnp.asarray(a) for a in nu])
    tstate = t_init([torch.from_numpy(p) for p in params])._replace(
        mu=[torch.from_numpy(a) for a in mu],
        nu=[torch.from_numpy(a) for a in nu])
    jups, jst = j_update([jnp.asarray(g) for g in grads], jstate,
                         [jnp.asarray(p) for p in params], step_i)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tups, tst = t_update([torch.from_numpy(g) for g in grads], tstate, tp,
                         step_i)
    apply_updates(tp, tups)
    jp = jax_apply_updates([jnp.asarray(p) for p in params], jups)
    for a, b in zip(tp + tst.mu + tst.nu, list(jp) + jst.mu + jst.nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_sgd_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(1)
    grads = _leaves(rng, SHAPES)
    jg, tgr = [jnp.asarray(g) for g in grads], [torch.from_numpy(g)
                                                 for g in grads]
    np.testing.assert_allclose(float(global_norm(tgr)),
                               float(jax_global_norm(jg)), rtol=TOL)
    for max_norm in (5.0, 1e4):
        (tc, tn), (jc, jn) = (clip_by_global_norm(tgr, max_norm),
                              jax_clip(jg, max_norm))
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=1e-7)
    for nesterov in (False, True):
        ji, ju = jax_sgd(1e-2, nesterov=nesterov)
        ti, tu = sgd(1e-2, nesterov=nesterov)
        jst, tst = ji(jg), ti(tgr)
        for step_i in range(3):
            jups, jst = ju(jg, jst, jg, step_i)
            tups, tst = tu(tgr, tst, tgr, step_i)
            for a, b in zip(tups, jups):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["constant", "warmup_linear",
                                  "warmup_cosine"])
def test_schedules_match_jax(name):
    args = (0.1,) if name == "constant" else (0.1, 5, 20, 0.01)
    js, ts = getattr(jax_schedules, name)(*args), getattr(schedules,
                                                          name)(*args)
    for step in range(0, 25):
        np.testing.assert_allclose(float(ts(step)),
                                   float(js(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-9)
    # the optimizer takes a schedule for lr and reads it at step + 1
    p, g = [torch.ones(3)], [torch.full((3,), 0.5)]
    got = adamw(ts)[1](g, adamw(ts)[0](p), p, 3)[0]
    want = adamw(float(ts(4)))[1](g, adamw(0.0)[0](p), p, 3)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# train step and train_full_graph
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_train_step_matches_jax(app):
    """One step of ``make_train_step`` (dropout 0): the loss and the
    updated parameters against JAX's step."""
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _data("tiny")
    p, tree = _params(app, jf.shape[1], n_cls)
    fwd_j = functools.partial(JAX_APPS[app].forward, drop=0.0)
    fwd_t = functools.partial(PORT_APPS[app].forward, drop=0.0)
    j_init, j_step = jax_make_train_step(fwd_j, "segment")
    jp, _, jloss = j_step(p, j_init(p), 0, jax_make_bundle(jg),
                          jnp.asarray(jf), jnp.asarray(jl),
                          jnp.asarray(jtr), jax.random.PRNGKey(0))
    model = from_jax_params(app, tree, device="cpu")
    t_init, t_step = make_train_step(fwd_t)
    _, loss = t_step(model, t_init(model), 0, make_bundle(tg),
                     torch.from_numpy(tf), torch.from_numpy(tl),
                     torch.from_numpy(ttr), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model), jp)


@pytest.mark.parametrize("dataset", ["tiny", "pubmed-like"])
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_train_full_graph_trajectory_matches_jax(app, dataset):
    """5 epochs, dropout 0, the port's kernel routes (``"kernel"``, what
    ``"auto"`` takes on the card; their wrappers' plain versions here)
    against JAX's segment path: loss per epoch within
    :data:`TRAJ_TOL` (relative), validation accuracy within 1% (one
    borderline node may flip), and the loss falls."""
    (jg, jf, jl, jtr, jva, n_cls), (tg, tf, tl, ttr, tva, _) = _data(dataset)
    p, tree = _params(app, jf.shape[1], n_cls)
    _, jh = jax_train_full_graph(
        functools.partial(JAX_APPS[app].forward, drop=0.0), p,
        jax_make_bundle(jg, ell=False, training=False), jf, jl, jtr,
        strategy="segment", epochs=5, val_mask=jva)
    model = from_jax_params(app, tree, device="cpu")
    _, th = train_full_graph(
        functools.partial(PORT_APPS[app].forward, drop=0.0), model,
        make_bundle(tg), tf, tl, ttr, strategy="kernel", epochs=5,
        val_mask=tva)
    assert set(th) == {"loss", "epoch_time", "val_acc"}
    assert len(th["epoch_time"]) == 5 and min(th["epoch_time"]) > 0
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=TRAJ_TOL)
    np.testing.assert_allclose(th["val_acc"], jh["val_acc"], atol=0.01)
    assert th["loss"][-1] < th["loss"][0]


def test_train_full_graph_discards_the_warm_up_and_checks_precision():
    (*_, n_cls), (tg, tf, tl, ttr, *_) = _data("tiny")
    _, tree = _params("gcn", tf.shape[1], n_cls)
    model = from_jax_params("gcn", tree, device="cpu")
    bundle = make_bundle(tg)
    _, hist = train_full_graph(gcn.forward, model, bundle, tf, tl, ttr,
                               epochs=0)
    assert hist == {"loss": [], "epoch_time": [], "val_acc": []}
    _close_tree(to_jax_params(model), tree, tol=0)
    for precision in ("bf16", "fp16"):
        with pytest.raises(NotImplementedError, match="A12"):
            train_full_graph(gcn.forward, model, bundle, tf, tl, ttr,
                             precision=precision)
    with pytest.raises(NotImplementedError, match="A12"):
        make_train_step(gcn.forward, precision="bf16")
