"""Port parity for mixed-precision training (``precision="bf16"``).

* JAX's ``test_bf16_final_loss_matches_fp32``, ported: the port's bf16
  final loss against its fp32 one within 2e-2 (JAX's documented
  tolerance, DESIGN.md §12), and falling but for GAT, as JAX excepts it.
* The port's bf16 against JAX's bf16, dropout 0 (as
  ``tests/test_torch_train.py`` does it): 5 epochs' losses within 2e-2
  (relative), and one step's grads leaf by leaf within
  2e-2·max|JAX bf16| plus twice JAX's own bf16 distance from its fp32
  grads — two bf16 computations each carry bf16's rounding noise, which a
  gradient summing many cancelling terms (sampled SAGE's layer-0 weight:
  JAX's bf16 grad is 4.6% of its largest entry off its fp32 grad) lifts
  above 2e-2 on either side. Full graph GCN / SAGE / GAT, sampled
  SAGE / GCN / GAT, R-GCN, MoNet and sampled R-GCN; the port on its plain
  routes and its kernel routes (the wrappers' plain versions here).
* The masters and the AdamW moments stay fp32 through bf16 steps.
* A bf16 step's kernel launches, counted through the wrappers' plain
  branches under the pinned kernel route, are the fp32 step's
  (``chip_smoke.TRAIN_LAUNCHES``, ``TRAIN_SAMPLED_LAUNCHES``,
  ``RELATIONAL_TRAIN_LAUNCHES``), with no fallback warning the fp32 step
  does not give.
"""
import copy
import functools
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (RELATIONAL_TRAIN_LAUNCHES, TRAIN_LAUNCHES,
                        TRAIN_SAMPLED_LAUNCHES)
from repro.data import NeighborSampler as JaxSampler
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.data import relational_graph as jax_relational_graph
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import monet as jax_monet
from repro.models.gnn import rgcn as jax_rgcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import block_features as jax_block_features
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.common import pad_features as jax_pad_features
from repro.models.gnn.train import train_full_graph as jax_train_full_graph
from repro.models.gnn.train import train_sampled as jax_train_sampled
from repro.optim import cast_tree as jax_cast_tree
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.core import from_coo
from repro_torch.data import NeighborSampler
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gat, gcn, monet, rgcn, sage
from repro_torch.models.gnn.common import (block_features, from_jax_params,
                                           make_bundle, pad_features)
from repro_torch.models.gnn.train import (call_in_precision,
                                          make_train_step, train_full_graph,
                                          train_sampled)
from repro_torch.substrate.nn import cross_entropy_loss
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

BF16_TOL = 2e-2
# a GAT logit within KINK_ULPS bf16 ulps of its terms lies at leaky-relu's
# kink (_kink_sides): each term is rounded to bf16 after inputs that were
# rounded too, so two bf16 computations may differ by about two ulps of
# each term
KINK_ULPS = 4
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat,
            "rgcn": jax_rgcn, "monet": jax_monet}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat, "rgcn": rgcn,
             "monet": monet}
N_RG, R_RG = 60, 3
_cache = {}


def _cached(key, build):
    if key not in _cache:
        _cache[key] = build()
    return _cache[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, dotted):
    for key in dotted.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else \
            tree[key]
    return np.array(tree, np.float32)


def _close_grads(model, grads, j16, j32, what=""):
    """The port's bf16 grads against JAX's, leaf by leaf (module
    docstring); every grad fp32."""
    for (name, _), g in zip(model.named_parameters(), grads):
        assert g.dtype == torch.float32, name
        ref, ref32 = _leaf(j16, name), _leaf(j32, name)
        tol = (BF16_TOL * float(np.abs(ref).max())
               + 2 * float(np.abs(ref - ref32).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=f"{what} {name}")


def _x(a, prec):
    """Input rows as the trainer casts them: to bf16, or as they are."""
    t = torch.as_tensor(a)
    return t.bfloat16() if prec == "bf16" else t


def _jax_bf16_loss(loss):
    """``loss(params, dtype)`` as JAX's trainer takes it in bf16 and fp32:
    a whole-tree cast of the params, fp32 logits."""
    return (jax.value_and_grad(lambda p: loss(p, jnp.bfloat16)),
            jax.grad(lambda p: loss(p, jnp.float32)))


# --------------------------------------------------------------------- #
# the cases: (JAX loss(params, dtype), port grads(model, strategy),
# JAX params) at a small size
# --------------------------------------------------------------------- #
def _tiny():
    return _cached("tiny", lambda: (jax_make_node_dataset("tiny"),
                                    make_node_dataset("tiny", device="cpu")))


def _full_case(app):
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _tiny()
    params = JAX_APPS[app].init(jax.random.PRNGKey(7), jf.shape[1], 16,
                                n_cls)
    jb, tb = jax_make_bundle(jg), make_bundle(tg)

    def jloss(p, dt):
        logits = JAX_APPS[app].forward(
            jax_cast_tree(p, dt), jb, jnp.asarray(jf).astype(dt),
            strategy="segment", train=True, rng=jax.random.PRNGKey(0),
            drop=0.0)
        return jax_ce(logits.astype(jnp.float32), jnp.asarray(jl),
                      jnp.asarray(jtr))

    def tgrads(model, strategy, prec="bf16"):
        logits = call_in_precision(
            prec, PORT_APPS[app].forward, model, tb, _x(tf, prec),
            strategy=strategy, train=True,
            gen=torch.Generator().manual_seed(0), drop=0.0)
        return torch.autograd.grad(cross_entropy_loss(
            logits.float(), torch.from_numpy(tl), torch.from_numpy(ttr)),
            list(model.parameters()))
    return jloss, tgrads, params


def _sampled_batch():
    """One batch of 16 seeds at fan-out (4, 4)."""
    def build():
        (jg, _, jl, jtr, _, _), (tg, *_) = _tiny()
        ids = np.nonzero(np.asarray(jtr))[0][5:21]
        lab = np.asarray(jl)[ids]
        return (JaxSampler(jg, [4, 4], 16, seed=3).sample(ids, lab),
                NeighborSampler(tg, [4, 4], 16, seed=3, device="cpu",
                                reverse=True).sample(ids, lab))
    return _cached("mb", build)


def _sampled_case(app):
    (_, jf, _, _, _, n_cls), (_, tf, *_) = _tiny()
    jmb, tmb = _sampled_batch()
    params = JAX_APPS[app].init(jax.random.PRNGKey(7), jf.shape[1], 16,
                                n_cls)
    jfeats, tfeats = jax_pad_features(jf), pad_features(tf, "cpu")

    def jloss(p, dt):
        x = jax_block_features(jfeats, jmb.input_ids).astype(dt)
        logits = JAX_APPS[app].forward_blocks(
            jax_cast_tree(p, dt), jmb.blocks, x, strategy="segment",
            bwd_strategy="scatter", train=True, rng=jax.random.PRNGKey(0),
            drop=0.0)
        return jax_ce(logits.astype(jnp.float32), jmb.labels,
                      jmb.label_mask)

    def tgrads(model, strategy, prec="bf16"):
        st, bwd = strategy
        x = _x(block_features(tfeats, tmb.input_ids), prec)
        logits = call_in_precision(
            prec, functools.partial(PORT_APPS[app].forward_blocks,
                                    drop=0.0), model, tmb.blocks, x,
            strategy=st, bwd_strategy=bwd, train=True,
            gen=torch.Generator().manual_seed(0))
        return torch.autograd.grad(cross_entropy_loss(
            logits.float(), tmb.labels, tmb.label_mask),
            list(model.parameters()))
    return jloss, tgrads, params


def _rgcn_data():
    def build():
        rels = jax_relational_graph(N_RG, R_RG, 150, seed=5)
        rng = np.random.default_rng(8)
        x = rng.standard_normal((N_RG, 8)).astype(np.float32)
        y = rng.integers(0, 4, N_RG)
        mask = rng.random(N_RG) < 0.6
        return (rels, jax_rgcn.build_relgraph(rels, N_RG),
                rgcn.build_relgraph(rels, N_RG, device="cpu"), x, y, mask)
    return _cached("rgcn", build)


def _relational_case(app):
    if app == "rgcn":
        _, jrg, trg, x, y, mask = _rgcn_data()
        params = jax_rgcn.init(jax.random.PRNGKey(3), 8, 12, 4, R_RG)
        jgraph, tgraph = jrg, trg
    else:
        (jg, x, y, mask, _, n_cls), (tg, *_) = _tiny()
        params = jax_monet.init(jax.random.PRNGKey(3), x.shape[1], 16,
                                n_cls, n_kernels=2)
        jgraph, tgraph = jax_make_bundle(jg, krel=2), make_bundle(tg,
                                                                  krel=2)

    def jloss(p, dt):
        logits = JAX_APPS[app].forward(jax_cast_tree(p, dt), jgraph,
                                       jnp.asarray(x).astype(dt),
                                       strategy="fused")
        return jax_ce(logits.astype(jnp.float32), jnp.asarray(y),
                      jnp.asarray(mask))

    def tgrads(model, strategy, prec="bf16"):
        logits = call_in_precision(prec, PORT_APPS[app].forward, model,
                                   tgraph, _x(x, prec), strategy=strategy)
        return torch.autograd.grad(cross_entropy_loss(
            logits.float(), torch.from_numpy(y), torch.from_numpy(mask)),
            list(model.parameters()))
    return jloss, tgrads, params


def _sampled_rgcn():
    def build():
        n, R = 200, 5
        rels = jax_relational_graph(n, R, 400, seed=4)
        jgm, jrel = jax_rgcn.merged_graph(rels, n)
        tgm, trel = rgcn.merged_graph(rels, n, device="cpu")
        rng = np.random.default_rng(0)
        feats = rng.standard_normal((n, 12)).astype(np.float32)
        labels = rng.integers(0, 3, n)
        ids = np.arange(5, 37)
        jmb = JaxSampler(jgm, [4, 4], 32, seed=3,
                         edge_rel=jrel).sample(ids, labels[ids])
        tmb = NeighborSampler(tgm, [4, 4], 32, seed=3, edge_rel=trel,
                              device="cpu",
                              reverse=True).sample(ids, labels[ids])
        return feats, jmb, tmb, R
    return _cached("sampled_rgcn", build)


def _sampled_rgcn_case(_app="rgcn"):
    feats, jmb, tmb, R = _sampled_rgcn()
    params = jax_rgcn.init(jax.random.PRNGKey(0), 12, 16, 3, n_rel=R)
    jfeats, tfeats = jax_pad_features(feats), pad_features(feats, "cpu")

    def jloss(p, dt):
        x = jax_block_features(jfeats, jmb.input_ids).astype(dt)
        logits = jax_rgcn.forward_blocks(jax_cast_tree(p, dt), jmb.blocks,
                                         x, strategy="segment",
                                         bwd_strategy="gather")
        return jax_ce(logits.astype(jnp.float32), jmb.labels,
                      jmb.label_mask)

    def tgrads(model, strategy, prec="bf16"):
        st, bwd = strategy
        x = _x(block_features(tfeats, tmb.input_ids), prec)
        logits = call_in_precision(prec, rgcn.forward_blocks, model,
                                   tmb.blocks, x, strategy=st,
                                   bwd_strategy=bwd)
        return torch.autograd.grad(cross_entropy_loss(
            logits.float(), tmb.labels, tmb.label_mask),
            list(model.parameters()))
    return jloss, tgrads, params


CASES = {"full": _full_case, "sampled": _sampled_case,
         "relational": _relational_case, "sampled_rgcn": _sampled_rgcn_case}
GRAD_CASES = (
    [("full", app, s) for app in ("gcn", "sage", "gat")
     for s in ("segment", "kernel")]
    + [("sampled", app, s) for app in ("sage", "gcn", "gat")
       for s in (("kernel", "auto"), ("ell", "scatter"), ("ell", "gather"))]
    + [("relational", app, s) for app in ("rgcn", "monet")
       for s in ("fused", "kernel")]
    + [("sampled_rgcn", "rgcn", s) for s in (("kernel", "gather"),
                                             ("ell", "scatter"))])


def _case_id(kind, app, strategy):
    return "-".join((kind, app) + ((strategy,) if isinstance(strategy, str)
                                   else tuple(strategy)))


def _spy_logits(module, run):
    """``run()`` with ``module.gsddmm`` watched: each ``u_add_v_copy_e``
    call's (graph, el, er, logits), one per GAT layer, and the result."""
    seen, sddmm = [], module.gsddmm

    def spy(g, op, **kw):
        out = sddmm(g, op, **kw)
        if op == "u_add_v_copy_e":
            seen.append((g, kw["u"], kw["v"], out))
        return out
    with mock.patch.object(module, "gsddmm", spy):
        return seen, run()


def _kink_sides(jloss, params, port):
    """Per GAT layer, ``(at, positive)``: the logits el[u] + er[v] that
    lie within ``KINK_ULPS`` bf16 ulps of their terms (2⁻⁸·(|el[u]| +
    |er[v]|), JAX's fp32 forward) of leaky-relu's kink at 0 and that the
    port's bf16 forward (``port``, :func:`_spy_logits`) put on the other
    side than JAX's bf16 forward, and the port's side of each logit. Two
    bf16 computations that round the terms differently may put such a
    logit on either side; its slope (1 or 0.2) moves the attention grads
    by far more than bf16's noise."""
    j32, _ = _spy_logits(jax_gat, lambda: jloss(params, jnp.float32))
    j16, _ = _spy_logits(jax_gat, lambda: jloss(params, jnp.bfloat16))
    assert len(j32) == len(j16) == len(port)
    sides = []
    for (g, el, er, _), (*_, x16), (*_, x) in zip(j32, j16, port):
        slot = np.asarray(g.eid_inv)        # caller edge → canonical slot
        a = np.asarray(el)[np.asarray(g.src)[slot]]
        b = np.asarray(er)[np.asarray(g.dst)[slot]]
        kink = (np.abs(a + b)
                < KINK_ULPS * 2.0 ** -8 * (np.abs(a) + np.abs(b)))
        pos = x.detach().float().numpy() >= 0
        assert pos.shape == kink.shape
        sides.append((kink & (pos != (np.asarray(x16, np.float32) >= 0)),
                      pos))
    return sides


def _on_sides(jloss, sides):
    """``jloss`` with leaky-relu's branch at each layer's ``at`` entries
    taken on the ``positive`` side (``sides``, one per layer in call
    order), in bf16 and fp32 alike; ``jloss`` itself where ``at`` marks
    nothing."""
    if not any(at.any() for at, _ in sides):
        return jloss

    def loss(p, dt):
        layers = iter(sides)

        def leaky_relu(x, slope=0.2):
            at, pos = next(layers)
            return jnp.where(jnp.where(at, pos, x >= 0), x, slope * x)
        with mock.patch.object(jax_gat, "leaky_relu", leaky_relu):
            return jloss(p, dt)
    return loss


def _jax_grads(jloss, params):
    value_and_grad16, grad32 = _jax_bf16_loss(jloss)
    return value_and_grad16(params)[1], grad32(params)


@pytest.mark.parametrize("kind,app,strategy", GRAD_CASES,
                         ids=[_case_id(*c) for c in GRAD_CASES])
def test_bf16_step_grads_match_jax(kind, app, strategy):
    """One bf16 step's grads against JAX's (module docstring). For GAT,
    JAX's loss takes the port's side of leaky-relu's kink at the logits
    that lie at it and that the port rounded to the other side
    (:func:`_kink_sides`): the kernel routes sum each head in fp32 and
    round once, JAX's segment route rounds each product. Every other
    logit, and every tolerance, is as for the other apps."""
    jloss, tgrads, params = CASES[kind](app)
    model = from_jax_params(app, _np(params), device="cpu")
    port, grads = _spy_logits(gat, lambda: tgrads(model, strategy))
    if port:
        jloss = _on_sides(jloss, _kink_sides(jloss, params, port))
    _close_grads(model, grads, *_jax_grads(jloss, params),
                 f"{kind} {app} {strategy}")


def test_sampled_gat_kernel_route_rounds_across_the_kink():
    """The sampled batch's GAT output layer holds a logit at leaky-relu's
    kink that the kernel route rounds to the other side than JAX's bf16
    segment route, and that side moves ``attn_r``'s grad by more than the
    grads' tolerance; with no logit marked, the reference is JAX's own
    grads, bit for bit."""
    jloss, tgrads, params = _sampled_case("gat")
    model = from_jax_params("gat", _np(params), device="cpu")
    port, _ = _spy_logits(gat, lambda: tgrads(model, ("kernel", "auto")))
    sides = _kink_sides(jloss, params, port)
    assert len(sides) == 2 and sides[-1][0].any()
    j16, j32 = _jax_grads(jloss, params)
    none = [(np.zeros_like(at), pos) for at, pos in sides]
    same = _jax_grads(_on_sides(jloss, none), params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves((j16, j32)),
        jax.tree_util.tree_leaves(same)))
    other, _ = _jax_grads(_on_sides(jloss, sides), params)
    ref, ref32, alt = (_leaf(t, "layers.1.attn_r") for t in (j16, j32, other))
    tol = (BF16_TOL * float(np.abs(ref).max())
           + 2 * float(np.abs(ref - ref32).max()))
    assert float(np.abs(alt - ref).max()) > tol


# --------------------------------------------------------------------- #
# trajectories
# --------------------------------------------------------------------- #
def _graph80():
    """JAX's test graph (tests/launch/test_mixed_precision.py::_graph)."""
    def build():
        rng = np.random.default_rng(0)
        src, dst = rng.integers(0, 80, 400), rng.integers(0, 80, 400)
        x = rng.standard_normal((80, 16)).astype(np.float32)
        y = rng.integers(0, 4, 80).astype(np.int32)
        return (from_coo(src, dst, n_src=80, n_dst=80, device="cpu"), x, y,
                np.ones(80, bool))
    return _cached("graph80", build)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_bf16_final_loss_matches_fp32(app):
    g, x, y, mask = _graph80()
    kw = {"n_heads": 2} if app == "gat" else {}
    init = PORT_APPS[app].init(torch.Generator().manual_seed(0), x.shape[1],
                               8, 4, device="cpu", **kw)
    bundle = make_bundle(g)
    _, h32 = train_full_graph(PORT_APPS[app].forward, copy.deepcopy(init),
                              bundle, x, y, mask, epochs=6,
                              precision="fp32")
    _, h16 = train_full_graph(PORT_APPS[app].forward, copy.deepcopy(init),
                              bundle, x, y, mask, epochs=6,
                              precision="bf16")
    assert abs(h32["loss"][-1] - h16["loss"][-1]) < 2e-2, (h32, h16)
    if app != "gat":    # GAT's dropout-heavy trajectory is non-monotone
        assert h16["loss"][-1] < h16["loss"][0]


@pytest.mark.parametrize("app", ["gcn", "sage", "gat", "rgcn", "monet"])
def test_bf16_trajectory_matches_jax(app):
    """5 epochs of ``train_full_graph`` in bf16, dropout 0: the port's
    kernel routes against JAX's plain path, loss by loss within 2e-2."""
    if app in ("rgcn", "monet"):
        _, _, params = _relational_case(app)
        if app == "rgcn":
            _, jgraph, tgraph, x, y, mask = _rgcn_data()
        else:
            (jg, x, y, mask, *_), (tg, *_) = _tiny()
            jgraph, tgraph = jax_make_bundle(jg, krel=2), make_bundle(
                tg, krel=2)
        jfwd, tfwd = JAX_APPS[app].forward, PORT_APPS[app].forward
        jstrategy = "fused"
    else:
        (jg, x, y, mask, *_), (tg, *_) = _tiny()
        _, _, params = _full_case(app)
        jgraph = jax_make_bundle(jg, ell=False, training=False)
        tgraph = make_bundle(tg)
        jfwd = functools.partial(JAX_APPS[app].forward, drop=0.0)
        tfwd = functools.partial(PORT_APPS[app].forward, drop=0.0)
        jstrategy = "segment"
    _, jh = jax_train_full_graph(jfwd, params, jgraph, x, y, mask,
                                 strategy=jstrategy, epochs=5,
                                 precision="bf16")
    model = from_jax_params(app, _np(params), device="cpu")
    _, th = train_full_graph(tfwd, model, tgraph, x, y, mask,
                             strategy="kernel", epochs=5, precision="bf16")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=BF16_TOL)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("app", ["sage", "gcn", "gat"])
def test_bf16_train_sampled_matches_jax(app):
    """Three batches of ``train_sampled`` in bf16 (one an epoch, both
    packages' samplers from one seed), loss by loss within 2e-2."""
    (jg, jf, jl, jtr, _, n_cls), (tg, *_) = _tiny()
    params = JAX_APPS[app].init(jax.random.PRNGKey(7), jf.shape[1], 16,
                                n_cls)
    ids = np.nonzero(np.asarray(jtr))[0]
    kw = dict(fanouts=(4, 4), batch_size=16, epochs=3, max_batches=1,
              seed=5, precision="bf16")
    _, jh = jax_train_sampled(
        functools.partial(JAX_APPS[app].forward_blocks, drop=0.0), params,
        jg, jf, jl, ids, sampler=JaxSampler(jg, [4, 4], 16, seed=5), **kw)
    _, th = train_sampled(
        functools.partial(PORT_APPS[app].forward_blocks, drop=0.0),
        from_jax_params(app, _np(params), device="cpu"), tg, jf, jl, ids,
        strategy="kernel",
        sampler=NeighborSampler(tg, [4, 4], 16, seed=5, device="cpu",
                                reverse=True), **kw)
    assert th["n_batches"] == jh["n_batches"] == [1, 1, 1]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=BF16_TOL)


# --------------------------------------------------------------------- #
# fp32 masters and moments; launches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("app", ["gcn", "gat"])
def test_bf16_masters_and_moments_stay_fp32(app):
    (*_, n_cls), (tg, tf, tl, ttr, *_) = _tiny()
    model = PORT_APPS[app].init(torch.Generator().manual_seed(0),
                                tf.shape[1], 16, n_cls, device="cpu")
    init, step = make_train_step(PORT_APPS[app].forward, "kernel",
                                 precision="bf16")
    state = init(model)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        state, loss = step(model, state, i, make_bundle(tg),
                           torch.from_numpy(tf), torch.from_numpy(tl),
                           torch.from_numpy(ttr), gen)
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for t in list(model.parameters()) + state.mu + state.nu:
        assert t.dtype == torch.float32


def _counting(monkeypatch):
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


LAUNCH_CASES = ([("full", app, "kernel", TRAIN_LAUNCHES[app])
                 for app in ("gcn", "sage", "gat")]
                + [("sampled", app, ("kernel", "auto"),
                    TRAIN_SAMPLED_LAUNCHES[app])
                   for app in ("gcn", "sage", "gat")]
                + [("relational", app, "kernel",
                    RELATIONAL_TRAIN_LAUNCHES[app])
                   for app in ("rgcn", "monet")]
                + [("sampled_rgcn", "rgcn", ("kernel", "gather"),
                    RELATIONAL_TRAIN_LAUNCHES["rgcn_sampled"])])


@pytest.mark.parametrize("kind,app,strategy,want", LAUNCH_CASES,
                         ids=[f"{k}-{a}" for k, a, *_ in LAUNCH_CASES])
def test_bf16_step_launches_equal_fp32(kind, app, strategy, want,
                                       monkeypatch):
    """A bf16 step's forward and backward launch the fp32 step's kernels
    (the plain branches stand in for them), and warn of no fallback the
    fp32 step does not warn of (GAT's max falls back in both: no kernel
    computes it; its rank-3 sum runs on the kernels in both)."""
    from repro_torch.core import planner

    _, tgrads, params = CASES[kind](app)
    counts = _counting(monkeypatch)
    model = from_jax_params(app, _np(params), device="cpu")
    warned = {}
    for prec in ("fp32", "bf16"):
        monkeypatch.setattr(planner, "_WARNED", set())
        counts.clear()
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            tgrads(model, strategy, prec)
        warned[prec] = {str(w.message) for w in got
                        if "falling back" in str(w.message)}
        assert counts == want, (prec, counts)
    assert warned["bf16"] <= warned["fp32"], warned
