"""Port parity for training on the ELL layouts: the ELL pull of
``weighted_copy_reduce`` (forward over G's pack, ∂x over Gᵀ's, ∂w per
edge), GCN and SAGE trained full-graph under ``strategy="ell"`` through
it, and the fused attention's backward on the row-complete ragged pack.

Each holds the port against the JAX package on the same numpy inputs at
1e-5 (fp32, relative to the largest entry where that exceeds 1): the
training graph's packs array for array, ``jax.vjp`` of the JAX pull,
``jax.grad`` of the JAX loss under ``"ell"`` (dropout 0, as
``test_torch_train.py`` runs it), three epochs of ``train_full_graph``,
and the JAX ragged adjoint. The ragged cases are the JAX suite's
``test_ragged_attention_matches_fused_seeded`` graphs.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.edge_softmax import _attention_grads_ragged as jax_ragged
from repro.core.edge_softmax import fused_attention as jax_fused_attention
from repro.core.graph import from_coo as jax_from_coo
from repro.core.planner import get_plan_cache as jax_plan_cache
from repro.core.training_ops import make_training_graph as jax_make_tg
from repro.core.training_ops import weighted_copy_reduce as jax_wcr
from repro.data import make_node_dataset as jax_make_node_dataset
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.train import train_full_graph as jax_train_full_graph
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.core import training_ops
from repro_torch.core.edge_softmax import fused_attention
from repro_torch.core.graph import from_coo, reverse
from repro_torch.core.planner import get_plan_cache
from repro_torch.core.training_ops import (make_training_graph,
                                           weighted_copy_reduce)
from repro_torch.data.synthetic import make_node_dataset
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gcn, sage
from repro_torch.models.gnn.common import (from_jax_params, make_bundle,
                                           to_jax_params)
from repro_torch.models.gnn.train import train_full_graph
from repro_torch.substrate.nn import cross_entropy_loss
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

# the module (``repro_torch.core.edge_softmax`` as an attribute of the
# package is the function of that name)
port_es = importlib.import_module("repro_torch.core.edge_softmax")

TOL = 1e-5
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage}
PORT_APPS = {"gcn": gcn, "sage": sage}
_memo = {}


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _graphs():
    """A hub row wider than a cap of 8, sources with no out-edge and
    destinations with no in-edge, duplicate edges."""
    if "g" not in _memo:
        rng = np.random.default_rng(6)
        src, dst = random_edges(rng, 110, 90, 500)
        src = np.concatenate([src, rng.integers(0, 110, 40), src[:20]])
        dst = np.concatenate([dst, np.full(40, 5), dst[:20]])
        _memo["g"] = (jax_from_coo(src, dst, n_src=120, n_dst=100),
                      from_coo(src, dst, n_src=120, n_dst=100, device="cpu"))
    return _memo["g"]


@pytest.mark.parametrize("cap", [64, 8])
def test_training_graph_packs_equal_jax(cap):
    jg, tg = _graphs()
    jtg, ttg = jax_make_tg(jg, cap), make_training_graph(tg, cap)
    assert ttg.g_rev is reverse(tg)
    assert ttg.ell is get_plan_cache(tg).ell(cap)
    for jp, tp in ((jtg.ell, ttg.ell), (jtg.ell_rev, ttg.ell_rev)):
        assert [c.width for c in jp.classes] == [c.width for c in tp.classes]
        for jc, tc in zip(jp.classes, tp.classes):
            for f in ("chunk_cols", "chunk_eids", "chunk_mask", "chunk_row"):
                np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                              np.asarray(getattr(jc, f)))


@pytest.mark.parametrize("wrt", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("cap", [64, 8])
def test_ell_pull_grads_match_jax(cap, wrt):
    """``weighted_copy_reduce(strategy="ell")``: output, ∂x and ∂w
    against ``jax.vjp`` of the JAX pull (its custom VJP over Gᵀ's pack);
    sources with no out-edge get exactly 0."""
    jg, tg = _graphs()
    jtg, ttg = jax_make_tg(jg, cap), make_training_graph(tg, cap)
    rng = np.random.default_rng(cap + len(wrt))
    x = rng.normal(size=(120, 6)).astype(np.float32)
    w = rng.normal(size=(tg.n_edges, 1)).astype(np.float32)
    ct = rng.normal(size=(100, 6)).astype(np.float32)
    ops = [jnp.asarray(x), jnp.asarray(w)]

    def jf(*diff):
        a = list(ops)
        for i, t in zip(wrt, diff):
            a[i] = t
        return jax_wcr(jtg, *a)

    ref, vjp = jax.vjp(jf, *[ops[i] for i in wrt])
    jgrads = vjp(jnp.asarray(ct))
    tops = [torch.tensor(a, requires_grad=i in wrt)
            for i, a in enumerate((x, w))]
    out = weighted_copy_reduce(ttg, *tops, strategy="ell")
    assert type(out.grad_fn).__name__ == "_EllPullBackward"
    _close(out.detach().numpy(), ref, "out")
    got = torch.autograd.grad(out, [tops[i] for i in wrt],
                              torch.from_numpy(ct))
    for i, a, b in zip(wrt, got, jgrads):
        _close(a.numpy(), b, f"d{'xw'[i]}")
    if 0 in wrt:
        assert not got[0][110:].any()
    with pytest.raises(ValueError, match="unknown strategy"):
        weighted_copy_reduce(ttg, *tops, strategy="segment")


def _data():
    if "tiny" not in _memo:
        _memo["tiny"] = (jax_make_node_dataset("tiny"),
                         make_node_dataset("tiny", device="cpu"))
    return _memo["tiny"]


def _params(app, d_in, n_classes):
    p = JAX_APPS[app].init(jax.random.PRNGKey(7), d_in, 16, n_classes)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _close_tree(got, ref):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        _close(a, b)


@pytest.mark.parametrize("app", ["gcn", "sage"])
def test_ell_loss_grads_match_jax(app, monkeypatch):
    """The whole loss under ``strategy="ell"``: the port pulls every
    layer through the ELL route (forward and, where a grad is wanted,
    backward over Gᵀ's pack — no kernel route, no segment route), and
    its loss and every parameter's grad match ``jax.grad`` of the JAX
    ``"ell"`` forward, whose bundle carries the training graph."""
    (jg, jf, jl, jtr, _, n_cls), (tg, tf, tl, ttr, _, _) = _data()
    p, tree = _params(app, jf.shape[1], n_cls)
    jb = jax_make_bundle(jg)

    def jax_loss(params):
        logits = JAX_APPS[app].forward(
            params, jb, jnp.asarray(jf), strategy="ell", train=True,
            rng=jax.random.PRNGKey(0), drop=0.0)
        return jax_ce(logits, jnp.asarray(jl), jnp.asarray(jtr))

    jloss, jgrads = jax.value_and_grad(jax_loss)(p)
    pulls = []
    real = training_ops._pull_weighted
    monkeypatch.setattr(training_ops, "_pull_weighted",
                        lambda g, *a: pulls.append(g) or real(g, *a))
    monkeypatch.setattr(spmm_ops, "spmm_plain", None)     # no B1 route
    model = from_jax_params(app, tree, device="cpu")
    bundle = make_bundle(tg, training=True)
    assert bundle.use_training_graph("ell", 16)
    assert not bundle.use_training_graph("auto", 16)
    assert bundle.ell is bundle.tg.ell
    logits = PORT_APPS[app].forward(
        model, bundle, torch.from_numpy(tf), strategy="ell", train=True,
        gen=torch.Generator().manual_seed(0), drop=0.0)
    loss = cross_entropy_loss(logits, torch.from_numpy(tl),
                              torch.from_numpy(ttr))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _close_tree(to_jax_params(model, grads=True), jgrads)
    # GCN: 2 forward pulls and 2 over Gᵀ; SAGE's layer 0 reads x, which
    # needs no grad: 2 forward and 1 backward
    g_rev = bundle.tg.g_rev
    want = [tg, tg, g_rev, g_rev] if app == "gcn" else [tg, tg, g_rev]
    assert pulls == want


@pytest.mark.parametrize("app", ["gcn", "sage"])
def test_ell_training_trajectory_matches_jax(app):
    """Three epochs of ``train_full_graph`` under ``"ell"`` (dropout 0)
    against JAX's under ``"ell"``: loss per epoch at 1e-5 relative."""
    (jg, jf, jl, jtr, jva, n_cls), (tg, tf, tl, ttr, tva, _) = _data()
    p, tree = _params(app, jf.shape[1], n_cls)
    _, jh = jax_train_full_graph(
        functools.partial(JAX_APPS[app].forward, drop=0.0), p,
        jax_make_bundle(jg), jf, jl, jtr, strategy="ell", epochs=3,
        val_mask=jva)
    model = from_jax_params(app, tree, device="cpu")
    _, th = train_full_graph(
        functools.partial(PORT_APPS[app].forward, drop=0.0), model,
        make_bundle(tg, training=True), tf, tl, ttr, strategy="ell",
        epochs=3, val_mask=tva)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=TOL)
    assert th["loss"][-1] < th["loss"][0]


def test_make_bundle_packs_and_views():
    _, tg = _graphs()
    plain = make_bundle(tg)
    assert plain.tg is None and plain.cache is get_plan_cache(tg)
    b = make_bundle(tg, ell=True, tiles=True, ell_width=8)
    assert b.cache.ell_cap == 8 and b.ell is b.cache.ell(8)
    assert b.tiles is b.cache.tiles() and b.tg is None
    assert not b.use_training_graph("ell", 4)     # no training graph
    make_bundle(tg)                                # back to the cap 64
    assert get_plan_cache(tg).ell_cap == 64


# --------------------------------------------------------------------- #
# the ragged-pack attention backward
# --------------------------------------------------------------------- #
def _skewed_coo(rng, n, nnz):
    src = rng.integers(0, n, nnz)
    dst = (rng.zipf(1.5, size=nnz) - 1) % n
    return src.astype(np.int64), dst.astype(np.int64)


def _ragged_case(seed):
    rng = np.random.default_rng(seed)
    if seed == 12:
        src, dst = random_edges(rng, 18, 14, 70, unique=True)
        n_u, n_v = 18, 14
    else:
        src, dst = _skewed_coo(rng, 24, 130)
        n_u, n_v = 24, 24
    # one extra destination with no in-edge
    jg = jax_from_coo(src, dst, n_src=n_u, n_dst=n_v + 1)
    tg = from_coo(src, dst, n_src=n_u, n_dst=n_v + 1, device="cpu")
    H, F = 3, 4
    el = rng.normal(size=(n_u, H)).astype(np.float32)
    er = rng.normal(size=(n_v + 1, H)).astype(np.float32)
    z = rng.normal(size=(n_u, H, F)).astype(np.float32)
    ct = rng.normal(size=(n_v + 1, H, F)).astype(np.float32)
    return jg, tg, (el, er, z), ct


@pytest.mark.parametrize("seed", [12, 13])
def test_ragged_attention_matches_fused_seeded(seed, monkeypatch):
    """The kernel route of ``fused_attention`` (its plain version on the
    CPU) differentiates on the ragged pack once the graph's cache holds
    one: its grads match ``jax.grad`` of the JAX ragged route
    (``strategy="pallas"``) and the JAX ragged adjoint itself, and
    without the pack it keeps ``_attention_grads``."""
    jg, tg, args, ct = _ragged_case(seed)
    jargs = {k: jnp.asarray(v) for k, v in zip(("el", "er", "z"), args)}

    def jloss(a):
        return jnp.sum(jax_fused_attention(jg, a["el"], a["er"], a["z"],
                                           strategy="pallas") * ct)

    ref_g = jax.grad(jloss)(jargs)
    ragged = []
    real = port_es._attention_grads_ragged
    monkeypatch.setattr(port_es, "_attention_grads_ragged",
                        lambda *a: ragged.append(1) or real(*a))

    def port(strategy):
        t = [torch.from_numpy(a).requires_grad_() for a in args]
        out = fused_attention(tg, *t, strategy=strategy)
        return out, torch.autograd.grad(out, t, torch.from_numpy(ct))

    _, plain = port("kernel")               # no pack yet: _attention_grads
    assert not ragged and get_plan_cache(tg).peek("ell_ragged") is None
    pack = get_plan_cache(tg).ell_ragged()
    out, got = port("kernel")
    assert ragged == [1]
    assert not out.detach().numpy()[np.asarray(jg.in_degrees) == 0].any()
    for k, a, b in zip(("el", "er", "z"), got, plain):
        _close(a.numpy(), np.asarray(ref_g[k]), f"d{k} ragged")
        _close(b.numpy(), np.asarray(ref_g[k]), f"d{k} canonical")
    # the adjoint alone, on the same pack, against JAX's
    jpack = jax_plan_cache(jg).ell_ragged()
    want = jax_ragged(jpack, *jargs.values(), 0.2, jnp.asarray(ct))
    have = real(pack, *map(torch.from_numpy, args), 0.2,
                torch.from_numpy(ct), (True, True, True))
    for a, b in zip(have, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("strategy", ["push", "ell", "onehot"])
@pytest.mark.parametrize("app", ["gcn", "sage"])
def test_forward_under_layout_routes_matches_jax(app, strategy):
    """GCN's and SAGE's forward under each layout route (``ell`` without
    a training graph: the blocked pull, differentiated by autograd)
    against the JAX forward under the same route."""
    (jg, jf, *_, n_cls), (tg, tf, *_) = _data()
    p, tree = _params(app, jf.shape[1], n_cls)
    ref = JAX_APPS[app].forward(p, jax_make_bundle(jg, training=False),
                                jnp.asarray(jf), strategy=strategy)
    model = from_jax_params(app, tree, device="cpu")
    with torch.no_grad():
        got = PORT_APPS[app].forward(model, make_bundle(tg),
                                     torch.from_numpy(tf), strategy=strategy)
    _close(got.numpy(), np.asarray(ref), f"{app} {strategy}")
