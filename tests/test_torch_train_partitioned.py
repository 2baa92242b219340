"""Port parity for partitioned full-graph training
(``forward_partitioned`` of GCN / SAGE / GAT, ``train_partitioned``)
against the JAX package's emulated ring, on the CPU, dropout 0 (the RNGs
differ):

* each app's ``forward_partitioned`` and its loss's gradients within
  2e-4 of JAX's at S ∈ {2, 3}, on the kernel route (the wrappers' plain
  versions here) and the plain route, and of the port's own full-graph
  forward; GCN and SAGE also delayed (a refresh and a stale step) and
  with int8 exchanges (the halo and residual carries too);
* ``train_partitioned`` exact, delayed and in bf16 × int8 with JAX's
  losses per epoch within 2e-4 (fp32) or 2e-2 (bf16), the same refresh
  pattern and the same ``partitioned:train`` plan record;
* JAX's error messages;
* the kernel launches of one step, counted through the wrappers' plain
  branches, are ``chip_smoke.partitioned_launches`` — the counts the
  chip run checks on the card — and a stale step launches no remote
  stage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import partitioned_launches
from repro.core import from_coo as jax_from_coo
from repro.core import planner as jax_planner
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import make_bundle as jax_make_bundle
from repro.models.gnn.common import (
    make_partitioned_bundle as jax_make_partitioned_bundle)
from repro.models.gnn.train import train_partitioned as jax_train_partitioned
from repro.optim import Precision as JaxPrecision
from repro.substrate.nn import cross_entropy_loss as jax_ce
from repro_torch.core import from_coo, planner
from repro_torch.core.partition import stage_plan
from repro_torch.kernels.binary_reduce import ops as br_ops
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import (from_jax_params, make_bundle,
                                           make_partitioned_bundle,
                                           to_jax_params)
from repro_torch.models.gnn.train import train_partitioned
from repro_torch.optim import Precision
from repro_torch.substrate.nn import cross_entropy_loss
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 2e-4
BF16_TOL = 2e-2
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}
N, D, C = 80, 16, 4
_cache = {}


def _data():
    """JAX's ``tests/launch/test_mixed_precision.py`` graph (80 nodes,
    400 edges, 16 features, 4 classes), on both sides."""
    if "data" not in _cache:
        rng = np.random.default_rng(0)
        src, dst = rng.integers(0, N, 400), rng.integers(0, N, 400)
        x = rng.standard_normal((N, D)).astype(np.float32)
        y = rng.integers(0, C, N).astype(np.int32)
        mask = rng.random(N) < 0.7
        _cache["data"] = (jax_from_coo(src, dst, n_src=N, n_dst=N),
                          from_coo(src, dst, n_src=N, n_dst=N, device="cpu"),
                          x, y, mask)
    return _cache["data"]


def _params(app, seed=0):
    kw = {"n_heads": 2} if app == "gat" else {}
    p = JAX_APPS[app].init(jax.random.PRNGKey(seed), D, 8, C, **kw)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _close_tree(got, ref, tol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        b = np.asarray(b, np.float64)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=tol,
                                   atol=tol * scale)


def _port_loss_grads(model, run, yp, mp):
    """(outputs of ``run(model)``, the loss's param grads as JAX's
    pytree)."""
    model.zero_grad()
    out = run(model)
    cross_entropy_loss(out[0], yp, mp).backward()
    return out, to_jax_params(model, grads=True)


# --------------------------------------------------------------------- #
# forwards and grads
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_forward_partitioned_and_grads_match_jax(app, S, route):
    jg, tg, x, y, mask = _data()
    p, tree = _params(app)
    jpb = jax_make_partitioned_bundle(jg, S)
    jpg = jpb.pg
    jxp, jyp, jmp = (jpg.scatter_nodes(jnp.asarray(a)) for a in (x, y, mask))
    mod = JAX_APPS[app]

    @jax.jit
    def jax_loss(params):
        logits = mod.forward_partitioned(params, jpb, jxp)[0]
        return jax_ce(logits, jyp, jmp), logits

    (_, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(p)
    pb = make_partitioned_bundle(tg, S)
    pg = pb.pg
    xp, yp, mp = (pg.scatter_nodes(torch.from_numpy(a))
                  for a in (x, y.astype(np.int64), mask))
    model = from_jax_params(app, tree, device="cpu")
    out, grads = _port_loss_grads(model, lambda m: PORT_APPS[
        app].forward_partitioned(m, pb, xp, strategy=route), yp, mp)
    assert out[1] is None
    _close_tree([out[0].detach().numpy()], [want])
    _close_tree(grads, jgrads)
    full = PORT_APPS[app].forward(model, make_bundle(tg),
                                  torch.from_numpy(x), strategy="segment")
    _close_tree([pg.gather_nodes(out[0]).detach().numpy()],
                [full.detach().numpy()])


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("comm", [False, True])
@pytest.mark.parametrize("app", ["gcn", "sage"])
def test_delayed_and_int8_forwards_match_jax(app, comm, route):
    """A refresh step then a stale step on its halo (with int8 the
    residual carried between them): logits, grads, halo and residual."""
    jg, tg, x, y, mask = _data()
    p, tree = _params(app, seed=1)
    S = 3
    jpb = jax_make_partitioned_bundle(jg, S)
    jpg = jpb.pg
    jxp, jyp, jmp = (jpg.scatter_nodes(jnp.asarray(a)) for a in (x, y, mask))
    mod, port = JAX_APPS[app], PORT_APPS[app]
    pb = make_partitioned_bundle(tg, S)
    pg = pb.pg
    xp, yp, mp = (pg.scatter_nodes(torch.from_numpy(a))
                  for a in (x, y.astype(np.int64), mask))
    model = from_jax_params(app, tree, device="cpu")
    halo, jhalo = port.init_halo(model, pg), mod.init_halo(p, jpg)
    res = port.init_comm(model, pg) if comm else None
    jres = mod.init_comm(p, jpg) if comm else None
    assert [tuple(h.shape) for h in halo] == [h.shape for h in jhalo]
    for refresh in (True, False):
        kw = {} if not comm else {"comm_state": jres}

        def jax_loss(params, halo_in, kw=kw, refresh=refresh):
            out = mod.forward_partitioned(params, jpb, jxp, halo=halo_in,
                                          refresh=refresh, **kw)
            return jax_ce(out[0], jyp, jmp), out

        (_, jout), jgrads = jax.jit(jax.value_and_grad(
            jax_loss, has_aux=True))(p, jhalo)
        tkw = {} if not comm else {"comm_state": res}
        out, grads = _port_loss_grads(
            model, lambda m: port.forward_partitioned(
                m, pb, xp, halo=halo, refresh=refresh, strategy=route,
                **tkw), yp, mp)
        _close_tree([out[0].detach().numpy()], [jout[0]])
        _close_tree(grads, jgrads)
        _close_tree([h.numpy() for h in out[1]], jout[1])
        if comm:
            _close_tree([r.numpy() for r in out[2]], jout[2], 1e-5)
            res, jres = out[2], jout[2]
        halo, jhalo = out[1], jout[1]


def test_gat_rejects_halo_and_comm_with_jax_messages():
    jg, tg, x, *_ = _data()
    model = from_jax_params("gat", _params("gat")[1], device="cpu")
    pb = make_partitioned_bundle(tg, 2)
    xp = pb.pg.scatter_nodes(torch.from_numpy(x))
    jpb = jax_make_partitioned_bundle(jg, 2)
    jp_, _ = _params("gat")
    jxp = jpb.pg.scatter_nodes(jnp.asarray(x))
    for kw, match in (({"halo": ()}, "delayed-halo"),
                      ({"comm_state": ()}, "compressed-comm")):
        with pytest.raises(ValueError) as want:
            jax_gat.forward_partitioned(jp_, jpb, jxp, **kw)
        with pytest.raises(ValueError, match=match) as got:
            gat.forward_partitioned(model, pb, xp, **kw)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# train_partitioned
# --------------------------------------------------------------------- #
TRAIN_CASES = [("gcn", 2, "exact"), ("sage", 3, "exact"),
               ("gat", 2, "exact"), ("gcn", 4, "delayed"),
               ("sage", 3, "delayed"), ("gcn", 4, "bf16+int8"),
               ("sage", 2, "bf16+int8"), ("gcn", 3, "fp32+int8")]


def _train_kw(app, mode, jax_side):
    mod = (JAX_APPS if jax_side else PORT_APPS)[app]
    P = JaxPrecision if jax_side else Precision
    kw = {}
    if mode == "delayed":
        kw.update(halo_staleness=2, init_halo_fn=mod.init_halo)
    if mode.endswith("int8"):
        kw.update(precision=P.parse(mode.split("+")[0], comm="int8"),
                  init_comm_fn=mod.init_comm)
    return kw


@pytest.mark.parametrize("app,S,mode", TRAIN_CASES)
def test_train_partitioned_matches_jax(app, S, mode):
    jg, tg, x, y, mask = _data()
    p, tree = _params(app, seed=2)
    epochs = 5
    _, jh = jax_train_partitioned(
        JAX_APPS[app].forward_partitioned, p, jg, x, y, mask, n_shards=S,
        epochs=epochs, val_mask=~mask, **_train_kw(app, mode, True))
    want_plan = jax_planner.last_plan("partitioned:train", "auto")
    model = from_jax_params(app, tree, device="cpu")
    _, th = train_partitioned(
        PORT_APPS[app].forward_partitioned, model, tg, x, y, mask,
        n_shards=S, epochs=epochs, val_mask=~mask,
        **_train_kw(app, mode, False))
    assert planner.last_plan("partitioned:train", "auto") == want_plan
    assert th["refreshed"] == jh["refreshed"]
    tol = BF16_TOL if mode.startswith("bf16") else TOL
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=tol, atol=tol)
    np.testing.assert_allclose(th["val_acc"], jh["val_acc"], atol=0.05)
    assert len(th["epoch_time"]) == epochs
    if mode != "delayed":
        assert th["loss"][-1] < th["loss"][0]


def test_bf16_int8_final_loss_within_2e2_of_fp32():
    """JAX's ``test_partitioned_bf16_int8_trains_and_matches_fp32``."""
    _, tg, x, y, mask = _data()
    tree = _params("gcn", seed=3)[1]
    _, h32 = train_partitioned(
        gcn.forward_partitioned, from_jax_params("gcn", tree, device="cpu"),
        tg, x, y, mask, n_shards=4, epochs=5, precision="fp32")
    _, hq = train_partitioned(
        gcn.forward_partitioned, from_jax_params("gcn", tree, device="cpu"),
        tg, x, y, mask, n_shards=4, epochs=5,
        precision=Precision.parse("bf16", comm="int8"),
        init_comm_fn=gcn.init_comm)
    assert abs(h32["loss"][-1] - hq["loss"][-1]) < 2e-2, (h32, hq)
    assert hq["loss"][-1] < hq["loss"][0]


def test_train_partitioned_errors_match_jax():
    jg, tg, x, y, mask = _data()
    p, tree = _params("gcn")
    model = from_jax_params("gcn", tree, device="cpu")
    for kw in ({"halo_staleness": 2},
               {"precision": "int8"}):
        jkw = dict(kw)
        tkw = dict(kw)
        if "precision" in kw:
            jkw["precision"] = JaxPrecision.parse("bf16", comm="int8")
            tkw["precision"] = Precision.parse("bf16", comm="int8")
        with pytest.raises(ValueError) as want:
            jax_train_partitioned(jax_gcn.forward_partitioned, p, jg, x, y,
                                  mask, n_shards=2, epochs=1, **jkw)
        with pytest.raises(ValueError) as got:
            train_partitioned(gcn.forward_partitioned, model, tg, x, y,
                              mask, n_shards=2, epochs=1, **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="ProcessGroup"):
        train_partitioned(gcn.forward_partitioned, model, tg, x, y, mask,
                          n_shards=2, epochs=1, mesh=object())


# --------------------------------------------------------------------- #
# launches per step, counted on the CPU
# --------------------------------------------------------------------- #
@pytest.fixture
def counts(monkeypatch):
    got = {}

    def counting(module, name, key):
        plain = getattr(module, name)

        def wrapped(*a, **kw):
            k = key(a) if callable(key) else key
            got[k] = got.get(k, 0) + 1
            return plain(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    counting(spmm_ops, "spmm_plain", "spmm_csr")
    counting(sddmm_ops, "sddmm_plain",
             lambda a: "sddmm_csr:copy" if a[1] == "copy" else "sddmm_csr")
    counting(br_ops, "binary_reduce_plain", "binary_reduce_csr")
    counting(es_ops, "edge_softmax_plain", "edge_softmax_csr")
    counting(es_ops, "fused_attention_plain", "fused_attention_csr")
    return got


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_partitioned_step_launches(app, S, counts):
    """One step's forward and backward on the kernel route launches
    ``partitioned_launches``; the plain route none; for GCN and SAGE a
    delayed refresh step B1 on the local and remote graphs, a stale step
    on the local graph alone, and int8 the same as a refresh step."""
    _, tg, x, y, mask = _data()
    model = from_jax_params(app, _params(app)[1], device="cpu")
    pb = make_partitioned_bundle(tg, S)
    pg = pb.pg
    xp, yp, mp = (pg.scatter_nodes(torch.from_numpy(a))
                  for a in (x, y.astype(np.int64), mask))
    port = PORT_APPS[app]

    def step(**kw):
        counts.clear()
        out = port.forward_partitioned(model, pb, xp, train=True,
                                       gen=torch.Generator().manual_seed(0),
                                       **kw)
        torch.autograd.grad(cross_entropy_loss(out[0], yp, mp),
                            list(model.parameters()))
        return dict(counts)

    stages = len(stage_plan(pg).stages)
    assert step(strategy="kernel") == partitioned_launches(app, stages)
    assert step(strategy="plain") == {}
    if app == "gat":
        return
    halo = port.init_halo(model, pg)
    assert step(halo=halo, refresh=True) == partitioned_launches(
        app, stages, parts=2)
    assert step(halo=halo, refresh=False) == partitioned_launches(
        app, stages, parts=1)
    assert step(comm_state=port.init_comm(model, pg)) == (
        partitioned_launches(app, stages, parts=2))


def test_partitioned_bundle_matches_jax():
    jg, tg, *_ = _data()
    jpb = jax_make_partitioned_bundle(jg, 3)
    pb = make_partitioned_bundle(tg, 3)
    assert pb.pg is planner.get_plan_cache(tg).partition(3, "contiguous")
    _close_tree([pb.gcn_w.numpy(), pb.mean_w.numpy()],
                [jpb.gcn_w, jpb.mean_w], 1e-7)
    jb, tb = jax_make_bundle(jg), make_bundle(tg)
    _close_tree([pb.pg.gather_edges(pb.gcn_w).numpy()],
                [np.asarray(jb.gcn_norm)], 0)
    _close_tree([pb.pg.gather_edges(pb.mean_w).numpy()],
                [tb.mean_norm.numpy()], 0)
