"""Port parity for the block path: ``core/blocks.py``, the block edge
softmax and fused attention, ``run_blocks`` and each app's
``forward_blocks`` / ``infer_blocks``.

Both packages sample the same blocks (one seed, bit-identical — see
tests/test_torch_sampler.py); each operator then runs on both at 1e-5.
The graph leaves ten nodes with no in-edge, and the batches are short,
so rows with no real edge (pad seeds included) are on every path. The
port's ``"kernel"`` strategy runs here through the wrappers' plain
versions (CPU tensors), which checks its routing and the dummy-row
slicing; the kernels themselves are held on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_gspmm as jax_block_gspmm
from repro.core import from_coo as jax_from_coo
from repro.core import planner as jax_planner
from repro.core import serve_block_signature as jax_signature
from repro.core.edge_softmax import \
    block_edge_softmax as jax_block_edge_softmax
from repro.core.edge_softmax import \
    block_fused_attention as jax_block_fused_attention
from repro.data import NeighborSampler as JaxSampler
from repro.models.gnn import gat as jax_gat
from repro.models.gnn import gcn as jax_gcn
from repro.models.gnn import sage as jax_sage
from repro.models.gnn.common import block_features as jax_block_features
from repro.models.gnn.common import pad_features as jax_pad_features
from repro_torch.core import from_coo, parse_op, planner
from repro_torch.core.blocks import (block_gspmm, block_supports,
                                     serve_block_signature)
from repro_torch.core.edge_softmax import (block_edge_softmax,
                                           block_fused_attention)
from repro_torch.data import NeighborSampler
from repro_torch.kernels.dispatch import (kernel_supports,
                                          sddmm_kernel_supports)
from repro_torch.models.gnn import gat, gcn, sage
from repro_torch.models.gnn.common import (block_features, from_jax_params,
                                           make_bundle, pad_features,
                                           run_blocks)
from tests.test_torch_harness import (fresh_fallback_warnings,  # noqa: F401
                                      jax_c1_shim)

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
N, NNZ, D_IN = 60, 420, 6
JAX_APPS = {"gcn": jax_gcn, "sage": jax_sage, "gat": jax_gat}
PORT_APPS = {"gcn": gcn, "sage": sage, "gat": gat}

_cache = {}


def _graphs():
    """Both packages' graph: nodes 50..59 have no in-edge."""
    if "g" not in _cache:
        rng = np.random.default_rng(21)
        src = rng.integers(0, N, NNZ)
        dst = rng.integers(0, N - 10, NNZ)
        feats = rng.standard_normal((N, D_IN)).astype(np.float32)
        _cache["g"] = (jax_from_coo(src, dst, n_src=N, n_dst=N),
                       from_coo(src, dst, n_src=N, n_dst=N, device="cpu"),
                       feats)
    return _cache["g"]


def _minibatch(fanouts, seed=0, seeds=(3, 55, 3, 17, 40, 59)):
    """(JAX minibatch, port minibatch) of one short batch of 8 (two pad
    seeds), drawn with the same seed."""
    jg, tg, _ = _graphs()
    seeds = np.asarray(seeds)
    lab = np.zeros(len(seeds), np.int64)
    jmb = JaxSampler(jg, fanouts, 8, seed=seed).sample(seeds, lab)
    tmb = NeighborSampler(tg, fanouts, 8, seed=seed,
                          device="cpu").sample(seeds, lab)
    return jmb, tmb


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("batch", [1, 4, 8, 128])
@pytest.mark.parametrize("fanouts", [3, 10, 4275, (2, 5), (25, 10, 5)])
def test_serve_block_signature_matches_jax(batch, fanouts):
    for n_layers in ((1, 2, 3) if isinstance(fanouts, int) else (None,)):
        assert serve_block_signature(batch, fanouts, n_layers) == \
            jax_signature(batch, fanouts, n_layers)
    if isinstance(fanouts, int):
        with pytest.raises(ValueError):
            serve_block_signature(batch, fanouts)


def test_sampled_signature_is_predicted():
    _, tmb = _minibatch([3, 4])
    assert tmb.shape_signature() == serve_block_signature(8, [3, 4])


# (op, operand widths): GCN / SAGE / GAT ops and every reducer
NODE_OPS = [("u_copy_add_v", {"u": 5}), ("u_copy_mean_v", {"u": 5}),
            ("u_copy_max_v", {"u": 5}), ("u_copy_min_v", {"u": 5}),
            ("u_copy_mul_v", {"u": 3}), ("e_copy_add_v", {"e": 4}),
            ("e_copy_max_v", {"e": 4}), ("e_copy_mean_v", {"e": 1}),
            ("u_mul_e_add_v", {"u": 5, "e": 1}),
            ("u_mul_e_mean_v", {"u": 5, "e": 5}),
            ("u_sub_e_max_v", {"u": 3, "e": 3}),
            ("u_div_e_add_v", {"u": 3, "e": 1}),
            ("e_mul_u_add_v", {"u": 4, "e": 4}),
            ("u_add_v_min_v", {"u": 3, "v": 3}),
            ("u_mul_e_add_v", {"u": (4, 3), "e": (4, 1)})]   # GAT rank 3
EDGE_OPS = [("u_add_v_copy_e", {"u": 4, "v": 4}),
            ("e_sub_v_copy_e", {"e": 4, "v": 4}),
            ("e_div_v_copy_e", {"e": 1, "v": 1}),
            ("u_dot_v_copy_e", {"u": 3, "v": 3}),
            ("u_copy_copy_e", {"u": 2})]


def _operands(bg_j, widths, rng):
    rows = {"u": bg_j.g.n_src, "v": bg_j.n_dst_real + 1, "e": bg_j.g.n_edges}
    out = {}
    for t, w in widths.items():
        shape = (rows[t],) + (w if isinstance(w, tuple) else (w,))
        x = rng.standard_normal(shape).astype(np.float32)
        out[t] = np.abs(x) + 0.5 if t == "e" else x   # divisors off 0
    return out


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("op,widths", NODE_OPS + EDGE_OPS,
                         ids=[f"{o}-{len(w)}-{i}" for i, (o, w) in
                              enumerate(NODE_OPS + EDGE_OPS)])
def test_block_gspmm_matches_jax(op, widths, li):
    jmb, tmb = _minibatch([3, 4])
    jbg, tbg = jmb.blocks[li].bg, tmb.blocks[li].bg
    ops = _operands(jbg, widths, np.random.default_rng(li))
    ref = np.asarray(jax_block_gspmm(
        jbg, op, strategy="ell", **{k: jnp.asarray(v) for k, v in
                                    ops.items()}))
    targs = {k: _t(v) for k, v in ops.items()}
    spec = parse_op(op)
    lhs = targs[spec.lhs]
    rhs = None if spec.rhs is None else targs[spec.rhs]
    kernel = (sddmm_kernel_supports if spec.out == "e"
              else kernel_supports)(spec, lhs, rhs)
    for s in (("auto", "ell", "segment", "push")
              + (("kernel",) if kernel else ())):
        got = block_gspmm(tbg, op, strategy=s, **targs)
        assert got.shape == ref.shape, (s, got.shape, ref.shape)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{op} {s}")


def test_block_gspmm_strategies_raise(fresh_fallback_warnings):
    """An unknown name raises; a gspmm name no block route runs
    ('onehot'), or 'kernel' on a spec no kernel computes, falls back to
    the uniform pull with a warning, as JAX's block planner does (its
    'pallas' in the kernel's place)."""
    jmb, tmb = _minibatch([3, 4])
    jbg, bg = jmb.blocks[1].bg, tmb.blocks[1].bg
    x = np.random.default_rng(0).standard_normal(
        (bg.g.n_src, 2)).astype(np.float32)
    u = torch.from_numpy(x)
    with pytest.raises(ValueError, match="unknown block strategy"):
        block_gspmm(bg, "u_copy_add_v", u=u, strategy="nope")
    for op, ours, theirs in (("u_copy_add_v", "onehot", "onehot"),
                             ("u_copy_max_v", "kernel", "pallas")):
        with pytest.warns(UserWarning, match="falling back to 'ell'"):
            got = block_gspmm(bg, op, u=u, strategy=ours)
        ref = jax_block_gspmm(jbg, op, u=jnp.asarray(x), strategy=theirs)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        assert (planner.last_plan(f"block:{op}", ours)
                == jax_planner.last_plan(f"block:{op}", theirs) == "ell")
    with pytest.raises(ValueError, match="missing"):
        block_gspmm(bg, "u_mul_e_add_v", u=u)
    for s in ("ell", "segment", "push", "kernel"):
        assert block_supports(s, parse_op("u_copy_max_v"))
        assert not block_supports(s, parse_op("u_add_v_copy_e"))
    assert not block_supports("onehot", parse_op("u_copy_add_v"))


@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("li", [0, 1])
def test_block_edge_softmax_matches_jax(li, H):
    jmb, tmb = _minibatch([3, 4])
    jbg, tbg = jmb.blocks[li].bg, tmb.blocks[li].bg
    x = 3 * np.random.default_rng(H).standard_normal(
        (jbg.g.n_edges, H)).astype(np.float32)
    if H == 1:
        x = x[:, 0]
    ref = np.asarray(jax_block_edge_softmax(jbg, jnp.asarray(x),
                                            strategy="ell"))
    for s in ("auto", "ell", "segment", "kernel"):
        got = block_edge_softmax(tbg, _t(x), strategy=s)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=s)


@pytest.mark.parametrize("H,F", [(1, 5), (2, 3)])
@pytest.mark.parametrize("li", [0, 1])
def test_block_fused_attention_matches_jax(li, H, F):
    jmb, tmb = _minibatch([3, 4])
    jbg, tbg = jmb.blocks[li].bg, tmb.blocks[li].bg
    rng = np.random.default_rng(10 * H + F)
    el = rng.standard_normal((jbg.g.n_src, H)).astype(np.float32)
    er = rng.standard_normal((jbg.n_dst_real + 1, H)).astype(np.float32)
    z = rng.standard_normal((jbg.g.n_src, H, F)).astype(np.float32)
    if H == 1:
        el, er, z = el[:, 0], er[:, 0], z[:, 0]
    ref = np.asarray(jax_block_fused_attention(
        jbg, jnp.asarray(el), jnp.asarray(er), jnp.asarray(z),
        strategy="fused"))
    for s in ("auto", "fused", "kernel"):
        got = block_fused_attention(tbg, _t(el), _t(er), _t(z), strategy=s)
        assert got.shape == ref.shape == (
            (jbg.n_dst_real, F) if H == 1 else (jbg.n_dst_real, H, F))
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=s)


def test_block_features_match_jax():
    jmb, tmb = _minibatch([3, 4])
    _, _, feats = _graphs()
    ref = np.asarray(jax_block_features(jax_pad_features(feats),
                                        jmb.input_ids))
    got = block_features(pad_features(feats, "cpu"), tmb.input_ids)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[tmb.input_ids_host < 0] == 0).all()


def _models(app):
    key = ("model", app)
    if key not in _cache:
        params = JAX_APPS[app].init(jax.random.PRNGKey(5), D_IN, 8, 4)
        _cache[key] = (params, from_jax_params(
            app, jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return _cache[key]


CASES = [("gcn", None), ("sage", None)] + [
    ("gat", a) for a in (None, "multipass", "softmax-fused", "fused",
                         "pallas", "auto")]


@pytest.mark.parametrize("fanouts", [[3, 4], [30, 30]])
@pytest.mark.parametrize("app,attn", CASES)
def test_forward_blocks_match_jax(app, attn, fanouts):
    """Every app (and GAT attn mode) on the same two sampled blocks,
    below and above the max in-degree, every block strategy."""
    params, model = _models(app)
    jmb, tmb = _minibatch(fanouts)
    _, _, feats = _graphs()
    kw = {} if attn is None else {"attn": attn}
    jx = jax_block_features(jax_pad_features(feats), jmb.input_ids)
    ref = np.asarray(JAX_APPS[app].infer_blocks(
        params, jmb.blocks, jx, strategy="ell", **kw))
    x = block_features(pad_features(feats, "cpu"), tmb.input_ids)
    for s in ("auto", "ell", "segment", "kernel"):
        got = PORT_APPS[app].infer_blocks(model, tmb.blocks, x, strategy=s,
                                          **kw)
        assert got.shape == ref.shape == (8, 4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{app} {attn} {s}")
    fwd = PORT_APPS[app].forward_blocks(model, tmb.blocks, x, **kw)
    np.testing.assert_allclose(fwd.detach().numpy(), ref, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("app", ["gcn", "sage", "gat"])
def test_blocks_above_max_in_degree_equal_full_forward(app):
    """Fan-out ≥ max in-degree: the block forward IS the full forward on
    the seeds' rows (the port against itself)."""
    _, model = _models(app)
    _, tg, feats = _graphs()
    full = PORT_APPS[app].infer(model, make_bundle(tg),
                                torch.from_numpy(feats)).numpy()
    seeds = np.array([0, 7, 55, 59, 12, 7])
    _, tmb = _minibatch([30, 30], seeds=seeds)
    x = block_features(pad_features(feats, "cpu"), tmb.input_ids)
    got = PORT_APPS[app].infer_blocks(model, tmb.blocks, x).numpy()
    np.testing.assert_allclose(got[:len(seeds)], full[seeds], rtol=TOL,
                               atol=TOL)


def test_run_blocks_checks_depth_and_gat_modes():
    _, model = _models("gcn")
    _, tmb = _minibatch([3, 4])
    x = torch.zeros(tmb.blocks[0].bg.g.n_src, D_IN)
    with pytest.raises(ValueError, match="2 layers but 1 blocks"):
        run_blocks(gcn.block_layer, model.layers, tmb.blocks[:1], x)
    _, gmodel = _models("gat")
    with pytest.raises(ValueError, match="unknown attn mode"):
        gat.infer_blocks(gmodel, tmb.blocks, x, attn="flash")
    with pytest.raises(ValueError, match="unknown block strategy"):
        gat.infer_blocks(gmodel, tmb.blocks, x, strategy="nope")


def test_gcn_norm_on_blocks_is_the_full_graphs():
    """Per-edge GCN weights on a block are the full graph's
    ``edge_norms`` for the same (u, v): pads weigh 0."""
    _, tg, _ = _graphs()
    _, tmb = _minibatch([30])
    blk = tmb.blocks[0]
    b = make_bundle(tg)
    full = {}
    for e in range(tg.n_edges):
        u, v = int(tg.src_caller[e]), int(tg.dst_caller[e])
        full[(u, v)] = float(b.gcn_norm[e])
    ids = blk.src_ids_host
    src, dst = blk.bg.g.src_caller.numpy(), blk.bg.g.dst_caller.numpy()
    for e in range(blk.bg.g.n_edges):
        w = float(blk.gcn_norm[e])
        if dst[e] == blk.bg.n_dst_real:
            assert w == 0.0
        else:
            assert w == pytest.approx(full[(ids[src[e]], ids[dst[e]])],
                                      rel=1e-6)
