"""Port parity for ``hetero_gspmm``'s layout routes and pins: ``ell``
(the fused graph's ELL pack, or one pack per relation-size class when the
relation sizes are skewed), ``push`` (the per-relation loop with a
scatter inner reduce), and the plain gspmm names that pin the loop
(ROADMAP C7).

Every case runs the JAX ``hetero_gspmm`` and the port's on the same numpy
operands with the same strategy name; outputs and every operand's
``jax.grad`` agree at 1e-5 (relative to the largest entry where that
exceeds 1). The seeded cases are the JAX suite's
(``tests/core/test_strategy_equivalence``): a skewed relation partition
with an empty relation, every operand form; and a partition skewed
enough to split into size classes, with max and min.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hetero as jax_hetero
from repro.core.hetero import from_rels as jax_from_rels
from repro.core.hetero import from_typed as jax_from_typed
from repro.core.hetero import hetero_gspmm as jax_hetero_gspmm
from repro_torch.core import hetero
from repro_torch.core.hetero import from_rels, from_typed, hetero_gspmm
from repro_torch.core.planner import get_plan_cache
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5


def _close(got, ref, what):
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _both(jrg, trg, args, ct, strategy, reduce, what):
    """Hold the port's output and grads against JAX's."""
    jargs = {k: jnp.asarray(v) for k, v in args.items()}

    def jf(a):
        return jax_hetero_gspmm(jrg, strategy=strategy, reduce=reduce, **a)

    ref = np.asarray(jf(jargs))
    ref_g = jax.grad(lambda a: jnp.sum(jf(a) * ct))(jargs)
    targs = {k: torch.from_numpy(v).requires_grad_() for k, v in
             args.items()}
    out = hetero_gspmm(trg, strategy=strategy, reduce=reduce, **targs)
    _close(out.detach().numpy(), ref, f"output: {what}")
    got = torch.autograd.grad(out, list(targs.values()),
                              torch.from_numpy(ct))
    for k, t in zip(targs, got):
        _close(t.numpy(), np.asarray(ref_g[k]), f"d{k}: {what}")


def _skewed_rels(rng, src, dst):
    """Four relations over the edge set: one big, two small, one empty."""
    nnz = len(src)
    cuts = sorted(rng.integers(0, nnz + 1, size=2))
    sizes = [cuts[0], 0, cuts[1] - cuts[0], nnz - cuts[1]]
    order = rng.permutation(nnz)
    rels, ptr = [], 0
    for sz in sizes:
        sel = order[ptr:ptr + sz]
        rels.append((src[sel], dst[sel]))
        ptr += sz
    return rels


ROUTES = ("fused", "loop", "ell", "push")


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("seed", [7, 8])
def test_hetero_matches_loop_reference_seeded(seed, strategy):
    """Every operand form (W, the basis, 3-D features with an edge
    weight) × sum / mean, and the max over plain features, on a skewed
    partition with an empty relation, against the JAX route."""
    rng = np.random.default_rng(seed)
    n_u, n_v, nnz = [(20, 16, 70), (25, 25, 110)][seed - 7]
    src, dst = random_edges(rng, n_u, n_v, nnz, unique=True)
    rels = _skewed_rels(rng, src, dst)
    jrg = jax_from_rels(rels, n_src=n_u, n_dst=n_v)
    trg = from_rels(rels, n_src=n_u, n_dst=n_v, device="cpu")
    n_rel, d_in, d_out, E = 4, 5, 3, len(src)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    u, u3, W = normal(n_u, d_in), normal(n_u, n_rel, d_out), normal(
        n_rel, d_in, d_out)
    basis, coeff = normal(2, d_in, d_out), normal(n_rel, 2)
    e = rng.uniform(0.5, 1.5, size=(E,)).astype(np.float32)
    ct = normal(n_v, d_out)
    forms = [({"u": u, "w": W}, ("sum", "mean")),
             ({"u": u, "basis": basis, "coeff": coeff}, ("sum", "mean")),
             ({"u": u3, "e": e}, ("sum",)),
             ({"u": normal(n_u, d_out)}, ("max", "min"))]
    for args, reduces in forms:
        for reduce in reduces:
            _both(jrg, trg, args, ct, strategy, reduce,
                  f"{list(args)} {reduce} via {strategy}")


def _skew_graphs():
    """The JAX suite's skewed partition (sizes 400, 11, 9, 7 of unique
    (src, dst) pairs over 40 nodes), which splits into size classes."""
    rng = np.random.default_rng(15)
    n, sizes = 40, [400, 11, 9, 7]
    pairs = rng.choice(n * n, size=sum(sizes), replace=False)
    s_all, d_all = pairs // n, pairs % n
    rels, off = [], 0
    for sz in sizes:
        rels.append((s_all[off:off + sz], d_all[off:off + sz]))
        off += sz
    return (rng, n, jax_from_rels(rels, n_src=n, n_dst=n),
            from_rels(rels, n_src=n, n_dst=n, device="cpu"))


def test_skew_classes_equal_jax():
    """The port splits where JAX splits: the same classes, each class
    graph's edges and canonical slots, each with its own ELL pack."""
    _, _, jrg, trg = _skew_graphs()
    jcls, tcls = jax_hetero._skew_classes(jrg), hetero._skew_classes(trg)
    assert tcls is not None and len(tcls) == len(jcls) >= 2
    for (jg, js), (tg, ts) in zip(jcls, tcls):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for f in ("src", "dst", "eid", "indptr_dst"):
            np.testing.assert_array_equal(getattr(tg.host, f),
                                          np.asarray(getattr(jg, f)))
        assert get_plan_cache(tg).peek("ell") is not None
    assert hetero._skew_classes(trg) is tcls          # built once
    # an unskewed partition keeps the one global pack, and says so once
    _, _, _, flat = _flat_graphs()
    assert hetero._skew_classes(flat) is None
    assert hetero._skew_classes(flat) is None


def _flat_graphs():
    rng = np.random.default_rng(2)
    src, dst = random_edges(rng, 20, 20, 90, unique=True)
    rel = np.arange(len(src)) % 3
    return (rng, 20, jax_from_typed(src, dst, rel, n_src=20, n_dst=20),
            from_typed(src, dst, rel, n_src=20, n_dst=20, device="cpu"))


@pytest.mark.parametrize("strategy", ROUTES)
@pytest.mark.parametrize("red", ["max", "min", "sum", "mean"])
def test_hetero_skew_max_min(red, strategy):
    """On the partition that splits into size classes, every route's
    extrema (and sums) match JAX's route, output and grads; ``ell`` goes
    through the per-class packs."""
    rng, n, jrg, trg = _skew_graphs()
    u = rng.normal(size=(n, 3)).astype(np.float32)
    ct = rng.normal(size=(n, 3)).astype(np.float32)
    args = {"u": u}
    if red in ("sum", "mean"):
        args["w"] = rng.normal(size=(4, 3, 3)).astype(np.float32)
    _both(jrg, trg, args, ct, strategy, red, f"skew {red} via {strategy}")
    assert hetero._skew_classes(trg) is not None


def _c7_graphs():
    """ROADMAP C7's input: ``from_typed``, 20 nodes, 120 edges, 3
    relations, ``default_rng(5)``."""
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 20, 120), rng.integers(0, 20, 120)
    rel = rng.integers(0, 3, 120)
    return (rng, jax_from_typed(src, dst, rel, n_src=20, n_dst=20, n_rel=3),
            from_typed(src, dst, rel, n_src=20, n_dst=20, n_rel=3,
                       device="cpu"))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("strategy", ["segment", "onehot", "pallas", "ring",
                                      "push", "ell"])
def test_c7_plain_pins_match_jax(strategy, reduce):
    """ROADMAP C7: a plain gspmm name pins what JAX's ``plan_hetero``
    pins — the per-relation loop (its push form for ``"push"``) — and the
    result matches JAX's at 1e-5 on C7's input (u (20, 4), w (3, 4, 3))."""
    rng, jrg, trg = _c7_graphs()
    args = {"u": rng.normal(size=(20, 4)).astype(np.float32),
            "w": rng.normal(size=(3, 4, 3)).astype(np.float32)}
    ct = rng.normal(size=(20, 3)).astype(np.float32)
    _both(jrg, trg, args, ct, strategy, reduce, f"C7 {strategy} {reduce}")
    want = {"push": "push", "ell": "ell"}.get(strategy, "loop")
    assert hetero._resolve(strategy, reduce, ()) == want


def test_ell_route_differentiates_through_the_gather_vjp():
    """``ell`` with a sum or mean takes JAX's gather VJP (one sorted
    reduce over the reverse table), as ``fused`` does; extrema and
    ``push`` differentiate by autograd."""
    rng, jrg, trg = _c7_graphs()
    u = torch.randn(20, 4, requires_grad=True)
    w = torch.randn(3, 4, 3, requires_grad=True)
    out = hetero_gspmm(trg, u, w=w, reduce="mean", strategy="ell")
    assert type(out.grad_fn).__name__ == "_HeteroFusedRevBackward"
    out = hetero_gspmm(trg, u, w=w, reduce="sum", strategy="push")
    assert type(out.grad_fn).__name__ != "_HeteroFusedRevBackward"
    with pytest.raises(ValueError, match="unknown hetero strategy"):
        hetero_gspmm(trg, u, w=w, strategy="scatter")
