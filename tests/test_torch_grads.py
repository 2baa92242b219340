"""Port parity for the gradients of the aggregation ops.

The same numpy operands and cotangent go through ``jax.vjp`` of the JAX
function and ``torch.autograd.grad`` of the port's, on a bipartite graph
(120 → 100 nodes) with duplicate edges, destinations of in-degree 0
(empty rows of G) and sources of out-degree 0 (empty rows of Gᵀ):

* ``reverse``: every index array of Gᵀ bit-equal to JAX's;
* ``weighted_copy_reduce`` (∂x, ∂w);
* ``gspmm`` for every spec of the kernel routes' adjoint table (B1 and
  B4, every ⊗ and width they take, and GAT's rank-3 per-head sum) and
  the specs only the segment route computes, on ``segment`` and
  ``kernel``; and, counted through the wrappers' plain branches, which
  kernels a kernel route's backward runs (never the segment route);
* ``gsddmm`` for every ⊗ on u / v / e operands and width broadcasts, on
  ``kernel``, ``canonical`` and ``gather``;
* ``edge_softmax``, ``edge_softmax_fused`` and ``fused_attention``, with
  tied logits, on their plain and kernel routes.

On the CPU a kernel route runs the wrappers' plain versions, forward and
backward, so these tests hold the backward's routing and arithmetic; the
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``. Tolerance 1e-5 (fp32), relative to the gradient's
largest entry where that exceeds 1; 1e-4 for ``div``, as the JAX suite
uses. Empty rows' grads must be exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.binary_reduce import gsddmm as jax_gsddmm
from repro.core.binary_reduce import gspmm as jax_gspmm
from repro.core.edge_softmax import edge_softmax as jax_edge_softmax
from repro.core.edge_softmax import edge_softmax_fused as jax_es_fused
from repro.core.edge_softmax import fused_attention as jax_fused_attention
from repro.core.graph import from_coo as jax_from_coo
from repro.core.graph import reverse as jax_reverse
from repro.core.training_ops import make_training_graph as jax_make_tg
from repro.core.training_ops import weighted_copy_reduce as jax_wcr
from repro_torch.core import (edge_softmax, edge_softmax_fused,
                              fused_attention, gsddmm, gspmm)
from repro_torch.core.graph import from_coo, reverse
from repro_torch.core.training_ops import (make_training_graph,
                                           weighted_copy_reduce)
from repro_torch.kernels.common import check_operand
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
N_SRC, N_DST = 120, 100
FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src", "perm_src",
          "eid_inv")


def _edges():
    """Sources < 105 and destinations < 88, so sources 105… have no
    out-edge and destinations 88… no in-edge; the first 30 edges twice."""
    src, dst = random_edges(np.random.default_rng(5), 105, 88, 420)
    return np.concatenate([src, src[:30]]), np.concatenate([dst, dst[:30]])


SRC, DST = _edges()
E = len(SRC)


def _graphs():
    return (jax_from_coo(SRC, DST, n_src=N_SRC, n_dst=N_DST),
            from_coo(SRC, DST, n_src=N_SRC, n_dst=N_DST, device="cpu"))


def _vjps(jax_fn, port_fn, operands, wrt, rng):
    """(JAX grads, port grads) of ``operands[i]`` for i in ``wrt``, with
    the same numpy operands and a normal cotangent drawn from ``rng`` at
    the output's shape."""
    jops = [jnp.asarray(a) for a in operands]

    def jf(*diff):
        ops = list(jops)
        for i, a in zip(wrt, diff):
            ops[i] = a
        return jax_fn(*ops)

    out, vjp = jax.vjp(jf, *[jops[i] for i in wrt])
    ct = rng.normal(size=out.shape).astype(np.float32)
    jgrads = [np.asarray(t) for t in vjp(jnp.asarray(ct))]
    tops = [torch.tensor(a, requires_grad=i in wrt)
            for i, a in enumerate(operands)]
    tgrads = torch.autograd.grad(port_fn(*tops), [tops[i] for i in wrt],
                                 torch.from_numpy(ct))
    return jgrads, [t.numpy() for t in tgrads]


def _close(got, ref, tol=TOL, what=""):
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# --------------------------------------------------------------------- #
# reverse
# --------------------------------------------------------------------- #
def test_reverse_bit_equal_to_jax_and_cached():
    jg, tg = _graphs()
    jr, tr = jax_reverse(jg), reverse(tg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tr.host, f),
                                      np.asarray(getattr(jr, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    assert (tr.n_src, tr.n_dst, tr.n_edges) == (N_DST, N_SRC, E)
    assert reverse(tg) is tr            # built once per graph
    # a caller-order edge operand lines up on both graphs
    np.testing.assert_array_equal(tr.host.src[tr.host.eid_inv], DST)
    np.testing.assert_array_equal(tr.host.dst[tr.host.eid_inv], SRC)


# --------------------------------------------------------------------- #
# weighted_copy_reduce
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wrt", [(0,), (1,), (0, 1)])
def test_weighted_copy_reduce_grads(wrt):
    jg, tg = _graphs()
    jtg, ttg = jax_make_tg(jg), make_training_graph(tg)
    assert ttg.g_rev is reverse(tg)
    rng = np.random.default_rng(1)
    x, w = _normal(rng, N_SRC, 6), _normal(rng, E, 1)
    jgr, tgr = _vjps(lambda a, b: jax_wcr(jtg, a, b),
                     lambda a, b: weighted_copy_reduce(ttg, a, b),
                     [x, w], wrt, rng)
    for i, a, b in zip(wrt, tgr, jgr):
        _close(a, b, what=f"d{'xw'[i]}")
    if 0 in wrt:      # sources with no out-edge get exactly 0
        assert not tgr[0][105:].any()


# --------------------------------------------------------------------- #
# gspmm
# --------------------------------------------------------------------- #
# (op, lhs width/shape, rhs width/shape or None): the kernel routes'
# adjoint table — B1 sum / mean, weighted or not; B4 e_copy, u_⊗_e for
# every ⊗ with a vector or a scalar edge operand, e_⊗_u; the rank-3
# per-head aggregation (B4 with an edge value per head, B1 at one head);
# the max runs on segment only
GSPMM_CASES = [
    ("u_mul_e_add_v", (N_SRC, 8), (E, 1)),
    ("u_mul_e_mean_v", (N_SRC, 8), (E, 1)),
    ("u_copy_add_v", (N_SRC, 8), None),
    ("u_copy_mean_v", (N_SRC, 8), None),
    ("e_copy_add_v", (E, 4), None),
    ("e_copy_mean_v", (E, 1), None),
    ("u_mul_e_add_v", (N_SRC, 4), (E, 4)),
    ("u_mul_e_mean_v", (N_SRC, 4), (E, 4)),
    ("u_add_e_add_v", (N_SRC, 4), (E, 4)),
    ("u_add_e_mean_v", (N_SRC, 4), (E, 1)),
    ("u_sub_e_add_v", (N_SRC, 4), (E, 4)),
    ("u_sub_e_add_v", (N_SRC, 4), (E, 1)),
    ("u_div_e_add_v", (N_SRC, 4), (E, 4)),
    ("u_div_e_mean_v", (N_SRC, 4), (E, 1)),
    ("e_mul_u_add_v", (E, 4), (N_SRC, 4)),
    ("e_mul_u_add_v", (E, 1), (N_SRC, 4)),
    ("e_add_u_mean_v", (E, 4), (N_SRC, 4)),
    ("u_mul_e_add_v", (N_SRC, 4, 3), (E, 4, 1)),
    ("u_mul_e_mean_v", (N_SRC, 4, 3), (E, 4, 1)),
    ("u_mul_e_add_v", (N_SRC, 1, 5), (E, 1, 1)),
    ("e_mul_u_add_v", (E, 4, 1), (N_SRC, 4, 3)),
    ("e_copy_max_v", (E, 4), None),
]


def _operand_kw(op, operands):
    toks = op.split("_")
    return dict(zip((toks[0], toks[2]), operands))


GSPMM_RUNS = [c + (s,) for c in GSPMM_CASES for s in ("segment", "kernel")
              if s == "segment" or "max" not in c[0]]


@pytest.mark.parametrize("op,lshape,rshape,strategy", GSPMM_RUNS,
                         ids=[f"{c[0]}-{len(c[1])}d-{c[2] and c[2][1]}-{c[3]}"
                              for c in GSPMM_RUNS])
def test_gspmm_grads(op, lshape, rshape, strategy):
    jg, tg = _graphs()
    rng = np.random.default_rng(2)
    ops = [_normal(rng, *lshape)]
    if rshape is not None:
        ops.append(_normal(rng, *rshape))
    if "div" in op:
        ops[1] = np.abs(ops[1]) + 0.5
    if "max" in op:     # distinct messages: a tie's gradient is split
        ops[0] = rng.permutation(E * 4).reshape(E, 4).astype(np.float32)
    jgr, tgr = _vjps(
        lambda *a: jax_gspmm(jg, op, strategy="segment",
                             **_operand_kw(op, a)),
        lambda *a: gspmm(tg, op, strategy=strategy, **_operand_kw(op, a)),
        ops, tuple(range(len(ops))), rng)
    tol = 1e-4 if "div" in op else TOL
    for a, b in zip(tgr, jgr):
        _close(a, b, tol, what=op)
    if op.startswith("u_"):     # sources with no out-edge get exactly 0
        assert not tgr[0][105:].any()


# the wrappers' plain branches a kernel route runs, forward and backward
# (all operands differentiated): B1 on G then Gᵀ, B4 on G (and on Gᵀ for
# a vector mul or a div), B3 for the edge operand. The rank-3 per-head
# sum launches what the rank-2 spec of its edge width does: at H heads B4
# on G and Gᵀ and B3's dot per head, at one head B1 twice and B3's dot
KERNEL_BACKWARDS = {
    ("u_mul_e_add_v", 1): {"spmm": 2, "sddmm": 1},
    ("u_mul_e_mean_v", 1): {"spmm": 2, "sddmm": 1},
    ("u_copy_add_v", None): {"spmm": 2},
    ("u_copy_mean_v", None): {"spmm": 2},
    ("e_copy_add_v", None): {"br": 1, "sddmm": 1},
    ("e_copy_mean_v", None): {"br": 1, "sddmm": 1},
    ("u_mul_e_add_v", 4): {"br": 2, "sddmm": 1},
    ("u_mul_e_mean_v", 4): {"br": 2, "sddmm": 1},
    ("u_add_e_add_v", 4): {"br": 1, "spmm": 1, "sddmm": 1},
    ("u_add_e_mean_v", 1): {"br": 1, "spmm": 1, "sddmm": 1},
    ("u_sub_e_add_v", 4): {"br": 1, "spmm": 1, "sddmm": 1},
    ("u_sub_e_add_v", 1): {"br": 1, "spmm": 1, "sddmm": 1},
    ("u_div_e_add_v", 4): {"br": 2, "sddmm": 1},
    ("u_div_e_mean_v", 1): {"br": 2, "sddmm": 1},
    ("e_mul_u_add_v", 4): {"br": 2, "sddmm": 1},
    ("e_mul_u_add_v", 1): {"br": 1, "spmm": 1, "sddmm": 1},
    ("e_add_u_mean_v", 4): {"br": 1, "spmm": 1, "sddmm": 1},
}
KERNEL_CASES = [c for c in GSPMM_CASES if "max" not in c[0]]


def _edge_width(op, lshape, rshape):
    if op.startswith("e_") and rshape is not None:
        return lshape[1]
    return None if rshape is None else rshape[1]


@pytest.mark.parametrize("op,lshape,rshape", KERNEL_CASES,
                         ids=[f"{c[0]}-{c[2] and c[2][1]}"
                              + ("-3d" if len(c[1]) == 3 else "")
                              for c in KERNEL_CASES])
def test_gspmm_kernel_route_backward_runs_the_kernels(op, lshape, rshape,
                                                      monkeypatch):
    """Every spec a kernel computes forward differentiates on the
    kernels too: count each wrapper's plain branch (its kernel's stand-in
    on the CPU) over the forward and backward, and fail on any call of
    the segment route."""
    from repro_torch.core import strategies
    from repro_torch.kernels.binary_reduce import ops as br_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    _, tg = _graphs()
    counts = {}
    for key, mod, name in (("spmm", spmm_ops, "spmm_plain"),
                           ("sddmm", sddmm_ops, "sddmm_plain"),
                           ("br", br_ops, "binary_reduce_plain")):
        def wrapped(*a, _key=key, _plain=getattr(mod, name), **kw):
            counts[_key] = counts.get(_key, 0) + 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    def no_segment(*a, **kw):
        raise AssertionError("a kernel route reached the segment route")
    monkeypatch.setattr(strategies, "pull_segment", no_segment)
    rng = np.random.default_rng(12)
    ops = [torch.tensor(_normal(rng, *lshape), requires_grad=True)]
    if rshape is not None:
        ops.append(torch.tensor(np.abs(_normal(rng, *rshape)) + 0.5,
                                requires_grad=True))
    out = gspmm(tg, op, strategy="kernel", **_operand_kw(op, ops))
    grads = torch.autograd.grad(out, ops, torch.ones_like(out))
    assert all(gr.shape == t.shape for gr, t in zip(grads, ops))
    assert counts == KERNEL_BACKWARDS[(op, _edge_width(op, lshape,
                                                       rshape))]


RANK3_CASES = [c for c in GSPMM_CASES if len(c[1]) == 3]


@pytest.mark.parametrize("op,lshape,rshape", RANK3_CASES,
                         ids=[f"{c[0]}-{c[1][1]}x{c[1][2]}"
                              for c in RANK3_CASES])
def test_rank3_kernel_route_grads_match_segment(op, lshape, rshape,
                                                monkeypatch):
    """GAT's per-head sum on the kernel route: output, ∂z and ∂α against
    the segment route at 1e-5, in the operands' shapes; every wrapper it
    calls gets operands of rank 1 or 2, an edge operand of at most H
    columns: no per-edge (E, H, F) tensor is made, forward or backward."""
    from repro_torch.kernels.binary_reduce import ops as br_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    _, tg = _graphs()
    rng = np.random.default_rng(4)
    ops = [_normal(rng, *lshape), np.abs(_normal(rng, *rshape))]
    kw = {}
    for strategy in ("segment", "kernel"):
        ts = [torch.tensor(a, requires_grad=True) for a in ops]
        kw[strategy] = ts
    ref = gspmm(tg, op, strategy="segment", **_operand_kw(op, kw["segment"]))
    ct = torch.from_numpy(_normal(rng, *ref.shape))
    ref_grads = torch.autograd.grad(ref, kw["segment"], ct)
    seen = []
    for mod, name in ((spmm_ops, "spmm_plain"), (sddmm_ops, "sddmm_plain"),
                      (br_ops, "binary_reduce_plain")):
        def wrapped(*a, _plain=getattr(mod, name), **k):
            seen.extend(tuple(t.shape) for t in a
                        if isinstance(t, torch.Tensor)
                        and t.is_floating_point())
            return _plain(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    got = gspmm(tg, op, strategy="kernel", **_operand_kw(op, kw["kernel"]))
    grads = torch.autograd.grad(got, kw["kernel"], ct)
    assert got.shape == ref.shape
    _close(got.detach().numpy(), ref.detach().numpy(), what=op)
    for a, b, t in zip(grads, ref_grads, kw["kernel"]):
        assert a.shape == t.shape
        _close(a.numpy(), b.numpy(), what=op)
    heads = (lshape if op.startswith("e_") else rshape)[1]
    assert seen and all(len(sh) <= 2 for sh in seen)
    assert all(int(np.prod(sh[1:])) <= heads for sh in seen if sh[0] == E)


# --------------------------------------------------------------------- #
# gsddmm
# --------------------------------------------------------------------- #
ROWS = {"u": N_SRC, "v": N_DST, "e": E}
GSDDMM_CASES = (
    [(op, t, w) for op in ("add", "sub", "mul", "div", "dot")
     for t in ("uv", "ev", "ue", "vu") for w in ((4, 4), (4, 1), (1, 4))
     if not (op == "dot" and w != (4, 4))]
    + [("copy", t, (w, None)) for t in "uve" for w in (4, 1)])


@pytest.mark.parametrize("strategy", ["kernel", "canonical", "gather"])
@pytest.mark.parametrize("op,targets,widths", GSDDMM_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}"
                              for c in GSDDMM_CASES])
def test_gsddmm_grads(op, targets, widths, strategy):
    jg, tg = _graphs()
    rng = np.random.default_rng(3)
    names = targets[:1] if op == "copy" else targets
    name = (f"{names[0]}_copy_copy_e" if op == "copy"
            else f"{names[0]}_{op}_{names[1]}_copy_e")
    ops = [_normal(rng, ROWS[t], w) for t, w in zip(names, widths)]
    if op == "div":
        ops[1] = (np.sign(ops[1]) * (0.5 + np.abs(ops[1]))).astype(
            np.float32)
    jgr, tgr = _vjps(
        lambda *a: jax_gsddmm(jg, name, strategy="canonical",
                              **dict(zip(names, a))),
        lambda *a: gsddmm(tg, name, strategy=strategy, **dict(zip(names, a))),
        ops, tuple(range(len(ops))), rng)
    tol = 1e-4 if op == "div" else TOL
    for t, a, b in zip(names, tgr, jgr):
        _close(a, b, tol, what=f"{name} d{t}")
        if t == "u":
            assert not a[105:].any()


def test_kernel_routes_keep_direct_wrapper_calls_strict():
    """A kernel wrapper still refuses an operand that requires grad; the
    routes above hand their wrappers detached operands."""
    with pytest.raises(NotImplementedError, match="requires grad"):
        check_operand("k", "x", torch.zeros(4, 3, requires_grad=True),
                      torch.float32, (4, 3), torch.device("cpu"))


# --------------------------------------------------------------------- #
# edge softmax and fused attention
# --------------------------------------------------------------------- #
def _tied_logits(rng, *shape):
    """Small integers: many rows hold tied maxima."""
    return rng.integers(-2, 3, size=shape).astype(np.float32)


@pytest.mark.parametrize("H", [4, 1])
@pytest.mark.parametrize("form,strategy", [
    ("composed", "segment"), ("composed", "kernel"), ("composed", "auto"),
    ("fused", "fused"), ("fused", "kernel")])
def test_edge_softmax_grads_with_ties(form, strategy, H):
    jg, tg = _graphs()
    rng = np.random.default_rng(4 + H)
    x = _tied_logits(rng, E, H)
    if form == "composed":
        jfn = lambda a: jax_edge_softmax(jg, a, strategy="segment")
        tfn = lambda a: edge_softmax(tg, a, strategy=strategy)
    else:
        jfn = lambda a: jax_es_fused(jg, a)
        tfn = lambda a: edge_softmax_fused(tg, a, strategy=strategy)
    (jgr,), (tgr,) = _vjps(jfn, tfn, [x], (0,), rng)
    _close(tgr, jgr)


@pytest.mark.parametrize("strategy", ["fused", "kernel"])
@pytest.mark.parametrize("heads", [(4, 3), (1, 5), None])
def test_fused_attention_grads_with_ties(heads, strategy):
    jg, tg = _graphs()
    rng = np.random.default_rng(9)
    H, F = heads or (1, 5)
    el, er = _tied_logits(rng, N_SRC, H), _tied_logits(rng, N_DST, H)
    z = _normal(rng, N_SRC, H, F)
    if heads is None:                  # 1-D logits, (n, F) features
        el, er, z = el[:, 0], er[:, 0], z[:, 0]
    jgr, tgr = _vjps(
        lambda a, b, c: jax_fused_attention(jg, a, b, c, strategy="fused"),
        lambda a, b, c: fused_attention(tg, a, b, c, strategy=strategy),
        [el, er, z], (0, 1, 2), rng)
    for what, a, b in zip(("el", "er", "z"), tgr, jgr):
        _close(a, b, what=what)
    assert not tgr[2][105:].any()     # sources no edge reads


@pytest.mark.parametrize("wrt", [(0,), (2,), (1, 2)])
def test_fused_attention_kernel_route_skips_unasked_grads(wrt):
    """Only the inputs that require grad get one (the rest stay None)."""
    _, tg = _graphs()
    rng = np.random.default_rng(10)
    ts = [torch.tensor(_normal(rng, *s), requires_grad=i in wrt)
          for i, s in enumerate([(N_SRC, 2), (N_DST, 2), (N_SRC, 2, 3)])]
    out = fused_attention(tg, *ts, strategy="kernel")
    out.sum().backward()
    assert [t.grad is not None for t in ts] == [i in wrt for i in range(3)]


def test_kernel_routes_are_autograd_functions():
    """Under a kernel strategy each op records its route's Function, so
    the tests above run the backward kernels' routing (plain versions on
    the CPU); a plain route records torch's own ops."""
    _, tg = _graphs()
    rng = np.random.default_rng(11)
    u = torch.tensor(_normal(rng, N_SRC, 4), requires_grad=True)
    v = torch.tensor(_normal(rng, N_DST, 4), requires_grad=True)
    e = torch.tensor(_normal(rng, E, 4), requires_grad=True)
    w = torch.tensor(_normal(rng, E, 1), requires_grad=True)
    z = torch.tensor(_normal(rng, N_SRC, 4, 3), requires_grad=True)
    outs = {
        "_KernelGspmm": gspmm(tg, "u_mul_e_add_v", u=u, e=w,
                              strategy="kernel"),
        "_KernelGsddmm": gsddmm(tg, "u_add_v_copy_e", u=u, v=v,
                                strategy="kernel"),
        "_EdgeSoftmaxKernel": edge_softmax_fused(tg, e, strategy="kernel"),
        "_FusedAttentionKernel": fused_attention(tg, u, v, z,
                                                 strategy="kernel")}
    for name, out in outs.items():
        assert type(out.grad_fn).__name__ == f"{name}Backward", name
    # the JAX package's weighted_copy_reduce is gspmm's kernel route
    wcr = weighted_copy_reduce(make_training_graph(tg), u, w)
    assert type(wcr.grad_fn).__name__ == "_KernelGspmmBackward"
    plain = gspmm(tg, "u_mul_e_add_v", u=u, e=w, strategy="segment")
    assert "Kernel" not in type(plain.grad_fn).__name__
    with torch.no_grad():       # no graph: the wrappers are called directly
        assert gspmm(tg, "u_copy_add_v", u=u, strategy="kernel").grad_fn \
            is None


# --------------------------------------------------------------------- #
# C6: a dot whose operand widths broadcast, on the segment route
# --------------------------------------------------------------------- #
def _c6_graph():
    """40 edges, 13 sources × 11 destinations: destinations 8–10 have
    no in-edge, and one edge is there 5 times (``default_rng(1)``)."""
    rng = np.random.default_rng(1)
    src = np.concatenate([rng.integers(0, 13, 35), np.full(5, 3)])
    dst = np.concatenate([rng.integers(0, 8, 35), np.full(5, 6)])
    return (jax_from_coo(src, dst, n_src=13, n_dst=11),
            from_coo(src, dst, n_src=13, n_dst=11, device="cpu"))


C6_WIDTHS = [((4,), (1,)), ((1,), (4,)), ((2, 3), (2, 1))]
C6_PAIRS = [("u", "v"), ("v", "u"), ("u", "e"), ("e", "u"), ("v", "e"),
            ("e", "v")]


@pytest.mark.parametrize("out", ["v", "u"])
@pytest.mark.parametrize("red", ["add", "mean"])
@pytest.mark.parametrize("pair", C6_PAIRS, ids="".join)
@pytest.mark.parametrize("widths", C6_WIDTHS,
                         ids=["4-1", "1-4", "23-21"])
def test_segment_broadcast_dot_grads_match_jax(widths, pair, red, out):
    """ROADMAP C6: ``gspmm(strategy="segment")`` on ``<l>_dot_<r>`` with
    operand widths that broadcast returns each operand's grad at its own
    shape, within 1e-5 of ``jax.grad`` of the JAX segment route (before
    the fix the segment backward raised on the wider operand)."""
    jg, tg = _c6_graph()
    op = f"{pair[0]}_dot_{pair[1]}_{red}_{out}"
    rows = {"u": 13, "v": 11, "e": 40}
    rng = np.random.default_rng(7)
    ops = [_normal(rng, rows[t], *w) for t, w in zip(pair, widths)]
    jgr, tgr = _vjps(
        lambda a, b: jax_gspmm(jg, op, strategy="segment",
                               **dict(zip(pair, (a, b)))),
        lambda a, b: gspmm(tg, op, strategy="segment",
                           **dict(zip(pair, (a, b)))),
        ops, (0, 1), rng)
    for a, b, x in zip(tgr, jgr, ops):
        assert a.shape == x.shape
        _close(a, b, what=op)
