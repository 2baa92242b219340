"""Port parity for the lattice's layout strategies: ``gspmm`` under
``push``, ``ell`` and ``onehot``, ``block_gspmm`` under ``push``, and the
positional ``binary_reduce``.

The same numpy operands and cotangent go through the JAX function pinned
to a strategy and the port's function pinned to the same strategy; the
output and every operand's gradient (``jax.grad`` against
``torch.autograd``) must agree at 1e-5 (relative to the largest entry
where that exceeds 1). The graph has unique edges (a tie splits an
extremum's gradient, which strategies may break differently), sources
with no out-edge and destinations with no in-edge. The product is held
on its output only: JAX has no transpose for a scatter or segment
product. ``test_outputs_and_vjps_agree_seeded`` is the port of the JAX
suite's cross-strategy harness (``tests/core/test_strategy_equivalence``):
every route the port runs on a spec against the JAX segment route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_reduce as jax_binary_reduce
from repro.core import block_gspmm as jax_block_gspmm
from repro.core import from_coo as jax_from_coo
from repro.core import gspmm as jax_gspmm
from repro.data import NeighborSampler as JaxSampler
from repro_torch.core import binary_reduce, block_gspmm, from_coo, gspmm
from repro_torch.core.binary_reduce import onehot_supports, parse_op
from repro_torch.data import NeighborSampler
from repro_torch.kernels.dispatch import kernel_supports
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

TOL = 1e-5
N_U, N_V = 30, 26
TEMPLATES = ("u_copy_{}_v", "u_mul_e_{}_v", "e_copy_{}_v", "u_add_v_{}_v",
             "u_dot_v_{}_v", "v_mul_e_{}_u")
REDUCERS = ("add", "max", "min", "mul", "mean")
_memo = {}


def _graphs():
    """Unique edges among sources < 27 and destinations < 22: sources
    27… have no out-edge, destinations 22… no in-edge."""
    if "g" not in _memo:
        src, dst = random_edges(np.random.default_rng(3), 27, 22, 150,
                                unique=True)
        _memo["g"] = (jax_from_coo(src, dst, n_src=N_U, n_dst=N_V),
                      from_coo(src, dst, n_src=N_U, n_dst=N_V, device="cpu"))
    return _memo["g"]


def _draw(rng, shape):
    """Operands bounded away from 0 (a product, a divide), either sign."""
    x = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    return x * np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def _operands(spec, d, n_edges, rng):
    rows = {"u": N_U, "v": N_V, "e": n_edges}
    # the edge operand is a scalar weight wherever it multiplies
    widths = {t: (1 if t == "e" and spec.op == "mul" else d)
              for t in ("u", "v", "e")}
    names = [spec.lhs] + ([spec.rhs] if spec.rhs else [])
    return {t: _draw(rng, (rows[t], widths[t])) for t in names}


def _close(got, ref, what):
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _jax_run(g, name, args, ct, strategy, diff):
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    out = np.asarray(jax_gspmm(g, name, strategy=strategy, **jargs))
    if not diff:
        return out, {}
    grads = jax.grad(lambda a: jnp.sum(
        jax_gspmm(g, name, strategy=strategy, **a) * ct))(jargs)
    return out, {k: np.asarray(v) for k, v in grads.items()}


def _port_run(g, name, args, ct, strategy, diff):
    targs = {k: torch.from_numpy(v).requires_grad_(diff)
             for k, v in args.items()}
    out = gspmm(g, name, strategy=strategy, **targs)
    if not diff:
        return out.detach().numpy(), {}
    grads = torch.autograd.grad(out, list(targs.values()),
                                torch.from_numpy(ct))
    return out.detach().numpy(), {k: t.numpy()
                                  for k, t in zip(targs, grads)}


def _runs():
    cases = []
    for route in ("push", "ell", "onehot"):
        for template in TEMPLATES:
            for red in REDUCERS:
                for d in (1, 5):
                    spec = parse_op(template.format(red))
                    if route != "push" and spec.out != "v":
                        continue        # ell / onehot pull onto v only
                    if route == "onehot":
                        ops = _operands(spec, d, 1, np.random.default_rng(0))
                        if not onehot_supports(
                                spec, *(torch.from_numpy(ops[t])
                                        if t else None
                                        for t in (spec.lhs, spec.rhs))):
                            continue
                    cases.append((route, template.format(red), d))
    return cases


RUNS = _runs()


@pytest.mark.parametrize("route,name,d", RUNS,
                         ids=[f"{r}-{n}-{d}" for r, n, d in RUNS])
def test_gspmm_route_matches_jax(route, name, d):
    jg, tg = _graphs()
    spec = parse_op(name)
    rng = np.random.default_rng(RUNS.index((route, name, d)))
    args = _operands(spec, d, tg.n_edges, rng)
    out_w = 1 if spec.op == "dot" else d
    ct = rng.normal(size=(N_V if spec.out == "v" else N_U, out_w)).astype(
        np.float32)
    diff = spec.reduce != "prod"
    ref, ref_g = _jax_run(jg, name, args, ct, route, diff)
    out, got = _port_run(tg, name, args, ct, route, diff)
    assert out.shape == ref.shape
    _close(out, ref, f"{name} via {route}")
    for k in ref_g:
        _close(got[k], ref_g[k], f"d{k}: {name} via {route}")
    if spec.out == "v":                 # empty rows are 0 on every route
        assert not out[22:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_outputs_and_vjps_agree_seeded(seed):
    """Port of the JAX cross-strategy harness: on its three seeded graphs,
    every route the port runs on a spec (push, ell, onehot where it
    applies, the kernel route's CPU stand-in where a kernel covers it)
    agrees with the JAX segment route, output and grads."""
    rng = np.random.default_rng(seed)
    n_u, n_v, nnz = [(18, 12, 60), (24, 24, 90), (7, 30, 45)][seed]
    src, dst = random_edges(rng, n_u, n_v, nnz, unique=True)
    jg = jax_from_coo(src, dst, n_src=n_u, n_dst=n_v)
    tg = from_coo(src, dst, n_src=n_u, n_dst=n_v, device="cpu")
    ops = {"u": _draw(rng, (n_u, 5)), "v": _draw(rng, (n_v, 5)),
           "e": _draw(rng, (len(src), 1))}
    ct = rng.normal(size=(n_v, 5)).astype(np.float32)
    for template in TEMPLATES[:5]:
        for red in REDUCERS:
            name = template.format(red)
            spec = parse_op(name)
            args = {k: ops[k] for k in [spec.lhs]
                    + ([spec.rhs] if spec.rhs else [])}
            narrow = spec.op == "dot" or (spec.lhs == "e"
                                          and spec.rhs is None)
            ct_d = ct[:, :1] if narrow else ct
            diff = red != "mul"
            ref, ref_g = _jax_run(jg, name, args, ct_d, "segment", diff)
            lhs, rhs = (None if t is None else torch.from_numpy(ops[t])
                        for t in (spec.lhs, spec.rhs))
            routes = ["push", "ell"]
            if onehot_supports(spec, lhs, rhs):
                routes.append("onehot")
            if kernel_supports(spec, lhs, rhs):
                routes.append("kernel")
            for s in routes:
                out, got = _port_run(tg, name, args, ct_d, s, diff)
                _close(out, ref, f"{name} via {s}")
                for k in ref_g:
                    _close(got[k], ref_g[k], f"d{k}: {name} via {s}")


def test_onehot_and_ell_refuse_what_they_cannot_run():
    """A pinned route that cannot compute a spec raises (JAX's
    ``_gspmm_onehot`` raises on the same specs; its planner's fallback
    chain is the port's A9)."""
    _, tg = _graphs()
    u, v = torch.ones(N_U, 3), torch.ones(N_V, 3)
    e1, e3 = torch.ones(tg.n_edges, 1), torch.ones(tg.n_edges, 3)
    for name, kw in (("u_copy_max_v", {"u": u}),
                     ("e_copy_add_v", {"e": e3}),
                     ("u_add_v_add_v", {"u": u, "v": v}),
                     ("u_mul_e_add_v", {"u": u, "e": e3}),
                     ("u_copy_add_v", {"u": torch.ones(N_U, 2, 3)})):
        with pytest.raises(ValueError, match="onehot"):
            gspmm(tg, name, strategy="onehot", **kw)
    with pytest.raises(ValueError, match="destinations"):
        gspmm(tg, "v_mul_e_add_u", v=v, e=e1, strategy="ell")
    with pytest.raises(NotImplementedError, match="A12"):
        gspmm(tg, "u_copy_add_v", u=u, strategy="ring")


@pytest.mark.parametrize("strategy", ["push", "ell", "onehot"])
def test_edge_outputs_under_layout_names(strategy):
    """An edge output pinned to a layout name runs the gsddmm route JAX
    maps it to (push: the caller-order gather, ell / onehot: the
    canonical stream), with the same values."""
    jg, tg = _graphs()
    rng = np.random.default_rng(9)
    u, v = _draw(rng, (N_U, 3)), _draw(rng, (N_V, 3))
    ref = np.asarray(jax_gspmm(jg, "u_sub_v_copy_e", u=jnp.asarray(u),
                               v=jnp.asarray(v), strategy=strategy))
    got = gspmm(tg, "u_sub_v_copy_e", u=torch.from_numpy(u),
                v=torch.from_numpy(v), strategy=strategy)
    _close(got.numpy(), ref, strategy)


@pytest.mark.parametrize("strategy", ["segment", "push", "ell"])
def test_binary_reduce_positional_matches_jax(strategy):
    jg, tg = _graphs()
    rng = np.random.default_rng(11)
    x, w = _draw(rng, (N_U, 4)), _draw(rng, (tg.n_edges, 1))
    for name, ops in (("u_mul_e_add_v", (x, w)), ("u_copy_max_v", (x,))):
        ref = np.asarray(jax_binary_reduce(jg, name,
                                           *map(jnp.asarray, ops),
                                           strategy=strategy))
        got = binary_reduce(tg, name, *map(torch.from_numpy, ops),
                            strategy=strategy)
        _close(got.numpy(), ref, f"{name} via {strategy}")
    with pytest.raises(ValueError, match="two operands"):
        binary_reduce(tg, "u_mul_e_add_v", torch.from_numpy(x))
    with pytest.raises(ValueError, match="share a target"):
        binary_reduce(tg, "u_add_u_add_v", torch.from_numpy(x),
                      torch.from_numpy(x))


# --------------------------------------------------------------------- #
# block push
# --------------------------------------------------------------------- #
BLOCK_TEMPLATES = ("u_copy_{}_v", "u_mul_e_{}_v", "e_copy_{}_v",
                   "u_add_v_{}_v")


def _block():
    """(JAX block, port block): one batch of 6 at fan-out max-in-degree
    // 2 with an extra destination of no in-edge as its first seed, so
    pad slots and the dummy row are on every path."""
    if "blk" not in _memo:
        rng = np.random.default_rng(3)
        src, dst = random_edges(rng, 20, 15, 60, unique=True)
        jg = jax_from_coo(src, dst, n_src=20, n_dst=16)
        tg = from_coo(src, dst, n_src=20, n_dst=16, device="cpu")
        fanout = max(2, int(np.asarray(jg.in_degrees).max()) // 2)
        seeds = np.concatenate([[15], rng.permutation(15)[:5]])
        lab = np.zeros(6, np.int64)
        jb = JaxSampler(jg, [fanout], 6, seed=0).sample(seeds, lab).blocks[0]
        tb = NeighborSampler(tg, [fanout], 6, seed=0, device="cpu",
                             reverse=True).sample(seeds, lab).blocks[0]
        _memo["blk"] = (jb.bg, tb.bg)
    return _memo["blk"]


@pytest.mark.parametrize("bwd", ["gather", "scatter"])
@pytest.mark.parametrize("red", REDUCERS)
@pytest.mark.parametrize("template", BLOCK_TEMPLATES)
def test_block_push_matches_jax(template, red, bwd):
    """``block_gspmm(strategy="push")`` (the scatter baseline on the
    padded block graph) against the JAX block push, output and every
    operand's grad, under both backwards (the product: output only)."""
    jbg, tbg = _block()
    name = template.format(red)
    spec = parse_op(name)
    rng = np.random.default_rng(7 * BLOCK_TEMPLATES.index(template)
                                + REDUCERS.index(red))
    rows = {"u": jbg.g.n_src, "v": jbg.g.n_dst, "e": jbg.g.n_edges}
    names = [spec.lhs] + ([spec.rhs] if spec.rhs else [])
    args = {t: _draw(rng, (rows[t], 1 if t == "e" else 4)) for t in names}
    out_w = 1 if spec.lhs == "e" and spec.rhs is None else 4
    ct = rng.normal(size=(jbg.n_dst_real, out_w)).astype(np.float32)
    diff = red != "mul"
    jargs = {k: jnp.asarray(v) for k, v in args.items()}

    def jf(a):
        return jax_block_gspmm(jbg, name, strategy="push", bwd_strategy=bwd,
                               **a)

    ref = np.asarray(jf(jargs))
    targs = {k: torch.from_numpy(v).requires_grad_(diff)
             for k, v in args.items()}
    out = block_gspmm(tbg, name, strategy="push", bwd_strategy=bwd, **targs)
    _close(out.detach().numpy(), ref, f"{name} push+{bwd}")
    if diff:
        ref_g = jax.grad(lambda a: jnp.sum(jf(a) * ct))(jargs)
        got = torch.autograd.grad(out, list(targs.values()),
                                  torch.from_numpy(ct))
        for k, t in zip(targs, got):
            _close(t.numpy(), np.asarray(ref_g[k]), f"d{k}: {name} push")
