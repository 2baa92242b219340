"""Port parity for the mesh ring (``repro_torch/core/partition.py`` with a
``torch.distributed`` process group) against the JAX package's
``shard_map`` ring (``repro/core/partition.py`` with a mesh), on the CPU.

* The reference program: one JAX child (``tests/conftest.run_multidevice``,
  8 emulated devices; it installs ROADMAP C1's shim before importing
  ``repro``) draws every case's inputs from numpy seeds and writes them
  first, then runs each case on ``make_shard_mesh(S)`` and writes the
  results; the port's spawns run on the inputs meanwhile.
* The port program: one ``torch.multiprocessing`` spawn per world size S ∈
  {2, 4, 8} of ``gloo`` ranks (``init_method="file://…"`` under the
  test's temporary directory, a 60 s group timeout, joined under a
  limit) runs every case of that S on the plain and the kernel route
  (here the kernels' plain versions), each rank on its shard; rank 0
  gathers the blocks, runs the port's emulated ring on the whole arrays
  and writes both.
* Held: ``ring_gspmm`` (scalar and per-head weight, ``contiguous`` and
  ``hash``) forward, ∂x and ∂w; ``uniform`` against the plain SpMM; the
  int8 ring (output, residual, each rank's ``q`` and scales equal to the
  whole array's); ``ring_edge_values``, ``bucket_softmax`` and the
  partitioned attention with their grads; ``ring_gspmm_delayed`` on a
  refresh and a stale step; gspmm's ``ring`` route under ``use_ring``;
  the exchange counters summed over the ranks; a rank whose sends do not
  match fails its run instead of hanging it. Within 2e-4 of JAX's mesh
  run and 1e-5 of the port's emulated ring.
"""
import concurrent.futures
import datetime
import os
import time

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice

TOL_JAX = 2e-4
TOL_EMU = 1e-5
WORLDS = (2, 4, 8)
ROUTES = ("plain", "kernel")
MODES = ("contiguous", "hash")
HEADS = (0, 2)                  # 0: a scalar weight; H: per-head (H, F)
N, NNZ = 96, 600
GROUP_TIMEOUT_S = 60
SPAWN_LIMIT_S = 240

_JAX_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax._src import core as _core
if not hasattr(jax.core, "trace_state_clean"):      # ROADMAP C1
    jax.core.trace_state_clean = _core.trace_state_clean
from repro.core import from_coo
from repro.core import partition as jp
from repro.core.edge_softmax import fused_attention_partitioned
from repro.kernels.spmm.ref import spmm_ref
from repro.launch.mesh import make_shard_mesh

N, NNZ = {N}, {NNZ}
out_path, inputs_path = sys.argv[1:3]
ins = {{}}
rng = np.random.default_rng(0)
src, dst = rng.integers(0, N, NNZ), rng.integers(0, N, NNZ)
ins["src"], ins["dst"] = src, dst
g = from_coo(src, dst, n_src=N, n_dst=N)
pgs = {{(S, mode): jp.build_partition(g, S, mode) for S in (2, 4, 8)
       for mode in ("contiguous", "hash", "uniform")}}


def normal(*shape):
    return rng.normal(size=shape).astype(np.float32)


def put(res, key, **arrs):
    for k, v in arrs.items():
        res[key + "/" + k] = np.asarray(v)


# every case's inputs first, written at once: the port runs on them
# while this program computes its references
for S in (2, 4, 8):
    for mode in ("contiguous", "hash"):
        pg = pgs[S, mode]
        for head in (0, 2):
            x = normal(N, 8) if not head else normal(N, head, 4)
            w = (rng.random(size=(NNZ,) if not head else (NNZ, head))
                 .astype(np.float32) + 0.1)
            put(ins, f"ring/{{S}}/{{mode}}/{{head}}", x=x, w=w,
                c=normal(pg.n_pad, *x.shape[1:]))
    n_pad = pgs[S, "contiguous"].n_pad
    put(ins, f"attn/{{S}}", el=normal(N, 2), er=normal(N, 2),
        z=normal(N, 2, 4), c=normal(n_pad, 2, 4))
    put(ins, f"int8/{{S}}", x=normal(N, 5), r=normal(n_pad, 5) * 0.01)
put(ins, "uniform", x=normal(N, 16))
eb = pgs[4, "hash"].eb
put(ins, "rev", el=normal(N, 3), er=normal(N, 3), c=normal(4, 4, eb, 3))
put(ins, "softmax", logits=normal(4, 4, eb, 3))
n_pad = pgs[4, "contiguous"].n_pad
put(ins, "delayed", x=normal(N, 6), w=rng.random(NNZ).astype(np.float32)
    + 0.1, stale=normal(n_pad, 6), c=normal(n_pad, 6))
np.savez(inputs_path + ".tmp.npz", **ins)
os.replace(inputs_path + ".tmp.npz", inputs_path)


def vjp(fn, args, ct):
    def loss(*a):
        o = fn(*a)
        return jnp.sum(o * ct), o
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return o, grads


def inp(key):
    return jnp.asarray(ins[key])


res = {{}}
for S in (2, 4, 8):
    mesh = make_shard_mesh(S)
    for mode in ("contiguous", "hash"):
        pg = pgs[S, mode]
        for head in (0, 2):
            key = f"ring/{{S}}/{{mode}}/{{head}}"
            o, (dx, dw) = vjp(lambda a, b: jp.ring_gspmm(pg, a, b,
                                                         mesh=mesh),
                              (pg.scatter_nodes(inp(key + "/x")),
                               pg.scatter_edges(inp(key + "/w"))),
                              inp(key + "/c"))
            put(res, key, out=o, dx=dx, dw=dw)
    pg = pgs[S, "contiguous"]
    key = f"attn/{{S}}"
    o, grads = vjp(lambda a, b, cc: fused_attention_partitioned(
        pg, a, b, cc, mesh=mesh), tuple(pg.scatter_nodes(inp(f"{{key}}/{{n}}"))
                                        for n in ("el", "er", "z")),
        inp(key + "/c"))
    put(res, key, out=o, d_el=grads[0], d_er=grads[1], d_z=grads[2])
    key = f"int8/{{S}}"
    wb = jnp.where(pg.mask, 1.0, 0.0)
    o, nr = jax.jit(lambda a, b: jp.ring_gspmm(
        pg, a, wb, mesh=mesh, comm="int8", residual=b))(
        pg.scatter_nodes(inp(key + "/x")), inp(key + "/r"))
    put(res, key, out=o, residual=nr)

mesh = make_shard_mesh(8)
pg = pgs[8, "uniform"]
wb = jnp.where(pg.mask, 1.0, 0.0)
put(res, "uniform", out=jax.jit(lambda a: jp.ring_gspmm(
    pg, a, wb, mesh=mesh))(pg.scatter_nodes(inp("uniform/x"))),
    spmm=spmm_ref(g.src, g.dst, inp("uniform/x"), N, "sum"))

mesh = make_shard_mesh(4)
pg = pgs[4, "hash"]
o, (d_el, d_er) = vjp(lambda a, b: jp.ring_edge_values(pg, a, b, mesh=mesh),
                      tuple(pg.scatter_nodes(inp(f"rev/{{n}}"))
                            for n in ("el", "er")), inp("rev/c"))
put(res, "rev", out=o, d_el=d_el, d_er=d_er)
a, (d_logits,) = vjp(lambda t: jp.bucket_softmax(pg, t),
                     (inp("softmax/logits"),), inp("rev/c"))
put(res, "softmax", out=a, d_logits=d_logits)

pg = pgs[4, "contiguous"]
jx = pg.scatter_nodes(inp("delayed/x"))
jw = pg.scatter_edges(inp("delayed/w"))
for refresh in (True, False):
    def loss(a):
        o, remote = jp.ring_gspmm_delayed(pg, a, jw, inp("delayed/stale"),
                                          refresh, mesh=mesh)
        return jnp.sum(o * inp("delayed/c")), (o, remote)
    (_, (o, remote)), dx = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jx)
    put(res, f"delayed/{{refresh}}", out=o, remote=remote, dx=dx)
np.savez(out_path, **res)
print("RING_MESH_REF_OK")
""".format(N=N, NNZ=NNZ)


# --------------------------------------------------------------------- #
# the port program: one spawn of gloo ranks per world size
# --------------------------------------------------------------------- #
def init_rank(rank: int, world: int, root: str):
    """Join the ``gloo`` group of ``world`` ranks rendezvousing in the file
    ``root``/pg, one thread each; returns the default group."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/pg", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.group.WORLD


def spawn_ranks(fn, world: int, args, limit: float = SPAWN_LIMIT_S) -> None:
    """Run ``fn(rank, *args)`` on ``world`` spawned processes; a rank that
    fails fails the call, and a run past ``limit`` seconds is killed and
    raises."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after {limit} s")


def gather_to_root(group, parts: dict) -> list:
    """Rank 0 gets every rank's ``parts``, in rank order (the others get
    an empty list)."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size(group) if dist.get_rank(group) == 0 \
        else None
    dist.gather_object(parts, got, dst=0, group=group)
    return got or []


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rank_cases(rank: int, world: int, ins: dict, group) -> tuple:
    """Every op case at ``world`` on this rank: (mesh blocks, emulated
    whole arrays — on rank 0 only —, flags)."""
    from repro_torch.core import from_coo, gspmm, planner
    from repro_torch.core import partition as tp
    from repro_torch.core.edge_softmax import fused_attention_partitioned
    from repro_torch.obs import metrics
    from repro_torch.optim.compression import BLOCK, int8_compress

    g = from_coo(ins["src"], ins["dst"], n_src=N, n_dst=N, device="cpu")
    mesh, emu, flags = {}, {}, {}

    def rows(pg, t):
        return t[rank * pg.rows:(rank + 1) * pg.rows]

    def grads(out, ct, ins):
        return torch.autograd.grad((out * ct).sum(), ins)

    def leaf(t):
        return t.detach().clone().requires_grad_()

    for mode in MODES:
        pg = tp.build_partition(g, world, mode)
        for head in HEADS:
            key = f"ring/{world}/{mode}/{head}"
            xp = pg.scatter_nodes(torch.from_numpy(ins[key + "/x"]))
            wb = pg.scatter_edges(torch.from_numpy(ins[key + "/w"]))
            c = torch.from_numpy(ins[key + "/c"])
            for route in ROUTES:
                x, w = leaf(rows(pg, xp)), leaf(wb[rank:rank + 1])
                out = tp.ring_gspmm(pg, x, w, mesh=group, strategy=route)
                dx, dw = grads(out, rows(pg, c), (x, w))
                mesh.update({f"{key}/{route}/out": _np(out),
                             f"{key}/{route}/dx": _np(dx),
                             f"{key}/{route}/dw": _np(dw)})
                if rank == 0:
                    x, w = leaf(xp), leaf(wb)
                    out = tp.ring_gspmm(pg, x, w, strategy=route)
                    dx, dw = grads(out, c, (x, w))
                    emu.update({f"{key}/{route}/out": _np(out),
                                f"{key}/{route}/dx": _np(dx),
                                f"{key}/{route}/dw": _np(dw)})
    pg = tp.build_partition(g, world, "contiguous")
    key = f"attn/{world}"
    nodes = [pg.scatter_nodes(torch.from_numpy(ins[f"{key}/{n}"]))
             for n in ("el", "er", "z")]
    c = torch.from_numpy(ins[key + "/c"])
    for route in ROUTES:
        leaves = [leaf(rows(pg, t)) for t in nodes]
        out = fused_attention_partitioned(pg, *leaves, mesh=group,
                                          strategy=route)
        gs = grads(out, rows(pg, c), leaves)
        mesh.update({f"{key}/{route}/{n}": _np(t) for n, t in zip(
            ("out", "d_el", "d_er", "d_z"), (out,) + gs)})
        if rank == 0:
            leaves = [leaf(t) for t in nodes]
            out = fused_attention_partitioned(pg, *leaves, strategy=route)
            gs = grads(out, c, leaves)
            emu.update({f"{key}/{route}/{n}": _np(t) for n, t in zip(
                ("out", "d_el", "d_er", "d_z"), (out,) + gs)})
    key = f"int8/{world}"
    xp = pg.scatter_nodes(torch.from_numpy(ins[key + "/x"]))
    r = torch.from_numpy(ins[key + "/r"])
    wb = pg.mask.float()
    for route in ROUTES:
        out, res = tp.ring_gspmm(pg, rows(pg, xp), wb[rank:rank + 1],
                                 mesh=group, comm="int8",
                                 residual=rows(pg, r), strategy=route)
        mesh.update({f"{key}/{route}/out": _np(out),
                     f"{key}/{route}/residual": _np(res)})
        if rank == 0:
            out, res = tp.ring_gspmm(pg, xp, wb, comm="int8", residual=r,
                                     strategy=route)
            emu.update({f"{key}/{route}/out": _np(out),
                        f"{key}/{route}/residual": _np(res)})
    # each rank's q and scales against the whole padded array's
    _, _, wire = tp._compress_shard(tp.rank_plan(pg, group), group,
                                    rows(pg, xp), rows(pg, r))
    q_all, s_all = int8_compress(xp + r)
    n = pg.rows * xp.shape[1]
    start, off = rank * n, wire.offset(rank)
    q, scales = wire.tensors
    first, last = start // BLOCK, (start + n - 1) // BLOCK
    flags[f"int8_q/{world}/{rank}"] = bool(
        torch.equal(q[off:off + n], q_all.reshape(-1)[start:start + n])
        and torch.equal(scales[:last - first + 1], s_all[first:last + 1]))
    # the exchange counters: what this rank sends, summed over the ranks
    prev = metrics.set_enabled(True)
    try:
        for comm in ("none", "int8"):
            int8 = comm == "int8"
            for on_mesh in (True, False):
                metrics.reset_metrics()
                if on_mesh:
                    tp.ring_gspmm(pg, rows(pg, xp), wb[rank:rank + 1],
                                  mesh=group, comm=comm,
                                  residual=rows(pg, r) if int8 else None)
                else:
                    tp.ring_gspmm(pg, xp, wb, comm=comm,
                                  residual=r if int8 else None)
                snap = metrics.snapshot()
                vals = np.array([snap.get(f"comm.ring.{k}", {}).get(
                    "value", 0) for k in ("raw_bytes", "wire_bytes",
                                          "pad_slots")], np.int64)
                (mesh if on_mesh else flags)[
                    f"counters/{world}/{comm}"
                    + ("" if on_mesh else f"/{rank}")] = vals
    finally:
        metrics.set_enabled(prev)
    if world == 8:
        pg = tp.build_partition(g, 8, "uniform")
        xp = pg.scatter_nodes(torch.from_numpy(ins["uniform/x"]))
        for route in ROUTES:
            mesh[f"uniform/{route}/out"] = _np(tp.ring_gspmm(
                pg, rows(pg, xp), pg.mask.float()[rank:rank + 1], mesh=group,
                strategy=route))
        if rank == 0:
            emu["uniform/segment"] = _np(gspmm(
                g, "u_copy_add_v", u=torch.from_numpy(ins["uniform/x"]),
                strategy="segment"))
        # gspmm's ring route under use_ring, on JAX's auto-ring graph
        rng = np.random.default_rng(0)
        n_big = 4096
        big = from_coo(rng.integers(0, n_big, 40_000),
                       rng.integers(0, n_big, 40_000), n_src=n_big,
                       n_dst=n_big, device="cpu")
        u = torch.from_numpy(rng.normal(size=(n_big, 64)).astype(np.float32))
        want = gspmm(big, "u_copy_add_v", u=u, strategy="segment")
        with planner.use_ring(group):
            got = gspmm(big, "u_copy_add_v", u=u)
            flags[f"auto_ring/plan/{rank}"] = planner.last_plan(
                "u_copy_add_v")
        flags[f"auto_ring/err/{rank}"] = float((got - want).abs().max())
        got = gspmm(big, "u_copy_add_v", u=u)
        flags[f"auto_ring/plan_outside/{rank}"] = planner.last_plan(
            "u_copy_add_v")
        flags[f"auto_ring/err_outside/{rank}"] = float(
            (got - want).abs().max())
    if world == 4:
        pg = tp.build_partition(g, 4, "hash")
        nodes = [pg.scatter_nodes(torch.from_numpy(ins[f"rev/{n}"]))
                 for n in ("el", "er")]
        c = torch.from_numpy(ins["rev/c"])
        logits = torch.from_numpy(ins["softmax/logits"])
        for route in ROUTES:
            leaves = [leaf(rows(pg, t)) for t in nodes]
            out = tp.ring_edge_values(pg, *leaves, mesh=group, strategy=route)
            gs = grads(out, c[rank:rank + 1], leaves)
            lg = leaf(logits[rank:rank + 1])
            alpha = tp.bucket_softmax(pg, lg, mesh=group, strategy=route)
            (d_logits,) = grads(alpha, c[rank:rank + 1], [lg])
            mesh.update({f"rev/{route}/out": _np(out),
                         f"rev/{route}/d_el": _np(gs[0]),
                         f"rev/{route}/d_er": _np(gs[1]),
                         f"softmax/{route}/out": _np(alpha),
                         f"softmax/{route}/d_logits": _np(d_logits)})
            if rank == 0:
                leaves = [leaf(t) for t in nodes]
                out = tp.ring_edge_values(pg, *leaves, strategy=route)
                gs = grads(out, c, leaves)
                lg = leaf(logits)
                alpha = tp.bucket_softmax(pg, lg, strategy=route)
                (d_logits,) = grads(alpha, c, [lg])
                emu.update({f"rev/{route}/out": _np(out),
                            f"rev/{route}/d_el": _np(gs[0]),
                            f"rev/{route}/d_er": _np(gs[1]),
                            f"softmax/{route}/out": _np(alpha),
                            f"softmax/{route}/d_logits": _np(d_logits)})
        pg = tp.build_partition(g, 4, "contiguous")
        xp = pg.scatter_nodes(torch.from_numpy(ins["delayed/x"]))
        wb = pg.scatter_edges(torch.from_numpy(ins["delayed/w"]))
        stale = torch.from_numpy(ins["delayed/stale"])
        c = torch.from_numpy(ins["delayed/c"])
        for refresh in (True, False):
            for route in ROUTES:
                key = f"delayed/{refresh}/{route}"
                x = leaf(rows(pg, xp))
                out, remote = tp.ring_gspmm_delayed(
                    pg, x, wb[rank:rank + 1], rows(pg, stale), refresh,
                    mesh=group, strategy=route)
                (dx,) = grads(out, rows(pg, c), [x])
                mesh.update({f"{key}/out": _np(out),
                             f"{key}/remote": _np(remote),
                             f"{key}/dx": _np(dx)})
                if rank == 0:
                    x = leaf(xp)
                    out, remote = tp.ring_gspmm_delayed(
                        pg, x, wb, stale, refresh, strategy=route)
                    (dx,) = grads(out, c, [x])
                    emu.update({f"{key}/out": _np(out),
                                f"{key}/remote": _np(remote),
                                f"{key}/dx": _np(dx)})
    return mesh, emu, flags


def _ops_rank(rank: int, world: int, root: str, inputs_path: str) -> None:
    import torch.distributed as dist

    group = init_rank(rank, world, root)
    try:
        mesh, emu, flags = _rank_cases(rank, world, dict(np.load(inputs_path)),
                                       group)
        blocks = gather_to_root(group, mesh)
        flags = gather_to_root(group, flags)
        if rank == 0:
            out = {f"mesh/{k}": np.concatenate([b[k] for b in blocks])
                   for k in blocks[0]}
            out.update({f"emu/{k}": v for k, v in emu.items()})
            out.update({f"flag/{k}": np.asarray(v) for f in flags
                        for k, v in f.items()})
            np.savez(os.path.join(root, "port.npz"), **out)
    finally:
        dist.destroy_process_group()


def _mismatched_rank(rank: int, root: str) -> None:
    """Rank 1 runs one ring pass more than rank 0, which then leaves the
    group: rank 1's sends never match, and its run fails (at the latest
    at the group's timeout)."""
    import torch.distributed as dist
    from repro_torch.core import from_coo
    from repro_torch.core import partition as tp

    init_rank(rank, 2, root)
    rng = np.random.default_rng(0)
    g = from_coo(rng.integers(0, 40, 200), rng.integers(0, 40, 200),
                 n_src=40, n_dst=40, device="cpu")
    pg = tp.build_partition(g, 2)
    x = torch.randn(pg.rows, 4)
    w = pg.mask.float()[rank:rank + 1]
    for _ in range(1 + rank):
        tp.ring_gspmm(pg, x, w, mesh=dist.group.WORLD)
    dist.destroy_process_group()


def wait_for_file(path: str, child, limit: float = SPAWN_LIMIT_S) -> None:
    """Wait until ``path`` exists; fail at once if ``child`` (the JAX
    program's future) ended without writing it."""
    deadline = time.monotonic() + limit
    while not os.path.exists(path):
        if child.done():
            r = child.result()
            raise AssertionError(f"{path} not written: {r.stderr[-3000:]}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written after {limit} s")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh results and, per world size, the port's: the JAX child
    writes every input first and its references last, and the port's
    spawns run on the inputs meanwhile."""
    root = tmp_path_factory.mktemp("ring_mesh")
    ref_path, inputs_path = str(root / "jax.npz"), str(root / "inputs.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(run_multidevice, _JAX_PROG, ref_path, inputs_path)
        wait_for_file(inputs_path, child)
        port = {}
        for world in WORLDS:
            d = root / f"s{world}"
            d.mkdir()
            spawn_ranks(_ops_rank, world, (world, str(d), inputs_path))
            port[world] = dict(np.load(d / "port.npz"))
        r = child.result()
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(ref_path))
    ref.update(np.load(inputs_path))
    return ref, port


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _hold(runs, world, key, names, ref_key=None):
    """Mesh against JAX's mesh run (2e-4) and the port's emulated ring
    (1e-5), name by name."""
    ref, port = runs
    p = port[world]
    for route in ROUTES:
        for name in names:
            got = p[f"mesh/{key}/{route}/{name}"]
            _close(got, ref[f"{ref_key or key}/{name}"], TOL_JAX)
            _close(got, p[f"emu/{key}/{route}/{name}"], TOL_EMU)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_gspmm_and_grads_match_jax_mesh(runs, world, mode, head):
    _hold(runs, world, f"ring/{world}/{mode}/{head}", ("out", "dx", "dw"))


def test_uniform_ring_matches_spmm(runs):
    """``test_ring_copy_reduce_8dev``: ``uniform`` mode puts padded row i
    at vertex i, so the first n rows are the plain SpMM (JAX's
    ``spmm_ref`` and the port's segment route)."""
    ref, port = runs
    for route in ROUTES:
        got = port[8][f"mesh/uniform/{route}/out"]
        _close(got, ref["uniform/out"], TOL_JAX)
        _close(got[:N], ref["uniform/spmm"], TOL_JAX)
        _close(got[:N], port[8]["emu/uniform/segment"], TOL_JAX)


@pytest.mark.parametrize("world", WORLDS)
def test_partitioned_attention_matches_jax_mesh(runs, world):
    _hold(runs, world, f"attn/{world}", ("out", "d_el", "d_er", "d_z"))


@pytest.mark.parametrize("world", WORLDS)
def test_int8_ring_matches_jax_mesh(runs, world):
    """The output and the new residual; on every rank its ``q`` and scales
    equal the whole padded array's quantization (a block straddling two
    ranks takes both ranks' amax)."""
    ref, port = runs
    p = port[world]
    for route in ROUTES:
        for name in ("out", "residual"):
            got = p[f"mesh/int8/{world}/{route}/{name}"]
            _close(got, ref[f"int8/{world}/{name}"], TOL_JAX)
            _close(got, p[f"emu/int8/{world}/{route}/{name}"], TOL_EMU)
    assert all(bool(p[f"flag/int8_q/{world}/{r}"]) for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_counters_sum_to_emulated(runs, world):
    p = runs[1][world]
    for comm in ("none", "int8"):
        summed = p[f"mesh/counters/{world}/{comm}"].reshape(world, 3).sum(0)
        np.testing.assert_array_equal(summed,
                                      p[f"flag/counters/{world}/{comm}/0"])
        assert summed[0] > 0


def test_edge_values_and_bucket_softmax_match_jax_mesh(runs):
    _hold(runs, 4, "rev", ("out", "d_el", "d_er"))
    _hold(runs, 4, "softmax", ("out", "d_logits"))


@pytest.mark.parametrize("refresh", [True, False])
def test_delayed_ring_matches_jax_mesh(runs, refresh):
    ref, port = runs
    p = port[4]
    for route in ROUTES:
        for name in ("out", "remote", "dx"):
            got = p[f"mesh/delayed/{refresh}/{route}/{name}"]
            _close(got, ref[f"delayed/{refresh}/{name}"], TOL_JAX)
            _close(got, p[f"emu/delayed/{refresh}/{route}/{name}"], TOL_EMU)


def test_auto_selects_ring_only_with_a_group(runs):
    """JAX's ``_AUTO_RING_PROG`` on 8 ranks: inside ``use_ring(group)``
    auto plans ``ring`` and agrees with ``segment`` within 1e-3; outside
    it plans something else, still right."""
    p = runs[1][8]
    for r in range(8):
        assert str(p[f"flag/auto_ring/plan/{r}"]) == "ring"
        assert str(p[f"flag/auto_ring/plan_outside/{r}"]) != "ring"
        assert float(p[f"flag/auto_ring/err/{r}"]) < 1e-3
        assert float(p[f"flag/auto_ring/err_outside/{r}"]) < 1e-3


def test_mismatched_sends_fail_not_hang(tmp_path):
    """The failing rank fails the spawn, well inside its join limit."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="Process 1"):
        spawn_ranks(_mismatched_rank, 2, (str(tmp_path),),
                    limit=GROUP_TIMEOUT_S + 30)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S + 30
