"""Port parity for partitioned training on the mesh ring (``train_partitioned``
and the apps' ``forward_partitioned`` with a ``torch.distributed`` process
group; ``launch/mesh.py``) against the JAX package's mesh runs, on the CPU.

* The reference program: one JAX child (8 emulated devices, ROADMAP C1's
  shim first) runs ``tests/launch/test_partitioned_train.py``'s cases —
  GCN, SAGE and GAT ``forward_partitioned`` and the loss's gradients at S
  = 2, 4, 8, ``train_partitioned`` GCN exact (3 epochs) and delayed
  (staleness 2, 4 epochs) at S = 4 — and
  ``test_mixed_precision.py::test_mesh_bf16_int8_train_leg`` (S = 2); it
  pickles the inputs and JAX's initial parameters first, the results
  last.
* The port program: one spawn of ``gloo`` ranks per world size (the
  helpers of ``test_torch_ring_mesh.py``) runs them on the mesh ring
  (plain and kernel routes for the steps) and on the emulated ring; rank
  0 gathers and pickles.
* Held: logits and grads within 2e-4 of JAX and 1e-5 of the emulated
  ring; the losses within 2e-4 (bf16 × int8: 2e-2); the refresh pattern;
  the parameters bit-identical across ranks after training; a run with
  dropout and ``val_acc`` equal to the emulated one; each rank's kernel
  launches per step (counted through the wrappers' plain branches) are
  ``chip_smoke.mesh_launches``; ``make_shard_mesh`` raises with too few
  ranks and builds a sub-group; ``make_mesh`` / ``make_production_mesh``
  on a 512-rank ``fake`` group.
"""
import concurrent.futures
import os
import pickle

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice
from tests.test_torch_ring_mesh import (gather_to_root, init_rank,
                                        spawn_ranks, wait_for_file)

TOL_JAX = 2e-4
TOL_EMU = 1e-5
BF16_TOL = 2e-2
WORLDS = (2, 4, 8)
APPS = ("gcn", "sage", "gat")
ROUTES = ("plain", "kernel")

_JAX_PROG = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax._src import core as _core
if not hasattr(jax.core, "trace_state_clean"):      # ROADMAP C1
    jax.core.trace_state_clean = _core.trace_state_clean
from repro.core import from_coo
from repro.launch.mesh import make_mesh, make_shard_mesh
from repro.models.gnn import gat, gcn, sage
from repro.models.gnn.common import make_partitioned_bundle
from repro.models.gnn.train import train_partitioned
from repro.optim import Precision
from repro.substrate.nn import cross_entropy_loss

out_path, inputs_path = sys.argv[1:3]
tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
apps = {"gcn": gcn, "sage": sage, "gat": gat}

# every input first (graphs, features, JAX's initial parameters), written
# at once: the port runs on them while this program computes its runs
ins = {}
rng = np.random.default_rng(0)
n, nnz, d, nc = 64, 400, 8, 3
src, dst = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
x = rng.normal(size=(n, d)).astype(np.float32)
labels = rng.integers(0, nc, n).astype(np.int32)
mask = rng.random(n) < 0.6
ins["app_data"] = (src, dst, x, labels, mask)
for app, mod in apps.items():
    ins[f"app/{app}/params"] = tree(mod.init(jax.random.PRNGKey(0), d, 8, nc))
rng = np.random.default_rng(0)
src, dst = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
ins["train"] = dict(src=src, dst=dst,
                    x=rng.normal(size=(n, d)).astype(np.float32),
                    labels=rng.integers(0, nc, n), mask=rng.random(n) < 0.6,
                    params=tree(gcn.init(jax.random.PRNGKey(1), d, 8, nc)))
rng = np.random.default_rng(0)
n2, m2, d2, c2 = 80, 400, 16, 4
src, dst = rng.integers(0, n2, m2), rng.integers(0, n2, m2)
ins["bf16"] = dict(src=src, dst=dst,
                   x=rng.standard_normal((n2, d2)).astype(np.float32),
                   labels=rng.integers(0, c2, n2).astype(np.int32),
                   mask=np.ones(n2, bool),
                   params=tree(gcn.init(jax.random.PRNGKey(0), d2, 8, c2)))
with open(inputs_path + ".tmp", "wb") as f:
    pickle.dump(ins, f)
os.replace(inputs_path + ".tmp", inputs_path)

res = {}
src, dst, x, labels, mask = ins["app_data"]
g = from_coo(src, dst, n_src=n, n_dst=n)
for app, mod in apps.items():
    params = jax.tree_util.tree_map(jnp.asarray, ins[f"app/{app}/params"])
    for S in (2, 4, 8):
        pb = make_partitioned_bundle(g, S, mesh=make_shard_mesh(S))
        pg = pb.pg
        xp = pg.scatter_nodes(jnp.asarray(x))
        yp, mp = pg.scatter_nodes(jnp.asarray(labels)), pg.scatter_nodes(
            jnp.asarray(mask))

        def loss(p):
            logits = mod.forward_partitioned(p, pb, xp)[0]
            return cross_entropy_loss(logits, yp, mp), logits
        (_, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        res[f"app/{app}/{S}"] = (np.asarray(logits), tree(grads))


def run(data, **kw):
    g = from_coo(data["src"], data["dst"], n_src=data["x"].shape[0],
                 n_dst=data["x"].shape[0])
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])
    return train_partitioned(gcn.forward_partitioned, params, g, data["x"],
                             data["labels"], data["mask"], **kw)[1]


mesh = make_shard_mesh(4)
hp = run(ins["train"], n_shards=4, mesh=mesh, epochs=3, drop=0.0, seed=0)
hd = run(ins["train"], n_shards=4, mesh=mesh, epochs=4, drop=0.0,
         halo_staleness=2, init_halo_fn=gcn.init_halo, seed=0)
res["train"] = dict(exact=hp["loss"], delayed=hd["loss"],
                    refreshed=hd["refreshed"])
hist = run(ins["bf16"], n_shards=2, mesh=make_mesh((2,), ("data",)),
           epochs=4, precision=Precision.parse("bf16", comm="int8"),
           init_comm_fn=gcn.init_comm)
res["bf16"] = dict(loss=hist["loss"])
with open(out_path, "wb") as f:
    pickle.dump(res, f)
print("TRAIN_MESH_REF_OK")
"""


def _counting():
    """Count each kernel wrapper's plain branch (its CPU stand-in) in
    this process; returns the live counts."""
    from repro_torch.kernels.binary_reduce import ops as br_ops
    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.sddmm import ops as sddmm_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    counts = {}
    for module, name, key in ((spmm_ops, "spmm_plain", "spmm_csr"),
                              (sddmm_ops, "sddmm_plain", "sddmm_csr"),
                              (br_ops, "binary_reduce_plain",
                               "binary_reduce_csr"),
                              (es_ops, "edge_softmax_plain",
                               "edge_softmax_csr")):
        def wrapped(*a, _plain=getattr(module, name), _key=key, **kw):
            counts[_key] = counts.get(_key, 0) + 1
            return _plain(*a, **kw)
        setattr(module, name, wrapped)
    return counts


def _flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]
                     ).numpy()


def _app_step(rank, world, ins, group, counts):
    """Each app's logits and global-loss grads on the mesh ring (both
    routes) and the emulated ring; the kernel route's launches."""
    from chip_smoke import mesh_launches
    from repro_torch.core import from_coo
    from repro_torch.core.partition import rank_plan
    from repro_torch.core.transport import all_reduce_sum
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.common import (from_jax_params,
                                               make_partitioned_bundle,
                                               shard_partitioned,
                                               to_jax_params)
    from repro_torch.models.gnn.train import _mesh_loss
    from repro_torch.substrate.nn import cross_entropy_loss

    src, dst, x, labels, mask = ins["app_data"]
    n = x.shape[0]
    tg = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
    mesh, emu, flags = {}, {}, {}
    for app, mod in (("gcn", gcn), ("sage", sage), ("gat", gat)):
        model = from_jax_params(app, ins[f"app/{app}/params"], device="cpu")
        params = list(model.parameters())
        pb = make_partitioned_bundle(tg, world, mesh=group)
        pg = pb.pg
        whole = [pg.scatter_nodes(torch.from_numpy(a)) for a in
                 (x, labels.astype(np.int64), mask)]
        _, xp, yp, mp = shard_partitioned(pb, *whole)
        plan = rank_plan(pg, group)
        want = mesh_launches(app, sum(b is not None for b in plan.fwd),
                             sum(b is not None for b in plan.bwd))
        for route in ROUTES:
            counts.clear()
            logits = mod.forward_partitioned(model, pb, xp, strategy=route)[0]
            grads = torch.autograd.grad(_mesh_loss(logits, yp, mp, group),
                                        params)
            flags[f"launches/{app}/{world}/{route}/{rank}"] = (
                dict(counts), want if route == "kernel" else {})
            grads = all_reduce_sum(grads, group)
            for p, gr in zip(params, grads):
                p.grad = gr
            mesh[f"{app}/{route}/logits"] = logits.detach().numpy()
            flags[f"{app}/{route}/grads/{rank}"] = to_jax_params(model, True)
            if rank == 0:
                epb = make_partitioned_bundle(tg, world)
                logits = mod.forward_partitioned(model, epb, whole[0],
                                                 strategy=route)[0]
                grads = torch.autograd.grad(cross_entropy_loss(
                    logits, whole[1], whole[2]), params)
                for p, gr in zip(params, grads):
                    p.grad = gr
                emu[f"{app}/{route}/logits"] = logits.detach().numpy()
                emu[f"{app}/{route}/grads"] = to_jax_params(model, True)
    return mesh, emu, flags


def _train_runs(rank, world, ins, group):
    """``train_partitioned`` on the mesh and emulated: JAX's exact and
    delayed GCN runs (S = 4) with a dropout run; the bf16 × int8 leg
    (S = 2)."""
    from repro_torch.core import from_coo
    from repro_torch.models.gnn import gcn
    from repro_torch.models.gnn.common import from_jax_params
    from repro_torch.models.gnn.train import train_partitioned
    from repro_torch.optim import Precision

    out = {}

    def run(case, data, **kw):
        model = from_jax_params("gcn", data["params"], device="cpu")
        src, dst = data["src"], data["dst"]
        n = data["x"].shape[0]
        g = from_coo(src, dst, n_src=n, n_dst=n, device="cpu")
        args = (gcn.forward_partitioned, model, g, data["x"],
                data["labels"], data["mask"])
        _, hm = train_partitioned(*args, n_shards=world, mesh=group, **kw)
        out[f"{case}/mesh/{rank}"] = (hm, _flat_params(model))
        if rank == 0:
            model = from_jax_params("gcn", data["params"], device="cpu")
            _, he = train_partitioned(gcn.forward_partitioned, model, g,
                                      *args[3:], n_shards=world, **kw)
            out[f"{case}/emu"] = (he, _flat_params(model))

    if world == 4:
        data = ins["train"]
        run("exact", data, epochs=3, drop=0.0, seed=0)
        run("delayed", data, epochs=4, drop=0.0, halo_staleness=2,
            init_halo_fn=gcn.init_halo, seed=0)
        run("dropout", data, epochs=3, drop=0.5, seed=3,
            val_mask=~data["mask"])
    if world == 2:
        run("bf16", ins["bf16"], epochs=4,
            precision=Precision.parse("bf16", comm="int8"),
            init_comm_fn=gcn.init_comm)
    return out


def _mesh_checks(rank, world, group) -> dict:
    """``make_shard_mesh``: too few ranks raise; fewer than the world is a
    sub-group of the first ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_shard_mesh

    out = {}
    try:
        make_shard_mesh(world + 1)
    except RuntimeError as e:
        out[f"too_few/{rank}"] = str(e)
    if world == 4:
        sub = make_shard_mesh(2)
        out[f"sub/{rank}"] = (dist.get_world_size(sub) if rank < 2
                              else None)
    assert make_shard_mesh(world) is dist.group.WORLD
    return out


def _train_rank(rank: int, world: int, root: str, inputs_path: str) -> None:
    import torch.distributed as dist

    counts = _counting()
    group = init_rank(rank, world, root)
    try:
        with open(inputs_path, "rb") as f:
            ins = pickle.load(f)
        mesh, emu, flags = _app_step(rank, world, ins, group, counts)
        flags.update(_train_runs(rank, world, ins, group))
        flags.update(_mesh_checks(rank, world, group))
        blocks = gather_to_root(group, mesh)
        flags = gather_to_root(group, flags)
        if rank == 0:
            out = {"mesh": {k: np.concatenate([b[k] for b in blocks])
                            for k in blocks[0]},
                   "emu": emu, "flags": {k: v for f in flags
                                         for k, v in f.items()}}
            with open(os.path.join(root, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _fake_mesh_rank(rank: int, root: str) -> None:
    """``make_mesh`` / ``make_production_mesh`` on a 512-rank ``fake``
    group (this process is rank 3)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=512)
    try:
        m = make_mesh((16, 16), ("data", "model"), device="cpu")
        p = make_production_mesh(multi_pod=True, device="cpu")
        with open(os.path.join(root, "fake.pkl"), "wb") as f:
            pickle.dump({"shape": tuple(m.shape),
                         "names": tuple(m.mesh_dim_names),
                         "coord": tuple(m.get_coordinate()),
                         "pod_shape": tuple(p.shape),
                         "pod_names": tuple(p.mesh_dim_names)}, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh results and, per world size, the port's (the port's
    spawns run on the JAX child's inputs while it computes its runs)."""
    root = tmp_path_factory.mktemp("train_mesh")
    ref_path, inputs_path = str(root / "jax.pkl"), str(root / "inputs.pkl")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(run_multidevice, _JAX_PROG, ref_path, inputs_path)
        wait_for_file(inputs_path, child)
        port = {}
        for world in WORLDS:
            d = root / f"s{world}"
            d.mkdir()
            spawn_ranks(_train_rank, world, (world, str(d), inputs_path))
            with open(d / "port.pkl", "rb") as f:
                port[world] = pickle.load(f)
        r = child.result()
    assert r.returncode == 0, r.stderr[-3000:]
    with open(ref_path, "rb") as f:
        return pickle.load(f), port


def _leaves(tree, path=""):
    """(path, array) of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaves(t, f"{path}.{i}")]
    return [(path, np.asarray(tree))]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _close_tree(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("app", APPS)
def test_forward_and_grads_match_jax_mesh(runs, app, world):
    """``_APP_PROG``: the padded logits and the loss's gradients, on every
    rank the global ones."""
    ref, port = runs
    p = port[world]
    logits, grads = ref[f"app/{app}/{world}"]
    for route in ROUTES:
        got = p["mesh"][f"{app}/{route}/logits"]
        _close(got, logits, TOL_JAX)
        _close(got, p["emu"][f"{app}/{route}/logits"], TOL_EMU)
        for r in range(world):
            g = p["flags"][f"{app}/{route}/grads/{r}"]
            _close_tree(g, grads, TOL_JAX)
            _close_tree(g, p["emu"][f"{app}/{route}/grads"], TOL_EMU)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("app", APPS)
def test_step_launches_per_rank(runs, app, world):
    flags = runs[1][world]["flags"]
    for route in ROUTES:
        for r in range(world):
            got, want = flags[f"launches/{app}/{world}/{route}/{r}"]
            assert got == want, (route, r)


def _hist(port, world, case, r):
    return port[world]["flags"][f"{case}/mesh/{r}"]


@pytest.mark.parametrize("case", ["exact", "delayed"])
def test_train_partitioned_matches_jax_mesh(runs, case):
    """``_TRAIN_PROG`` at S = 4: GCN's losses per epoch, the refresh
    pattern, and the run equal to the emulated one."""
    ref, port = runs
    want = ref["train"][case]
    emu, _ = port[4]["flags"][f"{case}/emu"]
    for r in range(4):
        hist, _ = _hist(port, 4, case, r)
        _close(hist["loss"], want, TOL_JAX)
        _close(hist["loss"], emu["loss"], TOL_EMU)
        assert hist["refreshed"] == emu["refreshed"]
    if case == "delayed":
        assert hist["refreshed"] == ref["train"]["refreshed"] == [
            True, False, True, False]


@pytest.mark.parametrize("case,world", [("exact", 4), ("delayed", 4),
                                        ("dropout", 4), ("bf16", 2)])
def test_parameters_equal_across_ranks(runs, case, world):
    port = runs[1]
    first = _hist(port, world, case, 0)[1]
    for r in range(1, world):
        np.testing.assert_array_equal(_hist(port, world, case, r)[1], first)
    emu = port[world]["flags"][f"{case}/emu"][1]
    _close(first, emu, BF16_TOL if case == "bf16" else TOL_EMU)


def test_dropout_run_equals_emulated(runs):
    """With ``drop > 0`` each rank keeps its rows of the whole layout's
    mask: the losses and ``val_acc`` are the emulated run's."""
    port = runs[1]
    emu, _ = port[4]["flags"]["dropout/emu"]
    for r in range(4):
        hist, _ = _hist(port, 4, "dropout", r)
        _close(hist["loss"], emu["loss"], TOL_EMU)
        assert hist["val_acc"] == emu["val_acc"]


def test_bf16_int8_leg_matches_jax_mesh(runs):
    """``test_mesh_bf16_int8_train_leg`` (S = 2, 4 epochs): the losses
    within 2e-2 of JAX's mesh run, falling."""
    ref, port = runs
    for r in range(2):
        hist, params = _hist(port, 2, "bf16", r)
        _close(hist["loss"], ref["bf16"]["loss"], BF16_TOL)
        assert hist["loss"][-1] < hist["loss"][0]
        assert np.isfinite(params).all()


def test_make_shard_mesh(runs):
    port = runs[1]
    for world in WORLDS:
        for r in range(world):
            msg = port[world]["flags"][f"too_few/{r}"]
            assert f"needs {world + 1} ranks, have {world}" in msg
            assert "torchrun" in msg
    assert [port[4]["flags"][f"sub/{r}"] for r in range(4)] == [
        2, 2, None, None]


def test_make_mesh_on_a_fake_group(tmp_path):
    spawn_ranks(_fake_mesh_rank, 1, (str(tmp_path),), limit=120)
    with open(tmp_path / "fake.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["shape"] == (16, 16) and got["names"] == ("data", "model")
    assert got["coord"] == (0, 3)
    assert got["pod_shape"] == (2, 16, 16)
    assert got["pod_names"] == ("pod", "data", "model")
