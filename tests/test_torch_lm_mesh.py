"""Port parity for one LM over a process mesh (``repro_torch.launch.steps``'
mesh step, ``checkpoint/manager.py``'s mesh save and sharded restore, the
train CLI's ``--mesh``) against the JAX package's mesh runs, on the CPU.

* The reference: one JAX child (``tests/conftest.run_multidevice``, 8
  emulated devices) writes every case's initial parameters first, then
  runs JAX's ``_SHARDED_TRAIN_PROG`` steps on a (2, 4) mesh — qwen2,
  granite-MoE and zamba2 smoke, 3 steps at B = 4, S = 32, and granite
  with ``microbatch=2`` — and the elastic case: llama saved after 2
  steps on (2, 4), restored onto (4, 2) and stepped; then it waits for
  the port's (2, 4) checkpoint and restores that onto (4, 2) too.
* The port: one ``torch.multiprocessing`` spawn of 8 ``gloo`` ranks per
  mesh (``init_method="file://…"``, a 60 s group timeout, joined under a
  limit; ``tests/test_torch_ring_mesh.py``'s harness), run meanwhile.
  (2, 4): the same cases from JAX's parameters, llama's checkpoint, and
  ``train.main(["--mesh", "2x4", ...])`` twice (the second resumes).
  (4, 2): the port's and JAX's checkpoints restored, one step each.
* Held: losses within 1e-5 and grad norms within 1e-4 relative of JAX's
  mesh run; the gathered params, μ and ν within ``test_train_steps_
  match_jax``'s bounds; every two ranks holding the same chunk of a leaf
  hold the same bits (replicated leaves bit-equal on every rank); each
  rank's state bytes equal the sum of JAX's ``shard_shape`` bytes; the
  restores land with ``data == 4`` and their next loss is JAX's restored
  loss (1e-5), both ways across packages; ``full_tensors`` (the
  transport's gathers) equals DTensor's own ``full_tensor``; a rank that
  leaves its peers mid-step fails the spawn within the group timeout.
"""
import concurrent.futures
import os
import pickle
import time

import numpy as np
import pytest
import torch

from tests.conftest import run_multidevice
from tests.test_torch_ring_mesh import (GROUP_TIMEOUT_S, gather_to_root,
                                        init_rank, spawn_ranks,
                                        wait_for_file)

CASES = [("qwen2_7b", 1), ("granite_moe_3b", 1), ("granite_moe_3b", 2),
         ("zamba2_2p7b", 1)]
ELASTIC = "llama3p2_3b"
B, S, STEPS = 4, 32, 3
LR = 3e-4

_JAX_PROG = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import CheckpointManager
from repro.configs import get_smoke_config
from repro.launch import shardings as SR
from repro.launch.mesh import make_mesh
from repro.launch.steps import TrainState, init_state, make_train_step
from repro.launch.train import synthetic_batch
from repro.pjit_utils import ambient_mesh

out_path, inputs_path, ckpt_root = sys.argv[1:4]
CASES = [("qwen2_7b", 1), ("granite_moe_3b", 1), ("granite_moe_3b", 2),
         ("zamba2_2p7b", 1)]
ELASTIC = "llama3p2_3b"
meshes = {s: make_mesh(s, ("data", "model")) for s in ((2, 4), (4, 2))}


def put(res, prefix, tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(res, prefix, v, path + (k,))
    else:
        res[prefix + "/" + "/".join(path)] = np.asarray(tree)


init = jax.jit(init_state, static_argnums=1)


def placed(cfg, mesh):
    state = init(jax.random.PRNGKey(0), cfg)
    specs = SR.param_specs(state.params, cfg, mesh)
    sh = SR.to_named(TrainState(specs, specs, specs, P()), mesh)
    return state, sh


ins, res = {}, {}
for arch in sorted({a for a, _ in CASES} | {ELASTIC}):
    cfg = get_smoke_config(arch)
    state, _ = placed(cfg, meshes[(2, 4)])
    put(ins, arch + "/params", state.params)
    for shape, mesh in meshes.items():
        _, sh = placed(cfg, mesh)
        nbytes = 0
        for p, s in zip(jax.tree.leaves(state.params),
                        jax.tree.leaves(sh.params)):
            n = int(np.prod(s.shard_shape(p.shape)))
            nbytes += n * p.dtype.itemsize + 2 * n * 4
        ins[f"{arch}/bytes/{shape[0]}x{shape[1]}"] = np.asarray(nbytes)
np.savez(inputs_path + ".tmp.npz", **ins)
os.replace(inputs_path + ".tmp.npz", inputs_path)   # whole when it appears

mesh = meshes[(2, 4)]
for arch, mb in CASES:
    cfg = get_smoke_config(arch)
    state, sh = placed(cfg, mesh)
    state = jax.device_put(state, sh)
    step = jax.jit(make_train_step(cfg, microbatch=mb), donate_argnums=(0,))
    losses, gnorms = [], []
    with ambient_mesh(mesh):
        for i in range(3):
            state, m = step(state, synthetic_batch(cfg, i, 4, 32))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    key = f"{arch}/{mb}"
    res[key + "/losses"] = np.asarray(losses)
    res[key + "/gnorms"] = np.asarray(gnorms)
    for f in ("params", "mu", "nu"):
        put(res, f"{key}/{f}", getattr(state, f))

# the elastic restart: save on (2, 4), restore onto (4, 2), one step
cfg = get_smoke_config(ELASTIC)
state, sh = placed(cfg, mesh)
state = jax.device_put(state, sh)
step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
with ambient_mesh(mesh):
    for i in range(2):
        state, m = step(state, synthetic_batch(cfg, i, 4, 32))
CheckpointManager(os.path.join(ckpt_root, "jax")).save(state, 2)


def restore_and_step(directory):
    template, sh = placed(cfg, meshes[(4, 2)])
    state, n = CheckpointManager(directory).restore_latest(template,
                                                           shardings=sh)
    assert n == 2
    assert state.params["blocks"]["attn"]["wq"].sharding.mesh.shape[
        "data"] == 4
    step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
    with ambient_mesh(meshes[(4, 2)]):
        _, m = step(state, synthetic_batch(cfg, 2, 4, 32))
    return float(m["loss"])


res["elastic/jax_on_jax"] = np.asarray(restore_and_step(
    os.path.join(ckpt_root, "jax")))
done = os.path.join(ckpt_root, "port", "step_2", "manifest.json")
deadline = time.monotonic() + 600
while not os.path.exists(done):
    if os.path.exists(os.path.join(ckpt_root, "abort")):
        sys.exit("the port's run failed: no checkpoint to restore")
    assert time.monotonic() < deadline, "no port checkpoint"
    time.sleep(0.2)
res["elastic/port_on_jax"] = np.asarray(restore_and_step(
    os.path.join(ckpt_root, "port")))
np.savez(out_path, **res)
print("LM_MESH_REF_OK")
"""


def _tree(flat: dict, prefix: str) -> dict:
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        *path, leaf = k[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    return [("/".join(path), tree)]


# --------------------------------------------------------------------- #
# the port's ranks
# --------------------------------------------------------------------- #
def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), device="cpu")


def _state(cfg, ins, arch, mesh):
    from repro_torch.launch import steps
    from repro_torch.models.lm import model as T

    model = T.from_jax_params(cfg, _tree(ins, arch + "/params"), "cpu")
    return steps.state_of(model, mesh)


def _chunks(state, mesh) -> dict:
    """Per leaf of the state tree: (this rank's coordinates on the mesh
    dims sharding it, its local shard)."""
    from repro_torch.launch import steps

    coord = mesh.get_coordinate()
    tree = steps.state_tree(state)
    return {f"{f}/{name}": (tuple(c for c, p in zip(coord, leaf.placements)
                                  if p.is_shard()),
                            leaf.to_local().numpy().copy())
            for f in ("params", "mu", "nu")
            for name, leaf in _leaves(getattr(tree, f))}


def _gathered(state) -> dict:
    from repro_torch.launch import steps
    from repro_torch.pjit_utils import full_tensors

    tree = steps.state_tree(state)
    return {f"{f}/{name}": full_tensors([leaf])[0].numpy()
            for f in ("params", "mu", "nu")
            for name, leaf in _leaves(getattr(tree, f))}


def _rank_24(rank: int, root: str, inputs_path: str, ckpt: str) -> None:
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.pjit_utils import ambient_mesh, full_tensors, shard_hint

    group = init_rank(rank, 8, root)
    try:
        ins = dict(np.load(inputs_path))
        mesh = _mesh((2, 4))
        out, flags = {}, {"rank": rank}
        for arch, mb in CASES:
            cfg = get_smoke_config(arch)
            state = _state(cfg, ins, arch, mesh)
            flags[f"{arch}/bytes"] = steps.state_bytes(state)
            step = steps.make_train_step(cfg, microbatch=mb, lr=LR,
                                         mesh=mesh)
            losses, gnorms = [], []
            with ambient_mesh(mesh):
                for i in range(STEPS):
                    state, m = step(state, train.synthetic_batch(
                        cfg, i, B, S, device="cpu"))
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
            key = f"{arch}/{mb}"
            flags[key + "/losses"] = losses
            flags[key + "/gnorms"] = gnorms
            flags[key + "/chunks"] = _chunks(state, mesh)
            for name, t in _gathered(state).items():
                out[f"{key}/{name}"] = t
        # DTensor's own gathers agree with the transport's
        leaf = next(iter(state.params.parameters()))
        flags["dtensor_full_equal"] = bool(torch.equal(
            leaf.full_tensor(), full_tensors([leaf])[0]))
        with ambient_mesh(mesh):
            hinted = shard_hint(leaf, "data", None)
        flags["hint_placements"] = str(hinted.placements)
        flags["hint_values_equal"] = bool(torch.equal(
            hinted.full_tensor(), leaf.full_tensor()))
        # llama: two steps on (2, 4), then the checkpoint
        cfg = get_smoke_config(ELASTIC)
        state = _state(cfg, ins, ELASTIC, mesh)
        step = steps.make_train_step(cfg, lr=LR, mesh=mesh)
        with ambient_mesh(mesh):
            for i in range(2):
                state, _ = step(state, train.synthetic_batch(
                    cfg, i, B, S, device="cpu"))
        CheckpointManager(os.path.join(ckpt, "port")).save(
            steps.state_tree(state), 2)
        # the CLI: three steps, then a resume to five
        argv = ["--arch", ELASTIC, "--smoke", "--mesh", "2x4", "--device",
                "cpu", "--batch", "4", "--seq", "16", "--ckpt-every", "2",
                "--log-every", "100", "--ckpt-dir",
                os.path.join(root, "cli")]
        first = train.main(argv + ["--steps", "3"])
        second = train.main(argv + ["--steps", "5"])
        flags["cli"] = (first["start_step"], first["losses"],
                        second["start_step"], second["losses"])
        flags = gather_to_root(group, flags)
        if rank == 0:
            with open(os.path.join(root, "flags24.pkl"), "wb") as f:
                pickle.dump(flags, f)
            np.savez(os.path.join(root, "port24.npz"), **out)
    finally:
        dist.destroy_process_group()


def _rank_42(rank: int, root: str, inputs_path: str, ckpt: str) -> None:
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.pjit_utils import ambient_mesh, axis_sizes

    group = init_rank(rank, 8, root)
    try:
        mesh = _mesh((4, 2))
        cfg = get_smoke_config(ELASTIC)
        flags = {}
        shardings = steps.state_placements(steps.eval_param_shapes(cfg), cfg,
                                           mesh)
        for who in ("port", "jax"):
            state = steps.init_state(cfg, seed=1, device="cpu", mesh=mesh)
            tree, n = CheckpointManager(os.path.join(
                ckpt, who)).restore_latest(
                    steps.state_tree(state), mesh=mesh, shardings=shardings)
            state = steps.load_state_tree(state, tree)
            wq = tree.params["blocks"]["attn"]["wq"]
            flags[f"{who}/restored"] = (n, state.step, axis_sizes(
                wq.device_mesh)["data"], steps.state_bytes(state))
            with ambient_mesh(mesh):
                _, m = steps.make_train_step(cfg, lr=LR, mesh=mesh)(
                    state, train.synthetic_batch(cfg, 2, B, S, device="cpu"))
            flags[f"{who}/loss"] = float(m["loss"])
        flags = gather_to_root(group, flags)
        if rank == 0:
            with open(os.path.join(root, "flags42.pkl"), "wb") as f:
                pickle.dump(flags, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh results and the port's two spawns: the JAX child writes
    the parameters first; the spawns run on them meanwhile."""
    root = tmp_path_factory.mktemp("lm_mesh")
    ref_path, inputs_path = str(root / "jax.npz"), str(root / "inputs.npz")
    os.makedirs(root / "ckpt")
    ckpt = str(root / "ckpt")
    d24, d42 = root / "m24", root / "m42"
    d24.mkdir()
    d42.mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(run_multidevice, _JAX_PROG, ref_path, inputs_path,
                            ckpt)
        try:
            wait_for_file(inputs_path, child)
            spawn_ranks(_rank_24, 8, (str(d24), inputs_path, ckpt))
            wait_for_file(os.path.join(ckpt, "jax", "step_2", "manifest.json"),
                          child)
            spawn_ranks(_rank_42, 8, (str(d42), inputs_path, ckpt))
        except BaseException:
            open(os.path.join(ckpt, "abort"), "w").close()   # free the child
            raise
        r = child.result()
    assert r.returncode == 0, r.stderr[-3000:]
    return {"ref": dict(np.load(ref_path)), "ins": dict(np.load(inputs_path)),
            "port": dict(np.load(d24 / "port24.npz")),
            "flags24": _unpickle(d24 / "flags24.pkl"),
            "flags42": _unpickle(d42 / "flags42.pkl")}


def _unpickle(path):
    """Rank 0's gathered flags (written by this test's own ranks)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _close(got, ref, what, slack=0.0):
    """test_train_steps_match_jax's bound: 1e-4·max|JAX| + 1e-6 (+ the
    params' ``slack``)."""
    ref = np.asarray(ref)
    err = float(np.abs(got - ref).max(initial=0.0))
    tol = 1e-4 * float(np.abs(ref).max(initial=0.0)) + 1e-6 + slack
    assert err <= tol, f"{what}: max err {err:.3g} > tol {tol:.3g}"


@pytest.mark.parametrize("arch,mb", CASES)
def test_mesh_steps_match_jax_mesh(runs, arch, mb):
    key = f"{arch}/{mb}"
    ref = runs["ref"]
    for flags in runs["flags24"]:
        np.testing.assert_allclose(flags[key + "/losses"],
                                   ref[key + "/losses"], rtol=1e-5)
        np.testing.assert_allclose(flags[key + "/gnorms"],
                                   ref[key + "/gnorms"], rtol=1e-4)
    moved = 1e-2 * LR * STEPS     # as test_train_steps_match_jax's
    for f in ("params", "mu", "nu"):
        want = _leaves(_tree(ref, f"{key}/{f}"))
        for name, r in want:
            got = runs["port"][f"{key}/{f}/{name}"]
            _close(got, r, f"{key} {f} {name}",
                   moved * (f == "params"))


@pytest.mark.parametrize("arch,mb", CASES)
def test_each_rank_holds_its_shard(runs, arch, mb):
    """Ranks holding the same chunk of a leaf hold the same bits; each
    rank's state bytes are the sum of JAX's shard shapes' bytes."""
    ranks = runs["flags24"]
    assert [f["rank"] for f in ranks] == list(range(8))
    want = int(runs["ins"][f"{arch}/bytes/2x4"])
    assert all(f[f"{arch}/bytes"] == want for f in ranks)
    chunks = [f[f"{arch}/{mb}/chunks"] for f in ranks]
    for name in chunks[0]:
        first = {}
        for c in chunks:
            key, local = c[name]
            if key in first:
                assert np.array_equal(local, first[key]), (name, key)
            first.setdefault(key, local)
    # a replicated leaf (a norm scale) has one chunk: every rank's bits
    assert any(len(v) == 1 for v in [
        {c[name][0] for c in chunks} for name in chunks[0]])


def test_dtensor_gathers_and_hints_agree(runs):
    for f in runs["flags24"]:
        assert f["dtensor_full_equal"] and f["hint_values_equal"]
        assert "Shard(dim=0)" in f["hint_placements"]


def test_elastic_restore_both_ways(runs):
    """(2, 4) → (4, 2): the port's checkpoint in the port and in JAX, and
    JAX's in the port, each step 3's loss = JAX's restored loss."""
    want = float(runs["ref"]["elastic/jax_on_jax"])
    np.testing.assert_allclose(float(runs["ref"]["elastic/port_on_jax"]),
                               want, rtol=1e-5)
    nbytes = int(runs["ins"][f"{ELASTIC}/bytes/4x2"])
    for f in runs["flags42"]:
        for who in ("port", "jax"):
            assert f[f"{who}/restored"] == (2, 2, 4, nbytes)
            np.testing.assert_allclose(f[f"{who}/loss"], want, rtol=1e-5)


def test_train_cli_mesh_runs_and_resumes(runs):
    for f in runs["flags24"]:
        start1, losses1, start2, losses2 = f["cli"]
        assert (start1, len(losses1), start2, len(losses2)) == (0, 3, 3, 2)
        assert np.isfinite(losses1 + losses2).all()
    assert len({tuple(f["cli"][1] + f["cli"][3])
                for f in runs["flags24"]}) == 1


def _leaving_rank(rank: int, root: str) -> None:
    """Rank 1 takes one mesh step more than rank 0, which then leaves the
    group: rank 1's gathers never complete, and its run fails (at the
    latest at the group's timeout)."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pjit_utils import ambient_mesh

    init_rank(rank, 2, root)
    cfg = get_smoke_config(ELASTIC)
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    state = steps.init_state(cfg, device="cpu", mesh=mesh)
    step = steps.make_train_step(cfg, mesh=mesh)
    with ambient_mesh(mesh):
        for i in range(1 + rank):
            state, _ = step(state, train.synthetic_batch(cfg, i, 2, 8,
                                                         device="cpu"))
    dist.destroy_process_group()


def test_a_rank_left_behind_fails_not_hangs(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="Process 1"):
        spawn_ranks(_leaving_rank, 2, (str(tmp_path),),
                    limit=GROUP_TIMEOUT_S + 30)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S + 30
