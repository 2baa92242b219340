"""Port parity for LM serving over a process mesh (``repro_torch.launch.
steps``' ``make_prefill_step`` / ``make_decode_step`` with ``mesh=``,
``init_mesh_cache``, ``reshard_cache``) against JAX's prefill and decode
jitted with ``param_specs`` / ``cache_specs`` shardings, on the CPU.

* The reference: one JAX child (``tests/conftest.run_multidevice``, 8
  emulated devices) writes each case's parameters (and whisper's encoder
  memory) first, then on a (2, 4) mesh under the ambient mesh runs, as
  JAX's dry run builds them, the prefill jitted with the prefill cache
  specs and ``DECODE_STEPS`` decode steps with the decode specs (JAX
  reshards the cache between), greedy; it records the logits, the
  tokens, the cache after prefill, and one device's cache bytes under
  each spec (``NamedSharding.shard_shape``).
* The port: one spawn of 8 ``gloo`` ranks as a (2, 4) mesh (``tests/
  test_torch_ring_mesh.py``'s harness) runs llama, mixtral (MoE and a
  sliding window), whisper (enc-dec) and mamba2 smoke from JAX's
  parameters: the mesh prefill, ``reshard_cache(kind="decode")``, and the
  decode steps on JAX's tokens.
* Held: the logits within ``test_torch_lm.py``'s 1e-4·max|JAX| + 1e-6,
  the greedy tokens equal, the gathered cache after prefill within the
  same bound, each rank holding exactly its cache shard's bytes under
  each spec; and the mesh train step's label check still raises on a
  real batch with masked labels.
"""
import concurrent.futures
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.launch.steps import named_leaves
from tests.conftest import run_multidevice
from tests.test_torch_ring_mesh import (gather_to_root, init_rank,
                                        spawn_ranks, wait_for_file)

ARCHS = ("llama3p2_3b", "mixtral_8x22b", "whisper_medium", "mamba2_1p3b")
B, S, MAX, DECODE_STEPS = 4, 8, 16, 4

_JAX_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch import shardings as SR
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models.lm import model as J
from repro.pjit_utils import ambient_mesh

out_path, inputs_path = sys.argv[1:3]
ARCHS = ("llama3p2_3b", "mixtral_8x22b", "whisper_medium", "mamba2_1p3b")
B, S, MAX, STEPS = 4, 8, 16, 4
mesh = make_mesh((2, 4), ("data", "model"))


def put(res, prefix, tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(res, prefix, v, path + (k,))
    else:
        res[prefix + "/" + "/".join(path)] = np.asarray(tree)


def shard_bytes(tree, specs):
    n = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        shp = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        n += int(np.prod(shp)) * leaf.dtype.itemsize
    return n


ins, cases = {}, {}
rng = np.random.default_rng(0)
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = jax.jit(J.init_params, static_argnums=1,
                     static_argnames="max_seq")(jax.random.PRNGKey(0), cfg,
                                                max_seq=MAX)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    put(ins, arch + "/params", params)
    ins[arch + "/tokens"] = tokens
    extras = {}
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        extras["memory"] = jax.jit(lambda p, f: J.encode(p, cfg, f))(
            params, jnp.asarray(frames))
        ins[arch + "/memory"] = np.asarray(extras["memory"])
    cases[arch] = (cfg, params, tokens, extras)
np.savez(inputs_path + ".tmp.npz", **ins)
os.replace(inputs_path + ".tmp.npz", inputs_path)   # whole when it appears

res = {}
for arch, (cfg, params, tokens, extras) in cases.items():
    pspecs = SR.param_specs(params, cfg, mesh)
    cache = J.init_cache(cfg, B, MAX, jnp.float32)
    specs = {k: SR.cache_specs(cfg, mesh, batch_size=B, seq_len=MAX, kind=k)
             for k in ("prefill", "decode")}
    for k, sp in specs.items():
        res[f"{arch}/bytes/{k}"] = np.asarray(shard_bytes(cache, sp))
    bspec = {k: SR.batch_specs(cfg, k, mesh, batch_size=B)
             for k in ("prefill", "decode")}
    ex_spec = {}
    if "memory" in extras:
        ex_spec["memory"] = SR._to_spec(
            mesh, (SR._data_if_divisible(mesh, B), None, None))
    with mesh, ambient_mesh(mesh):
        prefill = jax.jit(
            make_prefill_step(cfg),
            in_shardings=(SR.to_named(pspecs, mesh),
                          SR.to_named(bspec["prefill"]["tokens"], mesh),
                          SR.to_named(specs["prefill"], mesh),
                          SR.to_named(ex_spec, mesh)),
            out_shardings=(None, SR.to_named(specs["prefill"], mesh)),
            donate_argnums=(2,))
        decode = jax.jit(
            make_decode_step(cfg),
            in_shardings=(SR.to_named(pspecs, mesh),
                          SR.to_named(bspec["decode"]["tokens"], mesh),
                          SR.to_named(specs["decode"], mesh),
                          SR.to_named(P(), mesh), SR.to_named({}, mesh)),
            out_shardings=(None, SR.to_named(specs["decode"], mesh)),
            donate_argnums=(2,))
        logits, cache = prefill(params, jnp.asarray(tokens), cache, extras)
        put(res, arch + "/cache", cache)
        res[arch + "/logits/0"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        cache = jax.device_put(cache, SR.to_named(specs["decode"], mesh))
        for i in range(STEPS):
            logits, cache = decode(params, tok, cache, jnp.asarray(S + i), {})
            res[f"{arch}/logits/{i + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        res[arch + "/tokens"] = np.stack(toks)
np.savez(out_path + ".tmp.npz", **res)
os.replace(out_path + ".tmp.npz", out_path)   # whole when it appears
print("LM_SERVE_MESH_REF_OK")
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


def _rank(rank: int, root: str, inputs_path: str, ref_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import model as T
    from repro_torch.pjit_utils import ambient_mesh, full_tensors

    group = init_rank(rank, 8, root)
    try:
        ins = dict(np.load(inputs_path))
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        out, flags, ref = {}, {"rank": rank}, {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            model = T.from_jax_params(cfg, _tree(ins, arch + "/params"),
                                      "cpu")
            steps.shard_model(model, mesh)
            cache = steps.init_mesh_cache(cfg, B, MAX, torch.float32, mesh,
                                          kind="prefill", device="cpu")
            flags[arch + "/bytes/prefill"] = steps.cache_bytes(cache)
            extras = {}
            if arch + "/memory" in ins:
                extras["memory"] = torch.from_numpy(ins[arch + "/memory"])
            logits, cache = steps.make_prefill_step(cfg, mesh=mesh)(
                model, torch.from_numpy(ins[arch + "/tokens"]), cache,
                extras)
            out[arch + "/logits/0"] = full_tensors([logits])[0].numpy()
            names, leaves = zip(*steps.named_leaves(cache))
            for name, leaf in zip(names, full_tensors(leaves)):
                out[f"{arch}/cache/{name}"] = leaf.numpy().copy()
            cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
            flags[arch + "/bytes/decode"] = steps.cache_bytes(cache)
            decode = steps.make_decode_step(cfg, mesh=mesh)
            if not ref:     # JAX's greedy tokens, fed to both
                wait_for_file(ref_path, _NoChild())
                ref = dict(np.load(ref_path))
            toks = ref[arch + "/tokens"]
            got = [full_tensors([logits])[0].argmax(-1).numpy()]
            for i in range(DECODE_STEPS):
                logits, cache = decode(model, torch.from_numpy(toks[i]),
                                       cache, torch.tensor(S + i), {})
                full = full_tensors([logits])[0]
                out[f"{arch}/logits/{i + 1}"] = full.numpy()
                got.append(full.argmax(-1).numpy())
            flags[arch + "/tokens"] = np.stack(got)
        # the mesh train step still refuses masked labels on a real batch
        cfg = get_smoke_config("llama3p2_3b")
        state = steps.init_state(cfg, device="cpu", mesh=mesh)
        batch = train.synthetic_batch(cfg, 0, B, S, device="cpu")
        batch["labels"][0, 0] = -1
        try:
            with ambient_mesh(mesh):
                steps.make_train_step(cfg, mesh=mesh)(state, batch)
            flags["masked_labels"] = "accepted"
        except ValueError as e:
            flags["masked_labels"] = str(e)
        flags = gather_to_root(group, flags)
        if rank == 0:
            with open(os.path.join(root, "flags.pkl"), "wb") as f:
                pickle.dump(flags, f)
            np.savez(os.path.join(root, "port.npz"), **out)
    finally:
        dist.destroy_process_group()


class _NoChild:
    """``wait_for_file``'s child stand-in inside a rank (the JAX child is
    the parent's; the parent's limit covers it)."""

    def done(self):
        return False


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_serve_mesh")
    ref_path, inputs_path = str(root / "jax.npz"), str(root / "inputs.npz")
    ranks = root / "ranks"
    ranks.mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(run_multidevice, _JAX_PROG, ref_path, inputs_path)
        wait_for_file(inputs_path, child)
        try:
            spawn_ranks(_rank, 8, (str(ranks), inputs_path, ref_path))
        finally:
            r = child.result()
    assert r.returncode == 0, r.stderr[-3000:]
    with open(ranks / "flags.pkl", "rb") as f:
        flags = pickle.load(f)
    return {"ref": dict(np.load(ref_path)), "flags": flags,
            "port": dict(np.load(ranks / "port.npz"))}


def _close(got, ref, what):
    """test_torch_lm.py's bound: 1e-4·max|JAX| + 1e-6."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max(initial=0.0))
    tol = 1e-4 * float(np.abs(ref).max(initial=0.0)) + 1e-6
    assert err <= tol, f"{what}: max err {err:.3g} > tol {tol:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_decode_match_jax(runs, arch):
    ref, port = runs["ref"], runs["port"]
    for i in range(DECODE_STEPS + 1):
        _close(port[f"{arch}/logits/{i}"], ref[f"{arch}/logits/{i}"],
               f"{arch} logits {i}")
    for name, want in named_leaves(_tree(ref, arch + "/cache")):
        _close(port[f"{arch}/cache/{name}"], want, f"{arch} cache {name}")
    for f in runs["flags"]:
        np.testing.assert_array_equal(f[arch + "/tokens"],
                                      ref[arch + "/tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_cache_shard(runs, arch):
    flags = runs["flags"]
    assert [f["rank"] for f in flags] == list(range(8))
    for kind in ("prefill", "decode"):
        want = int(runs["ref"][f"{arch}/bytes/{kind}"])
        assert all(f[f"{arch}/bytes/{kind}"] == want for f in flags), kind


def test_mesh_train_step_refuses_masked_labels(runs):
    for f in runs["flags"]:
        assert "masked (negative) labels" in f["masked_labels"]
