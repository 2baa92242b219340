"""Port parity for the model axis's compute split (``repro_torch.models.lm.
tp``: Megatron TP and context-parallel attention, the sequence-parallel
residual, the vocab-parallel embedding / head / CE) in the
mesh train, prefill and decode steps, against JAX's (2, 4) mesh runs, on
the CPU.

* The reference: one JAX child (``tests/conftest.run_multidevice``, 8
  emulated devices) writes each case's parameters first, then runs on a
  (2, 4) mesh under the ambient mesh: ``TRAIN_STEPS`` jitted train steps
  of the smoke configs of llama3.2 (3 heads on a model axis of 4:
  'context'), qwen2 (4 heads: 'heads', its 2 K/V heads replicated; qkv
  bias), whisper (enc-dec, LayerNorm, GELU) and qwen2-vl (M-RoPE), B = 4,
  S = 32; and, as JAX's dry run builds them, the prefill jitted with the
  prefill cache specs and ``DECODE_STEPS`` greedy decode steps with the
  decode specs for llama3.2 (context prefill, head_dim decode), qwen2.5
  (5 heads: context) and whisper ('heads').
* The port: one spawn of 8 ``gloo`` ranks as (2, 4) (``tests/
  test_torch_ring_mesh.py``'s harness) runs the same from JAX's
  parameters: the mesh train steps, then the mesh prefill,
  ``reshard_cache`` and the decode steps on JAX's tokens; rank 0 also
  counts one unsplit rank's step on its rows (ambient ``MeshShape``).
* Held: losses within 1e-5 and grad norms within 1e-4 relative of JAX's
  on every rank, the gathered params at ``test_train_steps_match_jax``'s
  bound; the serve logits within ``test_torch_lm.py``'s 1e-4·max|JAX| +
  1e-6, the greedy tokens equal, the cache after prefill within the same
  bound; the working copy's split leaves are the rank's 'model' chunks,
  the cache a serve call reads and writes is the rank's shards, and no
  serve call gathers a cache leaf (``op_analysis``); a rank's train step
  counts at most 0.4× the FLOPs of its rows on one unsplit rank.
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

TRAIN = ("llama3p2_3b", "qwen2_7b", "whisper_medium", "qwen2_vl_2b")
SERVE = ("llama3p2_3b", "qwen2p5_14b", "whisper_medium")
FLOPS = ("llama3p2_3b", "qwen2_7b")
B, S, TRAIN_STEPS = 4, 32, 2
P, MAX, DECODE_STEPS = 8, 16, 3
LR = 3e-4
FLOPS_FRACTION = 0.4

_JAX_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P_
from repro.configs import get_smoke_config
from repro.launch import shardings as SR
from repro.launch.mesh import make_mesh
from repro.launch.steps import (TrainState, init_state, make_decode_step,
                                make_prefill_step, make_train_step)
from repro.launch.train import synthetic_batch
from repro.models.lm import model as J
from repro.pjit_utils import ambient_mesh

out_path, inputs_path = sys.argv[1:3]
TRAIN = ("llama3p2_3b", "qwen2_7b", "whisper_medium", "qwen2_vl_2b")
SERVE = ("llama3p2_3b", "qwen2p5_14b", "whisper_medium")
B, S, TRAIN_STEPS = 4, 32, 2
P, MAX, DECODE_STEPS = 8, 16, 3
mesh = make_mesh((2, 4), ("data", "model"))


def put(res, prefix, tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(res, prefix, v, path + (k,))
    else:
        res[prefix + "/" + "/".join(path)] = np.asarray(tree)


ins, res, serve = {}, {}, {}
rng = np.random.default_rng(0)
for arch in TRAIN:
    cfg = get_smoke_config(arch)
    state = jax.jit(init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, S)
    put(ins, "train/" + arch + "/params", state.params)
    res[arch] = state
for arch in SERVE:
    cfg = get_smoke_config(arch)
    params = jax.jit(J.init_params, static_argnums=1,
                     static_argnames="max_seq")(jax.random.PRNGKey(1), cfg,
                                                max_seq=MAX)
    tokens = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    put(ins, "serve/" + arch + "/params", params)
    ins["serve/" + arch + "/tokens"] = tokens
    extras = {}
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        extras["memory"] = jax.jit(lambda p, f: J.encode(p, cfg, f))(
            params, jnp.asarray(frames))
        ins["serve/" + arch + "/memory"] = np.asarray(extras["memory"])
    serve[arch] = (cfg, params, tokens, extras)
np.savez(inputs_path + ".tmp.npz", **ins)
os.replace(inputs_path + ".tmp.npz", inputs_path)   # whole when it appears

out = {}
for arch in TRAIN:
    cfg = get_smoke_config(arch)
    state = res[arch]
    specs = SR.param_specs(state.params, cfg, mesh)
    sh = SR.to_named(TrainState(specs, specs, specs, P_()), mesh)
    state = jax.device_put(state, sh)
    step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
    losses, gnorms = [], []
    with ambient_mesh(mesh):
        for i in range(TRAIN_STEPS):
            state, m = step(state, synthetic_batch(cfg, i, B, S))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out["train/" + arch + "/losses"] = np.asarray(losses)
    out["train/" + arch + "/gnorms"] = np.asarray(gnorms)
    put(out, "train/" + arch + "/params", state.params)

for arch, (cfg, params, tokens, extras) in serve.items():
    pspecs = SR.param_specs(params, cfg, mesh)
    cache = J.init_cache(cfg, B, MAX, jnp.float32)
    specs = {k: SR.cache_specs(cfg, mesh, batch_size=B, seq_len=MAX, kind=k)
             for k in ("prefill", "decode")}
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
                          SR.to_named(P_(), mesh), SR.to_named({}, mesh)),
            out_shardings=(None, SR.to_named(specs["decode"], mesh)),
            donate_argnums=(2,))
        logits, cache = prefill(params, jnp.asarray(tokens), cache, extras)
        put(out, "serve/" + arch + "/cache", cache)
        out["serve/" + arch + "/logits/0"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        cache = jax.device_put(cache, SR.to_named(specs["decode"], mesh))
        for i in range(DECODE_STEPS):
            logits, cache = decode(params, tok, cache, jnp.asarray(P + i), {})
            out[f"serve/{arch}/logits/{i + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        out["serve/" + arch + "/tokens"] = np.stack(toks)
np.savez(out_path + ".tmp.npz", **out)
os.replace(out_path + ".tmp.npz", out_path)
print("LM_TP_REF_OK")
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


# --------------------------------------------------------------------- #
# the port's ranks
# --------------------------------------------------------------------- #
def _train(rank, ins, mesh, flags, out):
    """The mesh train steps of ``TRAIN``; each step's gathered leaf
    shapes recorded, and for ``FLOPS`` one step's count beside one
    unsplit rank's count of the same rows."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.lm import model as T
    from repro_torch.pjit_utils import MeshShape, ambient_mesh, full_tensors

    working = {}
    build = steps.gather_plan

    def recording(sharded, split=None):
        plan = build(sharded, split)
        working["shapes"] = dict(plan.shapes)
        working["chunked"] = set(plan.chunked)
        return plan

    steps.gather_plan = recording
    try:
        for arch in TRAIN:
            cfg = get_smoke_config(arch)
            tree = _tree(ins, f"train/{arch}/params")
            state = steps.state_of(T.from_jax_params(cfg, tree, "cpu"), mesh)
            step = steps.make_train_step(cfg, lr=LR, mesh=mesh)
            losses, gnorms = [], []
            with ambient_mesh(mesh):
                for i in range(TRAIN_STEPS):
                    batch = train.synthetic_batch(cfg, i, B, S, device="cpu")
                    if arch in FLOPS and i == TRAIN_STEPS - 1:
                        with OpAnalysis() as oa:
                            state, m = step(state, batch)
                        flags[f"{arch}/flops"] = oa.analyze()["flops_hlo"]
                    else:
                        state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
            flags[f"{arch}/losses"] = losses
            flags[f"{arch}/gnorms"] = gnorms
            flags[f"{arch}/working"] = dict(working)
            params = steps.state_tree(state).params
            for name, leaf in named_leaves(params):     # every rank gathers
                whole = full_tensors([leaf])[0].numpy()
                if rank == 0:
                    out[f"train/{arch}/params/{name}"] = whole
            if rank == 0:
                if arch in FLOPS:   # one unsplit rank, the same rows
                    model = T.from_jax_params(cfg, tree, "cpu")
                    batch = train.synthetic_batch(cfg, 0, B, S, device="cpu")
                    rows = {k: v[:B // 2] for k, v in batch.items()}
                    with ambient_mesh(MeshShape((2, 4))), OpAnalysis() as oa:
                        steps.make_train_step(cfg, lr=LR)(
                            steps.state_of(model), rows)
                    flags[f"{arch}/flops_unsplit"] = oa.analyze()[
                        "flops_hlo"]
    finally:
        steps.gather_plan = build


def _serve(rank, ins, ref_path, mesh, flags, out):
    """The mesh prefill and decode steps of ``SERVE``; the cache leaves
    each call is handed recorded, and one decode step's collectives."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.lm import model as T
    from repro_torch.pjit_utils import full_tensors

    handed = []
    calls = {k: getattr(T, k) for k in ("prefill", "decode_step")}

    def recording(fn):
        def call(model, tokens, cache, *a, **kw):
            handed.append({n: tuple(t.shape)
                           for n, t in named_leaves(cache)})
            return fn(model, tokens, cache, *a, **kw)
        return call

    for k, fn in calls.items():
        setattr(T, k, recording(fn))
    try:
        wait_for_file(ref_path, _NoChild())
        ref = dict(np.load(ref_path))
        for arch in SERVE:
            cfg = get_smoke_config(arch)
            model = T.from_jax_params(cfg, _tree(ins, f"serve/{arch}/params"),
                                      "cpu")
            steps.shard_model(model, mesh)
            cache = steps.init_mesh_cache(cfg, B, MAX, torch.float32, mesh,
                                          kind="prefill", device="cpu")
            shards = {"prefill": {n: tuple(t.to_local().shape)
                                  for n, t in named_leaves(cache)}}
            extras = {}
            if f"serve/{arch}/memory" in ins:
                extras["memory"] = torch.from_numpy(
                    ins[f"serve/{arch}/memory"])
            handed.clear()
            logits, cache = steps.make_prefill_step(cfg, mesh=mesh)(
                model, torch.from_numpy(ins[f"serve/{arch}/tokens"]), cache,
                extras)
            out[f"serve/{arch}/logits/0"] = full_tensors([logits])[0].numpy()
            names, leaves = zip(*named_leaves(cache))
            for name, leaf in zip(names, full_tensors(leaves)):
                out[f"serve/{arch}/cache/{name}"] = leaf.numpy().copy()
            cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
            shards["decode"] = {n: tuple(t.to_local().shape)
                                for n, t in named_leaves(cache)}
            decode = steps.make_decode_step(cfg, mesh=mesh)
            toks = ref[f"serve/{arch}/tokens"]
            for i in range(DECODE_STEPS):
                args = (model, torch.from_numpy(toks[i]), cache,
                        torch.tensor(P + i), {})
                if i == DECODE_STEPS - 1:
                    with OpAnalysis() as oa:
                        oa.name(dict(named_leaves(cache, "cache")))
                        logits, cache = decode(*args)
                    flags[f"{arch}/decode_collectives"] = [
                        (r["kind"], r["names"]) for r in
                        oa.top_collectives(100)]
                else:
                    logits, cache = decode(*args)
                out[f"serve/{arch}/logits/{i + 1}"] = full_tensors(
                    [logits])[0].numpy()
            flags[f"{arch}/handed"] = list(handed)
            flags[f"{arch}/shards"] = shards
    finally:
        for k, fn in calls.items():
            setattr(T, k, fn)


def _rank(rank: int, root: str, inputs_path: str, ref_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    group = init_rank(rank, 8, root)
    try:
        ins = dict(np.load(inputs_path))
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        flags, out = {"rank": rank}, {}
        _train(rank, ins, mesh, flags, out)
        _serve(rank, ins, ref_path, mesh, flags, out)
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
    root = tmp_path_factory.mktemp("lm_tp")
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


def _close(got, ref, what, slack=0.0):
    """1e-4·max|JAX| + 1e-6 (+ ``slack``): ``test_torch_lm.py``'s and
    ``test_train_steps_match_jax``'s bound."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max(initial=0.0))
    tol = 1e-4 * float(np.abs(ref).max(initial=0.0)) + 1e-6 + slack
    assert err <= tol, f"{what}: max err {err:.3g} > tol {tol:.3g}"


@pytest.mark.parametrize("arch", TRAIN)
def test_split_train_steps_match_jax_mesh(runs, arch):
    ref = runs["ref"]
    for f in runs["flags"]:
        np.testing.assert_allclose(f[f"{arch}/losses"],
                                   ref[f"train/{arch}/losses"], rtol=1e-5)
        np.testing.assert_allclose(f[f"{arch}/gnorms"],
                                   ref[f"train/{arch}/gnorms"], rtol=1e-4)
    moved = 1e-2 * LR * TRAIN_STEPS     # as test_train_steps_match_jax's
    for name, want in named_leaves(_tree(ref, f"train/{arch}/params")):
        _close(runs["port"][f"train/{arch}/params/{name}"], want,
               f"{arch} params {name}", moved)


@pytest.mark.parametrize("arch", SERVE)
def test_split_serve_matches_jax_mesh(runs, arch):
    ref, port = runs["ref"], runs["port"]
    for i in range(DECODE_STEPS + 1):
        _close(port[f"serve/{arch}/logits/{i}"],
               ref[f"serve/{arch}/logits/{i}"], f"{arch} logits {i}")
    for name, want in named_leaves(_tree(ref, f"serve/{arch}/cache")):
        _close(port[f"serve/{arch}/cache/{name}"], want,
               f"{arch} cache {name}")
    greedy = [port[f"serve/{arch}/logits/{i}"].argmax(-1)
              for i in range(DECODE_STEPS + 1)]
    np.testing.assert_array_equal(np.stack(greedy),
                                  ref[f"serve/{arch}/tokens"])


# a leaf the split runs on its chunk: (name, dim, whole size) per arch;
# llama's attention is 'context' (whole weights), qwen2's 'heads' with
# its two K/V heads computed whole
_CHUNKS = {
    "llama3p2_3b": [("blocks.0.mlp.w_gate", 1, 96), ("blocks.1.mlp.w_down",
                                                     0, 96),
                    ("embed", 0, 128)],
    "qwen2_7b": [("blocks.0.attn.wq", 1, 4), ("blocks.0.attn.bq", 0, 4),
                 ("blocks.1.attn.wo", 0, 4), ("blocks.0.mlp.w_up", 1, 128),
                 ("embed", 0, 256), ("lm_head", 0, 256)],
    "whisper_medium": [("blocks.0.xattn.wk", 1, 4),
                       ("enc_blocks.1.attn.wv", 1, 4),
                       ("blocks.0.mlp.b_up", 0, 128)],
    "qwen2_vl_2b": [("blocks.0.attn.wq", 1, 4), ("embed", 0, 128)],
}
_WHOLE = {"llama3p2_3b": ["blocks.0.attn.wq", "blocks.0.norm1.scale"],
          "qwen2_7b": ["blocks.0.attn.wk", "blocks.0.attn.bv"],
          "whisper_medium": ["blocks.0.mlp.b_down", "dec_pos"],
          "qwen2_vl_2b": ["blocks.1.attn.wv", "final_norm.scale"]}


@pytest.mark.parametrize("arch", TRAIN)
def test_rank_runs_on_its_model_chunks(runs, arch):
    """The working copy holds each split leaf as the rank's 'model' chunk
    (a quarter of the whole along its split dim), never the whole leaf;
    the others whole."""
    for f in runs["flags"]:
        work = f[f"{arch}/working"]
        for name, dim, n in _CHUNKS[arch]:
            assert name in work["chunked"], (arch, name)
            assert work["shapes"][name][dim] == n // 4, (arch, name)
        for name in _WHOLE[arch]:
            assert name not in work["chunked"], (arch, name)


@pytest.mark.parametrize("arch", SERVE)
def test_serve_call_reads_and_writes_its_cache_shards(runs, arch):
    """Each prefill and decode call is handed the rank's shards of the
    cache (their shapes the shards' under the call's specs, never the
    whole leaf), and no decode step gathers a cache leaf."""
    for f in runs["flags"]:
        handed, shards = f[f"{arch}/handed"], f[f"{arch}/shards"]
        assert len(handed) == 1 + DECODE_STEPS
        assert handed[0] == shards["prefill"]
        assert all(h == shards["decode"] for h in handed[1:])
        for kind, names in f[f"{arch}/decode_collectives"]:
            assert "cache." not in names, (arch, kind, names)


def test_serve_cache_shards_split_the_model_axis(runs):
    """The K / V shards a call is handed are split over 'model' as the
    specs say: llama's prefill cache on the sequence, its decode cache on
    head_dim; whisper's on heads (B = 4 over 'data' = 2 rows each)."""
    f = runs["flags"][0]
    llama, whisper = f["llama3p2_3b/shards"], f["whisper_medium/shards"]
    assert llama["prefill"]["k"] == (2, 2, MAX // 4, 1, 16)
    assert llama["decode"]["k"] == (2, 2, MAX, 1, 4)
    for kind in ("prefill", "decode"):
        assert whisper[kind]["k"] == (2, 2, MAX, 1, 16)
        assert whisper[kind]["cross_k"] == (2, 2, 30, 1, 16)


@pytest.mark.parametrize("arch", FLOPS)
def test_split_step_counts_a_fraction_of_the_flops(runs, arch):
    """A rank's split train step counts at most ``FLOPS_FRACTION`` of the
    FLOPs of its rows through one unsplit rank (the model axis is 4)."""
    flags = runs["flags"]
    unsplit = flags[0][f"{arch}/flops_unsplit"]
    for f in flags:
        ratio = f[f"{arch}/flops"] / unsplit
        assert 0 < ratio <= FLOPS_FRACTION, f"{arch}: {ratio:.3f}"
