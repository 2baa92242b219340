"""Port parity for the model axis's split of the MoE FFN and the Mamba2
mixer (``repro_torch.models.lm.moe.moe_split``, ``mamba2.mamba2_split``,
``tp.Split.moe`` / ``mixer``) in the mesh train, prefill and decode steps,
against JAX's mesh runs, on the CPU.

* The reference: one JAX child (``tests/conftest.run_multidevice``, 8
  emulated devices) writes each case's parameters first, then runs on its
  mesh under the ambient mesh: ``TRAIN_STEPS`` jitted train steps and, as
  JAX's dry run builds them, the prefill jitted with the prefill cache
  specs and ``DECODE_STEPS`` greedy decode steps with the decode specs.
  The cases (``CASES``): granite-MoE smoke (8 small experts: the 'slots'
  split, one token block per rank's rows) trained on (2, 4); mamba2 and
  zamba2 smoke (the mixer's 8 heads and 160 conv channels over 'model';
  zamba2's shared attention block between its Mamba2 blocks, its cache
  with the extra layer dim) trained and served on (2, 4); mixtral smoke
  ('slots' prefill, a 'replicated' decode) served on (2, 4); and the
  big-expert modes, with the
  small-FFN threshold patched off (the port's ``moe.small_ffn``; in the
  JAX child ``moe._block_layout`` told the FFN is not small, so JAX's
  token blocks are the big experts' whole sequence: values, where the
  specs only place data): mixtral 'ep' (its 4 experts over a model axis
  of 4) on (2, 4) and 'ff' (d_ff 96 over a model axis of 3, which does
  not divide 4 experts) on (2, 3), trained and served.
* The port: one spawn of ``gloo`` ranks per mesh (8 as (2, 4), then 6 as
  (2, 3); ``tests/test_torch_ring_mesh.py``'s harness) runs the same from
  JAX's parameters, decoding JAX's greedy tokens; rank 0 also counts one
  unsplit rank's train step on its rows (ambient ``MeshShape``).
* Held, at ``test_torch_lm_tp.py``'s bounds: losses within 1e-5 and grad
  norms within 1e-4 relative of JAX's on every rank, and every leaf's
  first-step gradient (the mesh step's, its chunks gathered) within
  1e-4·max|JAX| + 1e-6; serve logits within the same bound, greedy
  tokens equal, the cache after prefill within the same bound. The
  params after the steps are not held: an element whose gradient lies
  within a few eps of AdamW's denominator moves by a fraction of lr that
  the summation order decides (mixtral's ``embed[111, 16]`` at step 2:
  3e-8 in a row of 0.08; JAX moves it up, the port down). Also: the
  working copy holds the split leaves as the rank's 'model' chunks (the
  experts on E or d_ff, ``out_proj``), the small experts, ``in_proj``
  and, in train and prefill, ``conv_w`` / ``conv_b`` whole (the conv
  runs on the rank's heads' channels), in decode those two as the rank's
  chunk (the conv runs on its channel chunk); every serve call is handed
  the rank's cache shards and no prefill or decode collective carries a
  cache leaf; no train or prefill collective is posted by
  ``mamba2_split`` itself, a decode's one gather of the conv output is
  (``op_analysis`` sites); a rank's train step counts at most 0.5× the
  FLOPs of its rows through one unsplit rank (granite, zamba2).
"""
import concurrent.futures
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.launch.steps import named_leaves
from tests.conftest import run_multidevice
from tests.test_torch_lm_tp import _close, _NoChild, _tree
from tests.test_torch_ring_mesh import (gather_to_root, init_rank,
                                        spawn_ranks, wait_for_file)

# (case, arch, mesh, big experts, train S or None, serve prompt or None)
CASES = [("granite", "granite_moe_3b", (2, 4), False, 32, None),
         ("zamba2", "zamba2_2p7b", (2, 4), False, 32, 8),
         ("mixtral", "mixtral_8x22b", (2, 4), False, None, 8),
         ("mamba2", "mamba2_1p3b", (2, 4), False, 32, 8),
         ("mixtral_ep", "mixtral_8x22b", (2, 4), True, 32, 8),
         ("mixtral_ff", "mixtral_8x22b", (2, 3), True, 30, 9)]
TRAIN = [c[0] for c in CASES if c[4]]
SERVE = [c[0] for c in CASES if c[5]]
FLOPS = ("granite", "zamba2")
B, TRAIN_STEPS, MAX, DECODE_STEPS = 4, 2, 16, 3
LR = 3e-4
FLOPS_FRACTION = 0.5

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
from repro.models.lm import moe as M
from repro.pjit_utils import ambient_mesh

out_path, inputs_path = sys.argv[1:3]
CASES = @CASES@
B, TRAIN_STEPS, MAX, DECODE_STEPS = @CONSTS@
layout = M._block_layout


def big_experts(on):
    # the big experts' token blocks: the specs only place data
    M._block_layout = ((lambda B, S, small: layout(B, S, False)) if on
                       else layout)


def put(res, prefix, tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(res, prefix, v, path + (k,))
    else:
        res[prefix + "/" + "/".join(path)] = np.asarray(tree)


ins, states, serve = {}, {}, {}
rng = np.random.default_rng(0)
for case, arch, shape, big, S, P in CASES:
    cfg = get_smoke_config(arch)
    if S:
        state = jax.jit(init_state, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), cfg, S)
        put(ins, "train/" + case + "/params", state.params)
        states[case] = state
    if P:
        params = jax.jit(J.init_params, static_argnums=1,
                         static_argnames="max_seq")(jax.random.PRNGKey(1),
                                                    cfg, max_seq=MAX)
        tokens = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
        put(ins, "serve/" + case + "/params", params)
        ins["serve/" + case + "/tokens"] = tokens
        serve[case] = (params, tokens)
np.savez(inputs_path + ".tmp.npz", **ins)
os.replace(inputs_path + ".tmp.npz", inputs_path)   # whole when it appears

out = {}
for case, arch, shape, big, S, P in CASES:
    cfg = get_smoke_config(arch)
    mesh = make_mesh(shape, ("data", "model"))
    big_experts(big)
    if S:
        state = states[case]
        specs = SR.param_specs(state.params, cfg, mesh)
        sh = SR.to_named(TrainState(specs, specs, specs, P_()), mesh)
        state = jax.device_put(state, sh)
        grad = jax.jit(jax.grad(lambda p, b: J.loss_fn(p, cfg, b)))
        with ambient_mesh(mesh):
            put(out, "train/" + case + "/grads",
                grad(state.params, synthetic_batch(cfg, 0, B, S)))
        step = jax.jit(make_train_step(cfg), donate_argnums=(0,))
        losses, gnorms = [], []
        with ambient_mesh(mesh):
            for i in range(TRAIN_STEPS):
                state, m = step(state, synthetic_batch(cfg, i, B, S))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        out["train/" + case + "/losses"] = np.asarray(losses)
        out["train/" + case + "/gnorms"] = np.asarray(gnorms)
    if P:
        params, tokens = serve[case]
        pspecs = SR.param_specs(params, cfg, mesh)
        cache = J.init_cache(cfg, B, MAX, jnp.float32)
        specs = {k: SR.cache_specs(cfg, mesh, batch_size=B, seq_len=MAX,
                                   kind=k) for k in ("prefill", "decode")}
        bspec = {k: SR.batch_specs(cfg, k, mesh, batch_size=B)
                 for k in ("prefill", "decode")}
        with mesh, ambient_mesh(mesh):
            prefill = jax.jit(
                make_prefill_step(cfg),
                in_shardings=(SR.to_named(pspecs, mesh),
                              SR.to_named(bspec["prefill"]["tokens"], mesh),
                              SR.to_named(specs["prefill"], mesh),
                              SR.to_named({}, mesh)),
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
            logits, cache = prefill(params, jnp.asarray(tokens), cache, {})
            put(out, "serve/" + case + "/cache", cache)
            out["serve/" + case + "/logits/0"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            cache = jax.device_put(cache, SR.to_named(specs["decode"], mesh))
            for i in range(DECODE_STEPS):
                logits, cache = decode(params, tok, cache,
                                       jnp.asarray(P + i), {})
                out[f"serve/{case}/logits/{i + 1}"] = np.asarray(logits)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            out["serve/" + case + "/tokens"] = np.stack(toks)
big_experts(False)
np.savez(out_path + ".tmp.npz", **out)
os.replace(out_path + ".tmp.npz", out_path)
print("LM_SPLIT_MOE_SSM_REF_OK")
""".replace("@CASES@", repr(CASES)).replace(
    "@CONSTS@", repr((B, TRAIN_STEPS, MAX, DECODE_STEPS)))


# --------------------------------------------------------------------- #
# the port's ranks
# --------------------------------------------------------------------- #
class _BigExperts:
    """The port's small-FFN test patched off while a big-expert case runs
    (``moe.small_ffn``, which the specs, the token blocks and the split
    read at call time)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from repro_torch.models.lm import moe

        self.moe, self.small = moe, moe.small_ffn
        if self.on:
            moe.small_ffn = lambda cfg: False

    def __exit__(self, *exc):
        self.moe.small_ffn = self.small


def _mesh_grads(cfg, state, mesh, batch) -> dict:
    """The mesh step's gradients of ``batch`` (before the clip) as JAX's
    tree, each leaf whole: the rank's shards' (each summed over 'data',
    ÷ its size), gathered."""
    from repro_torch.launch import steps
    from repro_torch.models.lm import model as T
    from repro_torch.models.lm.tp import make_split
    from repro_torch.pjit_utils import ambient_mesh, full_tensors, to_dtensor

    with ambient_mesh(mesh):
        rows = steps._rank_rows(cfg, mesh, batch)
        split = make_split(cfg, mesh, steps._seq_len(rows))
        _, grads = steps._shard_grads(cfg, state.params, mesh, [rows], split)
    shards = list(state.params.parameters())
    return T.to_jax_tree(state.params, full_tensors([
        to_dtensor(g, mesh, p.placements, p.shape)
        for g, p in zip(grads, shards)]))


def _collectives(oa) -> list:
    """Every collective site ``oa`` counted: (kind, leaf names, site)."""
    return [(r["kind"], r["names"], r["site"])
            for r in oa.top_collectives(None)]


def _train(rank, case, arch, S, ins, mesh, flags, out):
    """``case``'s first-step gradients and mesh train steps; the working
    copy's leaf shapes and chunked leaves recorded, the last step's
    collectives counted, and for ``FLOPS`` its FLOPs beside one unsplit
    rank's count of the same rows."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.lm import model as T
    from repro_torch.pjit_utils import MeshShape, ambient_mesh, axis_sizes

    working = {}
    build = steps.gather_plan

    def recording(sharded, split=None):
        plan = build(sharded, split)
        working["shapes"] = dict(plan.shapes)
        working["chunked"] = set(plan.chunked)
        working["modes"] = (split.moe if cfg.n_experts else None,
                            split.mixer if cfg.ssm_state else None)
        return plan

    cfg = get_smoke_config(arch)
    tree = _tree(ins, f"train/{case}/params")
    grads = _mesh_grads(cfg, steps.state_of(T.from_jax_params(
        cfg, tree, "cpu"), mesh), mesh, train.synthetic_batch(
            cfg, 0, B, S, device="cpu"))
    if rank == 0:
        for name, g in named_leaves(grads):
            out[f"train/{case}/grads/{name}"] = g.numpy()
    steps.gather_plan = recording
    try:
        state = steps.state_of(T.from_jax_params(cfg, tree, "cpu"), mesh)
        step = steps.make_train_step(cfg, lr=LR, mesh=mesh)
        losses, gnorms = [], []
        with ambient_mesh(mesh):
            for i in range(TRAIN_STEPS):
                batch = train.synthetic_batch(cfg, i, B, S, device="cpu")
                if i == TRAIN_STEPS - 1:
                    with OpAnalysis() as oa:
                        state, m = step(state, batch)
                    flags[f"{case}/flops"] = oa.analyze()["flops_hlo"]
                    flags[f"{case}/train_collectives"] = _collectives(oa)
                else:
                    state, m = step(state, batch)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
    finally:
        steps.gather_plan = build
    flags[f"{case}/losses"] = losses
    flags[f"{case}/gnorms"] = gnorms
    flags[f"{case}/working"] = dict(working)
    if rank == 0 and case in FLOPS:   # one unsplit rank, the same rows
        data = axis_sizes(mesh)["data"]
        model = T.from_jax_params(cfg, tree, "cpu")
        batch = train.synthetic_batch(cfg, 0, B, S, device="cpu")
        rows = {k: v[:B // data] for k, v in batch.items()}
        shape = MeshShape(tuple(int(s) for s in mesh.shape))
        with ambient_mesh(shape), OpAnalysis() as oa:
            steps.make_train_step(cfg, lr=LR)(steps.state_of(model), rows)
        flags[f"{case}/flops_unsplit"] = oa.analyze()["flops_hlo"]


def _serve(case, arch, P, ins, ref, mesh, flags, out):
    """``case``'s mesh prefill and decode steps on JAX's greedy tokens;
    the cache leaves each call is handed, the shards, the working copy's
    chunked leaves by call kind, and the prefill's and last decode step's
    collectives recorded."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.lm import model as T
    from repro_torch.pjit_utils import full_tensors

    handed, working = [], {}
    calls = {k: getattr(T, k) for k in ("prefill", "decode_step")}
    build = steps.gather_plan

    def recording(fn):
        def call(model, tokens, cache, *a, **kw):
            handed.append({n: tuple(t.shape)
                           for n, t in named_leaves(cache)})
            return fn(model, tokens, cache, *a, **kw)
        return call

    def building(sharded, split=None):
        plan = build(sharded, split)
        working[split.kind] = {n: plan.shapes[n] for n in plan.chunked}
        return plan

    for k, fn in calls.items():
        setattr(T, k, recording(fn))
    steps.gather_plan = building
    try:
        cfg = get_smoke_config(arch)
        model = T.from_jax_params(cfg, _tree(ins, f"serve/{case}/params"),
                                  "cpu")
        steps.shard_model(model, mesh)
        cache = steps.init_mesh_cache(cfg, B, MAX, torch.float32, mesh,
                                      kind="prefill", device="cpu")
        shards = {"prefill": {n: tuple(t.to_local().shape)
                              for n, t in named_leaves(cache)}}
        with OpAnalysis() as oa:
            oa.name(dict(named_leaves(cache, "cache")))
            logits, cache = steps.make_prefill_step(cfg, mesh=mesh)(
                model, torch.from_numpy(ins[f"serve/{case}/tokens"]), cache,
                {})
        flags[f"{case}/prefill_collectives"] = _collectives(oa)
        out[f"serve/{case}/logits/0"] = full_tensors([logits])[0].numpy()
        names, leaves = zip(*named_leaves(cache))
        for name, leaf in zip(names, full_tensors(leaves)):
            out[f"serve/{case}/cache/{name}"] = leaf.numpy().copy()
        cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
        shards["decode"] = {n: tuple(t.to_local().shape)
                            for n, t in named_leaves(cache)}
        decode = steps.make_decode_step(cfg, mesh=mesh)
        toks = ref[f"serve/{case}/tokens"]
        for i in range(DECODE_STEPS):
            args = (model, torch.from_numpy(toks[i]), cache,
                    torch.tensor(P + i), {})
            with OpAnalysis() as oa:
                oa.name(dict(named_leaves(cache, "cache")))
                logits, cache = decode(*args)
            out[f"serve/{case}/logits/{i + 1}"] = full_tensors(
                [logits])[0].numpy()
        flags[f"{case}/decode_collectives"] = _collectives(oa)
        flags[f"{case}/handed"] = list(handed)
        flags[f"{case}/shards"] = shards
        flags[f"{case}/serve_chunked"] = dict(working)
    finally:
        steps.gather_plan = build
        for k, fn in calls.items():
            setattr(T, k, fn)


def _rank(rank: int, shape: tuple, root: str, inputs_path: str,
          ref_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    world = shape[0] * shape[1]
    group = init_rank(rank, world, root)
    try:
        ins = dict(np.load(inputs_path))
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        flags, out = {"rank": rank}, {}
        mine = [c for c in CASES if c[2] == shape]
        for case, arch, _, big, S, _ in mine:
            if S:
                with _BigExperts(big):
                    _train(rank, case, arch, S, ins, mesh, flags, out)
        wait_for_file(ref_path, _NoChild())
        ref = dict(np.load(ref_path))
        for case, arch, _, big, _, P in mine:
            if P:
                with _BigExperts(big):
                    _serve(case, arch, P, ins, ref, mesh, flags, out)
        flags = gather_to_root(group, flags)
        if rank == 0:
            with open(os.path.join(root, "flags.pkl"), "wb") as f:
                pickle.dump(flags, f)
            np.savez(os.path.join(root, "port.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_split_moe_ssm")
    ref_path, inputs_path = str(root / "jax.npz"), str(root / "inputs.npz")
    flags, port = {}, {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        child = pool.submit(run_multidevice, _JAX_PROG, ref_path, inputs_path)
        wait_for_file(inputs_path, child)
        try:
            for shape in sorted({c[2] for c in CASES}, reverse=True):
                ranks = root / "ranks_{}x{}".format(*shape)
                ranks.mkdir()
                spawn_ranks(_rank, shape[0] * shape[1],
                            (shape, str(ranks), inputs_path, ref_path))
                with open(ranks / "flags.pkl", "rb") as f:
                    for f_rank in pickle.load(f):
                        flags.setdefault(f_rank["rank"], {}).update(f_rank)
                port.update(np.load(ranks / "port.npz"))
        finally:
            r = child.result()
    assert r.returncode == 0, r.stderr[-3000:]
    return {"ref": dict(np.load(ref_path)), "port": port,
            "flags": [flags[k] for k in sorted(flags)]}


def _ranks_of(runs, case):
    """The flags of the ranks that ran ``case``."""
    return [f for f in runs["flags"] if f"{case}/losses" in f
            or f"{case}/handed" in f]


@pytest.mark.parametrize("case", TRAIN)
def test_split_train_steps_match_jax_mesh(runs, case):
    ref = runs["ref"]
    ranks = _ranks_of(runs, case)
    assert len(ranks) == int(np.prod(next(c[2] for c in CASES
                                          if c[0] == case)))
    for f in ranks:
        np.testing.assert_allclose(f[f"{case}/losses"],
                                   ref[f"train/{case}/losses"], rtol=1e-5)
        np.testing.assert_allclose(f[f"{case}/gnorms"],
                                   ref[f"train/{case}/gnorms"], rtol=1e-4)
    for name, want in named_leaves(_tree(ref, f"train/{case}/grads")):
        _close(runs["port"][f"train/{case}/grads/{name}"], want,
               f"{case} grads {name}")


@pytest.mark.parametrize("case", SERVE)
def test_split_serve_matches_jax_mesh(runs, case):
    ref, port = runs["ref"], runs["port"]
    for i in range(DECODE_STEPS + 1):
        _close(port[f"serve/{case}/logits/{i}"],
               ref[f"serve/{case}/logits/{i}"], f"{case} logits {i}")
    for name, want in named_leaves(_tree(ref, f"serve/{case}/cache")):
        _close(port[f"serve/{case}/cache/{name}"], want,
               f"{case} cache {name}")
    greedy = [port[f"serve/{case}/logits/{i}"].argmax(-1)
              for i in range(DECODE_STEPS + 1)]
    np.testing.assert_array_equal(np.stack(greedy),
                                  ref[f"serve/{case}/tokens"])


# the split's modes per train case: (MoE, mixer)
_MODES = {"granite": ("slots", None), "zamba2": (None, "heads"),
          "mamba2": (None, "heads"), "mixtral_ep": ("ep", None),
          "mixtral_ff": ("ff", None)}
# a leaf the split runs on its chunk: (name, dim, whole size, model axis);
# a train step's Mamba2 conv runs on the rank's heads' channels, so
# conv_w / conv_b are whole there (a decode's: _DECODE_CONV)
_CHUNKS = {
    "granite": [],
    "zamba2": [("blocks.0.mixer.out_proj", 0, 128, 4)],
    "mamba2": [("blocks.1.mixer.out_proj", 0, 128, 4)],
    "mixtral_ep": [("blocks.0.moe.w_gate", 0, 4, 4),
                   ("blocks.1.moe.w_up", 0, 4, 4),
                   ("blocks.0.moe.w_down", 0, 4, 4)],
    "mixtral_ff": [("blocks.0.moe.w_gate", 2, 96, 3),
                   ("blocks.1.moe.w_up", 2, 96, 3),
                   ("blocks.0.moe.w_down", 1, 96, 3)],
}
_WHOLE = {"granite": ["blocks.0.moe.w_gate", "blocks.1.moe.w_down",
                      "blocks.0.moe.router"],
          "zamba2": ["blocks.0.mixer.in_proj", "blocks.2.mixer.A_log",
                     "blocks.1.norm.scale", "blocks.3.mixer.conv_w",
                     "blocks.1.mixer.conv_b"],
          "mamba2": ["blocks.1.mixer.in_proj", "blocks.0.mixer.skip_D",
                     "blocks.0.mixer.conv_w", "blocks.1.mixer.conv_b"],
          "mixtral_ep": ["blocks.0.moe.router"],
          "mixtral_ff": ["blocks.1.moe.router"]}


@pytest.mark.parametrize("case", TRAIN)
def test_rank_runs_on_its_model_chunks(runs, case):
    """The working copy holds each split leaf as the rank's 'model' chunk
    along its split dim, never the whole leaf; the small experts, the
    router and ``in_proj`` whole."""
    for f in _ranks_of(runs, case):
        work = f[f"{case}/working"]
        assert work["modes"] == _MODES[case], (case, work["modes"])
        for name, dim, n, m in _CHUNKS[case]:
            assert name in work["chunked"], (case, name)
            assert work["shapes"][name][dim] == n // m, (case, name)
        for name in _WHOLE[case]:
            assert name not in work["chunked"], (case, name)


# the SSM cases' conv leaves a decode runs on the rank's chunk:
# (name, dim, whole size, model axis)
_DECODE_CONV = {"zamba2": [("blocks.3.mixer.conv_w", 1, 160, 4),
                           ("blocks.1.mixer.conv_b", 0, 160, 4)],
                "mamba2": [("blocks.0.mixer.conv_w", 1, 160, 4),
                           ("blocks.1.mixer.conv_b", 0, 160, 4)]}
_MAMBA2_SPLIT = "models/lm/mamba2.py:mamba2_split"


@pytest.mark.parametrize("case", sorted(_DECODE_CONV))
def test_conv_runs_on_heads_in_train_and_prefill_on_chunk_in_decode(
        runs, case):
    """Train and prefill run the Mamba2 conv on the rank's heads' ``x``
    channels and all of ``B`` / ``C``: ``conv_w`` / ``conv_b`` reach the
    working copy whole and ``mamba2_split`` posts no collective; a decode
    runs it on the rank's channel chunk (those leaves its chunk) and
    gathers the one token's conv output there."""
    for f in _ranks_of(runs, case):
        for name, dim, n, m in _DECODE_CONV[case]:
            assert f[f"{case}/serve_chunked"]["decode"][name][dim] == n // m
            assert name not in f[f"{case}/serve_chunked"]["prefill"]
        for step in ("train", "prefill"):
            sites = [c for c in f[f"{case}/{step}_collectives"]
                     if c[2] == _MAMBA2_SPLIT]
            assert not sites, (case, step, sites)
        assert any(c[2] == _MAMBA2_SPLIT
                   for c in f[f"{case}/decode_collectives"]), case


@pytest.mark.parametrize("case", SERVE)
def test_serve_call_reads_and_writes_its_cache_shards(runs, case):
    """Each prefill and decode call is handed the rank's shards of the
    cache (their shapes the shards' under the call's specs), and no
    prefill or decode collective carries a cache leaf."""
    for f in _ranks_of(runs, case):
        handed, shards = f[f"{case}/handed"], f[f"{case}/shards"]
        assert len(handed) == 1 + DECODE_STEPS
        assert handed[0] == shards["prefill"]
        assert all(h == shards["decode"] for h in handed[1:])
        for step in ("prefill", "decode"):
            for kind, names, _ in f[f"{case}/{step}_collectives"]:
                assert "cache." not in names, (case, step, kind, names)


def test_mamba2_state_shards_split_the_model_axis(runs):
    """The ``ssm`` state is sharded on its 8 heads and the ``conv`` state
    on its 160 channels over 'model' = 4 (B = 4 over 'data' = 2 rows
    each), zamba2's with its (group, layer) lead, and each call is handed
    those shards."""
    f = runs["flags"][0]
    for kind in ("prefill", "decode"):
        shards = f["mamba2/shards"][kind]
        assert shards["ssm"] == (2, 2, 2, 16, 16)
        assert shards["conv"] == (2, 2, 3, 40)
        shards = f["zamba2/shards"][kind]
        assert shards["mamba.ssm"] == (2, 2, 2, 2, 16, 16)
        assert shards["mamba.conv"] == (2, 2, 2, 3, 40)


@pytest.mark.parametrize("case", FLOPS)
def test_split_step_counts_a_fraction_of_the_flops(runs, case):
    """A rank's split train step counts at most ``FLOPS_FRACTION`` of the
    FLOPs of its rows through one unsplit rank (the model axis is 4)."""
    flags = _ranks_of(runs, case)
    unsplit = flags[0][f"{case}/flops_unsplit"]
    for f in flags:
        ratio = f[f"{case}/flops"] / unsplit
        assert 0 < ratio <= FLOPS_FRACTION, f"{case}: {ratio:.3f}"
