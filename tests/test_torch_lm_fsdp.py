"""Per-block parameter gathering in the LM mesh steps
(``repro_torch.launch.fsdp``: ZeRO-3 as JAX's specs place it), on the CPU.

* The port: one spawn of 4 ``gloo`` ranks as (2, 2) (``tests/
  test_torch_ring_mesh.py``'s harness) runs, for each smoke config of
  ``ARCHS``, one mesh train step and a mesh prefill and decode step,
  reading ``fsdp.stats`` and counting the step's collectives
  (``op_analysis``); then one spawn of 6 ranks as (2, 3), where the smoke
  llama3.2's ``embed`` is sharded ``(None, ("model", "data"))`` and its
  ``wk`` / ``wv`` ``(("data", "model"), None, None)`` a layer: a fused
  dim, whose chunks DTensor orders in mesh order, runs one train step.
* The reference of the fused case: one process's train step of the same
  model and batch under ``ambient_mesh(MeshShape((2, 3)))`` (the
  reference every mesh test holds the port to; ``test_torch_lm_tp.py``
  holds that against JAX's mesh runs).
* Held: the gathered parameter bytes alive at once never exceed the
  largest block's gathered bytes plus every non-block leaf's, from the
  plan's shapes, and stay below a whole working copy's; a train step
  gathers each block twice (forward and recompute) and each non-block
  group once, a serve call each once; the step's all-reduces carry only
  the loss and the gradients of leaves replicated over 'data', never one
  sharded on it; in the fused case the mesh step's gradients (gathered)
  lie within ``test_torch_lm_tp.py``'s bound, 1e-4·max|ref| + 1e-6, of
  one rank's, and each fused leaf's update within 1e-3·lr of one rank's.
  Only the fused leaves' updates are held: AdamW's first step moves an
  element by about ±lr whatever its gradient's size, so an element whose
  gradient lies within its eps (one of ``final_norm.scale``'s here) moves
  by what the summation order decides (ROADMAP's note on parameters held
  only at the first step).
* Serving at depth: a narrow ``mamba2-1.3b`` at ``DEPTHS`` layers, a
  prefill and two decode steps fed one rank's greedy tokens, on the same
  spawn of 4 ranks. In float32 the mesh's logits are one rank's within
  1e-5 relative at every depth. In bfloat16 both drift from a float32 run
  on the same (bf16) weights as depth grows, so they drift from each
  other too; the mesh's logits lie no farther from float32's than
  ``TWIN_RATIO`` times one rank's (the split's bf16 partial sums round
  differently from one whole matmul, not worse).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_harness import jax_c1_shim  # noqa: F401
from tests.test_torch_ring_mesh import init_rank, spawn_ranks

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

ARCHS = ("llama3p2_3b", "qwen2_7b", "granite_moe_3b", "mamba2_1p3b",
         "zamba2_2p7b", "whisper_medium")
FUSED = "llama3p2_3b"
FUSED_LEAVES = ("embed", "blocks.0.attn.wk", "blocks.1.attn.wv")
B, S, P, MAX = 4, 16, 8, 16
LR = 3e-4
DEPTHS = (2, 8, 16)
DEPTH_PROMPT, DEPTH_DECODE = 32, 2
TWIN_RATIO = 2.0


def _counts(cfg, kind: str) -> int:
    """The gathers of one ``kind`` call: each block once (twice in a train
    step: its recompute), each non-block group once."""
    per = 2 if kind == "train" else 1
    blocks = cfg.n_layers * per
    top = 2 + (not cfg.tie_embeddings)             # embed, final_norm, head
    if cfg.family == "hybrid":
        top += 1                                    # the shared block
    if cfg.family == "encdec":
        top += 1                                    # dec_pos
        if kind == "train":                         # the encoder
            blocks += cfg.n_enc_layers * per
            top += 2                                # enc_pos, enc_final_norm
    return blocks + top


def _plan_bytes(sharded, plan) -> dict:
    """The gathered bytes of each block (by its prefix) and of the
    non-block leaves, from the plan's shapes (a leaf with nothing to
    gather is the rank's shard itself: no bytes)."""
    out = {}
    for n, p in sharded.named_parameters():
        if not plan.over[n]:
            continue
        parts = n.split(".")
        key = ".".join(parts[:2]) if parts[0] in ("blocks",
                                                  "enc_blocks") else "top"
        out[key] = out.get(key, 0) + int(np.prod(plan.shapes[n])) \
            * p.dtype.itemsize
    return out


def _depth_cfg(layers: int, dtype: str):
    """The narrow ``mamba2-1.3b`` of the serving-at-depth cases."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("mamba2_1p3b"), n_layers=layers, d_model=64, vocab=1024,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, dtype=dtype)


def _depth_serve(layers: int, dtype: str, feed=None, mesh=None) -> list:
    """The prefill's and each decode step's logits (whole, float32) of the
    narrow model drawn (seed 0) in bfloat16 and run in ``dtype``, on one
    process under ``MeshShape((2, 2))`` or over ``mesh``; decode is fed
    ``feed``, else its own greedy tokens."""
    from repro_torch.launch import steps
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape, ambient_mesh, full_tensors

    cfg = _depth_cfg(layers, dtype)
    model = lm.init_params(_depth_cfg(layers, "bfloat16"), seed=0,
                           device="cpu")
    if dtype != "bfloat16":
        model.cfg = cfg
        model.to(dtype=lm.lm_dtype(cfg))
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, DEPTH_PROMPT)), dtype=torch.int32)
    span, dt = DEPTH_PROMPT + DEPTH_DECODE + 1, lm.lm_dtype(cfg)
    if mesh is None:
        cache = lm.init_cache(cfg, 1, span, dt, "cpu")
        prefill, decode = (steps.make_prefill_step(cfg),
                           steps.make_decode_step(cfg))
    else:
        steps.shard_model(model, mesh)
        cache = steps.init_mesh_cache(cfg, 1, span, dt, mesh,
                                      kind="prefill", device="cpu")
        prefill, decode = (steps.make_prefill_step(cfg, mesh=mesh),
                           steps.make_decode_step(cfg, mesh=mesh))
    out = []
    with torch.no_grad(), ambient_mesh(mesh or MeshShape((2, 2))):
        logits, cache = prefill(model, tokens, cache, {})
        if mesh is not None:
            cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
        for i in range(DEPTH_DECODE + 1):
            if mesh is not None:
                logits = full_tensors([logits])[0]
            out.append(logits.float())
            if i < DEPTH_DECODE:
                tok = (out[-1].argmax(-1).int() if feed is None
                       else feed[i])
                logits, cache = decode(model, tok, cache,
                                       torch.tensor(DEPTH_PROMPT + i), {})
    return out


def _all_reduces(oa) -> list:
    """(site, operand bytes) of every all-reduce ``oa`` counted."""
    return [(r["site"], r["bytes_each"], r["count"])
            for r in oa.top_collectives(None) if r["kind"] == "all-reduce"]


def _main_rank(rank: int, root: str) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import fsdp, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm.tp import make_split
    from repro_torch.pjit_utils import ambient_mesh

    init_rank(rank, 4, root)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        state = steps.init_state(cfg, seed=0, max_seq=S, device="cpu",
                                 mesh=mesh)
        batch = synthetic_batch(cfg, 0, B, S, device="cpu")
        rows = steps._rank_rows(cfg, mesh, batch)
        plan = steps.gather_plan(state.params, make_split(
            cfg, mesh, steps._seq_len(rows)))
        step = steps.make_train_step(cfg, mesh=mesh)
        with ambient_mesh(mesh), OpAnalysis() as oa:
            fsdp.reset_stats()
            state, m = step(state, batch)
            train = fsdp.stats()
        replicated = sum(p.to_local().numel() for p in
                         state.params.parameters()
                         if not p.placements[0].is_shard())
        res = {"train": train, "plan_bytes": _plan_bytes(state.params, plan),
               "all_reduces": _all_reduces(oa), "replicated": replicated,
               "loss": float(m["loss"])}
        # serving: a prefill, then one decode step (its own plan: the
        # decode's split follows the cache's layout)
        model = lm.init_params(cfg, seed=0, max_seq=MAX, device="cpu")
        steps.shard_model(model, mesh)
        tokens = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (B, P)), dtype=torch.int32)
        extras = ({"memory": torch.zeros(B, cfg.enc_seq, cfg.d_model)}
                  if cfg.family == "encdec" else {})
        cache = steps.init_mesh_cache(cfg, B, MAX, torch.float32, mesh,
                                      kind="prefill", device="cpu")
        logits, cache = steps.make_prefill_step(cfg, mesh=mesh)(
            model, tokens, cache, extras)
        cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
        plans = []
        build = steps.gather_plan
        steps.gather_plan = lambda *a: plans.append(build(*a)) or plans[-1]
        try:
            fsdp.reset_stats()
            steps.make_decode_step(cfg, mesh=mesh)(
                model, tokens[:, -1], cache, torch.tensor(P), extras)
            res["decode"] = fsdp.stats()
        finally:
            steps.gather_plan = build
        res["decode_plan_bytes"] = _plan_bytes(model, plans[0])
        out[arch] = res
    with open(os.path.join(root, "feeds.pkl"), "rb") as f:
        feeds = pickle.load(f)
    out["depth"] = {(L, dt): _depth_serve(L, dt, feeds[L], mesh)
                    for L in DEPTHS for dt in ("bfloat16", "float32")}
    if rank == 0:
        with open(os.path.join(root, "main.pkl"), "wb") as f:
            pickle.dump(out, f)


def _fused_rank(rank: int, root: str) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.lm.tp import make_split
    from repro_torch.pjit_utils import ambient_mesh, full_tensors, to_dtensor

    init_rank(rank, 6, root)
    mesh = make_mesh((2, 3), ("data", "model"), device="cpu")
    cfg = get_smoke_config(FUSED)
    state = steps.init_state(cfg, seed=0, max_seq=S, device="cpu",
                             mesh=mesh)
    batch = synthetic_batch(cfg, 0, B, S, device="cpu")
    shards = dict(state.params.named_parameters())
    specs = {n: [(a, q.dim) for a, q in zip(mesh.mesh_dim_names,
                                             shards[n].placements)
                 if q.is_shard()] for n in FUSED_LEAVES}
    with ambient_mesh(mesh):
        rows = steps._rank_rows(cfg, mesh, batch)
        split = make_split(cfg, mesh, steps._seq_len(rows))
        _, grads = steps._shard_grads(cfg, state.params, mesh, [rows], split)
    grads = full_tensors([to_dtensor(g, mesh, p.placements, p.shape)
                          for g, p in zip(grads, shards.values())])
    before = full_tensors(list(shards.values()))
    with ambient_mesh(mesh):
        state, m = steps.make_train_step(cfg, lr=LR, mesh=mesh)(state, batch)
    after = full_tensors(list(state.params.parameters()))
    if rank == 0:
        names = list(shards)
        with open(os.path.join(root, "fused.pkl"), "wb") as f:
            pickle.dump({"specs": specs, "loss": float(m["loss"]),
                         "grads": dict(zip(names, grads)),
                         "update": {n: a - b for n, a, b in
                                    zip(names, after, before)}}, f)


def _fused_reference() -> dict:
    """One process's gradients and step of the fused case under
    ``MeshShape((2, 3))``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape, ambient_mesh

    cfg = get_smoke_config(FUSED)
    state = steps.init_state(cfg, seed=0, max_seq=S, device="cpu")
    batch = synthetic_batch(cfg, 0, B, S, device="cpu")
    params = dict(state.params.named_parameters())
    with ambient_mesh(MeshShape((2, 3))):
        grads = torch.autograd.grad(lm.loss_fn(state.params, batch),
                                    list(params.values()))
        before = {n: p.detach().clone() for n, p in params.items()}
        state, m = steps.make_train_step(cfg, lr=LR)(state, batch)
    return {"loss": float(m["loss"]),
            "grads": dict(zip(params, grads)),
            "update": {n: p.detach() - before[n]
                       for n, p in state.params.named_parameters()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_fsdp")
    main, fused = root / "main", root / "fused"
    main.mkdir()
    fused.mkdir()
    depth = {}
    for L in DEPTHS:
        depth[L, "one"] = _depth_serve(L, "bfloat16")
        feed = [x.argmax(-1).int() for x in depth[L, "one"][:DEPTH_DECODE]]
        depth[L, "float32"] = _depth_serve(L, "float32", feed)
        depth[L, "feed"] = feed
    with open(main / "feeds.pkl", "wb") as f:
        pickle.dump({L: depth[L, "feed"] for L in DEPTHS}, f)
    spawn_ranks(_main_rank, 4, (str(main),))
    spawn_ranks(_fused_rank, 6, (str(fused),))
    with open(main / "main.pkl", "rb") as f:
        got = pickle.load(f)
    with open(fused / "fused.pkl", "rb") as f:
        got_fused = pickle.load(f)
    return {"main": got, "fused": got_fused, "ref": _fused_reference(),
            "depth": depth}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ("train", "decode"))
def test_gathered_bytes_alive_stay_one_block(runs, arch, kind):
    """At no point of a train step (forward, recompute, backward) or a
    decode step are more gathered parameter bytes alive than the largest
    block's plus every non-block leaf's; a whole working copy (every
    block) is more. All of them are freed by the step's end."""
    res = runs["main"][arch]
    sizes = res["plan_bytes" if kind == "train" else "decode_plan_bytes"]
    blocks = [v for k, v in sizes.items() if k != "top"]
    bound = max(blocks) + sizes.get("top", 0)
    whole = sum(sizes.values())
    st = res[kind]
    assert 0 < st["peak_live_bytes"] <= bound < whole, (arch, kind, st,
                                                        bound, whole)
    assert st["live_bytes"] == 0, st


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ("train", "decode"))
def test_each_block_gathered_in_the_block(runs, arch, kind):
    """A train step gathers each block twice (its forward and its
    recompute) and each non-block group once; a decode step each once."""
    from repro_torch.configs import get_smoke_config

    got = runs["main"][arch][kind]["gathers"]
    assert got == _counts(get_smoke_config(arch), kind), (arch, kind, got)
    if kind == "train":
        assert runs["main"][arch]["train"]["reduce_scatters"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_no_gradient_all_reduce_over_data_for_sharded_leaves(runs, arch):
    """The step's gradient all-reduces (at ``steps._shard_grads``) carry
    the loss and the gradients of the leaves replicated over 'data', in
    float32, and nothing else: every leaf sharded over 'data' reaches
    AdamW by its gather's reduce-scatter. The other all-reduces are the
    norm's scalars and the split's activations."""
    res = runs["main"][arch]
    grads = [(b, n) for site, b, n in res["all_reduces"]
             if site == "launch/steps.py:_shard_grads"]
    assert grads == [((res["replicated"] + 1) * 4, 1)], (arch, grads)
    norm = [(b, n) for site, b, n in res["all_reduces"]
            if site == "launch/steps.py:train_step"]
    assert norm and all(b <= 4 * 4 for b, _ in norm), (arch, norm)


def test_fused_dim_leaves_get_one_ranks_update(runs):
    """``embed`` sharded ``(None, ("model", "data"))`` and ``wk`` / ``wv``
    ``(("data", "model"), None, None)`` on (2, 3): their chunks sit in
    mesh order ('data' outer); the reduce-scatter puts each rank's block
    back where its shard lives, so the mesh step's gradients, gathered,
    are one rank's, and so is every leaf's update."""
    got, ref = runs["fused"], runs["ref"]
    assert got["specs"] == {"embed": [("data", 1), ("model", 1)],
                            "blocks.0.attn.wk": [("data", 0), ("model", 0)],
                            "blocks.1.attn.wv": [("data", 0), ("model", 0)]}
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for name, want in ref["grads"].items():
        g = got["grads"][name]
        assert g.shape == want.shape, name
        err = float((g - want).abs().max())
        tol = 1e-4 * float(want.abs().max()) + 1e-6
        assert err <= tol, f"{name}: grad err {err:.3g} > {tol:.3g}"
    for name in FUSED_LEAVES:
        want = ref["update"][name]
        err = float((got["update"][name] - want).abs().max())
        assert err <= 1e-3 * LR, f"{name}: update err {err:.3g}"


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("layers", DEPTHS)
def test_float32_mesh_serve_is_one_ranks_at_depth(runs, layers):
    """In float32 the (2, 2) mesh's prefill and decode logits are one
    rank's to rounding, however deep the model."""
    got = runs["main"]["depth"][layers, "float32"]
    want = runs["depth"][layers, "float32"]
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert len(errs) == 1 + DEPTH_DECODE and max(errs) <= 1e-5, errs


@pytest.mark.parametrize("layers", DEPTHS)
def test_bf16_mesh_serve_no_farther_from_float32_than_one_rank(runs,
                                                                layers):
    """In bfloat16, one rank's logits and the mesh's each drift from a
    float32 run on the same weights and tokens as depth grows; the mesh's
    drift stays within ``TWIN_RATIO`` times one rank's."""
    truth = runs["depth"][layers, "float32"]
    one = max(_rel(a, b) for a, b in zip(runs["depth"][layers, "one"],
                                         truth))
    mesh = max(_rel(a, b) for a, b in zip(
        runs["main"]["depth"][layers, "bfloat16"], truth))
    assert 0 < one and mesh <= TWIN_RATIO * one, (layers, one, mesh)
