"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases (one JSON line per result; any failure raises, exit code != 0):

1. Environment: torch version, the card's name and power limit, TF32 off.
2. Build: compile every CUDA source of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, all in parallel.
3. Kernels: on the ``reddit-like`` graph, with and without self-loops
   (the latter has ~30k zero-in-degree rows), at each main-path shape,
   hold each kernel (B1 Copy-Reduce, B2 fused attention, B3 gSDDMM, B4
   Binary-Reduce, B5 edge softmax) against its plain PyTorch version
   within a stated tolerance, and time kernel, plain version and, where
   one PyTorch call computes the same function, that call — a yardstick
   the port never calls — with CUDA events. B1, B2, B4 and B5 are called
   twice at every shape and must give bit-identical outputs. Every kernel
   and yardstick is also timed on the device alone, warm and with L2
   flushed between launches (cold). B3 is also timed walking canonical
   order (its first version, kept in ``benchmarks/``), and B4 and B5 over
   work lists of other caps K and lanes per segment (the sweep rows).
4. Serve: for gcn, sage and gat, ``build_server(app, "reddit-like")``
   and a 4-client session; served rows must equal a plain-version full
   forward, each refresh must launch exactly the app's kernels (GAT
   serves multipass: B3 × 6 and B4 × 2) and be bit-identical over two
   calls, and no new signature may appear in steady state. The session's
   spans (``repro_torch.obs``): time per span name — intake and batching
   among them — and their coverage; SAGE's exported as a Chrome trace.
5. Forward: ``gat.infer`` on the served model at ``attn`` = multipass,
   softmax-fused (B3 × 2 + B5 × 2) and auto (the fused pipeline on B2,
   × 2), each against the plain multipass forward.
6. Trace: ``torch.profiler`` over one served GAT refresh (multipass): the
   ten device operations that take the most time, with their counts.
7. Blocks (run with the kernel phase, on ``reddit-like``): one class-128
   batch sampled at fan-out 10, seed 0, as the fan-out server samples
   it. Its two block graphs are bipartite (15,488 → 1,408 and 1,408 →
   128 slots) with a dummy row that holds every pad edge, the heaviest
   row, split on the work list; on each, B1 (GCN's weighted sum, SAGE's
   mean), B2, B3 (GAT's add / sub / div), B4 (``copy_rhs`` sum) and B5
   are held against their plain versions, bit-identical where the
   kernel phase requires it, and timed.
8. Serve fan-out: for gcn, sage and gat, ``build_server(app,
   "reddit-like", mode="fanout", fanout=10)`` and the serve phase's
   session; each served batch must launch the app's kernels once per
   block (B1 × 2; GAT B3 × 6 and B4 × 2), no new signature in steady
   state, and ``infer_blocks`` through the kernels must equal the uniform
   pull (``strategy="ell"``) on one fixed minibatch. Per-batch medians of
   each phase of a second session: the host draw (the ``serve.sample``
   span less the block graphs' build), the block graphs, the feature rows
   (``serve.cache_lookup``), the forward (``serve.infer``, with the
   kernels' first-launch structures) and the forward once more on the
   same blocks.
9. Serve exact: on 65,536 nodes of in-degree exactly 8, rows served at
   the default fan-out (8, every in-edge) equal the layer-wise rows.
10. Serve auto: ``mode="auto"``, fan-out 10: the class→mode map must be
    the planner formula's (class 8 fanout, 32 and 128 layerwise); a
    session serves both modes, and one row of each equals its reference.
11. Train: full-graph training on ``reddit-like`` at the widths of
    ``benchmarks/fig2_full_graph.py`` (2 layers, hidden 16; GAT 4 heads ×
    16, then 1 × 41; dropout 0.5 / 0.5 / 0.4), AdamW lr 1e-2. First the
    backward kernels at the step's shapes, each against its plain version
    and timed: B1 on Gᵀ (d = 16, 41 weighted, 16 unweighted) and on G
    (d = 16 weighted and mean), B3 ``copy`` from the destination and
    ``u_dot_v``, B4 ``copy_rhs`` on Gᵀ (B3's ``e_div_v`` and B4 on G
    have the forward's shapes, phase 3; SAGE's layer-0 mean at d = 602
    is serving's). Then GAT's attention chain (B3 logits, the composed
    edge softmax), and the B4 specs' kernel routes (``u_mul_e``,
    ``u_sub_e``, ``u_div_e``, ``e_mul_u``; backward on B1 / B4 over Gᵀ
    and B3): their kernel-route grads bit-identical over two calls and
    within tolerance of the plain ones. Then, per app: one step's grads
    on the kernel path (``strategy="auto"``) against ``"segment"``, per
    parameter, with one dropout seed; the kernel launches of one step
    (``TRAIN_LAUNCHES``); every app's grads bit-identical over two calls
    (GAT's rank-3 ``u_mul_e_add_v`` on B4 per head / B1, its backward on
    B4 / B1 over Gᵀ and B3's dot per head);
    ``train_full_graph`` for 10 epochs on each path, twice, in turns
    (kernel, plain, plain, kernel: epoch time median and p90 over the 20,
    loss finite and falling, peak device memory, launches: every kernel
    on the kernel path, none on the plain one); and one step
    under ``torch.profiler`` (the ten device operations with the most
    time, the port's kernels, device busy time over wall time; marked
    ``"complete": false``, and no busy share read from it, if it never
    recorded the step's launches).
12. Train sampled: minibatch training (``train_sampled``, paper Fig. 3).
    On the two blocks of one SAGE training batch (``reddit-like``, fan-out
    (10, 10), batch 64, seed 0), each block's Gᵀ built from the draw (held
    bit-equal to ``core.graph.reverse``; its build, work lists and first
    launch timed) and the backward kernels on it: B1 at d = 64 unweighted
    and d = 16 weighted, B4 ``copy_rhs`` at H = 4, against their plain
    versions in float64, bit-identical over two calls, timed. Per app, one
    step's grads on the kernel path (``strategy``, ``bwd_strategy`` =
    "auto": B1 / B3 / B4 forward and on G / Gᵀ backward) against the plain
    pull with autograd and with the gather backward, bit-identical over
    two calls, launches exact (``TRAIN_SAMPLED_LAUNCHES``), none on the
    plain paths. Then ``train_sampled`` at ``SAMPLED_RUNS`` (SAGE hidden
    64 on ``products-like`` (15, 10) × 512 and ``reddit-like`` (10, 10) ×
    64; GCN and GAT at the Fig. 2 widths), 2 epochs each, in turns kernel,
    plain, plain, kernel: epoch 1's time with its sample / step split, the
    loss (finite, falling), peak memory and launches; the first SAGE run's
    spans exported. Last, one SAGE step on ``products-like`` under
    ``torch.profiler``, as phase 11's.
13. Relational: ``hetero_gspmm`` alone at ``benchmarks/fig_hetero.py``'s
    100-relation shape (4,000 nodes, 100 relations × 350 edges, d 32 → 16,
    4 bases) for each operand form (``w``; ``basis`` / ``coeff``; 3-D
    ``u`` with ``e``; plain ``u`` with the mean): the kernel route (B1
    over the relation-expanded graph) against the float64 fused route
    within 1e-4·max|ref| + 1e-6, bit-identical over two calls, one B1
    launch a call, timed beside the fused route; B1 alone on each graph.
    Then each relational app's forward through its entry point at its
    benchmark's shape — R-GCN on ``bench_rgcn``'s BGS-like graph (5,000
    nodes, 8 × 25,000 edges, 32 → 32 → 4), GC-MC at ``bench_gcmc``'s
    ML-1M-like shape (2,000 × 1,500, 60,000 ratings, 5 levels), MoNet on
    ``pubmed-like`` (hidden 16, K = 2), LGNN on ``bench_lgnn``'s SBM (800
    nodes, three layers): against the float64 plain forward at the same
    tolerance, bit-identical, launches exact (``RELATIONAL_LAUNCHES``),
    timed; and its kernels alone at the forward's shapes (B1 on each
    relation-expanded graph, B3 ``dot`` / ``add`` / ``copy``). Last,
    R-GCN served through ``build_server`` (4,096 nodes, 8 relations, 32 →
    32 → 8): a layer-wise session (rows against the plain forward, B1 × 2
    a refresh, the refresh bit-identical and timed), a fan-out session at
    fan-out 10 (B4 once per block a batch, the kernels against the
    uniform pull, B4 alone on the two blocks), the exact check (default
    fan-out = layer-wise rows), and ``mode="auto"`` on the BGS-like graph
    at fan-out 3 (class→mode map of the planner's formula, both modes
    served, a row of each against its reference).
14. Train relational: full-graph training of the four relational apps at
    phase 13's shapes — R-GCN (random labels from seed 1, as
    ``bench_rgcn``) and MoNet through ``train_full_graph``, GC-MC
    (``rating_loss``) and LGNN (``train_loss``, BatchNorm in train mode)
    through ``train.make_loss_step`` — and sampled R-GCN on the BGS-like
    merged graph (fan-out (10, 10), batch 64). First the backward kernels
    at the steps' shapes against their float64 plain versions,
    bit-identical over two calls, timed: B1 on the reverse of each
    relation-expanded graph (R-GCN d = 32 / 4, GC-MC both directions d =
    64, MoNet d = 16 / 3, LGNN d = 16 / 2), B3 ``dot`` for MoNet's ∂e, and
    B1 over each sampled block's relation-expanded Gᵀ (d = 32 / 4). Per
    app, one step's grads on the kernel route (``strategy="auto"``)
    against the plain fused route, per parameter, within
    ``TRAIN_GRAD_RTOL``·max|plain| + 1e-6, both routes bit-identical over
    two calls, the kernel launches of one step exact
    (``RELATIONAL_TRAIN_LAUNCHES``), none on the plain route; LGNN's
    running statistics changed by a step; 10 epochs a route in turns
    kernel, plain, plain, kernel (epoch median and p90, loss finite and
    falling, peak memory, launches); one R-GCN step under
    ``torch.profiler``. Sampled R-GCN: its step's grads with the gather
    backward (B1 over the blocks' expanded Gᵀ) against the plain pull with
    the scatter and with the gather backward (both gathers bit-identical),
    then ``train_sampled`` 2 epochs a run in turns: epoch 1 with its
    sample / step split, loss, memory, launches.
15. Strategies: the lattice's layout routes, plain PyTorch, on
    ``reddit-like``, each held against the kernel route (B1 / B2 / B4)
    within ``STRATEGY_TOL`` and timed beside it (CUDA events, host and
    device-only, and peak memory over the call), launching no kernel
    itself. First the host build of each pack (the ELL pack of G and of
    Gᵀ, the ragged ELL, the tile pack, the skew classes). Then ``gspmm``
    under ``push``, ``ell`` and ``onehot`` at ``STRATEGY_ROUTES``, the max
    under ``push`` and ``ell`` against the segment route, and a broadcast
    ``u_dot_v`` through the segment backward (ROADMAP C6) against float64
    autograd of ``push``. Then ``STRATEGY_STEPS`` full-graph steps of GCN
    and SAGE at the fig. 2 widths under ``"ell"`` (the ELL pull both ways,
    no launch) and ``"kernel"`` (launches exact) from one init: per step
    the loss and every grad of ``"ell"`` against ``"kernel"`` at the same
    parameters within ``TRAIN_GRAD_RTOL``·max|kernel| + 1e-6, both
    trajectories' losses alike, step time and peak memory. Then
    ``block_gspmm`` under ``push`` on the block phase's class-128 batch
    against the block kernel route; ``hetero_gspmm`` under ``ell`` (with
    its skew classes) and ``push`` on ``HETERO_SKEW`` against its kernel
    route, the max against ``fused``; and GAT's attention grads through
    the ragged-pack backward against ``_attention_grads``, alone and
    through ``fused_attention``'s B2 route.

16. Planner (``core/planner.py``): the ``cuda`` cost row's fit
    (``benchmarks/torch_planner_fit.py``: each gspmm route's device time
    and work on ``reddit-like`` at d = 16 / 32 / 602, each route's host
    time on ``tiny``) beside the row the planner carries; for each op of
    ``PLANNER_RANK`` / ``PLANNER_RANK_SDDMM`` every route it can run,
    the cost model's ranking beside the measured device times, and
    auto's choice; autotune on the card (gspmm at d = 16 and 602, a
    sampled batch's block, GAT's logits), each winner held to the kernel
    route within ``STRATEGY_TOL``; the plan log and the drift report
    after a layer-wise serve, a full-graph step per app and a sampled
    SAGE epoch. It fails if a plain route (pinned, autotuned or chosen
    by auto) launches a kernel, or a kernel route launches none.

17. Mixed precision (``precision="bf16"``, ``optim/precision.py``): the
    bf16 forms of B1, B3 and B4 at a bf16 training step's shapes
    (``BF16_B1`` / ``BF16_B3`` / ``BF16_B4``, on G and Gᵀ), each
    bit-identical over two calls and held element by element to the
    float64 plain version of its bf16 inputs and fp32 weights and to its
    plain bf16 version, timed warm, device-only and cold beside its bf16
    bound, the fp32 kernel's device time and a bf16 library call; per app
    (GCN, SAGE, GAT full graph; SAGE, GCN, GAT sampled; R-GCN, MoNet and
    sampled R-GCN) one bf16 step's fp32 grads on the kernel path against
    the plain bf16 path within ``BF16_GRAD_RTOL`` (plus the plain path's
    own bf16 noise), bit-identical, with exactly the fp32 step's
    launches; the masters and AdamW moments fp32;
    ``train_full_graph`` in bf16 in turns with the fp32 kernel path
    (epoch median / p90, peak memory, the bf16 − fp32 final loss), the
    per-step cast of ``x``; ``train_sampled`` in bf16 at
    ``SAMPLED_RUNS``; R-GCN and MoNet epochs; the ``cuda:bf16`` cost
    row's fit (``benchmarks/torch_planner_fit.py --dtype bf16``) and
    auto's choice at each main-path op in bf16, the kernel at every one.

18. Partitioned training (``core/partition.py``, ``train_partitioned``;
    ``PART_*``, benchmarks/fig_partitioned.py's widths): the kernels on
    the ring's stage graphs and their reverses (B1 fp32 and bf16, B3
    ``add``, B4 ``copy_rhs``, B5 on the graph of every bucket), each
    against its float64 plain version, bit-identical, timed; one step of
    GCN, SAGE and GAT (and GCN / SAGE delayed refresh, stale and int8
    steps) on the kernel path against the plain ring (JAX's emulated
    loop), logits and grads within 1e-4·max|plain| + 1e-6, bit-identical
    over two calls, launching exactly ``partitioned_launches`` (a stale
    step the local graph alone); ``train_partitioned`` per app at S = 2 /
    4 / 8 (launches exact, the loss falling), GCN delayed, GCN in fp32 /
    bf16 × none / int8 (int8 raw / wire bytes ≥ 3 at fp32, bf16 × int8's
    final loss within 2e-2 of fp32's); the power-law leg; GCN and SAGE on
    ``reddit-like`` at S = 4 in turns kernel / plain beside the
    single-device epoch, with peak memory and one traced step.

19. The LM stack (``models/lm``, ``launch/{steps,train,serve}.py``,
    ``checkpoint/``; no kernel of its own): (a) each of the ten smoke
    configs, initialised on the CPU and copied to the card, card against
    CPU in fp32 — loss, grads, prefill logits and caches and two decode
    steps within 1e-4·max|cpu| + 1e-6, MoE routing (``gate_idx``,
    ``keep``) equal, the SSM / hybrid decode equal to the longer prefill
    within 2e-3, five ``make_train_step`` steps on a fixed batch with the
    last loss below the first (microbatch 2 for ``LM_MICROBATCH``);
    (b) a smoke train state (fp32 and bf16) saved from the card and
    restored onto it bit-exact, and the step taken after the restore
    bit-equal to the uninterrupted one; (c) ``llama3.2-3b`` at its full
    published config (its reckoned memory, bf16 params and grads and
    fp32 moments, must fit the card's free memory: ``reduced`` stays
    empty): a 2-layer full-width fp32 copy card against
    CPU (loss and last-position logits within 1e-4·max + 1e-6), then
    ``launch.train.main`` (1 warm-up and 3 timed steps at B = 2, S = 512
    on a fixed batch, the loss falling) and ``launch.serve.main`` twice
    (prefill 4 × 512, 32 greedy decode steps, the tokens equal): step ms,
    tokens/s, model TFLOP/s (6·active params·tokens; prefill 2·…) and its
    share of 989 TFLOP/s, prefill ms, decode ms a step, peak memory;
    (d) attention's backward residency: ``blockwise_attention`` alone at
    llama's attention widths (1 × 24 heads × 4,096, head_dim 128, KV
    blocks of 512, fp32), the bytes its forward leaves for its backward
    held to each KV block's running (acc, m, denom) plus q's fp32 copy
    and 64 MiB (every block's scores and probabilities printed beside),
    output and grads against the CPU within 1e-4·max + 1e-6; then
    ``llama3.2-3b`` at its full published config through
    ``launch.train.main`` and ``zamba2-2.7b`` at its published width cut
    to 12 of 54 layers (two applications of its shared attention block),
    each at B = 1, S = 4,096, 1 warm-up and 3 timed steps, the loss
    falling: step ms, peak memory, reckoned state, the card.

20. The mesh ring (``core/partition.py`` with a process group,
    ``core/transport.py``, ``launch/mesh.py``; run after phase 18, before
    19): B1 on rank 0's busiest local stage graph of ``reddit-like``'s S =
    4 partition and on the reverse of its busiest column bucket, against
    the float64 plain version, timed (kernel rows); then ``MESH_RANKS``
    processes spawned (this one already holds a CUDA context) join one
    ``gloo`` group on this card — every rank ``cuda:0``, its blocks through
    host memory — and load the kernels built in phase 2: (a) on
    ``pubmed-like`` at S = 2 (a sub-group of ranks 0 and 1) and 4, the op
    cases (``ring_gspmm`` scalar and per-head, int8, the delayed halo,
    the partitioned attention; forward and grads) on each rank's shard
    against the emulated ring on the card within 1e-4·max|ref| + 1e-6;
    (b) ``train_partitioned`` of GCN / SAGE / GAT at phase 18's widths,
    3 epochs, the losses within 1e-4 of the emulated run, the parameters
    bit-equal across the ranks, each rank's launches its step's
    (``mesh_launches``) per step; (c) GCN and SAGE at ``PART_HEAVY``:
    epoch ms beside phase 18's emulated and single-device epochs, each
    rank's exchange ms and bytes (gloo through the host on one card: not
    an NVLink or NCCL number), peak memory, rank 0's traced kernel ms.

21. The LM mesh (``pjit_utils.py``, ``launch/shardings.py``, the mesh
    train step of ``launch/steps.py``, the mesh save and sharded restore
    of ``checkpoint/``; run after phase 19; no kernel of its own):
    ``MESH_RANKS`` processes spawned join one ``gloo`` group on this card
    (every rank ``cuda:0``, its bytes through host memory) as a
    ``LM_MESH`` (2, 2) process mesh: (a) qwen2, granite-MoE and zamba2
    smoke, 3 steps at B = 4, S = 32, held to the same steps run here on
    one rank under ``ambient_mesh(MeshShape((2, 2)))`` (the MoE's token
    blocks): losses within 1e-5 relative, the gathered params within
    1e-4·max + 1e-6 plus 1% of the steps' lr, every two ranks holding the
    same chunk of a leaf bit-equal; (b) llama smoke saved after 2 steps
    on (2, 2) and, in a second spawn, restored onto (4, 1) with
    ``data == 4``, its step 3 within 1e-5 of the uninterrupted run's;
    (c) ``llama3.2-3b`` at its published width (bf16), depth cut to
    ``LM_MESH_FULL``'s layers so four ranks share the card (``reduced``):
    1 warm-up and 3 timed steps at B = 4, S = 512 on a fixed batch, each
    loss within 2e-2 of the same model's one-rank run here, the loss
    falling; step ms per rank, the per-block parameter gathers' ms, bytes
    and count, the gathered bytes alive at once at their peak beside a
    whole working copy's bytes, the gradients' reduce-scatters' and the
    other reductions' ms and bytes per rank (gloo through the host on one
    card: not an NVLink or NCCL number), each rank's state bytes beside
    the one-rank state's and the specs' count, peak memory per process,
    the card's name and power limit.

22. LM serving over the mesh and the dry run's counts (the mesh prefill
    and decode steps of ``launch/steps.py``, ``launch/dryrun.py``,
    ``launch/op_analysis.py``, ``launch/roofline.py``; run after phase 21;
    no kernel of its own): ``MESH_RANKS`` processes spawned join one
    ``gloo`` group on this card as the ``LM_MESH`` (2, 2) process mesh:
    (a) llama, mixtral (MoE, sliding window), whisper (enc-dec) and mamba2
    smoke, the model of shards and a cache of ``cache_specs``' shards: the
    mesh prefill of ``LM_SERVE_MESH_SMOKE``'s prompt, the cache resharded
    to the decode specs, ``LM_SERVE_MESH_STEPS`` greedy decode steps, held
    to the same steps run here on one rank under ``ambient_mesh(
    MeshShape((2, 2)))``: logits within ``LM_SERVE_MESH_TOL`` relative,
    tokens equal, each rank's cache bytes the specs' count; (b)
    ``llama3.2-3b`` at its published width, depth cut to
    ``LM_MESH_FULL``'s layers (``reduced``), served at
    ``LM_SERVE_MESH_FULL``: prefill ms (a warm-up and a timed call, each on
    a fresh cache), decode ms a step, the gathers' ms and bytes per call
    (gloo through the host on one card: not an NVLink or NCCL number), the
    cache's bytes and peak memory per rank; the same model and prompt
    served here on one rank under ``ambient_mesh(MeshShape((2, 2)))``,
    whose greedy tokens the ranks' decode steps are fed: each rank's
    logits of every call within ``LM_MESH_FULL_TOL`` (bf16) relative of
    one rank's, its greedy tokens equal but at near-ties (one rank's
    logits of the two tokens within that bound); the other rows of
    ``LM_SERVE_MESH_FULL_ROWS`` the same way, each printing its peak
    memory per rank beside a whole working copy's bytes, the last one
    ``mamba2-1.3b`` at all 48 layers in float32 (B = 1), with its bf16
    twin's distance from it on one rank and on the mesh; (c)
    ``op_analysis`` of
    real steps held EQUAL to the dry run's fake count of the same step
    (``dryrun.build_cell`` on cuda), and that fake count EQUAL to the same
    cell faked on the CPU, as a CPU-only torch counts it (FLOPs,
    collective bytes, the HBM estimate): rank 0's decode step of (b)
    against a fake (2, 2) group in this process (the real HBM estimate
    less ``gloo``'s host staging), and one rank's ``LM_FULL`` train step
    (``LM_TRAIN``) and decode step (``LM_SERVE``'s, after its prefill)
    here; beside each, the roofline terms at the H100 datasheet constants,
    the measured ms and the fraction of roofline, and the same for phase
    21's one-rank 2-layer step from its fake count.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
FLUSH_BYTES = 128 << 20       # written between cold launches: > 2.5x L2
SLEEP_CYCLES = 2_000_000      # ~1 ms of GPU sleep ahead of each timed launch
B1_SHAPES = [(32, "sum"), (41, "sum"), (602, "sum"),
             (32, "mean"), (41, "mean"), (602, "mean")]
B1_MAIN = [(32, "sum"), (41, "sum"), (602, "mean"), (32, "mean")]
B2_SHAPES = [(4, 32), (1, 41)]
# (op, lhs target, rhs target, width): GAT multipass's three per layer at
# H = 4 then 1, and mul / dot / copy at the same shapes
B3_SHAPES = [(op, lt, rt, d) for op, lt, rt in (
    ("add", "u", "v"), ("sub", "e", "v"), ("div", "e", "v"),
    ("mul", "e", "v"), ("dot", "u", "v"), ("copy", "u", None))
    for d in (4, 1)]
B3_MAIN = [(op, lt, rt, d) for d in (4, 1)
           for op, lt, rt in (("add", "u", "v"), ("sub", "e", "v"),
                              ("div", "e", "v"))]
# (binop, width of B, width of E, reduce): the composed softmax's sums
# at H = 4 then 1, a vector-E u_mul_e, a mean, and a width-1 E divided
# into a width that is no power of two, a mean through the split rows' fold,
# and GAT's per-head sum at 8 heads × 8 (an E value per head)
B4_SHAPES = [("copy_rhs", 4, 4, "sum"), ("copy_rhs", 1, 1, "sum"),
             ("mul", 32, 32, "sum"), ("copy_rhs", 4, 4, "mean"),
             ("div", 41, 1, "mean"), ("mul", 64, 8, "sum")]
B4_MAIN = B4_SHAPES[:2]
B4_CAPS = (128, 256)          # work-list caps K of B4's sweep rows
B4_LANES = (16, 32)           # lanes per segment of B4's sweep rows
B5_SHAPES = [4, 1]
B5_CAPS = (128, 256, 512)     # work-list caps K of B5's sweep rows
B5_LANES = (16, 32)           # lanes per segment of B5's sweep rows
# where span traces are exported (git-ignored, like the kernel builds)
TRACE_DIR = os.path.join("build", "traces")
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in (
    "spmm_csr", "fused_attention_csr", "sddmm_csr", "binary_reduce_csr",
    "edge_softmax_csr")}
REPLACES = {"spmm_csr": "src/repro/kernels/spmm/kernel.py:31",
            "fused_attention_csr": "src/repro/kernels/edge_softmax/kernel.py:51",
            "sddmm_csr": "src/repro/kernels/sddmm/kernel.py:18",
            "sddmm_csr:copy": "src/repro/kernels/sddmm/kernel.py:36",
            "binary_reduce_csr": "src/repro/kernels/binary_reduce/kernel.py:32",
            "edge_softmax_csr": "src/repro/kernels/edge_softmax/kernel.py:23"}
# kernel launches per refresh of each app's served (default) forward, and
# per forward of each GAT attn mode; every other counter must stay 0.
# GAT's per-head sum is B4 at layer 0's H heads and B1 at the output
# layer's one head
SERVE_LAUNCHES = {"gcn": {"spmm_csr": 2}, "sage": {"spmm_csr": 2},
                  "gat": {"sddmm_csr": 6, "binary_reduce_csr": 3,
                          "spmm_csr": 1}}
# (attn="fused" names the fused pipeline's plain version, as in the JAX
# package; "auto" is the pipeline on its kernel, B2)
FORWARD_LAUNCHES = {"multipass": {"sddmm_csr": 6, "binary_reduce_csr": 3,
                                  "spmm_csr": 1},
                    "softmax-fused": {"sddmm_csr": 2, "edge_softmax_csr": 2,
                                      "binary_reduce_csr": 1, "spmm_csr": 1},
                    "auto": {"fused_attention_csr": 2}}
# kernel launches per full-graph training step (forward and backward) of
# each app, strategy "auto": GCN B1 × 2 forward, × 2
# on Gᵀ backward; SAGE B1 × 2 forward, × 1 on Gᵀ backward (layer 0 reads
# x, which needs no grad); GAT multipass B3 × 6, B4 × 2 and the per-head
# sum (B4 at layer 0's heads, B1 at the output's one head) forward, per
# layer backward B3 e_div_v and copy, B4 on G × 3 (div, sub, add's v) and
# on Gᵀ × 1 (add's u), and the per-head sum's ∂z on Gᵀ (B4 / B1) and
# ∂α (B3 dot per head / dot)
TRAIN_LAUNCHES = {"gcn": {"spmm_csr": 4}, "sage": {"spmm_csr": 3},
                  "gat": {"sddmm_csr": 10, "sddmm_csr:copy": 2,
                          "binary_reduce_csr": 12, "spmm_csr": 2}}
# kernel launches per sampled training step (two blocks; forward and
# backward), strategy and bwd_strategy "auto": the full-graph step's, now
# on the block graphs and their Gᵀ (GAT's max runs on the uniform pull,
# with the gather backward in plain torch)
TRAIN_SAMPLED_LAUNCHES = {"gcn": {"spmm_csr": 4}, "sage": {"spmm_csr": 3},
                          "gat": {"sddmm_csr": 10, "sddmm_csr:copy": 2,
                                  "binary_reduce_csr": 12, "spmm_csr": 2}}
# kernel launches per forward of each relational app on the kernel route
# (the relational phase): R-GCN B1 × 2 (one fused aggregation a layer, on
# the relation-expanded graph); GC-MC B1 × 2 (the two encoder directions)
# and B3 dot × 5 (a decoder score per rating level); MoNet B3 copy × 2 (the
# pseudo-coordinates) and B1 × 2; LGNN, three layers, B3 add (Pᵀx) and B1
# (its three streams fused) × 3. A fan-out R-GCN batch launches B4 once
# per block (RGCN_FANOUT_LAUNCHES)
RELATIONAL_LAUNCHES = {"rgcn": {"spmm_csr": 2},
                       "gcmc": {"spmm_csr": 2, "sddmm_csr": 5},
                       "monet": {"spmm_csr": 2, "sddmm_csr:copy": 2},
                       "lgnn": {"spmm_csr": 3, "sddmm_csr": 3}}
RGCN_FANOUT_LAUNCHES = {"binary_reduce_csr": 2}
# kernel launches per training step (forward and backward) of each
# relational app, strategy "auto": the forward's (RELATIONAL_LAUNCHES),
# then backward R-GCN B1 × 2 (∂ of each layer's message table, B1 on the
# relation-expanded graph's reverse); GC-MC B1 × 2 (the two encoder
# tables) and, per rating level, B3 mul × 2 (ct times the other node
# operand) and B4 copy_rhs × 2 (the per-edge rows summed onto users over
# Gᵀ and onto items over G); MoNet B1 × 2 and B3 dot × 2 (∂ of the
# kernel weights); LGNN per layer B1 × 1 and, but for the last layer
# (whose line-graph output the loss does not read), B4 × 2 (Pᵀx's ∂u over
# Gᵀ, ∂v over G). A sampled R-GCN step: B4 a block forward, B1 over each
# block's relation-expanded Gᵀ backward
RELATIONAL_TRAIN_LAUNCHES = {
    "rgcn": {"spmm_csr": 4},
    "gcmc": {"spmm_csr": 4, "sddmm_csr": 15, "binary_reduce_csr": 10},
    "monet": {"spmm_csr": 4, "sddmm_csr": 2, "sddmm_csr:copy": 2},
    "lgnn": {"spmm_csr": 6, "sddmm_csr": 3, "binary_reduce_csr": 4},
    "rgcn_sampled": {"spmm_csr": 2, "binary_reduce_csr": 2}}


def partitioned_launches(app: str, stages: int, parts: int = 0) -> dict:
    """Kernel launches of one partitioned training step of a two-layer
    app (phase 18). An exact ring pass is B1 per non-empty ring diagonal
    (``stages``): GCN forward 2 passes, backward 2 (∂x on each stage's
    reverse, layer 0's through its linear); SAGE backward 1 (its layer-0
    input needs no grad). With a delayed halo or int8 exchanges a pass is
    B1 on the local (diagonal-0) graph and, on a refresh step, on the
    remote (off-diagonal) one: ``parts`` graphs instead of ``stages``.
    GAT per layer: B3 add per stage and B5 forward; backward B4 copy_rhs
    twice per stage (∂el on the reverse, ∂er) plus the softmax's B4 and
    B3 sub; its per-head sum (rank 3) runs on the segment route."""
    if app == "gat":
        return {"sddmm_csr": 2 * stages + 2,
                "binary_reduce_csr": 4 * stages + 2, "edge_softmax_csr": 2}
    return {"spmm_csr": (4 if app == "gcn" else 3) * (parts or stages)}


def mesh_launches(app: str, n_fwd: int, n_bwd: int) -> dict:
    """Kernel launches of one partitioned training step of a two-layer
    app on one rank of the mesh ring (phase 20): the rank's non-empty
    buckets of its row (``n_fwd``, reduced forward) and of its column
    (``n_bwd``, whose reverses the backward reduces) take the places of
    the emulated pass's stage graphs, so a rank whose buckets are all
    non-empty launches ``partitioned_launches`` of its step. A delayed
    refresh or an int8 step launches the same (the local and the remote
    part are every stage); a stale one its diagonal bucket alone."""
    if app == "gat":
        return {"sddmm_csr": 2 * n_fwd + 2,
                "binary_reduce_csr": 2 * (n_fwd + n_bwd) + 2,
                "edge_softmax_csr": 2}
    return {"spmm_csr": 2 * n_fwd + (2 if app == "gcn" else 1) * n_bwd}


# the relational phase's shapes, the repo's own benchmarks'. hetero_gspmm
# alone at benchmarks/fig_hetero.py's 100-relation BGS_SWEEP row (nodes,
# relations, edges per relation; d_in → d_out, bases), one operand form a
# row: (form, reduce, with an e operand)
HETERO_SHAPE = (4000, 100, 350)
HETERO_DIMS = (32, 16, 4)
HETERO_FORMS = [("w", "mean", False), ("basis", "mean", False),
                ("u3", "sum", True), ("plain", "mean", False)]
# R-GCN on benchmarks/fig2_full_graph.py::bench_rgcn's BGS-like graph
# (nodes, relations, edges per relation; 32 → 32 → 4, 4 bases); served in
# mode auto there at fan-out RGCN_AUTO_FANOUT, where the planner's formula
# puts classes 8 and 32 on fan-out and 128 layer-wise
RGCN_BGS = (5000, 8, 25_000)
RGCN_AUTO_FANOUT = 3
# R-GCN's layer-wise, fan-out and exact sessions: build_server's typed
# graph for any dataset but "tiny" (4096 nodes, 8 relations, 32 → 32 → 8)
RGCN_SERVE_DATASET = "bgs-like"
# GC-MC at bench_gcmc's ML-1M-like shape (users, items, ratings, levels;
# d_user, d_item, d_hidden, d_out)
GCMC_SHAPE = (2000, 1500, 60_000, 5)
GCMC_DIMS = (64, 64, 64, 32)
# MoNet on pubmed-like, hidden 16, K = 2 mixture kernels
MONET_DATASET, MONET_HIDDEN, MONET_K = "pubmed-like", 16, 2
# LGNN on bench_lgnn's SBM (nodes, communities, p_in, p_out; d_emb,
# d_hidden; three layers)
LGNN_SBM = (800, 2, 0.06, 0.003)
LGNN_DIMS = (16, 16)
# sampled R-GCN training on the BGS-like merged graph (phase 14): fan-outs,
# batch size, batches per epoch (SAMPLED_EPOCHS epochs; 20, not the 30 of
# the plain apps' runs, keeps the phase near 20 s of the script)
SAMPLED_RGCN = ((10, 10), 64, 20)
# the sampled-training phase (benchmarks/fig3_sampled_sage.py's SWEEP rows
# for SAGE at hidden 64; GCN and GAT at fig2_full_graph.py's widths):
# (app, dataset, fan-outs, batch size, hidden width, batches per epoch)
# (at batch 64 SAGE's loss climbs for its first ~20 batches, then falls:
# an epoch of 30 batches puts the second epoch's mean below the first's)
SAMPLED_RUNS = [("sage", "products-like", (15, 10), 512, 64, 8),
                ("sage", "reddit-like", (10, 10), 64, 64, 30),
                ("gcn", "reddit-like", (10, 10), 64, 16, 30),
                ("gat", "reddit-like", (10, 10), 64, 16, 30)]
SAMPLED_EPOCHS = 2
# the block backward kernels on each block's Gᵀ of SAGE's reddit-like
# training batch: B1 unweighted at d = 64 (SAGE's ∂h, 1/deg folded into
# the cotangent) and weighted at d = 16 (GCN's ∂h), B4 copy_rhs at H = 4
# (∂u of GAT's layer-0 logits)
SAMPLED_B1 = [(64, "copy_sum"), (16, "sum")]
SAMPLED_B4 = [("copy_rhs", 4, 4, "sum")]
# the training phase: hidden width and epochs; per-parameter grads of the
# kernel path against the plain one are held to TRAIN_GRAD_RTOL of the
# parameter's largest plain grad (+ 1e-6): a weight's grad sums up to
# 65,536 rows whose terms each carry the aggregations' reordering error
TRAIN_HIDDEN = 16
TRAIN_EPOCHS = 10
TRAIN_GRAD_RTOL = 1e-4
# the training step's kernel shapes that serving's do not cover: B1 on Gᵀ
# (GCN ∂x at d = 41 and 16 weighted, SAGE's at 16 unweighted: "copy_sum",
# its 1/deg_in folded into the cotangent) and on G at d = 16 (GCN layer
# 0 weighted, SAGE layer 1 mean); B3 copy of ct from the destination (∂
# of e_copy_add_v) at H = 4, 1, and u_dot_v (∂ of a scalar weight) at d =
# 16, 41; B4 copy_rhs on Gᵀ (∂ of u_add_v_copy_e's u) at H = 4, 1. GAT's
# per-head sum at 8 heads × 8: ∂α a u_dot_v per head (B3, the fifth field
# its heads) and ∂z B4 mul on Gᵀ with an edge value per head
TRAIN_B1 = {"reverse": [(16, "sum"), (41, "sum"), (16, "copy_sum")],
            "self_loops": [(16, "sum"), (16, "mean")]}
TRAIN_B3 = [("copy", "v", None, 4), ("copy", "v", None, 1),
            ("dot", "u", "v", 16), ("dot", "u", "v", 41),
            ("dot", "u", "v", 64, 8)]
TRAIN_B4 = [("copy_rhs", 4, 4, "sum"), ("copy_rhs", 1, 1, "sum"),
            ("mul", 64, 8, "sum")]
# the strategies phase (15) on reddit-like: each layout route of gspmm
# against the kernel route — (op, width, routes): GCN's weighted sum at
# d = 16, SAGE's mean at d = 602, and the one-hot route's mean at d = 32
# (its one-hot gathered rows take ≈ 47 GB at d = 602); the max against
# the segment route (no kernel computes a max). Every route is held to
# STRATEGY_TOL·max|ref| + STRATEGY_TOL
STRATEGY_ROUTES = [("u_mul_e_add_v", 16, ("push", "ell", "onehot")),
                   ("u_copy_mean_v", 602, ("push", "ell")),
                   ("u_copy_mean_v", 32, ("onehot",))]
STRATEGY_MAX = [("u_copy_max_v", 16, ("push", "ell"))]
STRATEGY_TOL = 1e-5
# full-graph steps of GCN and SAGE under "ell" and "kernel" (fig. 2
# widths: 602 → 16 → 41)
STRATEGY_STEPS = 3
# hetero's ell and push routes on a BGS-like skewed relational graph:
# nodes and per-relation edge counts (200,000 edges as bench_rgcn's, half
# in one relation; max / median 10, seven log2 size classes), d 32 → 16
HETERO_SKEW = (5000, (100_000, 50_000, 20_000, 12_000, 8_000, 5_000,
                      3_000, 2_000))
# the ragged attention backward at GAT's layer-0 shape (heads, features)
RAGGED_ATTN = (4, 16)
# the planner phase (16) on reddit-like: each main-path op (op, width of
# its node / edge operand, width of a second operand or None, lead dims)
# with the routes it can run, the cost model's ranking beside the
# measured device times (onehot only at d <= 32, as in phase 15)
PLANNER_RANK = [("u_mul_e_add_v", 16, 1, ()),
                ("u_copy_mean_v", 602, None, ()),
                ("e_copy_add_v", 4, None, ()),
                ("u_copy_max_v", 16, None, ()),
                ("e_copy_max_v", 4, None, ()),
                ("u_mul_e_add_v", 16, 1, (4,))]
PLANNER_RANK_SDDMM = [("u_add_v_copy_e", 4), ("e_div_v_copy_e", 4)]
PLANNER_ROUTES = ("kernel", "segment", "push", "ell", "onehot")
# autotune on the card: gspmm at GCN's d = 16 and SAGE's mean at d = 602,
# a sampled training batch's outer block (SAGE hidden 64), GAT's logits
PLANNER_AUTOTUNE = [("u_mul_e_add_v", 16, 1), ("u_copy_mean_v", 602, None)]
# the sampled epoch whose plan log and drift report phase 16 prints:
# SAGE (10, 10) × 64 on reddit-like, hidden 64, its first batches
PLANNER_SAMPLED = ((10, 10), 64, 64, 8)
# the mixed-precision phase (17) on reddit-like: the bf16 kernels at a
# bf16 training step's shapes (the forward's and the backward's on G and
# Gᵀ, as TRAIN_B1 / TRAIN_B3 / TRAIN_B4 and serving's GAT shapes): B1
# GCN's weighted sum at d = 16 / 41, SAGE's mean at d = 602 (layer 0) and
# 16, and on Gᵀ the weighted and unweighted (SAGE's ∂h) sums; B3 GAT's
# logits, shift and divide at H = 4 / 1, the copy of ct, a u_dot_v at 16
# and 41 and one per head (64, 8 heads: GAT's ∂α); B4 copy_rhs on G
# (forward) and Gᵀ (∂u) at H = 4 / 1, and GAT's per-head sum (mul, 64
# with an edge value per head, 8) on both. A kernel is held to
# BF16_REF_REL·|ref| + 1e-5·max|ref| of float64 (bf16's unit roundoff:
# one rounding at the store) and BF16_PLAIN_REL·|plain| + 1e-5·max|plain|
# of its plain bf16 version (one bf16 ulp: both round an fp32 sum taken
# in another order); a bf16 step's grads, kernel path against plain, to
# BF16_GRAD_RTOL of the largest plain grad per parameter (JAX's bf16
# tolerance, tests/launch/test_mixed_precision.py) plus twice the plain
# bf16 path's own distance from its fp32 grads (bf16_grads)
BF16_B1 = {"self_loops": [(16, "sum"), (41, "sum"), (602, "mean"),
                          (16, "mean")],
           "reverse": [(16, "sum"), (41, "sum"), (16, "copy_sum")]}
BF16_B3 = {"self_loops": [(op, lt, rt, d) for d in (4, 1)
                          for op, lt, rt in (("add", "u", "v"),
                                             ("sub", "e", "v"),
                                             ("div", "e", "v"),
                                             ("copy", "v", None))]
           + [("dot", "u", "v", 16), ("dot", "u", "v", 41),
              ("dot", "u", "v", 64, 8)]}
BF16_B4 = {label: [("copy_rhs", 4, 4, "sum"), ("copy_rhs", 1, 1, "sum"),
                   ("mul", 64, 8, "sum")]
           for label in ("self_loops", "reverse")}
BF16_REF_REL = 2.0 ** -8
BF16_PLAIN_REL = 2.0 ** -7
BF16_GRAD_RTOL = 2e-2
# the partitioned phase (18), at benchmarks/fig_partitioned.py's widths:
# pubmed-like (16,384 nodes, 45k edges, 500 features, 3 classes), GCN /
# SAGE / GAT at hidden 64, S = 2 / 4 / 8 contiguous, 3 epochs, dropout 0;
# GCN's delayed halo (staleness 4 at S = 8 over 8 epochs: 2 refresh, 6
# stale); GCN in fp32 / bf16 × none / int8 at S = 4; the power-law leg
# (R-MAT 2^13 nodes, 60,000 edges, seed 13, hash at S = 8, F = 8); the
# heavy case on reddit-like at Fig. 2's width (hidden 16), S = 4, 5
# epochs a run. Kernel rows on the busiest off-diagonal stage graph of
# each S = 4 partition and its reverse at the steps' shapes: B1 GCN's
# sums (64 / 3 pubmed, 16 / 41 reddit) and SAGE's layer-0 input (500 /
# 602), ∂x on the reverse; B3 GAT's logits (H = 4 / 1) and B4 their
# ∂el / ∂er; B1 bf16 at 64 / 3; B5 on the graph of every bucket
PART_DATASET = "pubmed-like"
PART_HIDDEN = 64
PART_SHARDS = (2, 4, 8)
PART_EPOCHS = 3
PART_HALO = (8, 4, 8)          # shards, staleness, epochs
PART_PREC_SHARDS = 4
PART_STEP_SHARDS = 4
PART_KERNEL_SHARDS = 4
PART_POWERLAW = (13, 60_000, 13, 8, 8)  # n_log2, edges, seed, shards, F
PART_HEAVY = ("reddit-like", 4, 16, 5)  # dataset, shards, hidden, epochs
PART_INT8_MIN_RATIO = 3.0
PART_LOSS_BF16_TOL = 2e-2
PART_B1 = {"pubmed": {"stage": [(64, "sum"), (3, "sum"), (500, "sum")],
                      "reverse": [(64, "sum"), (3, "sum")]},
           "reddit": {"stage": [(16, "sum"), (41, "sum"), (602, "sum")],
                      "reverse": [(16, "sum"), (41, "sum")]}}
PART_B3 = [("add", "u", "v", 4), ("add", "u", "v", 1)]
PART_B4 = [("copy_rhs", 4, 4, "sum"), ("copy_rhs", 1, 1, "sum")]
PART_B5 = [4, 1]
PART_BF16_B1 = [(64, "sum"), (3, "sum")]
# the mesh ring phase (20): MESH_RANKS processes of one gloo group on this
# card (each rank cuda:0, blocks through host memory), one spawn; S = 2 on a
# sub-group of the first ranks. (a) the op cases at MESH_SHARDS on
# pubmed-like against the emulated ring, (b) train_partitioned at phase 18's
# widths (MESH_EPOCHS), (c) PART_HEAVY. Kernel rows: B1 on rank 0's busiest
# row bucket of reddit-like's S = 4 partition (GCN's 16 / 41 and SAGE's
# layer-0 602) and on the reverse of its busiest column bucket (∂x, 16 / 41)
MESH_SHARDS = (2, 4)
MESH_RANKS = 4                 # = PART_HEAVY's shards
MESH_EPOCHS = PART_EPOCHS
MESH_TIMEOUT_S = 300           # the group's: a rank waiting longer fails
MESH_SPAWN_LIMIT_S = 600
MESH_B1 = {"stage": [(16, "sum"), (41, "sum"), (602, "sum")],
           "reverse": [(16, "sum"), (41, "sum")]}
# the fan-out serving phases: fan-out per layer (benchmarks/fig_serve.py's
# CMP_FANOUT). A served fan-out batch runs one block per layer, so it
# launches what a refresh launches: SERVE_LAUNCHES, per batch
FANOUT = 10
# per block of the class-128 fan-out batch (outer hop first): B1 at GCN's
# weighted sum and SAGE's mean, B2 / B3 / B4 / B5 at GAT's heads
BLOCK_SHAPES = [
    {"b1": [(32, "sum"), (602, "mean")], "b2": [(4, 32)],
     "b3": [k for k in B3_MAIN if k[3] == 4],
     "b4": [("copy_rhs", 4, 4, "sum")], "b5": [4]},
    {"b1": [(41, "sum"), (32, "mean")], "b2": [(1, 41)],
     "b3": [k for k in B3_MAIN if k[3] == 1],
     "b4": [("copy_rhs", 1, 1, "sum")], "b5": [1]}]


# the LM phase (19): the smoke configs' batch (B, S) and cache span, the
# steps of the card's train run and the arch that runs it in 2
# microbatches; the full-width config, its parity copy's depth and batch
# (layers, B, S), its train run (B, S, steps: 1 warm-up + 3 timed) and its
# serve run (B, prompt, tokens: the prefill's and 32 decode steps')
LM_SMOKE = (2, 16, 24)
LM_STEPS = 5
LM_MICROBATCH = "qwen2_vl_2b"
LM_FULL = "llama3p2_3b"
LM_PARITY = (2, 1, 64)
LM_TRAIN = (2, 512, 4)
LM_SERVE = (4, 512, 33)
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 dense
# phase 19 (d), attention's backward residency: (i) blockwise_attention
# alone at LM_FULL's attention widths (B, heads, head_dim, S, KV block;
# causal, fp32) and the slack its bound allows; (ii) LM_FULL at its
# published config and (iii) LM_RESIDENCY_HYBRID's arch at its published
# width cut to that many layers, each trained at (B, S) for 1 warm-up
# step and the rest timed
LM_ATTN_RESIDENCY = (1, 24, 128, 4096, 512)
LM_ATTN_RESIDENCY_SLACK = 64 * 2 ** 20
LM_RESIDENCY_TRAIN = (1, 4096, 4)
LM_RESIDENCY_HYBRID = ("zamba2_2p7b", 12)
LM_CKPT_DIR = os.path.join("build", "lm_ckpt")
# the LM mesh phase (21): MESH_RANKS ranks as a (data, model) mesh; the
# smoke archs held to the one-rank mesh semantics (llama: 3 heads on a
# model axis of 2, context-parallel attention; qwen2: 4 heads, Megatron
# TP; whisper: enc-dec; granite: the MoE's 'slots' split; zamba2: the
# Mamba2 mixer over its heads) and their batch (B, S, steps); the elastic
# restore's two meshes; the full-width config's depth and run (layers, B,
# S, warm-up steps, timed steps)
LM_MESH = (2, 2)
LM_MESH_ARCHS = ("llama3p2_3b", "qwen2_7b", "whisper_medium",
                 "granite_moe_3b", "zamba2_2p7b")
LM_MESH_BATCH = (4, 32, 3)
LM_MESH_ELASTIC = ((2, 2), (4, 1))
LM_MESH_FULL = (2, 4, 512, 1, 3)
LM_MESH_TOL = 1e-5
LM_MESH_FULL_TOL = 2e-2
# and these at their published widths, cut in depth so four ranks share
# the card, trained as LM_FULL's row: (arch, layers); granite's 40 small
# experts run the 'slots' split, mamba2's 64 SSM heads split over 'model'
LM_MESH_FULL_MORE = (("granite_moe_3b", 2), ("mamba2_1p3b", 2))
# phase 21 (a) holds every smoke arch's first-step gradients to one rank's
# and, after the steps, the params of these: whisper's are not held there,
# since one element of its dec_pos has a first-step gradient of -9.3e-9,
# within one eps (1e-8) of AdamW's denominator, where any two valid fp32
# summation orders move the parameter by different fractions of lr (the
# card: 3.7e-5 against a bound of 1.7e-5); tests/test_torch_lm_tp.py holds
# its params against JAX's on the CPU
LM_MESH_PARAMS_ARCHS = ("llama3p2_3b", "qwen2_7b", "granite_moe_3b",
                        "zamba2_2p7b")
# the LM serve mesh phase (22): MESH_RANKS ranks as the LM_MESH process
# mesh serve the smoke archs (prefill, then LM_SERVE_MESH_STEPS greedy
# decode steps at (B, prompt, cache span)), held to one rank under
# MeshShape(LM_MESH) within LM_SERVE_MESH_TOL relative; then the full width
# at LM_MESH_FULL's depth: (B, prompt, timed decode steps), one warm-up each
LM_SERVE_MESH_ARCHS = ("llama3p2_3b", "mixtral_8x22b", "whisper_medium",
                       "mamba2_1p3b")
LM_SERVE_MESH_SMOKE = (4, 16, 32)
LM_SERVE_MESH_STEPS = 8
LM_SERVE_MESH_FULL = (4, 512, 4)
LM_SERVE_MESH_TOL = 1e-5
# phase 22 (b)'s full-width serve rows: (arch, layers, B, prompt, timed
# decode steps, dtype), LM_FULL's first; mixtral's 8 experts run
# expert-parallel on the model axis of 2 (one layer: ≈ 5.4e9 parameters,
# its train state would not fit four ranks on one card, so it is served
# only). The last row shows the per-block point at depth: mamba2-1.3b at
# its published width and all its layers, where a rank's peak is its
# shards and about one block, not a whole working copy. It runs in
# float32: at that depth one rank's bf16 logits and the mesh's each lie
# farther than LM_MESH_FULL_TOL from a float32 run (its twin, below, shows
# how far), so they cannot be held to each other. A row whose dtype is not its
# config's also serves its twin in the config's dtype on the same
# weights, fed the row's greedy tokens, and holds the mesh's twin no
# farther than LM_MESH_TWIN_RATIO times one rank's twin from the row's
# one-rank logits: the split's bf16 sums may round differently from one
# rank's whole matmul, never worse by more than that ratio
LM_SERVE_MESH_FULL_ROWS = (
    (LM_FULL, LM_MESH_FULL[0]) + LM_SERVE_MESH_FULL + ("bfloat16",),
    ("mamba2_1p3b", 2, 4, 512, 4, "bfloat16"),
    ("mixtral_8x22b", 1, 4, 128, 2, "bfloat16"),
    ("mamba2_1p3b", 48, 1, 128, 2, "float32"))
LM_MESH_TWIN_RATIO = 2.0
# phases 21–22's split rows read a step's collectives by op_analysis site:
# these are not the split's activations (the per-block parameter gathers
# and their gradients' reduce-scatters, the step's gradient mean over
# replicas and norm); and these sites may sum in float32 in a
# bf16 model, where JAX's value is float32 too (the head_dim scores, the
# CE's label logit, the MoE's aux and expert-load means) or, in the
# backward, the gradient of a float32 leaf entered through Split.part
# (norms, A_log / dt_bias / skip_D, the router; no larger than the
# largest float32 leaf). Every other reduction runs in the model's dtype,
# and no train or prefill collective is posted by mamba2_split itself.
# On a CUDA device autograd runs the backward on its own thread, whose
# stack holds no frame of the port: op_analysis's site is "" there, which
# the rows call LM_BACKWARD_SITE (on the CPU: steps.py:_loss_and_grads).
LM_NOT_ACTIVATION_SITES = ("launch/fsdp.py:forward",
                           "launch/fsdp.py:backward",
                           "launch/steps.py:_shard_grads",
                           "launch/steps.py:train_step")
LM_FP32_SITES = ("models/lm/layers.py:reduce",
                 "models/lm/model.py:_chunked_ce_split",
                 "models/lm/moe.py:moe_split",
                 "models/lm/moe.py:_mean_over_ranks")
LM_BACKWARD_SITE = "(autograd's device thread)"
LM_FP32_GRAD_SITES = ("launch/steps.py:_loss_and_grads", LM_BACKWARD_SITE)
LM_MAMBA2_SPLIT_SITE = "models/lm/mamba2.py:mamba2_split"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_device_ms(fn, cold: bool, reps: int = 20,
                   warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``'s device work
    alone. The GPU first sleeps, so the host has queued both events and
    ``fn``'s launches before the first event runs (``time_ms`` above also
    counts the host's wrapper time); with ``cold``, ``FLUSH_BYTES`` are
    written between launches so the inputs start outside L2."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if cold:
            flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def warm_cold_ms(fn):
    """``time_device_ms`` of ``fn`` warm and with L2 flushed (cold)."""
    return time_device_ms(fn, False), time_device_ms(fn, True)


def bit_identical(what: str, fn) -> torch.Tensor:
    """Call ``fn`` twice; raise unless the outputs are bit-identical."""
    first, second = fn(), fn()
    if not torch.equal(first, second):
        raise AssertionError(f"{what}: two calls differ by "
                             f"{float((first - second).abs().max())}")
    return first


def bound(bytes_moved: float, flops: float):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rows_read(g) -> tuple:
    """(source rows, destination rows) that some edge of ``g`` references:
    what a kernel must read of a node operand. A block graph's pad source
    slots, which no edge references, are left out; its pad edges, all in
    the dummy row the kernels compute, are counted."""
    return (int(np.count_nonzero(g.host.out_degrees)),
            int(np.count_nonzero(g.host.in_degrees)))


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output has non-finite values")
    return float((got - ref).abs().max()) if ref.numel() else 0.0


def plain_reference(fn, *args, fp64: bool = False):
    """The plain version ``fn`` on ``args``: as is (fp32), or with every
    floating tensor in float64. A block's dummy row sums ~10^4 pad edges
    from ONE source row; the fp32 plain version (atomic ``index_add_``)
    then carries a rounding error that grows with the row's length, so
    the block phase holds the kernels to the fp64 result instead."""
    if not fp64:
        return fn(*args)
    return fn(*(a.double() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args))


def reference_fields(ref, fn, args, fp64: bool) -> dict:
    """Which reference a row's error is taken against; with ``fp64``,
    also the fp32 plain version's own error against it."""
    if not fp64:
        return {"reference": "fp32 plain"}
    return {"reference": "fp64 plain",
            "plain_fp32_max_abs_err": max_err(fn(*args), ref)}


def check_b1(g, w_canon, gen, label: str, rows: dict,
             shapes=B1_SHAPES, fp64: bool = False) -> None:
    from repro_torch.kernels.spmm.ops import spmm_csr, spmm_plain

    deg = g.in_degrees.clamp(min=1).float()
    n_u = rows_read(g)[0]
    for d, red in shapes:      # red: "sum" (weighted), "mean", "copy_sum"
        mean = red == "mean"
        weight = w_canon if red == "sum" else None
        B = torch.randn(g.n_src, d, generator=gen).cuda()
        n0 = spmm_csr.launches
        got = bit_identical(f"spmm_csr d={d} {red}",
                            lambda: spmm_csr(g, B, weight, mean))
        ref = plain_reference(spmm_plain, g, B, weight, mean, fp64=fp64)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-5 * float(ref.abs().max())
        refs = reference_fields(ref, spmm_plain, (g, B, weight, mean),
                                fp64)
        if mean:
            vals = (1.0 / deg).index_select(0, g.long("dst"))
        else:
            vals = (torch.ones(g.n_edges, device=deg.device)
                    if weight is None else weight)
        A = torch.sparse_csr_tensor(g.long("indptr_dst"), g.long("src"),
                                    vals, size=(g.n_dst, g.n_src))
        lib_err = max_err(torch.sparse.mm(A, B), ref)
        k_ms = time_ms(lambda: spmm_csr(g, B, weight, mean))
        p_ms = time_ms(lambda: spmm_plain(g, B, weight, mean))
        l_ms = time_ms(lambda: torch.sparse.mm(A, B))
        k_dev = warm_cold_ms(lambda: spmm_csr(g, B, weight, mean))
        lib_dev = warm_cold_ms(lambda: torch.sparse.mm(A, B))
        nbytes = 4 * ((g.n_dst + 1)
                      + g.n_edges * (1 if weight is None else 2)
                      + n_u * d + g.n_dst * d)
        b_ms, b_by = bound(nbytes, 2 * g.n_edges * d)
        row = {"phase": "kernel", "kernel": "spmm_csr", "graph": label,
               "d": d, "reduce": red, "weighted": weight is not None,
               "max_abs_err": err, "tol": tol, **refs,
               "library_max_abs_err": lib_err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
               "launches": spmm_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"spmm_csr disagrees: {row}")
        rows[(label, d, red)] = row


def check_b2(g, gen, label: str, rows: dict, shapes=B2_SHAPES,
             fp64: bool = False) -> None:
    from repro_torch.kernels.edge_softmax.ops import (fused_attention_csr,
                                                      fused_attention_plain)

    n_u, n_v = rows_read(g)
    for H, F in shapes:
        el = torch.randn(g.n_src, H, generator=gen).cuda()
        er = torch.randn(g.n_dst, H, generator=gen).cuda()
        z = torch.randn(g.n_src, H, F, generator=gen).cuda()
        n0 = fused_attention_csr.launches
        got = bit_identical(f"fused_attention_csr H={H} F={F}",
                            lambda: fused_attention_csr(g, el, er, z, 0.2))
        args = (g, el, er, z, 0.2)
        ref = plain_reference(fused_attention_plain, *args, fp64=fp64)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-4 * float(ref.abs().max())
        refs = reference_fields(ref, fused_attention_plain, args, fp64)
        k_ms = time_ms(lambda: fused_attention_csr(g, el, er, z, 0.2))
        p_ms = time_ms(lambda: fused_attention_plain(g, el, er, z, 0.2))
        k_dev = warm_cold_ms(lambda: fused_attention_csr(g, el, er, z, 0.2))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + n_u * H
                      + n_v * H + n_u * H * F + g.n_dst * H * F)
        b_ms, b_by = bound(nbytes, g.n_edges * H * (2 * F + 6))
        row = {"phase": "kernel", "kernel": "fused_attention_csr",
               "graph": label, "H": H, "F": F, "max_abs_err": err,
               "tol": tol, **refs, "kernel_ms": k_ms, "plain_ms": p_ms,
               "library_ms": None, "kernel_device_ms": k_dev[0],
               "kernel_cold_ms": k_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
               "launches": fused_attention_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"fused_attention_csr disagrees: {row}")
        rows[(label, H, F)] = row


def b3_operands(g, gen, op: str, lt: str, rt, d: int) -> tuple:
    """B3's arguments ``(g, op, lt, lhs[, rt, rhs])`` at one shape, drawn
    from ``gen`` on the card."""
    n_rows = {"u": g.n_src, "v": g.n_dst, "e": g.n_edges}
    args = (g, op, lt, torch.randn(n_rows[lt], d, generator=gen).cuda())
    if rt is not None:
        rhs = torch.randn(n_rows[rt], d, generator=gen).cuda()
        if op == "div":     # the path divides by sums of exp, >= 1
            rhs = rhs.abs() + 0.5
        args += (rt, rhs)
    return args


def check_b3(g, gen, label: str, rows: dict, shapes=B3_SHAPES,
             fp64: bool = False) -> None:
    """B3 at ``shapes`` against its plain version (with ``fp64``, the
    float64 plain version, and bit-identical over two calls), timed. A
    shape's optional fifth field is a dot's heads (a dot per head)."""
    from benchmarks.torch_sddmm_walks import sddmm_canonical
    from repro_torch.kernels.sddmm.ops import (CALLER_INDEX, sddmm_csr,
                                               sddmm_plain)

    n_u, n_v = rows_read(g)
    read = {"u": n_u, "v": n_v, "e": g.n_edges}
    for op, lt, rt, d, *more in shapes:
        heads = more[0] if more else 1
        args = b3_operands(g, gen, op, lt, rt, d)
        lhs = args[3]
        n0 = sddmm_csr.launches
        kernel = functools.partial(sddmm_csr, *args, heads=heads)
        plain = functools.partial(sddmm_plain, heads=heads)
        got = (bit_identical(f"sddmm_csr {op} d={d} heads={heads}", kernel)
               if fp64 else kernel())
        ref = plain_reference(plain, *args, fp64=fp64)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        if op == "dot" or fp64:
            tol = 1e-5 + 1e-5 * float(ref.abs().max())
            why = "fma chain vs torch.sum: another summation order"
        else:
            tol = 0.0
            why = "one IEEE op per element in both: exact"
        lib_ms, lib_dev, lib = None, (None, None), {}
        if op == "copy":
            caller = g.long(CALLER_INDEX[lt])
            lib_err = max_err(lhs.index_select(0, caller), ref)
            if lib_err != 0.0:
                raise AssertionError(f"index_select copy differs: {lib_err}")
            lib_ms = time_ms(lambda: lhs.index_select(0, caller))
            lib_dev = warm_cold_ms(lambda: lhs.index_select(0, caller))
        if (op, lt, rt, heads) == ("dot", "u", "v", 1):
            # sampled V·Uᵀ on the graph's CSR by destination: one value per
            # edge, in CSR (canonical) order, not the caller's
            A = torch.sparse_csr_tensor(
                g.long("indptr_dst"), g.long("src"),
                torch.zeros(g.n_edges, device=lhs.device),
                size=(g.n_dst, g.n_src))
            V, Ut = args[5], lhs.t().contiguous()

            def sampled():
                return torch.sparse.sampled_addmm(A, V, Ut, beta=0.0)
            vals = sampled().values().index_select(0, g.long("eid_inv"))
            lib_err = max_err(vals[:, None], ref)
            if not lib_err <= tol:
                raise AssertionError(f"sampled_addmm dot differs: {lib_err}")
            lib_ms = time_ms(sampled)
            lib_dev = warm_cold_ms(sampled)
            lib = {"library": "torch.sparse.sampled_addmm (CSR order)",
                   "library_max_abs_err": lib_err}
        k_ms = time_ms(kernel)
        p_ms = time_ms(lambda: plain(*args))
        k_dev = warm_cold_ms(kernel)
        # the kernel's first walk (canonical order, written through eid),
        # a benchmark variant kept to show what the caller-order walk buys
        # (it has no dot per head)
        canon_err = canon_ms = None
        if heads == 1:
            canon_err = max_err(sddmm_canonical(*args), ref)
            canon_ms = time_device_ms(lambda: sddmm_canonical(*args), False)
        # one caller-order index array per node operand; an edge operand
        # is read at its own caller edge id, with no index
        n_idx = len({lt, rt} - {"e", None})
        nbytes = 4 * (n_idx * g.n_edges + read[lt] * lhs.shape[1]
                      + (0 if rt is None else read[rt] * args[5].shape[1])
                      + ref.numel())
        b_ms, b_by = bound(nbytes, g.n_edges * d)
        row = {"phase": "kernel", "kernel": "sddmm_csr", "graph": label,
               "op": op, "lhs": lt, "rhs": rt, "d": d, "heads": heads,
               "max_abs_err": err, "tol": tol, "tol_reason": why,
               **reference_fields(ref, plain, args, fp64),
               "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1],
               "canonical_device_ms": canon_ms,
               "canonical_max_abs_err": canon_err, "bound_ms": b_ms,
               "bound_by": b_by, "launches": sddmm_csr.launches - n0, **lib}
        emit(row)
        if not (err <= tol and (canon_err is None or canon_err <= tol)):
            raise AssertionError(f"sddmm_csr disagrees: {row}")
        rows[(label, op, lt, rt, d) + tuple(more)] = row


def check_b4(g, gen, label: str, rows: dict, shapes=B4_SHAPES,
             sweep: bool = True, fp64: bool = False) -> None:
    from repro_torch.kernels.binary_reduce.ops import (_launch_br,
                                                       binary_reduce_csr,
                                                       binary_reduce_plain)
    from repro_torch.kernels.rowsplit import row_split

    deg = g.in_degrees.long()
    has_edge = deg > 0
    n_u = rows_read(g)[0]
    for binop, d, de, red in shapes:
        mean = red == "mean"
        B = (None if binop == "copy_rhs"
             else torch.randn(g.n_src, d, generator=gen).cuda())
        E = torch.randn(g.n_edges, de, generator=gen).cuda()
        if binop == "div":      # keep divisors away from 0
            E = E.abs() + 0.5
        n0 = binary_reduce_csr.launches
        got = bit_identical(f"binary_reduce_csr {binop} d={d} {red}",
                            lambda: binary_reduce_csr(g, B, E, binop, mean))
        args = (g, B, E, binop, mean)
        ref = plain_reference(binary_reduce_plain, *args, fp64=fp64)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5 + 1e-5 * float(ref.abs().max())
        refs = reference_fields(ref, binary_reduce_plain, args, fp64)
        lib_ms = lib_err = None
        lib_dev = (None, None)
        if binop == "copy_rhs":
            # the edge values already in canonical order: the permutation
            # through eid is left out of the library's time
            e_canon = E.index_select(0, g.long("eid"))

            def lib():
                return torch.segment_reduce(e_canon, red, lengths=deg)

            lib_err = max_err(lib()[has_edge], ref[has_edge])
            lib_ms = time_ms(lib)
            lib_dev = warm_cold_ms(lib)
        k_ms = time_ms(lambda: binary_reduce_csr(g, B, E, binop, mean))
        p_ms = time_ms(lambda: binary_reduce_plain(g, B, E, binop, mean))
        k_dev = warm_cold_ms(lambda: binary_reduce_csr(g, B, E, binop, mean))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + E.numel() + ref.numel()
                      + (0 if B is None else g.n_edges + n_u * d))
        b_ms, b_by = bound(nbytes, g.n_edges * d * (1 if B is None else 2))
        row = {"phase": "kernel", "kernel": "binary_reduce_csr",
               "graph": label, "binop": binop, "d": d, "de": de,
               "reduce": red, "max_abs_err": err, "tol": tol, **refs,
               "tol_reason": "another summation order",
               "library_max_abs_err": lib_err, "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1], "bound_ms": b_ms,
               "bound_by": b_by, "bit_identical": True,
               "launches": binary_reduce_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"binary_reduce_csr disagrees: {row}")
        rows[(label, binop, d, de, red)] = row
        if not sweep or (binop, d, de, red) not in B4_MAIN:
            continue
        # the work list's cap K and the lanes per segment: the wrapper's
        # (128, 16) against their neighbours
        lpe = min(32, 1 << (d - 1).bit_length())
        for K, lanes in [(K, n) for K in B4_CAPS for n in B4_LANES
                         if n >= lpe]:
            rs = row_split(g, K)
            k_err = max_err(_launch_br(g, B, E, binop, mean, rs, lanes), ref)
            emit({"phase": "sweep", "kernel": "binary_reduce_csr",
                  "graph": label, "binop": binop, "d": d, "reduce": red,
                  "K": K, "lanes": lanes, "max_abs_err": k_err,
                  "device_ms": time_device_ms(lambda: _launch_br(
                      g, B, E, binop, mean, rs, lanes), False)})
            if not k_err <= tol:
                raise AssertionError(f"binary_reduce_csr K={K} lanes="
                                     f"{lanes} d={d}: {k_err}")


def sparse_softmax(g, x, ref, tol: float) -> dict:
    """B5's library yardstick: ``torch.sparse.softmax`` over the (dst,
    src) COO of ``g`` with the (E, H) logits as dense values, along the
    source dimension — the same function only when no (dst, src) pair
    repeats (coalescing would merge them); its values come back in
    (dst, src) order. Times and error, or why there is none."""
    h = g.host
    dst, src = (a[h.eid_inv].astype(np.int64) for a in (h.dst, h.src))
    key = dst * g.n_src + src
    if np.unique(key).size != g.n_edges:
        return {"library_ms": None, "library": "none: repeated (dst, src) "
                "pairs, which torch.sparse.softmax's COO would merge"}
    order = torch.from_numpy(np.argsort(key, kind="stable")).to(x.device)
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([dst, src])).to(x.device), x,
        size=(g.n_dst, g.n_src, x.shape[1])).coalesce()

    def softmax():
        return torch.sparse.softmax(coo, 1)
    vals = torch.empty_like(x).index_copy_(0, order, softmax().values())
    lib_err = max_err(vals, ref)
    if not lib_err <= tol:
        raise AssertionError(f"torch.sparse.softmax differs: {lib_err}")
    dev = warm_cold_ms(softmax)
    return {"library": "torch.sparse.softmax ((dst, src) order)",
            "library_max_abs_err": lib_err, "library_ms": time_ms(softmax),
            "library_device_ms": dev[0], "library_cold_ms": dev[1]}


def check_b5(g, gen, label: str, rows: dict, shapes=B5_SHAPES,
             sweep: bool = True, fp64: bool = False) -> None:
    from repro_torch.kernels.edge_softmax.ops import (_launch_softmax,
                                                      edge_softmax_csr,
                                                      edge_softmax_plain)
    from repro_torch.kernels.rowsplit import build_row_split

    for H in shapes:
        x = 3 * torch.randn(g.n_edges, H, generator=gen).cuda()
        n0 = edge_softmax_csr.launches
        got = bit_identical(f"edge_softmax_csr H={H}",
                            lambda: edge_softmax_csr(g, x))
        ref = plain_reference(edge_softmax_plain, g, x, fp64=fp64)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-5
        refs = reference_fields(ref, edge_softmax_plain, (g, x), fp64)
        k_ms = time_ms(lambda: edge_softmax_csr(g, x))
        p_ms = time_ms(lambda: edge_softmax_plain(g, x))
        k_dev = warm_cold_ms(lambda: edge_softmax_csr(g, x))
        nbytes = 4 * ((g.n_dst + 1) + g.n_edges + 2 * x.numel())
        b_ms, b_by = bound(nbytes, 4 * x.numel())
        lib = sparse_softmax(g, x, ref, tol)
        row = {"phase": "kernel", "kernel": "edge_softmax_csr",
               "graph": label, "H": H, "max_abs_err": err, "tol": tol,
               **refs,
               "tol_reason": "alpha <= 1; expf and the sum's order differ",
               "kernel_ms": k_ms, "plain_ms": p_ms, **lib,
               "kernel_device_ms": k_dev[0], "kernel_cold_ms": k_dev[1],
               "bound_ms": b_ms, "bound_by": b_by, "bit_identical": True,
               "launches": edge_softmax_csr.launches - n0}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"edge_softmax_csr disagrees: {row}")
        rows[(label, H)] = row
        if not sweep:
            continue
        # the work list's cap K and the lanes per segment: the wrapper's
        # (128, 16) against their neighbours
        hl = min(32, 1 << (H - 1).bit_length())
        for K, lanes in [(K, n) for K in B5_CAPS for n in B5_LANES
                         if n >= hl]:
            rs = build_row_split(g.indptr_dst, K)
            k_err = max_err(_launch_softmax(g, x, rs, lanes), ref)
            emit({"phase": "sweep", "kernel": "edge_softmax_csr",
                  "graph": label, "H": H, "K": K, "lanes": lanes,
                  "max_abs_err": k_err, "device_ms": time_device_ms(
                      lambda: _launch_softmax(g, x, rs, lanes), False)})
            if not k_err <= tol:
                raise AssertionError(f"edge_softmax K={K} lanes={lanes} "
                                     f"H={H}: {k_err}")


def counters():
    """Every kernel wrapper, by name, with its launch counter; B3's copy
    (B3b) is read from ``sddmm_csr.op_launches``."""
    from repro_torch.kernels.binary_reduce.ops import binary_reduce_csr
    from repro_torch.kernels.edge_softmax.ops import (edge_softmax_csr,
                                                      fused_attention_csr)
    from repro_torch.kernels.sddmm.ops import sddmm_csr
    from repro_torch.kernels.spmm.ops import spmm_csr

    return {f.__name__: f for f in (spmm_csr, fused_attention_csr, sddmm_csr,
                                    binary_reduce_csr, edge_softmax_csr)}


def reset_counts() -> None:
    for f in counters().values():
        f.launches = 0
    counters()["sddmm_csr"].op_launches.clear()


def read_counts() -> dict:
    out = {name: f.launches for name, f in counters().items()}
    out["sddmm_csr:copy"] = counters()["sddmm_csr"].op_launches["copy"]
    out["sddmm_csr"] -= out["sddmm_csr:copy"]
    return out


def check_launches(what: str, launches: dict, per_run: dict,
                   runs: int) -> None:
    want = {k: per_run.get(k, 0) * runs for k in launches}
    if runs < 1 or launches != want:
        raise AssertionError(f"{what}: launches {launches} over {runs} "
                             f"run(s); expected {want}")


def span_table(events, export: str = None) -> dict:
    """Per span name of ``events``: count, total and median ms; the share
    of the window the top-level spans cover (``span_coverage``). With
    ``export``, the events are also written as a Chrome trace to
    ``build/traces/trace_<export>.json``."""
    from repro_torch import obs

    names = sorted({e["name"] for e in events})
    table = {n: [e["dur"] / 1e3 for e in events if e["name"] == n]
             for n in names}
    out = {"by_name": {n: {"count": len(v), "total_ms": sum(v),
                           "median_ms": statistics.median(v)}
                       for n, v in table.items()},
           "coverage": obs.span_coverage(events)}
    if export:
        os.makedirs(TRACE_DIR, exist_ok=True)
        out["exported"] = obs.export_chrome_trace(
            os.path.join(TRACE_DIR, f"trace_{export}.json"))
    return out


def serve_app(app: str):
    """Serve ``app`` through ``build_server`` and check it; returns the
    row and the server (its model feeds the forward phase)."""
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import gat, gcn, sage

    from repro_torch import obs

    t0 = time.perf_counter()
    srv = build_server(app, "reddit-like", device="cuda")
    setup_s = time.perf_counter() - t0
    n = srv.g.n_src
    obs.clear_trace()
    reset_counts()
    res = run_session(srv, n_clients=4, requests_per_client=25,
                      ids_fn=lambda rng: rng.integers(0, n, 4))
    launches = read_counts()
    spans = span_table(obs.trace_events(),
                       f"serve_{app}" if app == "sage" else None)
    refreshes = srv.refreshes
    check_launches(app, launches, SERVE_LAUNCHES[app], refreshes)
    if res["recompiles_steady"] != 0:
        raise AssertionError(f"{app}: {res['recompiles_steady']} "
                             f"steady-state recompiles")
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    ref = mod.infer(srv.model, srv.bundle, srv.x_device,
                    strategy="segment").cpu().numpy()
    if not np.isfinite(ref).all() or ref.shape != (n, 41):
        raise AssertionError(f"{app}: plain forward shape {ref.shape}")
    served_err = 0.0
    for ids, rows in res["responses"]:
        if rows.shape != (len(ids), ref.shape[1]):
            raise AssertionError(f"{app}: served shape {rows.shape}")
        served_err = max(served_err, float(np.abs(rows - ref[ids]).max()))
    if not served_err <= 1e-4:
        raise AssertionError(f"{app}: served rows off by {served_err}")
    table = bit_identical(f"{app} refresh", lambda: mod.infer(
        srv.model, srv.bundle, srv.x_device)).cpu().numpy()
    table_err = float(np.abs(table - ref).max())
    if not table_err <= 1e-4:
        raise AssertionError(f"{app}: kernel forward off by {table_err}")

    def kernel_forward():
        mod.infer(srv.model, srv.bundle, srv.x_device)

    def plain_forward():
        mod.infer(srv.model, srv.bundle, srv.x_device, strategy="segment")

    row = {"phase": "serve", "app": app, "dataset": "reddit-like",
           "n_samples": res["n_samples"], "p50_ms": res["p50_ms"],
           "p99_ms": res["p99_ms"], "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "refreshes": refreshes, "launches": launches,
           "served_max_abs_err": served_err,
           "table_max_abs_err": table_err, "refresh_bit_identical": True,
           "spans": spans,
           "refresh_forward_ms": time_ms(kernel_forward, reps=5, warmup=1),
           "plain_forward_ms": time_ms(plain_forward, reps=5, warmup=1),
           "setup_s": setup_s}
    emit(row)
    return row, srv


def forward_gat(srv) -> dict:
    """``gat.infer`` on the served GAT at each attn mode that reaches a
    kernel: launches per forward, error against the plain multipass
    forward, and the forward's time. Returns mode → row."""
    from repro_torch.models.gnn import gat

    args = (srv.model, srv.bundle, srv.x_device)
    ref = gat.infer(*args, strategy="segment")
    rows = {}
    for attn, per_run in FORWARD_LAUNCHES.items():
        reset_counts()
        out = gat.infer(*args, attn=attn)
        torch.cuda.synchronize()
        launches = read_counts()
        check_launches(f"gat attn={attn}", launches, per_run, 1)
        err = max_err(out, ref)
        if not err <= 1e-4:
            raise AssertionError(f"gat attn={attn}: off by {err}")
        row = {"phase": "forward", "app": "gat", "dataset": "reddit-like",
               "attn": attn, "launches": launches, "max_abs_err": err,
               "refresh_forward_ms": time_ms(lambda: gat.infer(
                   *args, attn=attn), reps=5, warmup=1)}
        emit(row)
        rows[attn] = row
    return rows


def trace(fn, top: int = 10) -> dict:
    """``fn()`` (which ends in a host wait for the device) under
    ``torch.profiler`` with CUDA activity, twice: a warm-up call, then,
    after a pause, the recorded one (a call recorded from the profiler's
    start, or at once after its warm-up, lost its first launches on the
    H100 in some runs). Returns the ``top`` device operations by total
    device time, with their counts, the port's own kernels, their
    launches (combine passes left out, so one per wrapper call), and
    device time over the profiled wall time. A reading only: it checks
    nothing, and no kernel counter is read from it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from benchmarks.torch_sddmm_walks import CANONICAL_SRC

    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(
                     p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    # the step annotation carries its kernels' device time: left out
    dev = [e for e in recorded[0]
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith("ProfilerStep")]
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)

    def entry(e):
        return {"name": e.key[:160], "count": e.count,
                "total_us": e.self_device_time_total}

    # the port's kernels live in anonymous namespaces of csrc/*.cu, as
    # some of PyTorch's do: match the __global__ names of its sources too
    root = os.path.dirname(os.path.abspath(__file__))
    names = set()
    for path in [os.path.join(root, p) for p in SOURCES.values()] + [
            str(CANONICAL_SRC)]:
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    head = "void (anonymous namespace)::"

    def ours(key):
        return (key.startswith(head)
                and re.split(r"[<(]", key[len(head):])[0] in names)

    device_us = sum(e.self_device_time_total for e in dev)
    port = [e for e in dev if ours(e.key)]
    host = sorted((e for e in recorded[0] if e.self_cpu_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"device_events": sum(e.count for e in dev),
            "device_us_total": device_us, "wall_us_profiled": wall_us,
            "device_busy_share_profiled": device_us / wall_us,
            "top": [entry(e) for e in dev[:top]],
            "port_kernels": [entry(e) for e in port],
            "top_host": [{"name": e.key[:160], "count": e.count,
                          "self_cpu_us": e.self_cpu_time_total}
                         for e in host[:top]],
            "port_launches": sum(e.count for e in port
                                 if "combine" not in e.key)}


def trace_step(fn, launches: int) -> dict:
    """:func:`trace` of one training step ``fn`` that launches
    ``launches`` of the port's kernels. A trace that lost launches (fewer
    of the port's than the step makes) is taken again, up to three times
    in all; if none recorded them all, it is marked incomplete and no
    busy share is read from it."""
    for attempt in range(1, 4):
        traced = trace(fn)
        traced["attempt"] = attempt
        traced["complete"] = traced["port_launches"] == launches
        if traced["complete"]:
            break
    if not traced["complete"]:
        traced["device_busy_share_profiled"] = None
    return traced


def epoch_runs(what: str, model, run, strategy: dict, want: dict,
               order=("kernel", "plain", "plain", "kernel"),
               falling: bool = True) -> dict:
    """``run(model, strategy)`` (a training history: per-epoch ``loss``,
    ``epoch_time`` and perhaps ``val_acc``) on a copy of ``model``, on
    each path of ``strategy`` (``{"kernel": ..., "plain": ...}``), in
    turns (``order``: kernel, plain, plain, kernel). Per path: epoch time
    median and p90 over the pooled epochs, the loss (finite and, with
    ``falling``, falling, or raise), peak device memory, the launches —
    ``want`` in a run of a path whose name starts with "kernel", none in
    a plain one, or raise."""
    import copy

    runs = {path: [] for path in order}
    for path in order:
        m = copy.deepcopy(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        hist = run(m, strategy[path])
        launches = read_counts()
        loss = hist["loss"]
        if not (all(np.isfinite(loss))
                and (loss[-1] < loss[0] or not falling)):
            raise AssertionError(f"{what} {path}: loss {loss}")
        expect = {k: want.get(k, 0) if path.startswith("kernel") else 0
                  for k in launches}
        if launches != expect:
            raise AssertionError(f"{what} {path} training launched "
                                 f"{launches}; expected {expect}")
        runs[path].append({
            "epoch_ms": [t * 1e3 for t in hist["epoch_time"]],
            "loss": loss, "val_acc": hist.get("val_acc"),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches})

    def pooled(rs):
        ep = [t for r in rs for t in r["epoch_ms"]]
        return {"epoch_ms_median": statistics.median(ep),
                "epoch_ms_p90": statistics.quantiles(ep, n=10,
                                                     method="inclusive")[-1],
                "run_medians_ms": [statistics.median(r["epoch_ms"])
                                   for r in rs],
                "epoch_ms": [r["epoch_ms"] for r in rs],
                "loss": rs[0]["loss"], "val_acc": rs[0]["val_acc"],
                "max_memory_allocated_bytes": max(
                    r["max_memory_allocated_bytes"] for r in rs),
                "launches": {k: sum(r["launches"][k] for r in rs)
                             for k in rs[0]["launches"]}}

    return {path: pooled(rs) for path, rs in runs.items()}


def trace_gat_refresh(srv, top: int = 10) -> dict:
    """One served GAT refresh (``gat.infer``, multipass) under
    :func:`trace`."""
    from repro_torch.models.gnn import gat

    args = (srv.model, srv.bundle, srv.x_device)
    row = {"phase": "trace", "app": "gat", "attn": "multipass",
           **trace(lambda: gat.infer(*args), top)}
    emit(row)
    return row


def check_blocks(g, gen, rows: dict) -> None:
    """Sample one class-128 batch of ``g`` at fan-out ``FANOUT``, seed 0,
    as the fan-out server samples it, and hold every kernel against its
    plain version on each of its two block graphs (bipartite, with a
    dummy row holding every pad edge) at ``BLOCK_SHAPES``."""
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.kernels.edge_softmax.ops import SOFTMAX_SEGMENT_EDGES
    from repro_torch.kernels.rowsplit import SEGMENT_EDGES, row_split

    seeds = np.random.default_rng(0).permutation(g.n_dst)[:128]
    sampler = NeighborSampler(g, [FANOUT, FANOUT], 128, seed=0,
                              device="cuda")
    mb = sampler.sample(seeds, np.zeros(128, np.int64))
    for li, (blk, shapes) in enumerate(zip(mb.blocks, BLOCK_SHAPES)):
        bg = blk.bg
        bgg = bg.g
        label = f"block{li}"
        deg = bgg.host.in_degrees
        n_real = int(deg[:bg.n_dst_real].sum())
        lists = []
        for K in (SEGMENT_EDGES, SOFTMAX_SEGMENT_EDGES):
            rs = row_split(bgg, K)
            lists.append({"K": rs.K, "segments": rs.n_segments,
                          "split_rows": rs.n_split,
                          "partial_slots": rs.n_partials,
                          "dummy_row_split": bool((rs.split[:, 0]
                                                   == bg.n_dst_real).any())})
        emit({"phase": "blocks", "graph": label, "n_src": bgg.n_src,
              "n_dst_real": bg.n_dst_real, "fanout": bg.fanout,
              "edge_slots": bgg.n_edges, "real_edges": n_real,
              "pad_edges": bgg.n_edges - n_real,
              "real_sources": int((blk.src_ids_host >= 0).sum()),
              "dummy_row_degree": int(deg[bg.n_dst_real]),
              "max_real_degree": int(deg[:bg.n_dst_real].max()),
              "work_lists": lists})
        if int(deg[bg.n_dst_real]) != bgg.n_edges - n_real:
            raise AssertionError(f"{label}: a pad edge outside the dummy "
                                 f"row")
        w = blk.gcn_norm.index_select(0, bgg.long("eid")).contiguous()
        check_b1(bgg, w, gen, label, rows["spmm_csr"], shapes["b1"],
                 fp64=True)
        check_b2(bgg, gen, label, rows["fused_attention_csr"], shapes["b2"],
                 fp64=True)
        check_b3(bgg, gen, label, rows["sddmm_csr"], shapes["b3"])
        check_b4(bgg, gen, label, rows["binary_reduce_csr"], shapes["b4"],
                 sweep=False, fp64=True)
        check_b5(bgg, gen, label, rows["edge_softmax_csr"], shapes["b5"],
                 sweep=False, fp64=True)


FANOUT_PHASES = ("sample", "block_graphs", "feature_rows", "forward",
                 "forward_again")


def instrument_fanout(srv) -> dict:
    """Time, on this instance only, the two phases of every fan-out batch
    ``srv`` serves from now on that no span covers (ms, host clock): the
    block graphs' build and upload (``build``, inside the ``serve.sample``
    span, after the host draw), and the forward run once more on the same
    blocks, their kernel structures cached (``forward_again``, fenced like
    ``serve.infer``; its answer is dropped). The second forward makes the
    session slower, so the serving metrics come from a session before
    this. :func:`fanout_phases` reads the rest from the spans."""
    from repro_torch import obs

    times = {"block_graphs": [], "forward_again": []}
    make_sampler, infer = srv._sampler, srv._infer_blocks

    def sampler(cls):
        s = make_sampler(cls)
        if "build" not in vars(s):
            build = s.build

            def timed_build(hb):
                t0 = time.perf_counter()
                out = build(hb)
                times["block_graphs"].append(
                    (time.perf_counter() - t0) * 1e3)
                return out
            s.build = timed_build
        return s

    def infer_blocks(mb, x):
        out = infer(mb, x)
        t0 = time.perf_counter()
        obs.fence(srv._blocks_fn(srv.model, mb.blocks, x))
        times["forward_again"].append((time.perf_counter() - t0) * 1e3)
        return out

    srv._sampler = sampler
    srv._infer_blocks = infer_blocks
    return times


def fanout_phases(events, times: dict) -> dict:
    """Per fan-out batch, each phase in ms: from the spans ``serve.sample``
    (the host draw: the span less the block graphs' build), ``serve.
    cache_lookup`` of the feature cache (``feature_rows``) and
    ``serve.infer`` (``forward``, with the kernels' per-graph structures
    built at their first launch on each new block graph); from
    :func:`instrument_fanout`, ``block_graphs`` and ``forward_again``."""
    def durs(name, **args):
        return [e["dur"] / 1e3 for e in events if e["name"] == name
                and all(e["args"].get(k) == v for k, v in args.items())]

    out = {"sample": [a - b for a, b in zip(durs("serve.sample"),
                                            times["block_graphs"])],
           "block_graphs": times["block_graphs"],
           "feature_rows": durs("serve.cache_lookup", cache="feat"),
           "forward": durs("serve.infer"),
           "forward_again": times["forward_again"]}
    if len({len(v) for v in out.values()}) != 1:
        raise AssertionError(f"fan-out phases of unequal counts: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    return out


def check_session(app: str, res: dict, n_out: int) -> None:
    if res["recompiles_steady"] != 0:
        raise AssertionError(f"{app}: {res['recompiles_steady']} "
                             f"steady-state recompiles")
    for ids, rows in res["responses"]:
        if rows.shape != (len(ids), n_out) or not np.isfinite(rows).all():
            raise AssertionError(f"{app}: served {rows.shape}, finite "
                                 f"{np.isfinite(rows).all()}")


def serve_fanout_app(app: str) -> dict:
    """Serve ``app`` on ``reddit-like`` in mode fanout at ``FANOUT``
    through ``build_server``: the 4-client session of the serve phase,
    the app's launches per served batch, zero steady-state signatures,
    the kernels against the uniform pull on one fixed minibatch, and the
    per-batch medians of each phase."""
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch import obs
    from repro_torch.models.gnn.common import block_features, pad_features

    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    t0 = time.perf_counter()
    srv = build_server(app, "reddit-like", mode="fanout", fanout=FANOUT,
                       device="cuda")
    setup_s = time.perf_counter() - t0
    n = srv.g.n_src

    def session():
        return run_session(srv, n_clients=4, requests_per_client=25,
                           ids_fn=lambda rng: rng.integers(0, n, 4))

    reset_counts()
    res = session()
    launches = read_counts()
    served = srv.served_batches
    check_launches(f"{app} fanout", launches, SERVE_LAUNCHES[app], served)
    check_session(app, res, 41)
    if srv.refreshes or srv.mode_batches["layerwise"]:
        raise AssertionError(f"{app}: mode fanout refreshed a table")
    fc = res["stats"]["feat_cache"]
    # a second session, instrumented, for the per-batch phase times
    times = instrument_fanout(srv)
    obs.clear_trace()
    check_session(app, session(), 41)
    times = fanout_phases(obs.trace_events(), times)
    # the kernels against the uniform pull on one fixed minibatch
    ids = np.random.default_rng(1).permutation(n)[:128]
    mb = NeighborSampler(srv.g, [FANOUT] * 2, 128, seed=0,
                         device="cuda").sample(ids, np.zeros(128, np.int64))
    x = block_features(pad_features(srv.feats, "cuda"), mb.input_ids)
    got = mod.infer_blocks(srv.model, mb.blocks, x)
    ref = mod.infer_blocks(srv.model, mb.blocks, x, strategy="ell")
    torch.cuda.synchronize()
    err = max_err(got, ref)
    if not err <= 1e-4:
        raise AssertionError(f"{app} fanout: kernels off the uniform pull "
                             f"by {err}")
    row = {"phase": "serve_fanout", "app": app, "dataset": "reddit-like",
           "fanout": FANOUT, "n_samples": res["n_samples"],
           "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "served_batches": served, "launches": launches,
           "signatures": sorted(map(list, srv.tracker.seen)),
           "feat_cache": {"hits": fc.hits, "misses": fc.misses,
                          "hit_ratio": fc.hit_ratio, "pinned": fc.pinned},
           "batch_medians_ms": {k: statistics.median(v)
                                for k, v in times.items() if v},
           "batch_phase_counts": {k: len(v) for k, v in times.items()},
           "first_launch_structures_median_ms": statistics.median(
               a - b for a, b in zip(times["forward"],
                                     times["forward_again"])),
           "kernel_vs_ell_max_abs_err": err,
           "block_forward_ms": time_ms(lambda: mod.infer_blocks(
               srv.model, mb.blocks, x), reps=10, warmup=1),
           "block_forward_ell_ms": time_ms(lambda: mod.infer_blocks(
               srv.model, mb.blocks, x, strategy="ell"), reps=10, warmup=1),
           "setup_s": setup_s}
    emit(row)
    return row


def serve_exact() -> list:
    """The JAX serve test's claim at full width on the card: on 65,536
    nodes of in-degree exactly 8 (numpy seed 0), rows served in mode
    fanout at the default fan-out (8, every in-edge) equal those served
    layer-wise, within 1e-4, for each app."""
    from repro_torch.core.graph import from_coo
    from repro_torch.core.serving import GNNServer
    from repro_torch.models.gnn import gat, gcn, sage

    rng = np.random.default_rng(0)
    n, k = 65_536, 8
    src = rng.integers(0, n, (n, k)).reshape(-1)
    dst = np.repeat(np.arange(n), k)
    feats = rng.standard_normal((n, 602)).astype(np.float32)
    g = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    ids = np.random.default_rng(1).integers(0, n, 300)
    # classes 8, 32 and 128, then 300 ids in largest-class chunks
    requests = [[(0, ids[:6])], [(1, ids[6:26])], [(2, ids[26:126])],
                [(3, ids)]]
    rows = []
    for app, mod in (("gcn", gcn), ("sage", sage), ("gat", gat)):
        model = mod.init(torch.Generator().manual_seed(0), 602, 32, 41,
                         device="cuda")
        fo = GNNServer(app, model, g, feats, mode="fanout", device="cuda")
        lw = GNNServer(app, model, g, feats, mode="layerwise",
                       device="cuda")
        if fo.fanout != k:
            raise AssertionError(f"default fan-out {fo.fanout} != {k}")
        reset_counts()
        got = [fo.serve(r) for r in requests]
        launches = read_counts()
        check_launches(f"{app} exact", launches, SERVE_LAUNCHES[app],
                       fo.served_batches)
        ref = [lw.serve(r) for r in requests]
        err = 0.0
        for r, a, b in zip(requests, got, ref):
            for rid, rid_ids in r:
                if a[rid].shape != (len(rid_ids), 41):
                    raise AssertionError(f"{app}: shape {a[rid].shape}")
                err = max(err, float(np.abs(a[rid] - b[rid]).max()))
        row = {"phase": "serve_exact", "app": app, "n_nodes": n,
               "n_edges": g.n_edges, "fanout": fo.fanout,
               "served_batches": fo.served_batches,
               "signatures": sorted(map(list, fo.tracker.seen)),
               "launches": launches, "fanout_vs_layerwise_max_abs_err": err}
        emit(row)
        if not err <= 1e-4:
            raise AssertionError(f"{app}: fan-out rows off the layer-wise "
                                 f"rows by {err}")
        rows.append(row)
        del fo, lw
    return rows


def expected_modes(n_edges: int, n_layers: int, fanout: int, classes,
                   refresh_batches: int) -> dict:
    """The serve planner's choice per class, by its formula: layer-wise
    costs ``n_edges·layers/refresh_batches + 8·class``, fan-out its
    padded edge slots ``Σ_l n_dst_l·fanout``; ties go layer-wise."""
    out = {}
    for c in classes:
        sizes, slots = [c], 0
        for _ in range(n_layers):
            slots += sizes[-1] * fanout
            sizes.append(sizes[-1] * (fanout + 1))
        layerwise = n_edges * n_layers / refresh_batches + 8.0 * c
        out[c] = "fanout" if slots < layerwise else "layerwise"
    return out


def serve_auto_app(app: str) -> dict:
    """``build_server(app, "reddit-like", mode="auto", fanout=FANOUT)``:
    the class→mode map against the planner's formula, a session that
    serves both modes (launches: the app's per refresh and per fan-out
    batch), then one fan-out row against the uniform pull on the same
    seeded blocks and one layer-wise row against the plain forward.

    Each request asks for 1 id (three in four) or 12, so a batch of
    small requests alone is class 8 (fan-out) and one holding a 12-id
    request is class 32 (layer-wise)."""
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.common import block_features, pad_features

    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    srv = build_server(app, "reddit-like", mode="auto", fanout=FANOUT,
                       device="cuda")
    classes = srv.batcher.classes
    modes = {c: srv.mode_for_class(c) for c in classes}
    want = expected_modes(srv.g.n_edges, srv.n_layers, FANOUT, classes,
                          srv.refresh_batches)
    if modes != want or want != {8: "fanout", 32: "layerwise",
                                 128: "layerwise"}:
        raise AssertionError(f"{app}: class→mode {modes}, formula {want}")
    n = srv.g.n_src
    reset_counts()
    res = run_session(srv, n_clients=4, requests_per_client=25,
                      ids_fn=lambda rng: rng.integers(
                          0, n, 1 if rng.random() < 0.75 else 12))
    launches = read_counts()
    per_mode = dict(srv.mode_batches)
    check_launches(f"{app} auto", launches, SERVE_LAUNCHES[app],
                   srv.refreshes + per_mode["fanout"])
    check_session(app, res, 41)
    # the batches of the session proper: warm-up serves one per class
    session = {m: k - list(modes.values()).count(m)
               for m, k in per_mode.items()}
    if not (session["fanout"] and session["layerwise"]):
        raise AssertionError(f"{app}: one mode served nothing {session}")
    # one fan-out row: the class-8 sampler replayed from its seed
    ids4 = np.random.default_rng(2).integers(0, n, 4)
    srv._sampler(8).reset()
    got8 = srv.serve([(0, ids4)])[0]
    mb = NeighborSampler(srv.g, [FANOUT] * 2, 8, seed=srv.seed,
                         device="cuda").sample(ids4, np.zeros(4, np.int64))
    ref8 = mod.infer_blocks(srv.model, mb.blocks,
                            block_features(pad_features(srv.feats, "cuda"),
                                           mb.input_ids),
                            strategy="ell")[:4].cpu().numpy()
    err_fanout = float(np.abs(got8 - ref8).max())
    # one layer-wise row against the plain full forward
    ids20 = np.random.default_rng(3).integers(0, n, 20)
    got32 = srv.serve([(1, ids20)])[1]
    full = mod.infer(srv.model, srv.bundle, srv.x_device,
                     strategy="segment").cpu().numpy()
    err_lw = float(np.abs(got32 - full[ids20]).max())
    row = {"phase": "serve_auto", "app": app, "dataset": "reddit-like",
           "fanout": FANOUT, "refresh_batches": srv.refresh_batches,
           "class_modes": {str(c): m for c, m in modes.items()},
           "n_samples": res["n_samples"], "p50_ms": res["p50_ms"],
           "p99_ms": res["p99_ms"], "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "mode_batches": per_mode, "session_mode_batches": session,
           "refreshes": srv.refreshes,
           "launches": launches, "fanout_row_max_abs_err": err_fanout,
           "layerwise_row_max_abs_err": err_lw}
    emit(row)
    if not (err_fanout <= 1e-4 and err_lw <= 1e-4):
        raise AssertionError(f"{app} auto: rows off {err_fanout} {err_lw}")
    return row


def train_kernels(g, gen, rows: dict) -> None:
    """The backward kernels at the training step's shapes (``TRAIN_B1``,
    ``TRAIN_B3``, ``TRAIN_B4``), each against its plain version, bit-
    identical over two calls where the kernel phase requires it, timed
    warm and device-only, with a bound from ``rows_read`` of G or Gᵀ."""
    from repro_torch.core.graph import reverse
    from repro_torch.models.gnn.common import make_bundle

    g_rev = reverse(g)
    w = make_bundle(g).gcn_norm
    for label, gr in (("reverse", g_rev), ("self_loops", g)):
        check_b1(gr, w.index_select(0, gr.long("eid")).contiguous(), gen,
                 label, rows["spmm_csr"], TRAIN_B1[label])
    check_b3(g, gen, "self_loops", rows["sddmm_csr"], TRAIN_B3)
    check_b4(g_rev, gen, "reverse", rows["binary_reduce_csr"], TRAIN_B4,
             sweep=False)


def check_attention_chain(g, gen) -> list:
    """GAT's attention chain on ``g`` at H = 4 and 1 — B3 logits,
    leaky-relu, the composed edge softmax — differentiated on the kernel
    routes (B3 / B4 backward) and on the plain ones: the kernel-route
    grads of el and er must be bit-identical over two calls and within
    ``1e-5 + 1e-5·max|plain|`` of the plain grads."""
    from repro_torch.core import edge_softmax, gsddmm
    from repro_torch.substrate.nn import leaky_relu

    rows = []
    for H in (4, 1):
        el = torch.randn(g.n_src, H, generator=gen).cuda().requires_grad_()
        er = torch.randn(g.n_dst, H, generator=gen).cuda().requires_grad_()
        ct = torch.randn(g.n_edges, H, generator=gen).cuda()

        def grads(strategy):
            logits = leaky_relu(gsddmm(
                g, "u_add_v_copy_e", u=el, v=er,
                strategy="kernel" if strategy == "kernel" else "gather"))
            alpha = edge_softmax(g, logits, strategy=strategy)
            return torch.autograd.grad(alpha, (el, er), ct)

        first, again, plain = grads("kernel"), grads("kernel"), grads(
            "segment")
        torch.cuda.synchronize()
        bit = all(torch.equal(a, b) for a, b in zip(first, again))
        errs = [max_err(a, b) for a, b in zip(first, plain)]
        tols = [1e-5 + 1e-5 * float(b.abs().max()) for b in plain]
        row = {"phase": "train_chain", "H": H, "bit_identical": bit,
               "max_abs_err": {"el": errs[0], "er": errs[1]},
               "tol": {"el": tols[0], "er": tols[1]}}
        emit(row)
        if not bit or any(e > t for e, t in zip(errs, tols)):
            raise AssertionError(f"attention chain grads: {row}")
        rows.append(row)
    return rows


# the B4 specs whose kernel-route backward runs B1 / B4 on Gᵀ and B3 (no
# app's step reaches them): (op, node width, edge width)
TRAIN_GSPMM = [("u_mul_e_add_v", 16, 16), ("u_sub_e_add_v", 16, 16),
               ("u_div_e_mean_v", 16, 1), ("e_mul_u_add_v", 16, 16)]


def check_gspmm_grads(g, gen) -> list:
    """``gspmm`` on ``g`` for each spec of ``TRAIN_GSPMM``, differentiated
    on its kernel route and on the segment route: the kernel-route grads
    of both operands must be bit-identical over two calls and within
    ``1e-5 + 1e-5·max|plain|`` of the plain grads."""
    from repro_torch.core import gspmm

    rows = []
    for op, d, de in TRAIN_GSPMM:
        u = torch.randn(g.n_src, d, generator=gen).cuda().requires_grad_()
        e = (torch.rand(g.n_edges, de, generator=gen) + 0.5).cuda()
        e.requires_grad_()
        ct = torch.randn(g.n_dst, d, generator=gen).cuda()
        kw = {"e": e, "u": u}

        def grads(strategy):
            return torch.autograd.grad(
                gspmm(g, op, strategy=strategy, **kw), (u, e), ct)

        first, again, plain = grads("kernel"), grads("kernel"), grads(
            "segment")
        torch.cuda.synchronize()
        bit = all(torch.equal(a, b) for a, b in zip(first, again))
        errs = [max_err(a, b) for a, b in zip(first, plain)]
        tols = [1e-5 + 1e-5 * float(b.abs().max()) for b in plain]
        row = {"phase": "train_gspmm", "op": op, "d": d, "de": de,
               "bit_identical": bit,
               "max_abs_err": {"u": errs[0], "e": errs[1]},
               "tol": {"u": tols[0], "e": tols[1]}}
        emit(row)
        if not bit or any(err > t for err, t in zip(errs, tols)):
            raise AssertionError(f"gspmm grads: {row}")
        rows.append(row)
    return rows


def train_app(app: str, data) -> dict:
    """Train ``app`` full-graph on ``reddit-like`` (``data``: the bundle,
    features, labels, masks, class count): the checks and readings of
    phase 11, one row."""
    import copy

    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.train import make_train_step, train_full_graph
    from repro_torch.substrate.nn import cross_entropy_loss

    bundle, x, labels, train_mask, val_mask, n_classes = data
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    model = mod.init(torch.Generator().manual_seed(0), x.shape[1],
                     TRAIN_HIDDEN, n_classes, device="cuda")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def grads(strategy):
        logits = mod.forward(model, bundle, x, strategy=strategy, train=True,
                             gen=torch.Generator(device="cuda").manual_seed(0))
        out = torch.autograd.grad(
            cross_entropy_loss(logits, labels, train_mask), params)
        torch.cuda.synchronize()
        return out

    grads("auto")       # G's and Gᵀ's per-graph kernel structures
    reset_counts()
    kernel = grads("auto")
    step_launches = read_counts()
    check_launches(f"{app} train step", step_launches, TRAIN_LAUNCHES[app],
                   1)
    again, plain = grads("auto"), grads("segment")
    grad_rows = {}
    for n, k, a, p in zip(names, kernel, again, plain):
        tol = 1e-6 + TRAIN_GRAD_RTOL * float(p.abs().max())
        grad_rows[n] = {"max_abs_err": max_err(k, p), "tol": tol,
                        "max_abs_plain": float(p.abs().max()),
                        "bit_identical": torch.equal(k, a),
                        "again_max_abs_diff": float((k - a).abs().max())}
    bad = {n: r for n, r in grad_rows.items() if r["max_abs_err"] > r["tol"]
           or not r["bit_identical"]}
    if bad:
        raise AssertionError(f"{app} train grads: {bad}")

    # 10 epochs per run, in turns: kernel, plain, plain, kernel; a step
    # per epoch and the warm-up, a forward per validation
    strategy = {"kernel": "auto", "plain": "segment"}
    runs = epoch_runs(app, model, lambda m, st: train_full_graph(
        mod.forward, m, bundle, x, labels, train_mask, strategy=st,
        epochs=TRAIN_EPOCHS, seed=0, val_mask=val_mask)[1], strategy,
        {k: TRAIN_LAUNCHES[app].get(k, 0) * (TRAIN_EPOCHS + 1)
         + SERVE_LAUNCHES[app].get(k, 0) * TRAIN_EPOCHS
         for k in read_counts()})

    # per path: the host's time to run a step's Python and launches
    # (forward, backward, clip, update) against its wait for the device
    # after it (the loss read); medians over 5 steps after one
    for path in runs:
        opt_init, step = make_train_step(mod.forward, strategy[path])
        m = copy.deepcopy(model)
        state = opt_init(m)
        gen = torch.Generator(device="cuda").manual_seed(0)
        host, wait = [], []
        for i in range(6):
            t0 = time.perf_counter()
            state, loss = step(m, state, i, bundle, x, labels, train_mask,
                               gen)
            t1 = time.perf_counter()
            float(loss)
            t2 = time.perf_counter()
            if i:
                host.append((t1 - t0) * 1e3)
                wait.append((t2 - t1) * 1e3)
        runs[path]["step_host_ms_median"] = statistics.median(host)
        runs[path]["step_wait_ms_median"] = statistics.median(wait)

    # one training step on the kernel path under the profiler
    opt_init, step = make_train_step(mod.forward)
    m = copy.deepcopy(model)
    state = opt_init(m)
    gen = torch.Generator(device="cuda").manual_seed(0)
    traced = trace_step(lambda: float(step(m, state, 0, bundle, x, labels,
                                           train_mask, gen)[1]),
                        sum(TRAIN_LAUNCHES[app].values()))
    # the traced step's device time over the epoch median of the untraced
    # kernel-path runs above (a separate run of the same step)
    traced["device_busy_share_vs_epoch_median"] = (
        traced["device_us_total"] / 1e3 / runs["kernel"]["epoch_ms_median"]
        if traced["complete"] else None)
    row = {"phase": "train", "app": app, "dataset": "reddit-like",
           "hidden": TRAIN_HIDDEN, "epochs": TRAIN_EPOCHS,
           "step_launches": step_launches,
           "launches": runs["kernel"]["launches"], "grads": grad_rows,
           "grads_bit_identical": all(r["bit_identical"]
                                      for r in grad_rows.values()),
           "kernel": runs["kernel"], "plain": runs["plain"],
           "epoch_speedup_median": (runs["plain"]["epoch_ms_median"]
                                    / runs["kernel"]["epoch_ms_median"]),
           "trace": traced}
    emit(row)
    return row


# --------------------------------------------------------------------- #
# 12. sampled minibatch training
# --------------------------------------------------------------------- #
def sampled_batch(g, labels, train_mask, fanouts, batch: int):
    """The first batch ``train_sampled`` (seed 0) trains on, each block
    built with its Gᵀ."""
    from repro_torch.data.sampler import NeighborSampler

    sampler = NeighborSampler(g, list(fanouts), batch, seed=0,
                              device="cuda", reverse=True)
    ids = np.nonzero(train_mask)[0]
    return next(sampler.batches(ids, labels[ids], drop_last=False))


def sampled_block_kernels(mb, gen, rows: dict) -> list:
    """On each block of the training batch ``mb``: its Gᵀ against
    ``core.graph.reverse`` of the same graph (bit-equal), the time to
    build it from the block's caller-order edges (the draw's order) and
    its work lists, the first B1 launch on it; then B1 and B4 on it at
    ``SAMPLED_B1`` / ``SAMPLED_B4``, held against their plain versions in
    float64, bit-identical over two calls and timed."""
    from repro_torch.core.graph import from_coo, reverse, reverse_from_draw
    from repro_torch.kernels.binary_reduce.ops import BR_SEGMENT_EDGES
    from repro_torch.kernels.rowsplit import SEGMENT_EDGES, row_split
    from repro_torch.kernels.spmm.ops import spmm_csr

    out = []
    for li, blk in enumerate(mb.blocks):
        g, label = blk.bg.g, f"block{li}_T"
        src, dst = g.host.src[g.host.eid_inv], g.host.dst[g.host.eid_inv]
        fresh = reverse(from_coo(src, dst, n_src=g.n_src, n_dst=g.n_dst,
                                 device="cuda"))
        gt = reverse(g)
        same = all(torch.equal(getattr(gt, f), getattr(fresh, f))
                   for f in ("src", "dst", "eid", "indptr_dst",
                             "indptr_src", "perm_src", "eid_inv"))
        if not same:
            raise AssertionError(f"{label}: Gᵀ from the draw differs from "
                                 f"reverse(g)")
        B = torch.randn(gt.n_src, 64, generator=gen).cuda()
        t = {"build": [], "work_list_b1": [], "work_list_b4": [],
             "first_b1": [], "warm_b1": []}
        for _ in range(5):       # each on a new Gᵀ, with no structures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gt = reverse_from_draw(g, src, dst)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            row_split(gt, SEGMENT_EDGES)
            t2 = time.perf_counter()
            row_split(gt, BR_SEGMENT_EDGES)
            t3 = time.perf_counter()
            spmm_csr(gt, B, None, False)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            spmm_csr(gt, B, None, False)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for k, a, b in (("build", t0, t1), ("work_list_b1", t1, t2),
                            ("work_list_b4", t2, t3), ("first_b1", t3, t4),
                            ("warm_b1", t4, t5)):
                t[k].append((b - a) * 1e3)
        n_real = int(blk.bg.real_deg.sum())
        row = {"phase": "train_sampled_blocks", "graph": label,
               "n_src": gt.n_src, "n_dst": gt.n_dst, "edges": gt.n_edges,
               "real_edges": n_real,
               "dummy_source_degree": int(gt.host.in_degrees[-1]),
               "gt_bit_equal_reverse": same,
               **{f"{k}_ms_median": statistics.median(v)
                  for k, v in t.items()}}
        emit(row)
        w = blk.gcn_norm.index_select(0, gt.long("eid")).contiguous()
        check_b1(gt, w, gen, label, rows["spmm_csr"], SAMPLED_B1, fp64=True)
        check_b4(gt, gen, label, rows["binary_reduce_csr"], SAMPLED_B4,
                 sweep=False, fp64=True)
        out.append(row)
    return out


def sampled_model(app: str, d_in: int, hidden: int, n_classes: int):
    from repro_torch.models.gnn import gat, gcn, sage

    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    return mod, mod.init(torch.Generator().manual_seed(0), d_in, hidden,
                         n_classes, device="cuda")


def sampled_grads(app: str, hidden: int, mb, feats_pad, n_classes) -> dict:
    """One sampled step's per-parameter grads of ``app`` on ``mb``: the
    kernel path (``strategy="auto"``, ``bwd_strategy="auto"``: gather)
    against the plain path (``"ell"``, ``"scatter"``) and the plain gather
    (``"ell"``, ``"gather"``), one dropout generator, within
    ``TRAIN_GRAD_RTOL`` of the largest plain grad (+ 1e-6); bit-identical
    over two calls on the kernel path; the kernel launches of the step
    exact (``TRAIN_SAMPLED_LAUNCHES``), none on either plain path."""
    from repro_torch.models.gnn.common import block_features
    from repro_torch.substrate.nn import cross_entropy_loss

    mod, model = sampled_model(app, feats_pad.shape[1], hidden, n_classes)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    x = block_features(feats_pad, mb.input_ids)

    def grads(strategy, bwd):
        logits = mod.forward_blocks(
            model, mb.blocks, x, strategy=strategy, bwd_strategy=bwd,
            train=True, gen=torch.Generator(device="cuda").manual_seed(0))
        out = torch.autograd.grad(
            cross_entropy_loss(logits, mb.labels, mb.label_mask), params)
        torch.cuda.synchronize()
        return out

    grads("auto", "auto")       # the blocks' per-graph kernel structures
    reset_counts()
    kernel = grads("auto", "auto")
    step_launches = read_counts()
    check_launches(f"{app} sampled step", step_launches,
                   TRAIN_SAMPLED_LAUNCHES[app], 1)
    again = grads("auto", "auto")
    plain = {}
    for path, args in (("plain", ("ell", "scatter")),
                       ("plain_gather", ("ell", "gather"))):
        reset_counts()
        plain[path] = grads(*args)
        check_launches(f"{app} sampled {path}", read_counts(), {}, 1)
    gather_again = grads("ell", "gather")
    rows = {}
    for i, n in enumerate(names):
        r = {"bit_identical": torch.equal(kernel[i], again[i]),
             "plain_gather_bit_identical": torch.equal(
                 plain["plain_gather"][i], gather_again[i])}
        for path, p in plain.items():
            tol = 1e-6 + TRAIN_GRAD_RTOL * float(p[i].abs().max())
            r[path] = {"max_abs_err": max_err(kernel[i], p[i]), "tol": tol,
                       "max_abs_plain": float(p[i].abs().max())}
        rows[n] = r
    bad = {n: r for n, r in rows.items() if not r["bit_identical"] or any(
        r[p]["max_abs_err"] > r[p]["tol"] for p in plain)}
    row = {"phase": "train_sampled_grads", "app": app, "hidden": hidden,
           "step_launches": step_launches, "grads": rows,
           "grads_bit_identical": all(r["bit_identical"]
                                      for r in rows.values())}
    emit(row)
    if bad:
        raise AssertionError(f"{app} sampled grads: {bad}")
    return row


def sampled_runs(app: str, dataset: str, data, fanouts, batch: int,
                 hidden: int, max_batches: int, export: str = None,
                 order=("kernel", "plain", "plain", "kernel",
                        "kernel_telemetry_off"),
                 precision: str = "fp32", falling: bool = True) -> dict:
    """``train_sampled`` of ``app`` for ``SAMPLED_EPOCHS`` epochs of
    ``max_batches`` batches, in turns kernel, plain, plain, kernel:
    epoch 1's time and its sample / step split (epoch 0 pays the first
    batches' structures), the loss (finite, lower in the last epoch than
    in the first), peak device memory, the launches (per batch the
    step's, plus one drift probe — a step and a forward — per run on the
    kernel path; none on the plain one). Then one more kernel run with
    telemetry off (``obs.set_enabled(False)``: no span, no fenced block
    op, no drift probe), the cost of the telemetry. With ``export``, the
    first kernel run's spans: their time per name, coverage and a Chrome
    trace. ``order`` (the runs, in turns), ``precision`` (the trainer's)
    and ``falling`` (whether the loss must fall) let the mixed-precision
    phase run the same cells."""
    import copy

    from repro_torch import obs
    from repro_torch.models.gnn.train import train_sampled

    g, feats, labels, train_mask, n_classes = data
    mod, model = sampled_model(app, feats.shape[1], hidden, n_classes)
    ids = np.nonzero(train_mask)[0]
    paths = {"kernel": ("auto", "auto"), "plain": ("ell", "scatter"),
             "kernel_telemetry_off": ("auto", "auto")}
    runs = {path: [] for path in order}
    spans = None
    for path in order:
        telemetry = obs.set_enabled(path != "kernel_telemetry_off")
        m = copy.deepcopy(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        obs.clear_trace()
        reset_counts()
        _, hist = train_sampled(
            mod.forward_blocks, m, g, feats, labels, ids, fanouts=fanouts,
            batch_size=batch, strategy=paths[path][0],
            bwd_strategy=paths[path][1], epochs=SAMPLED_EPOCHS, seed=0,
            max_batches=max_batches, precision=precision)
        launches = read_counts()
        probe = obs.enabled()
        obs.set_enabled(telemetry)
        if export and spans is None and path == "kernel":
            spans = span_table(obs.trace_events(), export)
        loss = hist["loss"]
        if not (all(np.isfinite(loss))
                and (loss[-1] < loss[0] or not falling)):
            raise AssertionError(f"{app} {dataset} {path}: loss {loss}")
        n = sum(hist["n_batches"])
        per = TRAIN_SAMPLED_LAUNCHES[app]
        want = {k: (per.get(k, 0) * (n + probe)
                    + SERVE_LAUNCHES[app].get(k, 0) * probe)
                if path != "plain" else 0 for k in launches}
        if n != SAMPLED_EPOCHS * max_batches or launches != want:
            raise AssertionError(f"{app} {dataset} {path}: {n} batches, "
                                 f"launches {launches}; expected {want}")
        runs[path].append({
            "epoch_ms": [t * 1e3 for t in hist["epoch_time"]],
            "sample_ms": [t * 1e3 for t in hist["sample_time"]],
            "step_ms": [t * 1e3 for t in hist["step_time"]],
            "n_batches": hist["n_batches"], "loss": loss,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches})

    def pooled(rs):
        e1 = [r["epoch_ms"][1] for r in rs]
        return {"epoch1_ms": e1,
                "epoch1_ms_per_batch": [t / max_batches for t in e1],
                "sample1_ms": [r["sample_ms"][1] for r in rs],
                "step1_ms": [r["step_ms"][1] for r in rs],
                "epoch0_ms": [r["epoch_ms"][0] for r in rs],
                "loss": rs[0]["loss"],
                "max_memory_allocated_bytes": max(
                    r["max_memory_allocated_bytes"] for r in rs),
                "launches": {k: sum(r["launches"][k] for r in rs)
                             for k in rs[0]["launches"]}}

    row = {"phase": "train_sampled", "app": app, "dataset": dataset,
           "precision": precision, "fanouts": list(fanouts),
           "batch_size": batch, "hidden": hidden, "epochs": SAMPLED_EPOCHS,
           "batches_per_epoch": max_batches,
           "launches_per_batch": TRAIN_SAMPLED_LAUNCHES[app],
           **{path: pooled(rs) for path, rs in runs.items()},
           "spans": spans}
    row["launches"] = {k: sum(row[path]["launches"][k] for path in runs
                              if path.startswith("kernel"))
                       for k in row["kernel"]["launches"]}
    emit(row)
    return row


def trace_sampled_step(data, fanouts, batch: int, hidden: int) -> dict:
    """One SAGE sampled step on the kernel path under :func:`trace`, on
    the first training batch, taken again (up to three times in all) if it
    lost launches; ``"complete": false`` and no busy share if none
    recorded them all."""
    from repro_torch.models.gnn import sage
    from repro_torch.models.gnn.common import pad_features
    from repro_torch.models.gnn.train import make_sampled_train_step

    g, feats, labels, train_mask, n_classes = data
    mb = sampled_batch(g, labels, train_mask, fanouts, batch)
    _, model = sampled_model("sage", feats.shape[1], hidden, n_classes)
    feats_pad = pad_features(feats, "cuda")
    opt_init, step = make_sampled_train_step(sage.forward_blocks, "auto")
    state = opt_init(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    traced = trace_step(lambda: float(step(model, state, 0, mb, feats_pad,
                                           gen)[1]),
                        sum(TRAIN_SAMPLED_LAUNCHES["sage"].values()))
    row = {"phase": "train_sampled_trace", "app": "sage",
           "fanouts": list(fanouts), "batch_size": batch, "hidden": hidden,
           **traced}
    emit(row)
    return row


# --------------------------------------------------------------------- #
# 13. the relational apps
# --------------------------------------------------------------------- #
def bgs_relations():
    """``bench_rgcn``'s BGS-like typed graph, as per-relation pairs."""
    from repro_torch.data.synthetic import relational_graph

    n, R, epr = RGCN_BGS
    return relational_graph(n, R, epr, seed=0)


def bgs_inputs():
    """``bench_rgcn``'s inputs: features (n, 32) and random labels over
    the 4 classes, both from numpy seed 1."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(RGCN_BGS[0], 32)).astype(np.float32)
    return x, rng.integers(0, 4, RGCN_BGS[0])


def ml1m_graphs():
    """GC-MC's structures at ``GCMC_SHAPE``: the two level RelGraphs, the
    rating graph and the ratings (seed 0, as ``bench_gcmc``)."""
    from repro_torch.core.graph import from_coo
    from repro_torch.data.synthetic import bipartite_ratings
    from repro_torch.models.gnn import gcmc

    nu, ni, nr, levels = GCMC_SHAPE
    u, i, r = bipartite_ratings(nu, ni, nr, levels, seed=0)
    fwd, bwd = gcmc.build_level_relgraphs(u, i, r, nu, ni, levels, "cuda")
    return fwd, bwd, from_coo(u, i, n_src=nu, n_dst=ni, device="cuda"), r


def sbm_graphs():
    """LGNN's graphs at ``LGNN_SBM`` (seed 0): G, its line graph L (and
    the seconds L took), the fused RelGraph, the community labels."""
    from repro_torch.core.graph import from_coo
    from repro_torch.data.synthetic import sbm_graph
    from repro_torch.models.gnn import lgnn

    n, k, p_in, p_out = LGNN_SBM
    src, dst, comm = sbm_graph(n, k, p_in, p_out, seed=0)
    g = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    t0 = time.perf_counter()
    lg = lgnn.build_line_graph(g)
    line_s = time.perf_counter() - t0
    return g, lg, line_s, lgnn.build_relgraph(g, lg), comm


def relational_tol(ref: torch.Tensor) -> float:
    """The relational phase's tolerance: 1e-4·max|ref| + 1e-6."""
    return 1e-4 * float(ref.abs().max()) + 1e-6


def check_forward(app: str, run, extra: dict) -> dict:
    """One relational forward through the entry point a user calls:
    ``run(strategy, fp64)`` runs it on the kernel route (``"auto"``) or
    the plain one (``"fused"``), in fp32 or on a float64 copy of the
    model and inputs. Launches of one kernel forward
    (``RELATIONAL_LAUNCHES``), bit-identical over two calls, within
    ``relational_tol`` of the float64 plain forward, and timed."""
    reset_counts()
    got = run("auto", False)
    torch.cuda.synchronize()
    launches = read_counts()
    check_launches(f"{app} forward", launches, RELATIONAL_LAUNCHES[app], 1)
    again = run("auto", False)
    if not torch.equal(got, again):
        raise AssertionError(f"{app}: two forwards differ by "
                             f"{float((got - again).abs().max())}")
    ref = run("fused", True)
    err = max_err(got, ref)
    tol = relational_tol(ref)
    row = {"phase": "relational", "app": app, **extra,
           "out_shape": list(got.shape), "max_abs_err": err, "tol": tol,
           "reference": "fp64 plain (fused)",
           "plain_fp32_max_abs_err": max_err(run("fused", False), ref),
           "bit_identical": True, "launches": launches,
           "forward_ms": time_ms(lambda: run("auto", False), reps=10,
                                 warmup=1),
           "plain_forward_ms": time_ms(lambda: run("fused", False), reps=5,
                                       warmup=1)}
    emit(row)
    if not err <= tol:
        raise AssertionError(f"{app}: kernel forward off the plain one: "
                             f"{row}")
    return row


def canonical_weights(rg, g, e=None, mean: bool = False) -> torch.Tensor:
    """The B1 weight the hetero kernel route hands ``g`` (``rg``'s graph or
    its expansion, one caller edge order): ``e`` and / or the per-relation
    mean weight, in ``g``'s canonical order."""
    s = torch.ones(rg.n_edges, device=rg.device) if e is None else e
    if mean:
        s = s * rg.mean_norm_caller
    return s.index_select(0, g.long("eid")).contiguous()


def hetero_forms(gen, b1_rows: dict) -> list:
    """``hetero_gspmm`` alone at ``HETERO_SHAPE`` for each operand form of
    ``HETERO_FORMS``: the kernel route (B1 over the relation-expanded
    graph; the fused graph for plain ``u``) against the float64 fused
    route, bit-identical over two calls, one launch a call, timed beside
    the fused route; then B1 alone on that graph with that weight
    (``check_b1``)."""
    from repro_torch.core.hetero import from_rels, hetero_gspmm
    from repro_torch.data.synthetic import relational_graph
    from repro_torch.kernels.spmm.ops import spmm_csr

    n, R, epr = HETERO_SHAPE
    d_in, d_out, n_bases = HETERO_DIMS
    t0 = time.perf_counter()
    rg = from_rels(relational_graph(n, R, epr, seed=0), n_src=n, n_dst=n,
                   device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gx = rg.expanded()
    expand_s = time.perf_counter() - t0

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    rows = []
    for form, reduce, with_e in HETERO_FORMS:
        kw = {"u": rnd(n, R, d_out) if form == "u3" else rnd(n, d_in)}
        if form == "w":
            kw["w"] = rnd(R, d_in, d_out, scale=0.2)
        if form == "basis":
            kw["basis"] = rnd(n_bases, d_in, d_out, scale=0.2)
            kw["coeff"] = rnd(R, n_bases, scale=0.3)
        if with_e:
            kw["e"] = (torch.rand(rg.n_edges, generator=gen) + 0.5).cuda()

        def route(strategy, ops=kw):
            return hetero_gspmm(rg, **ops, reduce=reduce, strategy=strategy)

        n0 = spmm_csr.launches
        got = bit_identical(f"hetero_gspmm {form}", lambda: route("kernel"))
        calls = spmm_csr.launches - n0
        if calls != 2:
            raise AssertionError(f"hetero {form}: {calls} B1 launches in two "
                                 f"calls")
        ref = route("fused", {k: v.double() for k, v in kw.items()})
        err = max_err(got, ref)
        tol = relational_tol(ref)
        g = rg.g if form == "plain" else gx
        table = (0 if form in ("plain", "u3")
                 else 4 * n * R * d_out / 2 ** 20)
        row = {"phase": "relational", "op": "hetero_gspmm", "form": form,
               "reduce": reduce, "e": with_e, "n": n, "n_rel": R,
               "n_edges": rg.n_edges, "d_in": d_in, "d_out": d_out,
               "b1_graph": {"n_src": g.n_src, "n_dst": g.n_dst,
                            "n_edges": g.n_edges},
               "table_mb": table, "max_abs_err": err, "tol": tol,
               "reference": "fp64 plain (fused)",
               "plain_fp32_max_abs_err": max_err(route("fused"), ref),
               "bit_identical": True, "b1_launches_per_call": calls // 2,
               "kernel_route_ms": time_ms(lambda: route("kernel")),
               "fused_ms": time_ms(lambda: route("fused")),
               "relgraph_build_s": build_s, "expanded_build_s": expand_s}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"hetero {form}: kernel route off: {row}")
        rows.append(row)
        check_b1(g, canonical_weights(rg, g, kw.get("e"), reduce == "mean"),
                 gen, f"hetero_{form}", b1_rows,
                 [(d_in if form == "plain" else d_out, "sum")])
    return rows


def relational_forwards(gen, b1_rows: dict, b3_rows: dict) -> list:
    """Each relational app's forward at its benchmark's shape
    (``check_forward``), then its kernels alone at the forward's shapes:
    B1 on each relation-expanded graph, B3 on the plain graph."""
    import copy

    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.models.gnn import gcmc, lgnn, monet, rgcn
    from repro_torch.models.gnn.common import make_bundle

    def seeded():
        return torch.Generator().manual_seed(0)

    def runner(fwd, model, *inputs):
        model64 = copy.deepcopy(model).double()
        inputs64 = [x.double() for x in inputs]

        def run(strategy, fp64):
            with torch.no_grad():
                return fwd(model64 if fp64 else model,
                           *(inputs64 if fp64 else inputs), strategy)
        return run

    rows = []
    # R-GCN on the BGS-like typed graph
    n, R, _ = RGCN_BGS
    t0 = time.perf_counter()
    rg = rgcn.build_relgraph(bgs_relations(), n, "cuda")
    gx = rg.expanded()
    build_s = time.perf_counter() - t0
    model = rgcn.init(seeded(), 32, 32, 4, R, device="cuda")
    x = torch.randn(n, 32, generator=gen).cuda()
    rows.append(check_forward("rgcn", runner(
        lambda m, h, st: rgcn.forward(m, rg, h, strategy=st), model, x),
        {"graph": "bgs-like", "n": n, "n_rel": R, "n_edges": rg.n_edges,
         "widths": [32, 32, 4], "n_bases": 4, "build_s": build_s}))
    check_b1(gx, canonical_weights(rg, gx, mean=True), gen, "rgcn_expanded",
             b1_rows, [(32, "sum"), (4, "sum")])

    # GC-MC at the ML-1M-like shape
    nu, ni, nr, levels = GCMC_SHAPE
    du, di, dh, do = GCMC_DIMS
    fwd, bwd, g_all, _ = ml1m_graphs()
    model = gcmc.init(seeded(), du, di, dh, do, levels, device="cuda")
    xu = torch.randn(nu, du, generator=gen).cuda()
    xi = torch.randn(ni, di, generator=gen).cuda()
    rows.append(check_forward("gcmc", runner(
        lambda m, a, b, st: gcmc.forward(m, (fwd, bwd, g_all), a, b,
                                         strategy=st), model, xu, xi),
        {"graph": "ml1m-like", "n_users": nu, "n_items": ni,
         "n_ratings": nr, "levels": levels, "dims": list(GCMC_DIMS)}))
    for label, rel in (("gcmc_user_item", fwd), ("gcmc_item_user", bwd)):
        g = rel.expanded()
        check_b1(g, canonical_weights(rel, g, mean=True), gen, label,
                 b1_rows, [(dh, "sum")])
    check_b3(g_all, gen, "gcmc_ratings", b3_rows, [("dot", "u", "v", do)])

    # MoNet on pubmed-like
    g, feats, *_, n_classes = make_node_dataset(MONET_DATASET, device="cuda")
    bundle = make_bundle(g, krel=MONET_K)
    model = monet.init(seeded(), feats.shape[1], MONET_HIDDEN, n_classes,
                       n_kernels=MONET_K, device="cuda")
    rows.append(check_forward("monet", runner(
        lambda m, h, st: monet.forward(m, bundle, h, strategy=st), model,
        torch.from_numpy(feats).cuda()),
        {"graph": MONET_DATASET, "n": g.n_dst, "n_edges": g.n_edges,
         "max_in_degree": int(g.host.in_degrees.max()),
         "hidden": MONET_HIDDEN, "kernels": MONET_K}))
    krel = bundle.krel(MONET_K)
    gk = krel.expanded()
    e = (torch.rand(krel.n_edges, generator=gen) + 0.5).cuda()
    check_b1(gk, canonical_weights(krel, gk, e), gen, "monet_krel", b1_rows,
             [(MONET_HIDDEN, "sum"), (n_classes, "sum")])
    check_b3(g, gen, "monet_pseudo", b3_rows,
             [("copy", "u", None, 1), ("copy", "v", None, 1)])
    del bundle, krel, gk, feats

    # LGNN on the SBM
    n, k = LGNN_SBM[:2]
    d_emb, d_hidden = LGNN_DIMS
    g, lg, line_s, rel, _ = sbm_graphs()
    model = lgnn.init(seeded(), n, d_emb, d_hidden, k, device="cuda")
    rows.append(check_forward("lgnn", runner(
        lambda m, st: lgnn.forward(m, g, lg, rg=rel, strategy=st)[0],
        model),
        {"graph": "sbm", "n": n, "n_edges": g.n_edges,
         "line_edges": lg.n_edges, "relgraph_edges": rel.n_edges,
         "dims": [d_emb, d_hidden, k], "train": True,
         "line_graph_build_s": line_s}))
    gl = rel.expanded()
    check_b1(gl, canonical_weights(rel, gl), gen, "lgnn_expanded", b1_rows,
             [(d_hidden, "copy_sum"), (k, "copy_sum")])
    check_b3(g, gen, "lgnn_sbm", b3_rows,
             [("add", "u", "v", d_emb + 1), ("add", "u", "v", d_hidden)])
    return rows


def rgcn_sessions(gen, b4_rows: dict) -> list:
    """R-GCN served through ``build_server`` (its typed graph, 32 → 32 →
    8): a layer-wise session (launches per refresh, served rows against
    the plain forward, the refresh bit-identical and timed) and a fan-out
    one at ``FANOUT`` (B4 once per block a batch, no refresh, the kernels
    against the uniform pull on one minibatch, B4 alone on its blocks);
    rows served at the default fan-out equal to the layer-wise rows
    (``serve_exact``); and ``mode="auto"`` on the BGS-like graph at
    ``RGCN_AUTO_FANOUT`` (the class→mode map of the planner's formula,
    both modes served, one row of each against its reference)."""
    from repro_torch.core.serving import GNNServer
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.launch.serve_gnn import build_server, run_session
    from repro_torch.models.gnn import rgcn
    from repro_torch.models.gnn.common import block_features, pad_features

    def session(srv, ids_fn=None):
        n = srv.g.n_src
        return run_session(srv, n_clients=4, requests_per_client=25,
                           ids_fn=ids_fn or (lambda rng: rng.integers(
                               0, n, 4)))

    def pull(srv, ids, cls):
        """(kernel rows, uniform-pull rows, blocks) of one fan-out batch,
        sampled as the class-``cls`` sampler draws its first batch."""
        mb = NeighborSampler(srv.g, [srv.fanout] * srv.n_layers, cls,
                             seed=srv.seed, edge_rel=srv.edge_rel,
                             device="cuda").sample(
            ids, np.zeros(len(ids), np.int64))
        x = block_features(pad_features(srv.feats, "cuda"), mb.input_ids)
        got = rgcn.infer_blocks(srv.model, mb.blocks, x)
        ref = rgcn.infer_blocks(srv.model, mb.blocks, x, strategy="ell")
        torch.cuda.synchronize()
        return got, ref, mb

    rows = []
    # layer-wise
    srv = build_server("rgcn", RGCN_SERVE_DATASET, mode="layerwise",
                       device="cuda")
    reset_counts()
    res = session(srv)
    launches = read_counts()
    check_launches("rgcn layerwise", launches, RELATIONAL_LAUNCHES["rgcn"],
                   srv.refreshes)
    check_session("rgcn", res, 8)
    ref = rgcn.infer(srv.model, srv.rg, srv.x_device,
                     strategy="fused").cpu().numpy()
    served_err = max(float(np.abs(rows_ - ref[ids]).max())
                     for ids, rows_ in res["responses"])
    table = bit_identical("rgcn refresh", lambda: rgcn.infer(
        srv.model, srv.rg, srv.x_device)).cpu().numpy()
    table_err = float(np.abs(table - ref).max())
    row = {"phase": "relational_serve", "app": "rgcn", "mode": "layerwise",
           "n_nodes": srv.g.n_src, "n_edges": srv.g.n_edges,
           "n_rel": srv.rg.n_rel, "n_samples": res["n_samples"],
           "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "refreshes": srv.refreshes, "launches": launches,
           "served_max_abs_err": served_err, "table_max_abs_err": table_err,
           "refresh_bit_identical": True,
           "refresh_forward_ms": time_ms(lambda: rgcn.infer(
               srv.model, srv.rg, srv.x_device), reps=5, warmup=1),
           "plain_forward_ms": time_ms(lambda: rgcn.infer(
               srv.model, srv.rg, srv.x_device, strategy="fused"), reps=5,
               warmup=1)}
    emit(row)
    if not (served_err <= 1e-4 and table_err <= 1e-4):
        raise AssertionError(f"rgcn layerwise: rows off {row}")
    rows.append(row)

    # fan-out
    srv = build_server("rgcn", RGCN_SERVE_DATASET, mode="fanout",
                       fanout=FANOUT, device="cuda")
    reset_counts()
    res = session(srv)
    launches = read_counts()
    check_launches("rgcn fanout", launches, RGCN_FANOUT_LAUNCHES,
                   srv.served_batches)
    check_session("rgcn", res, 8)
    if srv.refreshes or srv.mode_batches["layerwise"]:
        raise AssertionError("rgcn: mode fanout refreshed a table")
    got, ref, mb = pull(srv, np.random.default_rng(1).permutation(
        srv.g.n_src)[:128], 128)
    err = max_err(got, ref)
    for li, (blk, d) in enumerate(zip(mb.blocks, (32, 8))):
        check_b4(blk.bg.g, gen, f"rgcn_block{li}", b4_rows,
                 [("copy_rhs", d, d, "sum")], sweep=False, fp64=True)
    row = {"phase": "relational_serve", "app": "rgcn", "mode": "fanout",
           "fanout": FANOUT, "n_samples": res["n_samples"],
           "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "served_batches": srv.served_batches, "launches": launches,
           "signatures": sorted(map(list, srv.tracker.seen)),
           "kernels_vs_pull_max_abs_err": err}
    emit(row)
    if not err <= 1e-4:
        raise AssertionError(f"rgcn fanout: kernels off the pull by {err}")
    rows.append(row)

    # exact: the default fan-out keeps every in-edge
    fo = build_server("rgcn", RGCN_SERVE_DATASET, mode="fanout",
                      device="cuda")
    lw = build_server("rgcn", RGCN_SERVE_DATASET, mode="layerwise",
                      device="cuda")
    req_ids = np.random.default_rng(1).integers(0, fo.g.n_src, 300)
    requests = [[(0, req_ids[:6])], [(1, req_ids[6:26])],
                [(2, req_ids[26:126])], [(3, req_ids)]]
    reset_counts()
    got = [fo.serve(r) for r in requests]
    launches = read_counts()
    check_launches("rgcn exact", launches, RGCN_FANOUT_LAUNCHES,
                   fo.served_batches)
    want = [lw.serve(r) for r in requests]
    err = max(float(np.abs(a[rid] - b[rid]).max())
              for r, a, b in zip(requests, got, want) for rid, _ in r)
    row = {"phase": "relational_serve", "app": "rgcn", "mode": "exact",
           "fanout": fo.fanout,
           "max_in_degree": int(fo.g.host.in_degrees.max()),
           "served_batches": fo.served_batches, "launches": launches,
           "fanout_vs_layerwise_max_abs_err": err}
    emit(row)
    if fo.fanout != row["max_in_degree"] or not err <= 1e-4:
        raise AssertionError(f"rgcn exact: {row}")
    rows.append(row)
    del fo, lw

    # auto, on the BGS-like graph
    n, R, _ = RGCN_BGS
    feats = np.random.default_rng(0).standard_normal((n, 32)).astype(
        np.float32)
    srv = GNNServer("rgcn", rgcn.init(torch.Generator().manual_seed(0), 32,
                                      32, 4, R, device="cuda"), None, feats,
                    rels=bgs_relations(), mode="auto",
                    fanout=RGCN_AUTO_FANOUT, device="cuda")
    classes = srv.batcher.classes
    modes = {c: srv.mode_for_class(c) for c in classes}
    want = expected_modes(srv.g.n_edges, srv.n_layers, RGCN_AUTO_FANOUT,
                          classes, srv.refresh_batches)
    if modes != want or want != {8: "fanout", 32: "fanout",
                                 128: "layerwise"}:
        raise AssertionError(f"rgcn auto: class→mode {modes}, formula "
                             f"{want}")
    reset_counts()
    res = session(srv, lambda rng: rng.integers(
        0, n, 1 if rng.random() < 0.75 else 40))
    launches = read_counts()
    per_mode = dict(srv.mode_batches)
    want_launches = {k: 0 for k in launches}
    want_launches["spmm_csr"] = (RELATIONAL_LAUNCHES["rgcn"]["spmm_csr"]
                                 * srv.refreshes)
    want_launches["binary_reduce_csr"] = (
        RGCN_FANOUT_LAUNCHES["binary_reduce_csr"] * per_mode["fanout"])
    if launches != want_launches:
        raise AssertionError(f"rgcn auto: launches {launches}, expected "
                             f"{want_launches}")
    check_session("rgcn", res, 4)
    session_batches = {m: k - list(modes.values()).count(m)
                       for m, k in per_mode.items()}
    if not (session_batches["fanout"] and session_batches["layerwise"]):
        raise AssertionError(f"rgcn auto: one mode served nothing "
                             f"{session_batches}")
    ids4 = np.random.default_rng(2).integers(0, n, 4)
    srv._sampler(8).reset()
    got8 = srv.serve([(0, ids4)])[0]
    _, ref8, _ = pull(srv, ids4, 8)
    err_fanout = float(np.abs(got8 - ref8[:4].cpu().numpy()).max())
    ids40 = np.random.default_rng(3).integers(0, n, 40)
    got128 = srv.serve([(1, ids40)])[1]
    full = rgcn.infer(srv.model, srv.rg, srv.x_device,
                      strategy="fused").cpu().numpy()
    err_lw = float(np.abs(got128 - full[ids40]).max())
    row = {"phase": "relational_serve", "app": "rgcn", "mode": "auto",
           "graph": "bgs-like", "fanout": RGCN_AUTO_FANOUT,
           "refresh_batches": srv.refresh_batches,
           "class_modes": {str(c): m for c, m in modes.items()},
           "n_samples": res["n_samples"], "p50_ms": res["p50_ms"],
           "p99_ms": res["p99_ms"], "throughput_rps": res["throughput_rps"],
           "recompiles_steady": res["recompiles_steady"],
           "mode_batches": per_mode, "session_mode_batches": session_batches,
           "refreshes": srv.refreshes, "launches": launches,
           "fanout_row_max_abs_err": err_fanout,
           "layerwise_row_max_abs_err": err_lw}
    emit(row)
    if not (err_fanout <= 1e-4 and err_lw <= 1e-4):
        raise AssertionError(f"rgcn auto: rows off {row}")
    rows.append(row)
    return rows


# --------------------------------------------------------------------- #
# 14. relational training
# --------------------------------------------------------------------- #
def relational_grads(app: str, model, grads_fn, plains: dict,
                     launches: dict, kernel_args=("auto",),
                     rtol: float = TRAIN_GRAD_RTOL,
                     phase: str = "train_relational_grads",
                     noise=None) -> dict:
    """One step's per-parameter grads of ``app``: ``grads_fn(*args)`` on
    the kernel path (``kernel_args``) against each plain path of
    ``plains`` (name → (args, whether it must be bit-identical over two
    calls)), within ``rtol`` of the largest plain grad (+ 1e-6, + the
    parameter's entry of ``noise``, plain path → per-parameter absolute
    slack, where given); the kernel path bit-identical over two calls
    and its launches exactly ``launches``; no launch on a plain path."""
    names = [n for n, _ in model.named_parameters()]
    grads_fn(*kernel_args)          # per-graph structures, Gᵀs included
    reset_counts()
    kernel = grads_fn(*kernel_args)
    step_launches = read_counts()
    check_launches(f"{app} train step", step_launches, launches, 1)
    again = grads_fn(*kernel_args)
    plain, plain_bits = {}, {}
    for path, (args, must) in plains.items():
        reset_counts()
        plain[path] = grads_fn(*args)
        check_launches(f"{app} {path} step", read_counts(), {}, 1)
        if must:
            plain_bits[path] = [torch.equal(a, b) for a, b in
                                zip(plain[path], grads_fn(*args))]
    rows = {}
    for i, n in enumerate(names):
        r = {"bit_identical": torch.equal(kernel[i], again[i]),
             **{f"{p}_bit_identical": b[i] for p, b in plain_bits.items()}}
        for path, pg in plain.items():
            mx = float(pg[i].abs().max())
            r[path] = {"max_abs_err": max_err(kernel[i], pg[i]),
                       "tol": 1e-6 + rtol * mx + (
                           noise[path][i] if noise else 0.0),
                       "max_abs_plain": mx}
        rows[n] = r
    bad = {n: r for n, r in rows.items()
           if not all(v for k, v in r.items() if k.endswith("bit_identical"))
           or any(r[p]["max_abs_err"] > r[p]["tol"] for p in plain)}
    row = {"phase": phase, "app": app,
           "step_launches": step_launches, "grads": rows,
           "grads_bit_identical": all(r["bit_identical"]
                                      for r in rows.values())}
    emit(row)
    if bad:
        raise AssertionError(f"{app} relational grads: {bad}")
    return row


def loss_step_epochs(loss, model, strategy: str, epochs: int) -> dict:
    """GC-MC's and LGNN's training: ``epochs`` steps of
    ``train.make_loss_step`` on ``loss(model, strategy=...)``, each timed
    to its loss read, after one warm-up step on a copy of the model (its
    result discarded, as ``train_full_graph``'s), which builds the
    per-graph structures of every kernel of the step."""
    import copy
    import functools

    from repro_torch.models.gnn.train import make_loss_step

    init, step = make_loss_step(functools.partial(loss, strategy=strategy))
    warm = copy.deepcopy(model)
    float(step(warm, init(warm), 0)[1])
    del warm
    opt, hist = init(model), {"loss": [], "epoch_time": []}
    for e in range(epochs):
        t0 = time.perf_counter()
        opt, loss_e = step(model, opt, e)
        loss_e = float(loss_e)
        hist["epoch_time"].append(time.perf_counter() - t0)
        hist["loss"].append(loss_e)
    return hist


def relational_train_kernels(gen, rows: dict, graphs: dict) -> None:
    """The backward kernels at the training steps' shapes, each against
    its float64 plain version, bit-identical over two calls, timed: B1 on
    the reverse of each relation-expanded graph (``graphs``: label →
    (RelGraph, widths, e-weight or None, mean)), and B3 ``dot`` for
    MoNet's ∂e on its expansion (the message table against ∂out)."""
    from repro_torch.core.graph import reverse

    for label, (rel, widths, e, mean) in graphs.items():
        gx = rel.expanded()
        gt = reverse(gx)
        weighted = e is not None or mean
        check_b1(gt, canonical_weights(rel, gt, e, mean) if weighted
                 else None, gen, f"{label}_T", rows["spmm_csr"],
                 [(d, "sum" if weighted else "copy_sum") for d in widths],
                 fp64=True)
        if label == "monet_krel":
            check_b3(gx, gen, label, rows["sddmm_csr"],
                     [("dot", "u", "v", d) for d in widths], fp64=True)


def train_relational(gen, rows: dict) -> list:
    """Phase 14: full-graph training of R-GCN (``train_full_graph`` on its
    RelGraph), MoNet (on ``make_bundle(g, krel=2)``), GC-MC and LGNN
    (``make_loss_step`` on ``rating_loss`` / ``train_loss``), each at its
    benchmark's shape — the backward kernels at the step's shapes, one
    step's grads on the kernel route against the plain fused route,
    launches per step, 10 epochs a route — and one R-GCN step under
    ``torch.profiler``."""
    import copy

    from repro_torch.models.gnn import gcmc, lgnn, monet, rgcn
    from repro_torch.models.gnn.common import make_bundle
    from repro_torch.models.gnn.train import make_train_step, train_full_graph
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.substrate.nn import cross_entropy_loss

    def seeded():
        return torch.Generator().manual_seed(0)

    out = []
    # R-GCN and MoNet: the full-graph trainer
    n, R, _ = RGCN_BGS
    rg = rgcn.build_relgraph(bgs_relations(), n, "cuda")
    x, y = (torch.from_numpy(a).cuda() for a in bgs_inputs())
    everyone = torch.ones(n, dtype=torch.bool, device="cuda")
    g, feats, labels, train_mask, _, n_classes = make_node_dataset(
        MONET_DATASET, device="cuda")
    bundle = make_bundle(g, krel=MONET_K)
    feats, labels, train_mask = (torch.from_numpy(a).cuda() for a in
                                 (feats, labels, train_mask))
    fwd, bwd, g_all, ratings = ml1m_graphs()
    du, di, dh, do = GCMC_DIMS
    rng = np.random.default_rng(0)      # bench_gcmc's inputs
    xu, xi = (torch.from_numpy(rng.normal(size=(m, d)).astype(
        np.float32)).cuda() for m, d in ((GCMC_SHAPE[0], du),
                                         (GCMC_SHAPE[1], di)))
    ratings = torch.from_numpy(ratings).cuda()
    g_sbm, lg, line_s, rel_sbm, comm = sbm_graphs()
    comm = torch.from_numpy(comm).cuda()
    d_emb, d_hidden = LGNN_DIMS
    relational_train_kernels(gen, rows, {
        "rgcn_expanded": (rg, (32, 4), None, True),
        "gcmc_user_item": (fwd, (dh,), None, True),
        "gcmc_item_user": (bwd, (dh,), None, True),
        "monet_krel": (bundle.krel(MONET_K), (MONET_HIDDEN, n_classes),
                       (torch.rand(bundle.krel(MONET_K).n_edges,
                                   generator=gen) + 0.5).cuda(), False),
        "lgnn_expanded": (rel_sbm, (d_hidden, LGNN_SBM[1]), None, False)})

    def full_graph(mod, data, mask):
        def loss(m, strategy):
            return cross_entropy_loss(mod.forward(m, data[0], data[1],
                                                  strategy=strategy),
                                      data[2], mask)

        def run(m, strategy, epochs):
            return train_full_graph(mod.forward, m, data[0], data[1],
                                    data[2], mask, strategy=strategy,
                                    epochs=epochs, seed=0)[1]
        return loss, run

    apps = {
        "rgcn": (rgcn.init(seeded(), 32, 32, 4, R, device="cuda"),
                 *full_graph(rgcn, (rg, x, y), everyone),
                 {"graph": "bgs-like", "n": n, "n_rel": R,
                  "n_edges": rg.n_edges, "widths": [32, 32, 4],
                  "n_bases": 4}),
        "monet": (monet.init(seeded(), feats.shape[1], MONET_HIDDEN,
                             n_classes, n_kernels=MONET_K, device="cuda"),
                  *full_graph(monet, (bundle, feats, labels), train_mask),
                  {"graph": MONET_DATASET, "n": g.n_dst,
                   "n_edges": g.n_edges, "hidden": MONET_HIDDEN,
                   "kernels": MONET_K}),
    }

    def gcmc_loss(m, strategy):
        return gcmc.rating_loss(m, (fwd, bwd, g_all), xu, xi, ratings,
                                strategy=strategy)

    def lgnn_loss(m, strategy):
        return lgnn.train_loss(m, g_sbm, lg, comm, rg=rel_sbm,
                               strategy=strategy)

    apps["gcmc"] = (
        gcmc.init(seeded(), du, di, dh, do, GCMC_SHAPE[3], device="cuda"),
        gcmc_loss, lambda m, st, ep: loss_step_epochs(gcmc_loss, m, st, ep),
        {"graph": "ml1m-like", "n_users": GCMC_SHAPE[0],
         "n_items": GCMC_SHAPE[1], "n_ratings": GCMC_SHAPE[2],
         "levels": GCMC_SHAPE[3], "dims": list(GCMC_DIMS)})
    apps["lgnn"] = (
        lgnn.init(seeded(), LGNN_SBM[0], d_emb, d_hidden, LGNN_SBM[1],
                  device="cuda"),
        lgnn_loss, lambda m, st, ep: loss_step_epochs(lgnn_loss, m, st, ep),
        {"graph": "sbm", "n": LGNN_SBM[0], "n_edges": g_sbm.n_edges,
         "line_edges": lg.n_edges, "relgraph_edges": rel_sbm.n_edges,
         "dims": [d_emb, d_hidden, LGNN_SBM[1]],
         "line_graph_build_s": line_s})

    for app, (model, loss, run, extra) in apps.items():
        params = list(model.parameters())
        m1 = copy.deepcopy(model)     # LGNN's loss writes its BN state

        def grads(strategy):
            got = torch.autograd.grad(loss(m1, strategy), list(
                m1.parameters()), allow_unused=True)
            torch.cuda.synchronize()
            return [torch.zeros_like(p) if gr is None else gr
                    for p, gr in zip(params, got)]

        per_step = RELATIONAL_TRAIN_LAUNCHES[app]
        grad_row = relational_grads(app, model, grads,
                                    {"plain": (("fused",), True)}, per_step)
        bn_changed = None
        if app == "lgnn":             # one step writes the running stats
            m2 = copy.deepcopy(model)
            before = [b.clone() for b in m2.buffers()]
            loss_step_epochs(lgnn_loss, m2, "auto", 1)
            bn_changed = [not torch.equal(a, b)
                          for a, b in zip(before, m2.buffers())]
            if not all(bn_changed):
                raise AssertionError(f"lgnn: a step left BatchNorm "
                                     f"statistics unchanged: {bn_changed}")
        runs = epoch_runs(
            app, model, lambda m, st: run(m, st, TRAIN_EPOCHS),
            {"kernel": "auto", "plain": "fused"},
            {k: v * (TRAIN_EPOCHS + 1) for k, v in per_step.items()})
        row = {"phase": "train_relational", "app": app, **extra,
               "epochs": TRAIN_EPOCHS,
               "step_launches": grad_row["step_launches"],
               "launches": runs["kernel"]["launches"],
               "grads_max_abs_err": max(r["plain"]["max_abs_err"]
                                        for r in grad_row["grads"].values()),
               "grads_bit_identical": grad_row["grads_bit_identical"],
               "bn_stats_changed": bn_changed,
               "kernel": runs["kernel"], "plain": runs["plain"],
               "epoch_speedup_median": (runs["plain"]["epoch_ms_median"]
                                        / runs["kernel"]["epoch_ms_median"])}
        if app == "rgcn":
            opt_init, step = make_train_step(rgcn.forward)
            m = copy.deepcopy(model)
            state = opt_init(m)
            tgen = torch.Generator(device="cuda").manual_seed(0)
            row["trace"] = trace_step(lambda: float(step(
                m, state, 0, rg, x, y, everyone, tgen)[1]),
                sum(per_step.values()))
        emit(row)
        out.append(row)
    return out


def train_relational_sampled(gen, rows: dict) -> list:
    """Phase 14, sampled R-GCN on the BGS-like merged graph at
    ``SAMPLED_RGCN``: B1 over each block's relation-expanded Gᵀ of the
    first training batch (float64 plain, bit-identical, timed); one
    step's grads on the kernel path (B4 forward, the gather backward on
    B1) against the plain pull with autograd (scatter) and with the
    gather backward, both gathers bit-identical over two calls; then
    ``train_sampled`` in turns kernel, plain, plain, kernel: epoch 1 with
    its sample / step split, the loss (finite, falling), launches."""
    import copy

    from repro_torch.core.hetero import block_expanded_reverse
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.models.gnn import rgcn
    from repro_torch.models.gnn.common import block_features, pad_features
    from repro_torch.models.gnn.train import train_sampled
    from repro_torch.substrate.nn import cross_entropy_loss

    n, R, _ = RGCN_BGS
    fanouts, batch, max_batches = SAMPLED_RGCN
    gm, rel_ids = rgcn.merged_graph(bgs_relations(), n, "cuda")
    x, y = bgs_inputs()
    ids = np.arange(n)
    model = rgcn.init(torch.Generator().manual_seed(0), 32, 32, 4, R,
                      device="cuda")

    def sampler():
        return NeighborSampler(gm, list(fanouts), batch, seed=0,
                               edge_rel=rel_ids, device="cuda",
                               reverse=True)

    mb = next(sampler().batches(ids, y, drop_last=False))
    for li, blk in enumerate(mb.blocks):
        gx = block_expanded_reverse(blk.bg, blk.rel, R)
        check_b1(gx, blk.rel_norm.index_select(0, gx.long("eid"))
                 .contiguous(), gen, f"rgcn_block{li}_xT", rows["spmm_csr"],
                 [(32 if li == 0 else 4, "sum")], fp64=True)
    feats_pad = pad_features(x, "cuda")
    xb = block_features(feats_pad, mb.input_ids)

    def grads(strategy, bwd):
        logits = rgcn.forward_blocks(model, mb.blocks, xb,
                                     strategy=strategy, bwd_strategy=bwd)
        got = torch.autograd.grad(cross_entropy_loss(
            logits, mb.labels, mb.label_mask), list(model.parameters()))
        torch.cuda.synchronize()
        return got

    per_step = RELATIONAL_TRAIN_LAUNCHES["rgcn_sampled"]
    grad_row = relational_grads(
        "rgcn_sampled", model, grads,
        {"plain_scatter": (("ell", "scatter"), False),
         "plain_gather": (("ell", "gather"), True)}, per_step,
        kernel_args=("auto", "auto"))

    paths = {"kernel": ("auto", "auto"), "plain": ("ell", "scatter")}
    runs = {"kernel": [], "plain": []}
    for path in ("kernel", "plain", "plain", "kernel"):
        m = copy.deepcopy(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _, hist = train_sampled(
            rgcn.forward_blocks, m, gm, x, y, ids, fanouts=fanouts,
            batch_size=batch, strategy=paths[path][0],
            bwd_strategy=paths[path][1], epochs=SAMPLED_EPOCHS, seed=0,
            max_batches=max_batches, sampler=sampler())
        got = read_counts()
        loss = hist["loss"]
        if not (all(np.isfinite(loss)) and loss[-1] < loss[0]):
            raise AssertionError(f"rgcn sampled {path}: loss {loss}")
        nb = sum(hist["n_batches"])
        # a step per batch and one drift probe (a step and a forward)
        want = {k: per_step.get(k, 0) * (nb + 1)
                + RGCN_FANOUT_LAUNCHES.get(k, 0)
                if path == "kernel" else 0 for k in got}
        if nb != SAMPLED_EPOCHS * max_batches or got != want:
            raise AssertionError(f"rgcn sampled {path}: {nb} batches, "
                                 f"launches {got}; expected {want}")
        runs[path].append({
            "epoch1_ms": hist["epoch_time"][1] * 1e3,
            "sample1_ms": hist["sample_time"][1] * 1e3,
            "step1_ms": hist["step_time"][1] * 1e3,
            "epoch0_ms": hist["epoch_time"][0] * 1e3, "loss": loss,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": got})

    def pooled(rs):
        return {**{k: [r[k] for r in rs] for k in (
            "epoch1_ms", "sample1_ms", "step1_ms", "epoch0_ms")},
                "epoch1_ms_per_batch": [r["epoch1_ms"] / max_batches
                                        for r in rs],
                "loss": rs[0]["loss"],
                "max_memory_allocated_bytes": max(
                    r["max_memory_allocated_bytes"] for r in rs),
                "launches": {k: sum(r["launches"][k] for r in rs)
                             for k in rs[0]["launches"]}}

    row = {"phase": "train_relational_sampled", "app": "rgcn",
           "graph": "bgs-like", "fanouts": list(fanouts),
           "batch_size": batch, "batches_per_epoch": max_batches,
           "epochs": SAMPLED_EPOCHS,
           "step_launches": grad_row["step_launches"],
           "grads_bit_identical": grad_row["grads_bit_identical"],
           "kernel": pooled(runs["kernel"]), "plain": pooled(runs["plain"])}
    row["launches"] = row["kernel"]["launches"]
    emit(row)
    return [row]


# --------------------------------------------------------------------- #
# 15. the lattice's layout routes
# --------------------------------------------------------------------- #
def peak_mb(fn) -> float:
    """Device memory (MiB) one call of ``fn`` holds above what was
    allocated before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def launched() -> int:
    return sum(read_counts().values())


def route_vs(what: str, fn, ref_fn, ref_name: str, extra: dict) -> dict:
    """Hold ``fn`` (a plain route, which must launch no kernel) against
    ``ref_fn`` within ``STRATEGY_TOL``; time both (host, device-only)
    and read their peak memory. One row, emitted."""
    ref = ref_fn()
    reset_counts()
    got = fn()
    torch.cuda.synchronize()
    if launched():
        raise AssertionError(f"{what}: the plain route launched "
                             f"{read_counts()}")
    err = max_err(got, ref)
    tol = STRATEGY_TOL + STRATEGY_TOL * float(ref.abs().max())
    row = {"phase": "strategies", "check": what, **extra,
           "reference": ref_name, "max_abs_err": err, "tol": tol,
           "ms": time_ms(fn, reps=10, warmup=2),
           "device_ms": time_device_ms(fn, False, reps=10, warmup=2),
           "peak_mb": peak_mb(fn),
           "ref_ms": time_ms(ref_fn, reps=10, warmup=2),
           "ref_device_ms": time_device_ms(ref_fn, False, reps=10,
                                           warmup=2),
           "ref_peak_mb": peak_mb(ref_fn)}
    emit(row)
    if not err <= tol:
        raise AssertionError(f"{what} disagrees: {row}")
    return row


def timed_build(name: str, fn, builds: dict):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    builds[name] = {"build_s": time.perf_counter() - t0}
    return out


def skewed_relgraph():
    """``HETERO_SKEW``'s relational graph: per relation uniform random
    edges over its nodes, numpy seed 0."""
    from repro_torch.core.hetero import from_rels

    n, sizes = HETERO_SKEW
    rng = np.random.default_rng(0)
    rels = [(rng.integers(0, n, m), rng.integers(0, n, m)) for m in sizes]
    return from_rels(rels, n_src=n, n_dst=n, device="cuda")


def strategy_packs(g, rg) -> dict:
    """The host build (and upload) of each pack of the phase, timed at
    its first use, with its size."""
    from repro_torch.core import hetero
    from repro_torch.core.graph import reverse
    from repro_torch.core.planner import get_plan_cache

    builds = {}
    cache = get_plan_cache(g)
    ell = timed_build("ell", cache.ell, builds)
    rev = reverse(g)
    ell_rev = timed_build("ell_rev", get_plan_cache(rev).ell, builds)
    rag = timed_build("ell_ragged", cache.ell_ragged, builds)
    tiles = timed_build("tiles", cache.tiles, builds)
    classes = timed_build("skew_classes",
                          lambda: hetero._skew_classes(rg), builds)
    if classes is None or len(classes) < 2:
        raise AssertionError("the skewed relational graph formed no skew "
                             "classes: the ell route would check only its "
                             "global pack")
    for name, pack in (("ell", ell), ("ell_rev", ell_rev),
                       ("ell_ragged", rag)):
        builds[name].update(classes=[c.width for c in pack.classes],
                            slots=pack.slots)
    builds["tiles"].update(buckets=tiles.n_buckets, eb=tiles.eb,
                           bm=tiles.bm, bk=tiles.bk)
    builds["skew_classes"].update(
        classes=len(classes),
        class_edges=[cg.n_edges for cg, _ in classes],
        class_ell_slots=[get_plan_cache(cg).peek("ell").slots
                         for cg, _ in classes])
    emit({"phase": "strategies", "check": "pack_builds",
          "n_edges": g.n_edges, "relational_edges": rg.n_edges,
          "packs": builds})
    return builds


def strategy_gspmm(g, gen) -> list:
    """``gspmm`` under each layout route against the kernel route (the
    max against segment), and C6's broadcast ``u_dot_v`` through the
    segment backward against float64 autograd of ``push``."""
    from repro_torch.core import gspmm
    from repro_torch.models.gnn.common import make_bundle

    w = make_bundle(g).gcn_norm[:, None]
    rows = []
    for specs, ref in ((STRATEGY_ROUTES, "kernel"), (STRATEGY_MAX,
                                                     "segment")):
        for op, d, routes in specs:
            kw = {"u": torch.randn(g.n_src, d, generator=gen).cuda()}
            if "_e_" in op:
                kw["e"] = w
            for route in routes:
                rows.append(route_vs(
                    f"gspmm {route}",
                    lambda: gspmm(g, op, strategy=route, **kw),
                    lambda: gspmm(g, op, strategy=ref, **kw), ref,
                    {"op": op, "d": d, "route": route}))
    # C6 on the card: u (n, 16) · v (n, 1), the grads at their shapes
    u = torch.randn(g.n_src, 16, generator=gen).cuda().requires_grad_()
    v = torch.randn(g.n_dst, 1, generator=gen).cuda().requires_grad_()
    ct = torch.randn(g.n_dst, 1, generator=gen).cuda()
    got = torch.autograd.grad(gspmm(g, "u_dot_v_add_v", u=u, v=v,
                                    strategy="segment"), (u, v), ct)
    ud, vd = (t.detach().double().requires_grad_() for t in (u, v))
    ref = torch.autograd.grad(gspmm(g, "u_dot_v_add_v", u=ud, v=vd,
                                    strategy="push"), (ud, vd), ct.double())
    errs = [max_err(a.double(), b) for a, b in zip(got, ref)]
    tols = [STRATEGY_TOL + STRATEGY_TOL * float(b.abs().max()) for b in ref]
    row = {"phase": "strategies", "check": "segment_broadcast_dot_grads",
           "op": "u_dot_v_add_v", "widths": [16, 1],
           "shapes": [list(t.shape) for t in got],
           "reference": "float64 push autograd", "max_abs_err": errs,
           "tol": tols}
    emit(row)
    if ([t.shape for t in got] != [u.shape, v.shape]
            or any(e > t for e, t in zip(errs, tols))):
        raise AssertionError(f"C6 on the card: {row}")
    rows.append(row)
    return rows


def strategy_train(g, dataset) -> list:
    """``STRATEGY_STEPS`` full-graph steps of GCN and SAGE under ``"ell"``
    and ``"kernel"`` from one init: at each step of the ``"ell"``
    trajectory, the loss and grads of both routes at its parameters;
    then each route's own trajectory (step time, peak memory, loss;
    launches: none under ``"ell"``, exact under ``"kernel"``)."""
    import copy

    from repro_torch.models.gnn import gcn, sage
    from repro_torch.models.gnn.common import make_bundle
    from repro_torch.models.gnn.train import make_train_step
    from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
    from repro_torch.substrate.nn import cross_entropy_loss

    _, feats, labels, train_mask, _, n_classes = dataset
    x, y, mask = (torch.from_numpy(a).cuda() for a in (feats, labels,
                                                       train_mask))
    y = y.long()
    bundle = make_bundle(g, training=True)
    if not bundle.use_training_graph("ell", TRAIN_HIDDEN):
        raise AssertionError("the training bundle has no ELL packs")
    rows = []
    for app, mod in (("gcn", gcn), ("sage", sage)):
        model = mod.init(torch.Generator().manual_seed(0), x.shape[1],
                         TRAIN_HIDDEN, n_classes, device="cuda")

        def loss_grads(m, strategy, seed):
            logits = mod.forward(
                m, bundle, x, strategy=strategy, train=True,
                gen=torch.Generator(device="cuda").manual_seed(seed))
            loss = cross_entropy_loss(logits, y, mask)
            grads = torch.autograd.grad(loss, list(m.parameters()))
            return loss.detach(), grads

        # the grads of both routes at the "ell" trajectory's parameters
        m = copy.deepcopy(model)
        opt_init, opt_update = adamw(1e-2, weight_decay=5e-4)
        state = opt_init(list(m.parameters()))
        per_step = []
        for i in range(STRATEGY_STEPS):
            reset_counts()
            l_ell, g_ell = loss_grads(m, "ell", i)
            torch.cuda.synchronize()
            if launched():
                raise AssertionError(f"{app} ell step launched "
                                     f"{read_counts()}")
            l_k, g_k = loss_grads(m, "kernel", i)
            errs = {n: max_err(a, b) for (n, _), a, b in zip(
                m.named_parameters(), g_ell, g_k)}
            tols = {n: 1e-6 + TRAIN_GRAD_RTOL * float(b.abs().max())
                    for (n, _), b in zip(m.named_parameters(), g_k)}
            loss_err = abs(float(l_ell) - float(l_k))
            loss_tol = 1e-6 + TRAIN_GRAD_RTOL * abs(float(l_k))
            per_step.append({"loss_ell": float(l_ell),
                             "loss_kernel": float(l_k),
                             "loss_abs_err": loss_err,
                             "grads_max_abs_err": errs, "tol": tols})
            if loss_err > loss_tol or any(errs[n] > tols[n] for n in errs):
                raise AssertionError(f"{app} step {i} ell vs kernel: "
                                     f"{per_step[-1]}")
            grads, _ = clip_by_global_norm(list(g_ell), 5.0)
            ups, state = opt_update(grads, state, list(m.parameters()), i)
            apply_updates(list(m.parameters()), ups)
        # each route's own trajectory
        runs = {}
        for route in ("ell", "kernel"):
            opt_init, step = make_train_step(mod.forward, route)
            mr = copy.deepcopy(model)
            st = opt_init(mr)
            gen = torch.Generator(device="cuda").manual_seed(0)
            step(copy.deepcopy(mr), opt_init(mr), 0, bundle, x, y, mask,
                 gen)                   # warm-up, as train_full_graph's
            gen = torch.Generator(device="cuda").manual_seed(0)
            times, mems, losses = [], [], []
            torch.cuda.synchronize()
            reset_counts()
            for i in range(STRATEGY_STEPS):
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                st, loss = step(mr, st, i, bundle, x, y, mask, gen)
                losses.append(float(loss))
                times.append((time.perf_counter() - t0) * 1e3)
                mems.append((torch.cuda.max_memory_allocated() - base)
                            / 2**20)
            runs[route] = {"step_ms": times, "step_peak_mb": mems,
                           "loss": losses, "launches": read_counts()}
        if sum(runs["ell"]["launches"].values()):
            raise AssertionError(f"{app} ell trajectory launched "
                                 f"{runs['ell']['launches']}")
        check_launches(f"{app} kernel trajectory", runs["kernel"]["launches"],
                       TRAIN_LAUNCHES[app], STRATEGY_STEPS)
        for a, b in zip(runs["ell"]["loss"], runs["kernel"]["loss"]):
            if not abs(a - b) <= 1e-6 + TRAIN_GRAD_RTOL * abs(b):
                raise AssertionError(f"{app} trajectories: {runs}")
        row = {"phase": "strategies", "check": "train_ell", "app": app,
               "widths": [int(x.shape[1]), TRAIN_HIDDEN, n_classes],
               "steps": per_step, "ell": runs["ell"],
               "kernel": runs["kernel"],
               "launches": runs["kernel"]["launches"]}
        emit(row)
        rows.append(row)
    return rows


def strategy_blocks(g, gen) -> list:
    """``block_gspmm`` under ``push`` on the block phase's class-128
    batch (fan-out ``FANOUT``, seed 0) against the block kernel route,
    at the B1 shapes of ``BLOCK_SHAPES``."""
    from repro_torch.core.blocks import block_gspmm
    from repro_torch.data.sampler import NeighborSampler

    seeds = np.random.default_rng(0).permutation(g.n_dst)[:128]
    mb = NeighborSampler(g, [FANOUT, FANOUT], 128, seed=0,
                         device="cuda").sample(seeds, np.zeros(128, np.int64))
    rows = []
    for li, (blk, shapes) in enumerate(zip(mb.blocks, BLOCK_SHAPES)):
        for d, red in shapes["b1"]:
            op = "u_mul_e_add_v" if red == "sum" else "u_copy_mean_v"
            kw = {"u": torch.randn(blk.bg.g.n_src, d, generator=gen).cuda()}
            if red == "sum":
                kw["e"] = blk.gcn_norm[:, None]
            rows.append(route_vs(
                "block_gspmm push",
                lambda: block_gspmm(blk.bg, op, strategy="push", **kw),
                lambda: block_gspmm(blk.bg, op, strategy="kernel", **kw),
                "kernel", {"graph": f"block{li}", "op": op, "d": d,
                           "route": "push"}))
    return rows


def strategy_hetero(rg, gen) -> list:
    """``hetero_gspmm`` under ``ell`` (the skew classes' packs) and
    ``push`` against its kernel route, and the max under both against
    ``fused``."""
    from repro_torch.core import hetero

    n = rg.n_src
    u = torch.randn(n, 32, generator=gen).cuda()
    w = torch.randn(rg.n_rel, 32, 16, generator=gen).cuda() / 32 ** 0.5
    u16 = torch.randn(n, 16, generator=gen).cuda()
    rows = []
    cases = [(red, route, "kernel", {"u": u, "w": w})
             for red in ("mean", "sum") for route in ("ell", "push")]
    cases += [("max", route, "fused", {"u": u16})
              for route in ("ell", "push")]
    for red, route, ref, kw in cases:
        rows.append(route_vs(
            "hetero_gspmm", lambda: hetero.hetero_gspmm(
                rg, strategy=route, reduce=red, **kw),
            lambda: hetero.hetero_gspmm(rg, strategy=ref, reduce=red, **kw),
            ref, {"route": route, "reduce": red,
                  "form": "w" if "w" in kw else "plain",
                  "skew_classes": len(hetero._skew_classes(rg))}))
    return rows


def strategy_attention(g, gen) -> list:
    """GAT's attention grads (``RAGGED_ATTN`` heads × features) through
    the ragged-pack backward against ``_attention_grads``: the adjoints
    alone, then through ``fused_attention``'s B2 route, whose backward
    takes the pack built earlier in the phase."""
    import importlib

    from repro_torch.core.planner import get_plan_cache

    es = importlib.import_module("repro_torch.core.edge_softmax")
    pack = get_plan_cache(g).peek("ell_ragged")
    if pack is None:
        raise AssertionError("the ragged pack was not built")
    H, F = RAGGED_ATTN
    el = torch.randn(g.n_src, H, generator=gen).cuda()
    er = torch.randn(g.n_dst, H, generator=gen).cuda()
    z = torch.randn(g.n_src, H, F, generator=gen).cuda()
    ct = torch.randn(g.n_dst, H, F, generator=gen).cuda()
    needs = (True, True, True)
    rows = []
    for i, name in enumerate(("el", "er", "z")):
        rows.append(route_vs(
            "attention_grads_ragged",
            lambda: es._attention_grads_ragged(pack, el, er, z, 0.2, ct,
                                               needs)[i],
            lambda: es._attention_grads(g, el, er, z, 0.2, ct, needs)[i],
            "_attention_grads", {"grad": name, "H": H, "F": F}))
    ins = [t.clone().requires_grad_() for t in (el, er, z)]
    got = torch.autograd.grad(es.fused_attention(g, *ins, strategy="kernel"),
                              ins, ct)
    want = es._attention_grads(g, el, er, z, 0.2, ct, needs)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    tols = [STRATEGY_TOL + STRATEGY_TOL * float(b.abs().max()) for b in want]
    row = {"phase": "strategies", "check": "fused_attention_ragged_backward",
           "H": H, "F": F, "max_abs_err": errs, "tol": tols}
    emit(row)
    if any(e > t for e, t in zip(errs, tols)):
        raise AssertionError(f"ragged backward through B2: {row}")
    rows.append(row)
    return rows


def launches_of(fn) -> int:
    """Kernel launches of one call of ``fn`` (the counters reset)."""
    reset_counts()
    fn()
    torch.cuda.synchronize()
    return sum(read_counts().values())


def check_route_launches(what: str, route: str, n: int) -> None:
    """A kernel route launches some kernel, a plain route none."""
    if (n > 0) != (route == "kernel"):
        raise AssertionError(f"{what}: route {route!r} launched {n} "
                             f"kernel(s)")


def planner_fit(g, gen) -> dict:
    """The cuda row's fit (benchmarks/torch_planner_fit.py) on this run's
    card, printed beside the row the planner carries."""
    from benchmarks.torch_planner_fit import fit_cuda_row
    from repro_torch.core import planner
    from repro_torch.data.synthetic import make_node_dataset

    tiny = make_node_dataset("tiny", device="cuda")[0]
    fit = fit_cuda_row(g, tiny, gen, emit=print)
    row = {"phase": "planner_fit", **{k: fit[k] for k in (
        "rate", "fixed", "ell_class", "unit_ms", "host_ms",
        "reddit_stats")}, "device_ms": fit["device_ms"], "work": fit["work"],
        "carried": {"rate": planner._THROUGHPUT["cuda"],
                    "fixed": planner._FIXED["cuda"],
                    "ell_class": planner._OVERHEAD["cuda"]["ell_class"]}}
    emit(row)
    return row


def planner_rank(g, gen) -> list:
    """Per main-path op: every route it can run, its predicted cost on
    the cuda row and its measured device time, both rankings, auto's
    choice; each route's launches checked (a kernel route launches, a
    plain one not), and auto's."""
    from repro_torch.core import gspmm, gsddmm, parse_op, planner

    stats = planner.get_plan_cache(g).stats
    out = []
    for op, d, de, lead in PLANNER_RANK:
        spec = parse_op(op)
        nodes = g.n_edges if spec.lhs == "e" else g.n_src
        lhs = torch.randn((nodes,) + lead + (d,), generator=gen).cuda()
        rhs = None if de is None else torch.rand(
            (g.n_edges,) + lead + (de,), generator=gen).cuda()
        kw = {spec.lhs: lhs} if rhs is None else {spec.lhs: lhs, "e": rhs}
        width = int(np.prod(lhs.shape[1:]))
        routes = [r for r in PLANNER_ROUTES
                  if planner.supports(r, spec, lhs, rhs)
                  and (r != "onehot" or width <= 32)]
        pred, meas = {}, {}
        for r in routes:
            pred[r] = planner.estimate_cost(r, stats, width, "cuda")
            meas[r] = time_device_ms(lambda: gspmm(g, op, strategy=r, **kw),
                                     cold=False, reps=10, warmup=2)
            check_route_launches(f"{op} d={width}", r, launches_of(
                lambda: gspmm(g, op, strategy=r, **kw)))
        auto = planner.plan_gspmm(g, spec, lhs, rhs).strategy
        check_route_launches(f"{op} d={width} auto", auto,
                             launches_of(lambda: gspmm(g, op, **kw)))
        row = {"phase": "planner_rank", "op": op, "d": width,
               "predicted": pred, "device_ms": meas,
               "predicted_order": sorted(pred, key=pred.get),
               "measured_order": sorted(meas, key=meas.get), "auto": auto}
        row["auto_is_fastest"] = auto == row["measured_order"][0]
        emit(row)
        out.append(row)
        del lhs, rhs, kw
    sig = (g.n_src, g.n_dst, g.n_edges)
    for op, d in PLANNER_RANK_SDDMM:
        spec = parse_op(op)
        kw = {t: torch.randn(g.n_edges if t == "e" else g.n_src, d,
                             generator=gen).cuda().abs_() + 0.5
              for t in (spec.lhs, spec.rhs)}
        pred, meas = {}, {}
        for r in ("kernel", "canonical", "gather"):
            pred[r] = planner._sddmm_cost(r, g.n_edges, d, "cuda")
            meas[r] = time_device_ms(lambda: gsddmm(g, op, strategy=r, **kw),
                                     cold=False, reps=10, warmup=2)
            check_route_launches(f"sddmm {op}", r, launches_of(
                lambda: gsddmm(g, op, strategy=r, **kw)))
        auto = planner.plan_sddmm(sig, spec, d, lhs_data=kw[spec.lhs],
                                  rhs_data=kw[spec.rhs])
        check_route_launches(f"sddmm {op} auto", auto,
                             launches_of(lambda: gsddmm(g, op, **kw)))
        row = {"phase": "planner_rank", "op": f"sddmm:{op}", "d": d,
               "predicted": pred, "device_ms": meas,
               "predicted_order": sorted(pred, key=pred.get),
               "measured_order": sorted(meas, key=meas.get), "auto": auto}
        row["auto_is_fastest"] = auto == row["measured_order"][0]
        emit(row)
        out.append(row)
    return out


def planner_autotune(g, gen, mb) -> list:
    """Autotune on the card: each candidate measured once (the times the
    planner kept), the winner's output against the kernel route within
    STRATEGY_TOL, and the winner's launches on a second, cached call."""
    from repro_torch.core import block_gspmm, gspmm, gsddmm, parse_op
    from repro_torch.core import planner

    def check(what, got, ref, winner, again):
        err = max_err(got, ref)
        tol = STRATEGY_TOL + STRATEGY_TOL * float(ref.abs().max())
        check_route_launches(f"autotune {what}", winner, launches_of(again))
        row = {"phase": "planner_autotune", "op": what,
               "times_s": planner.autotune_times(what.split(" ")[0]),
               "winner": winner, "max_abs_err": err, "tol": tol}
        emit(row)
        if not err <= tol:
            raise AssertionError(f"autotune {what}: {row}")
        return row

    out = []
    planner.clear_block_plans()         # cost-mode decisions are memoized
    planner.clear_sddmm_plans()
    planner.set_mode("autotune")
    try:
        for op, d, de in PLANNER_AUTOTUNE:
            u = torch.randn(g.n_src, d, generator=gen).cuda()
            kw = {"u": u} if de is None else {
                "u": u, "e": torch.rand(g.n_edges, de, generator=gen).cuda()}
            ref = gspmm(g, op, strategy="kernel", **kw)
            got = gspmm(g, op, **kw)
            out.append(check(f"{op} d={d}", got, ref, planner.last_plan(op),
                             lambda: gspmm(g, op, **kw)))
            del u, kw, ref, got
        bg = mb.blocks[0].bg
        x = torch.randn(bg.g.n_src, 64, generator=gen).cuda()
        ref = block_gspmm(bg, "u_copy_mean_v", u=x, strategy="kernel")
        got = block_gspmm(bg, "u_copy_mean_v", u=x)
        out.append(check("block:u_copy_mean_v d=64", got, ref,
                         planner.last_plan("block:u_copy_mean_v"),
                         lambda: block_gspmm(bg, "u_copy_mean_v", u=x)))
        el, er = (torch.randn(g.n_src, 4, generator=gen).cuda()
                  for _ in range(2))
        ref = gsddmm(g, "u_add_v_copy_e", u=el, v=er, strategy="kernel")
        got = gsddmm(g, "u_add_v_copy_e", u=el, v=er)
        out.append(check("sddmm:u_add_v_copy_e d=4", got, ref,
                         planner.last_plan("sddmm:u_add_v_copy_e"),
                         lambda: gsddmm(g, "u_add_v_copy_e", u=el, v=er)))
    finally:
        planner.set_mode("cost")
        planner.clear_block_plans()
        planner.clear_sddmm_plans()
        planner.get_plan_cache(g)._autotuned.clear()
    return out


def planner_drift(g, dataset) -> dict:
    """The plan log and the drift report after one layer-wise serve (a
    GCN server on ``g``, one request per class), one full-graph step
    per app and one sampled SAGE epoch, all under auto."""
    from repro_torch import obs
    from repro_torch.core import planner
    from repro_torch.core.serving import GNNServer
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.common import make_bundle
    from repro_torch.models.gnn.train import make_train_step, train_sampled

    _, feats, labels, train_mask, _, n_classes = dataset
    init = torch.Generator().manual_seed(0)             # the weights
    gen = torch.Generator(device="cuda").manual_seed(0)  # dropout
    obs.clear_events()
    planner.clear_plan_log()
    t0 = time.perf_counter()
    srv = GNNServer("gcn", gcn.init(init, feats.shape[1], 32, n_classes),
                    g, feats, mode="layerwise", device="cuda")
    srv.serve([(i, list(range(i, i + n))) for i, n in enumerate((8, 32,
                                                                128))])
    del srv
    bundle = make_bundle(g)
    x = torch.from_numpy(feats).cuda()
    y = torch.from_numpy(labels).cuda().long()
    mask = torch.from_numpy(train_mask).cuda()
    for mod in (gcn, sage, gat):
        model = mod.init(init, feats.shape[1], TRAIN_HIDDEN, n_classes)
        opt_init, step = make_train_step(mod.forward, "auto")
        float(step(model, opt_init(model), 0, bundle, x, y, mask, gen)[1])
    fanouts, batch, hidden, n_batches = PLANNER_SAMPLED
    model = sage.init(init, feats.shape[1], hidden, n_classes)
    train_sampled(sage.forward_blocks, model, g, feats, labels,
                  np.nonzero(train_mask)[0], fanouts=fanouts,
                  batch_size=batch, epochs=1, max_batches=n_batches)
    log = [{"op": op, "requested": req, "chosen": chosen}
           for (op, req), chosen in sorted(planner.plan_log().items())]
    drift = obs.drift_report()
    row = {"phase": "planner_drift", "seconds": time.perf_counter() - t0,
           "plan_log": log, "drift": drift,
           "drifted": [r["op"] for r in drift if r["drifted"]]}
    emit(row)
    if not drift or not any(r["family"] == "block_bwd" for r in drift):
        raise AssertionError("planner: the drift report lacks rows")
    return row


# --------------------------------------------------------------------- #
# 17. mixed-precision training
# --------------------------------------------------------------------- #
def _bf16(args) -> tuple:
    """``args`` with every floating tensor in bf16."""
    return tuple(a.to(torch.bfloat16) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def bf16_cases(g, w_canon, gen, label: str, shapes=None) -> list:
    """B1, B3 and B4 at phase 17's shapes on ``g`` (``BF16_B1`` /
    ``BF16_B3`` / ``BF16_B4`` under ``label``, or ``shapes``, a triple of
    such lists), bf16 features drawn from
    ``gen`` and B1's weight ``w_canon`` in fp32: per shape ``(kernel name,
    row fields, kernel fn, plain fn, args, bytes, flops, library fn or
    None)``. Bytes count each bf16 feature row read once at 2 bytes an
    element, the output written once, weights and index arrays at 4."""
    from repro_torch.kernels.binary_reduce.ops import (binary_reduce_csr,
                                                       binary_reduce_plain)
    from repro_torch.kernels.sddmm.ops import (CALLER_INDEX, sddmm_csr,
                                               sddmm_plain)
    from repro_torch.kernels.spmm.ops import spmm_csr, spmm_plain

    bf = torch.bfloat16
    n_u, n_v = rows_read(g)
    out = []
    b1, b3, b4 = shapes or (BF16_B1.get(label, ()), BF16_B3.get(label, ()),
                            BF16_B4.get(label, ()))
    for d, red in b1:
        mean = red == "mean"
        weight = w_canon if red == "sum" else None
        B = torch.randn(g.n_src, d, generator=gen).cuda().to(bf)
        if mean:
            vals = (1.0 / g.in_degrees.clamp(min=1).float()).index_select(
                0, g.long("dst"))
        else:
            vals = (torch.ones(g.n_edges, device=B.device)
                    if weight is None else weight)
        A = torch.sparse_csr_tensor(g.long("indptr_dst"), g.long("src"),
                                    vals.to(bf), size=(g.n_dst, g.n_src))
        nbytes = (4 * ((g.n_dst + 1) + g.n_edges * (1 if weight is None
                                                     else 2))
                  + 2 * (n_u + g.n_dst) * d)
        out.append(("spmm_csr", {"d": d, "reduce": red,
                                 "weighted": weight is not None},
                    spmm_csr, spmm_plain, (g, B, weight, mean), nbytes,
                    2 * g.n_edges * d,
                    lambda A=A, B=B: torch.sparse.mm(A, B)))
    read = {"u": n_u, "v": n_v, "e": g.n_edges}
    for op, lt, rt, d, *more in b3:
        heads = more[0] if more else 1     # a dot per head (check_b3)
        args = _bf16(b3_operands(g, gen, op, lt, rt, d))
        n_idx = len({lt, rt} - {"e", None})
        nbytes = (4 * n_idx * g.n_edges
                  + 2 * (read[lt] * d + (0 if rt is None else read[rt] * d)
                         + g.n_edges * (heads if op == "dot" else d)))
        lib = None
        if op == "copy":
            lib = (lambda lhs=args[3], caller=g.long(CALLER_INDEX[lt]):
                   lhs.index_select(0, caller))
        out.append(("sddmm_csr:copy" if op == "copy" else "sddmm_csr",
                    {"op": op, "lhs": lt, "rhs": rt, "d": d, "heads": heads},
                    functools.partial(sddmm_csr, heads=heads),
                    functools.partial(sddmm_plain, heads=heads), args,
                    nbytes, g.n_edges * d, lib))
    for binop, d, de, red in b4:
        # copy_rhs reads no node rows; mul reads B through the sources
        B = (None if binop == "copy_rhs"
             else torch.randn(g.n_src, d, generator=gen).cuda().to(bf))
        E = torch.randn(g.n_edges, de, generator=gen).cuda().to(bf)
        nbytes = (4 * ((g.n_dst + 1) + g.n_edges)
                  + 2 * (E.numel() + g.n_dst * d)
                  + (0 if B is None else 4 * g.n_edges + 2 * n_u * d))
        lib = None
        if B is None:
            lib = (lambda e=E.index_select(0, g.long("eid")),
                   n=g.in_degrees.long(), r=red:
                   torch.segment_reduce(e, r, lengths=n))
        out.append(("binary_reduce_csr",
                    {"binop": binop, "d": d, "de": de, "reduce": red},
                    binary_reduce_csr, binary_reduce_plain,
                    (g, B, E, binop, red == "mean"), nbytes,
                    g.n_edges * d * (1 if B is None else 2), lib))
    return out


def check_bf16_kernels(g, w_canon, gen, label: str, rows: dict,
                       shapes=None) -> None:
    """Phase 17 (a): each bf16 kernel of :func:`bf16_cases` on ``g``,
    bit-identical over two calls; within ``BF16_PLAIN_REL`` (one bf16 ulp:
    both round an fp32 sum taken in another order) of its plain bf16
    version and within ``BF16_REF_REL``·|ref| + 1e-5·max|ref| (one
    rounding at the store, plus the fp32 sum's error) of the float64
    plain version of the same bf16 inputs and fp32 weights, element by
    element; timed warm, device-only and cold, beside its bf16 bound, the
    bf16 plain version, the fp32 kernel's device time at the same shape
    and one bf16 library call where PyTorch has one."""
    for name, fields, kernel, plain, args, nbytes, flops, lib in bf16_cases(
            g, w_canon, gen, label, shapes):
        counter = counters()[name.split(":")[0]]
        n0 = counter.launches
        what = f"{name} bf16 {label} {fields}"
        got = bit_identical(what, lambda: kernel(*args))
        pl = plain(*args)
        ref = plain(*(a.double() if isinstance(a, torch.Tensor)
                      and a.is_floating_point() else a for a in args))
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or pl.dtype != torch.bfloat16:
            raise AssertionError(f"{what}: dtypes {got.dtype}, {pl.dtype}")
        k64, p64 = got.double(), pl.double()
        ref_bad = int(((k64 - ref).abs() > BF16_REF_REL * ref.abs()
                       + 1e-5 * float(ref.abs().max())).sum())
        plain_bad = int(((k64 - p64).abs() > BF16_PLAIN_REL * p64.abs()
                         + 1e-5 * float(p64.abs().max())).sum())
        args32 = tuple(a.float() if isinstance(a, torch.Tensor)
                       and a.dtype == torch.bfloat16 else a for a in args)
        k_ms = time_ms(lambda: kernel(*args))
        k_dev = warm_cold_ms(lambda: kernel(*args))
        fp32_dev = time_device_ms(lambda: kernel(*args32), False)
        p_ms = time_ms(lambda: plain(*args))
        lib_ms, lib_dev, lib_err, lib_why = None, (None, None), None, None
        if lib is not None:
            try:    # a yardstick only: PyTorch may lack the bf16 form
                lib_err = max_err(lib().double(), ref)
            except RuntimeError as exc:
                lib, lib_why = None, str(exc).splitlines()[0][:160]
        if lib is not None:
            lib_ms = time_ms(lib)
            lib_dev = warm_cold_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        row = {"phase": "kernel_bf16", "kernel": name.split(":")[0],
               "dtype": "bfloat16", "graph": label, **fields,
               "max_abs_err": max_err(k64, ref), "reference": "fp64 plain",
               "tol": f"{BF16_REF_REL}*|ref| + 1e-5*max|ref|",
               "elements_over_tol": ref_bad,
               "plain_max_abs_err": max_err(k64, p64),
               "plain_elements_over_tol": plain_bad,
               "plain_bf16_ref_max_abs_err": max_err(p64, ref),
               "kernel_ms": k_ms, "kernel_device_ms": k_dev[0],
               "kernel_cold_ms": k_dev[1], "fp32_kernel_device_ms": fp32_dev,
               "plain_ms": p_ms, "library_ms": lib_ms,
               "library_device_ms": lib_dev[0],
               "library_cold_ms": lib_dev[1], "library_max_abs_err": lib_err,
               "library_missing": lib_why, "bound_ms": b_ms,
               "bound_by": b_by, "bit_identical": True,
               "launches": counter.launches - n0}
        emit(row)
        if ref_bad or plain_bad:
            raise AssertionError(f"{what} disagrees: {row}")
        rows[name][(label, "bf16") + tuple(fields.values())] = row


def bf16_grads(what: str, model, grads_fn, plains: dict,
               launches: dict, kernel_args=("auto",)) -> dict:
    """Phase 17 (b): one bf16 step's grads (``grads_fn(*args)``, each an
    fp32 gradient of an fp32 master) on the kernel path against each
    plain bf16 path, bit-identical over two calls, launches exactly
    ``launches`` (:func:`relational_grads`), per parameter within
    ``BF16_GRAD_RTOL``·max|plain| plus twice the plain bf16 path's own
    distance from its fp32 grads (``grads_fn(*args, prec="fp32")``): two
    bf16 paths each carry bf16's rounding noise, which a gradient that
    sums many cancelling terms (R-GCN's layer-0 basis) lifts above 2e-2
    of its largest entry on either path."""
    def checked(*args, prec="bf16"):
        got = grads_fn(*args, prec=prec)
        bad = [t.dtype for t in got if t.dtype != torch.float32]
        if bad:
            raise AssertionError(f"{what} {prec}: grads in {bad}")
        return got

    noise = {}
    for path, (args, _) in plains.items():
        ref = checked(*args, prec="fp32")
        noise[path] = [2.0 * float((a - b).abs().max())
                       for a, b in zip(checked(*args), ref)]
    row = relational_grads(what, model, checked, plains, launches,
                           kernel_args, rtol=BF16_GRAD_RTOL,
                           phase="train_bf16_grads", noise=noise)
    return row


def check_masters(what: str, model, step, *args) -> None:
    """One bf16 ``step`` (a trainer step with ``precision="bf16"``) on a
    copy of ``model``: parameters and AdamW moments stay fp32, the loss
    is finite."""
    import copy

    m = copy.deepcopy(model)
    opt_init, step_fn = step
    state, loss = step_fn(m, opt_init(m), 0, *args)
    dtypes = {t.dtype for t in list(m.parameters()) + state.mu + state.nu}
    if dtypes != {torch.float32} or not np.isfinite(float(loss)):
        raise AssertionError(f"{what} bf16 step: dtypes {dtypes}, loss "
                             f"{float(loss)}")


def train_bf16_full(app: str, data) -> dict:
    """Phase 17 (b, c) for ``app`` on ``reddit-like`` at phase 11's widths:
    one bf16 step's grads (kernel path against the segment route), the
    masters and moments fp32, then ``train_full_graph`` in bf16 for
    ``TRAIN_EPOCHS`` epochs in turns kernel, plain, fp32 kernel, fp32
    kernel, plain, kernel (launches exact; the loss finite and, but for
    GAT, as JAX's test excepts it, falling), with the bf16 − fp32 final
    loss delta (a reading, not a check)."""
    import functools

    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.train import (call_in_precision,
                                              make_train_step,
                                              train_full_graph)
    from repro_torch.substrate.nn import cross_entropy_loss

    bundle, x, labels, train_mask, val_mask, n_classes = data
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    model = mod.init(torch.Generator().manual_seed(0), x.shape[1],
                     TRAIN_HIDDEN, n_classes, device="cuda")
    def grads(strategy, prec="bf16"):
        logits = call_in_precision(
            prec, mod.forward, model, bundle,
            x.to(torch.bfloat16) if prec == "bf16" else x,
            strategy=strategy, train=True,
            gen=torch.Generator(device="cuda").manual_seed(0))
        out = torch.autograd.grad(cross_entropy_loss(
            logits.float(), labels, train_mask), list(model.parameters()))
        torch.cuda.synchronize()
        return out

    grad_row = bf16_grads(app, model, grads,
                          {"plain": (("segment",), False)},
                          TRAIN_LAUNCHES[app])
    check_masters(app, model, make_train_step(mod.forward, "auto",
                                              precision="bf16"),
                  bundle, x, labels, train_mask,
                  torch.Generator(device="cuda").manual_seed(0))
    strategy = {"kernel": ("auto", "bf16"), "plain": ("segment", "bf16"),
                "kernel_fp32": ("auto", "fp32")}
    runs = epoch_runs(
        f"{app} bf16", model, lambda m, st: train_full_graph(
            mod.forward, m, bundle, x, labels, train_mask, strategy=st[0],
            epochs=TRAIN_EPOCHS, seed=0, val_mask=val_mask,
            precision=st[1])[1], strategy,
        {k: TRAIN_LAUNCHES[app].get(k, 0) * (TRAIN_EPOCHS + 1)
         + SERVE_LAUNCHES[app].get(k, 0) * TRAIN_EPOCHS
         for k in read_counts()},
        order=("kernel", "plain", "kernel_fp32", "kernel_fp32", "plain",
               "kernel"), falling=app != "gat")
    cast = functools.partial(x.to, torch.bfloat16)
    row = {"phase": "train_bf16", "app": app, "dataset": "reddit-like",
           "hidden": TRAIN_HIDDEN, "epochs": TRAIN_EPOCHS,
           "step_launches": grad_row["step_launches"],
           "launches": {k: runs["kernel"]["launches"][k]
                        + runs["kernel_fp32"]["launches"][k]
                        for k in runs["kernel"]["launches"]},
           "grads_max_abs_err": max(r["plain"]["max_abs_err"]
                                    for r in grad_row["grads"].values()),
           "grads_bit_identical": grad_row["grads_bit_identical"],
           **runs,
           "final_loss_bf16_minus_fp32": (runs["kernel"]["loss"][-1]
                                          - runs["kernel_fp32"]["loss"][-1]),
           "x_cast_shape": list(x.shape), "x_cast_ms": time_ms(cast),
           "x_cast_device_ms": time_device_ms(cast, False),
           "epoch_ratio_bf16_over_fp32": (
               runs["kernel"]["epoch_ms_median"]
               / runs["kernel_fp32"]["epoch_ms_median"])}
    emit(row)
    return row


def train_bf16_sampled(g_loops, feats, labels, train_mask, n_classes,
                       prod) -> list:
    """Phase 17 (b, d): each sampled app's bf16 step grads on the
    training batch of ``reddit-like`` (10, 10) × 64 (kernel path against
    the plain pull with autograd and with the gather backward), then
    ``train_sampled`` in bf16 at ``SAMPLED_RUNS``' cells, kernel then
    plain: epoch 1 a batch with its sample / step split, launches
    exact, the loss finite (and falling but for GAT)."""
    from repro_torch.models.gnn.common import block_features, pad_features
    from repro_torch.models.gnn.train import call_in_precision
    from repro_torch.substrate.nn import cross_entropy_loss

    out = []
    mb = sampled_batch(g_loops, labels, train_mask, (10, 10), 64)
    xs = block_features(pad_features(feats, "cuda"), mb.input_ids)
    for app, hidden in (("sage", 64), ("gcn", 16), ("gat", 16)):
        mod, model = sampled_model(app, feats.shape[1], hidden, n_classes)

        def grads(strategy, bwd, prec="bf16", mod=mod, model=model):
            logits = call_in_precision(
                prec, mod.forward_blocks, model, mb.blocks,
                xs.to(torch.bfloat16) if prec == "bf16" else xs,
                strategy=strategy, bwd_strategy=bwd, train=True,
                gen=torch.Generator(device="cuda").manual_seed(0))
            got = torch.autograd.grad(cross_entropy_loss(
                logits.float(), mb.labels, mb.label_mask),
                list(model.parameters()))
            torch.cuda.synchronize()
            return got

        out.append(bf16_grads(f"{app} sampled", model, grads,
                              {"plain": (("ell", "scatter"), False),
                               "plain_gather": (("ell", "gather"), True)},
                              TRAIN_SAMPLED_LAUNCHES[app],
                              kernel_args=("auto", "auto")))
    del mb, xs
    torch.cuda.empty_cache()
    sets = {"reddit-like": (g_loops, feats, labels, train_mask, n_classes),
            "products-like": prod}
    for app, ds, fo, b, h, nb in SAMPLED_RUNS:
        out.append(sampled_runs(app, ds, sets[ds], fo, b, h, nb,
                                order=("kernel", "plain"),
                                precision="bf16", falling=app != "gat"))
    return out


def train_bf16_relational(gen) -> list:
    """Phase 17 (b, e): R-GCN (on its RelGraph) and MoNet (on
    ``make_bundle(g, krel=2)``) in bf16 at phase 14's shapes — a step's
    grads, kernel route against the plain fused route, and 10 epochs a
    route in turns, launches exact — and one bf16 step of sampled R-GCN
    (``SAMPLED_RGCN``'s batch) against the plain pull both ways."""
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.models.gnn import monet, rgcn
    from repro_torch.models.gnn.common import (block_features, make_bundle,
                                               pad_features)
    from repro_torch.models.gnn.train import (call_in_precision,
                                              train_full_graph)
    from repro_torch.substrate.nn import cross_entropy_loss

    out = []
    n, R, _ = RGCN_BGS
    rg = rgcn.build_relgraph(bgs_relations(), n, "cuda")
    xh, yh = bgs_inputs()
    x, y = torch.from_numpy(xh).cuda(), torch.from_numpy(yh).cuda()
    everyone = torch.ones(n, dtype=torch.bool, device="cuda")
    g, feats, labels, train_mask, _, n_classes = make_node_dataset(
        MONET_DATASET, device="cuda")
    bundle = make_bundle(g, krel=MONET_K)
    feats, labels, train_mask = (torch.from_numpy(a).cuda() for a in
                                 (feats, labels, train_mask))
    apps = {"rgcn": (rgcn, rgcn.init(torch.Generator().manual_seed(0), 32,
                                     32, 4, R, device="cuda"),
                     rg, x, y, everyone),
            "monet": (monet, monet.init(torch.Generator().manual_seed(0),
                                        feats.shape[1], MONET_HIDDEN,
                                        n_classes, n_kernels=MONET_K,
                                        device="cuda"),
                      bundle, feats, labels, train_mask)}
    for app, (mod, model, graph, xs, ys, mask) in apps.items():
        def grads(strategy, prec="bf16", mod=mod, model=model, graph=graph,
                  xs=xs, ys=ys, mask=mask):
            logits = call_in_precision(
                prec, mod.forward, model, graph,
                xs.to(torch.bfloat16) if prec == "bf16" else xs,
                strategy=strategy)
            got = torch.autograd.grad(cross_entropy_loss(
                logits.float(), ys, mask), list(model.parameters()))
            torch.cuda.synchronize()
            return got

        per_step = RELATIONAL_TRAIN_LAUNCHES[app]
        grad_row = bf16_grads(app, model, grads,
                              {"plain": (("fused",), True)}, per_step)
        runs = epoch_runs(
            f"{app} bf16", model, lambda m, st, mod=mod, graph=graph,
            xs=xs, ys=ys, mask=mask: train_full_graph(
                mod.forward, m, graph, xs, ys, mask, strategy=st,
                epochs=TRAIN_EPOCHS, seed=0, precision="bf16")[1],
            {"kernel": "auto", "plain": "fused"},
            {k: v * (TRAIN_EPOCHS + 1) for k, v in per_step.items()})
        row = {"phase": "train_bf16_relational", "app": app,
               "epochs": TRAIN_EPOCHS,
               "step_launches": grad_row["step_launches"],
               "launches": runs["kernel"]["launches"],
               "grads_max_abs_err": max(
                   r["plain"]["max_abs_err"]
                   for r in grad_row["grads"].values()),
               "grads_bit_identical": grad_row["grads_bit_identical"],
               **runs}
        emit(row)
        out.append(row)

    fanouts, batch, _ = SAMPLED_RGCN
    gm, rel_ids = rgcn.merged_graph(bgs_relations(), n, "cuda")
    mb = next(NeighborSampler(gm, list(fanouts), batch, seed=0,
                              edge_rel=rel_ids, device="cuda",
                              reverse=True).batches(np.arange(n), yh,
                                                    drop_last=False))
    xs = block_features(pad_features(xh, "cuda"), mb.input_ids)
    model = apps["rgcn"][1]

    def grads(strategy, bwd, prec="bf16"):
        logits = call_in_precision(
            prec, rgcn.forward_blocks, model, mb.blocks,
            xs.to(torch.bfloat16) if prec == "bf16" else xs,
            strategy=strategy, bwd_strategy=bwd)
        got = torch.autograd.grad(cross_entropy_loss(
            logits.float(), mb.labels, mb.label_mask),
            list(model.parameters()))
        torch.cuda.synchronize()
        return got

    row = bf16_grads("rgcn_sampled", model, grads,
                     {"plain_scatter": (("ell", "scatter"), False),
                      "plain_gather": (("ell", "gather"), True)},
                     RELATIONAL_TRAIN_LAUNCHES["rgcn_sampled"],
                     kernel_args=("auto", "auto"))
    out.append(row)
    return out


def bf16_planner(g, gen) -> dict:
    """Phase 17 (f): the ``cuda:bf16`` row's fit on this run's card
    (``benchmarks/torch_planner_fit.py --dtype bf16``) beside the row the
    planner carries, and auto's choice, on the carried row, at each
    main-path op with bf16 features: the kernel at every one, or raise."""
    from benchmarks.torch_planner_fit import fit_cuda_row
    from repro_torch.core import parse_op, planner
    from repro_torch.data.synthetic import make_node_dataset

    tiny = make_node_dataset("tiny", device="cuda")[0]
    fit = fit_cuda_row(g, tiny, gen, emit=print, dtype=torch.bfloat16)
    bf = torch.bfloat16
    stats = planner.get_plan_cache(g).stats
    w = torch.rand(g.n_edges, 1, generator=gen).cuda()
    choices = {}
    for op, d in (("u_mul_e_add_v", 16), ("u_copy_mean_v", 602),
                  ("e_copy_add_v", 4), ("u_mul_e_add_v", 41),
                  ("u_copy_add_v", 16)):
        spec = parse_op(op)
        rows = g.n_edges if spec.lhs == "e" else g.n_src
        lhs = torch.randn(rows, d, generator=gen).cuda().to(bf)
        rhs = w if spec.rhs == "e" else None
        choices[f"{op} d={d}"] = {
            "auto": planner.plan_gspmm(g, spec, lhs, rhs).strategy,
            "predicted": {r: planner.estimate_cost(r, stats, d, "cuda", bf)
                          for r in ("kernel", "segment", "push", "ell")}}
    sig = (g.n_src, g.n_dst, g.n_edges)
    for op, d in PLANNER_RANK_SDDMM + [("e_sub_v_copy_e", 4),
                                       ("u_dot_v_copy_e", 16)]:
        spec = parse_op(op)
        kw = {t: torch.randn(g.n_edges if t == "e" else g.n_src, d,
                             generator=gen).cuda().to(bf)
              for t in (spec.lhs, spec.rhs)}
        choices[f"sddmm:{op} d={d}"] = {"auto": planner.plan_sddmm(
            sig, spec, d, lhs_data=kw[spec.lhs], rhs_data=kw[spec.rhs])}
    row = {"phase": "planner_fit_bf16", **{k: fit[k] for k in (
        "rate", "fixed", "ell_class", "unit_ms", "host_ms",
        "reddit_stats")}, "device_ms": fit["device_ms"], "work": fit["work"],
        "unit_device_ms": fit["unit_device_ms"],
        "carried": {"rate": planner._THROUGHPUT["cuda:bf16"],
                    "fixed": planner._FIXED["cuda"]},
        "auto_bf16": choices}
    emit(row)
    missed = {k: v for k, v in choices.items() if v["auto"] != "kernel"}
    if missed:
        raise AssertionError(f"auto does not take the kernel in bf16: "
                             f"{missed}")
    return row


# --------------------------------------------------------------------- #
# 18. partitioned training
# --------------------------------------------------------------------- #
def _part_data(ds) -> tuple:
    """(graph, feats, labels, train mask, n_classes) of a
    ``make_node_dataset`` tuple, the masks as numpy."""
    g, feats, labels, train_mask, _, n_classes = ds
    return g, feats, labels, train_mask, n_classes


def partition_kernels(g_pub, g_red, gen, rows: dict) -> None:
    """Phase 18 (a): the kernels on the ring's stage graphs at the
    partitioned steps' shapes (``PART_*`` below): on the busiest
    off-diagonal stage graph of each ``PART_KERNEL_SHARDS``-way partition
    and its reverse, B1 (the weighted sums of GCN and SAGE, forward and
    ∂x), on ``pubmed-like``'s also B3 ``add`` (GAT's logits), B4
    ``copy_rhs`` (∂el on the reverse, ∂er), B1's bf16 form, and B5 on the
    graph of every bucket (the bucket softmax); each held to its float64
    plain version, bit-identical over two calls, timed beside its bound,
    plain version and library call."""
    from repro_torch.core.partition import stage_plan
    from repro_torch.models.gnn.common import make_partitioned_bundle

    S = PART_KERNEL_SHARDS
    for name, g, b1 in (("pubmed", g_pub, PART_B1["pubmed"]),
                        ("reddit", g_red, PART_B1["reddit"])):
        t0 = time.perf_counter()
        pb = make_partitioned_bundle(g, S)
        plan = stage_plan(pb.pg)
        part = max((p for p in plan.stages if p.stage > 0),
                    key=lambda p: p.g.n_edges)
        rev, rev_canon = part.rev, part.rev_canon
        emit({"phase": "partition_plan", "graph": name, "shards": S,
              "stats": pb.pg.stats.__dict__,
              "stage_edges": {p.stage: p.g.n_edges for p in plan.stages},
              "checked_stage": part.stage,
              "build_s": time.perf_counter() - t0})
        wf = pb.gcn_w.reshape(-1)
        label = f"{name}_s{S}_stage{part.stage}"
        cases = ((label, part.g, part.canon, "stage"),
                 (label + "_rev", rev, rev_canon, "reverse"))
        for lab, gg, idx, which in cases:
            check_b1(gg, wf.index_select(0, idx).contiguous(), gen, lab,
                     rows["spmm_csr"], b1[which], fp64=True)
        if name != "pubmed":
            continue
        check_b3(part.g, gen, label, rows["sddmm_csr"], PART_B3, fp64=True)
        for lab, gg, idx, _ in cases:
            check_b4(gg, gen, lab, rows["binary_reduce_csr"], PART_B4,
                     sweep=False, fp64=True)
            check_bf16_kernels(gg, wf.index_select(0, idx).contiguous(),
                               gen, lab, rows["bf16"],
                               (PART_BF16_B1, (), ()))
        check_b5(plan.everything.g, gen, f"{name}_s{S}_all_buckets",
                 rows["edge_softmax_csr"], PART_B5, sweep=False, fp64=True)


def partition_step(app: str, ds) -> dict:
    """Phase 18 (b): one partitioned step of ``app`` on ``pubmed-like`` at
    ``PART_STEP_SHARDS`` shards: the logits and every parameter's grad on
    the kernel path within 1e-4·max|plain| + 1e-6 of the plain path
    (JAX's emulated ring), bit-identical over two calls, launching
    exactly ``partitioned_launches``; for GCN and SAGE also a delayed
    refresh step, a stale one (B1 on the local graph alone: no remote
    stage) and an int8 step, each against its plain path."""
    from repro_torch.core.partition import stage_plan
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.common import make_partitioned_bundle
    from repro_torch.substrate.nn import cross_entropy_loss

    g, feats, labels, train_mask, n_classes = _part_data(ds)
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    model = mod.init(torch.Generator().manual_seed(0), feats.shape[1],
                     PART_HIDDEN, n_classes, device="cuda")
    pb = make_partitioned_bundle(g, PART_STEP_SHARDS)
    pg = pb.pg
    xp, yp, mp = (pg.scatter_nodes(torch.from_numpy(a).cuda())
                  for a in (feats, labels.astype(np.int64), train_mask))
    plan = stage_plan(pg)
    stages = len(plan.stages)
    parts = (plan.local is not None) + (plan.remote is not None)
    params = list(model.parameters())

    def step(strategy, **kw):
        out = mod.forward_partitioned(model, pb, xp, strategy=strategy,
                                      **kw)
        grads = torch.autograd.grad(cross_entropy_loss(out[0], yp, mp),
                                    params)
        torch.cuda.synchronize()
        return [out[0].detach()] + list(grads)

    modes = {"exact": ({}, partitioned_launches(app, stages))}
    if app != "gat":
        halo = mod.init_halo(model, pg)
        comm = mod.init_comm(model, pg)
        modes.update({
            "delayed_refresh": ({"halo": halo, "refresh": True},
                                partitioned_launches(app, stages, parts)),
            "delayed_stale": ({"halo": halo, "refresh": False},
                              partitioned_launches(app, stages, 1)),
            "int8": ({"comm_state": comm},
                     partitioned_launches(app, stages, parts))})
    names = ["logits"] + [n for n, _ in model.named_parameters()]
    out = {}
    for mode, (kw, want) in modes.items():
        step("kernel", **kw)            # per-graph structures, Gᵀs too
        reset_counts()
        got = step("kernel", **kw)
        launched = read_counts()
        check_launches(f"{app} partitioned {mode} step", launched, want, 1)
        again = step("kernel", **kw)
        reset_counts()
        ref = step("plain", **kw)
        check_launches(f"{app} partitioned {mode} plain step",
                       read_counts(), {}, 1)
        per = {}
        for n, a, b, r in zip(names, got, again, ref):
            mx = float(r.abs().max())
            per[n] = {"max_abs_err": max_err(a, r),
                      "tol": 1e-4 * mx + 1e-6, "max_abs_plain": mx,
                      "bit_identical": torch.equal(a, b)}
        bad = {n: v for n, v in per.items()
               if not (v["bit_identical"] and v["max_abs_err"] <= v["tol"])}
        out[mode] = {"step_launches": launched, "checks": per}
        if bad:
            raise AssertionError(f"{app} partitioned {mode} step: {bad}")
    row = {"phase": "train_partitioned_step", "app": app,
           "dataset": PART_DATASET, "shards": PART_STEP_SHARDS,
           "hidden": PART_HIDDEN, "stages": stages, "parts": parts,
           "modes": out, "step_launches": out["exact"]["step_launches"]}
    emit(row)
    return row


def _train_run(app: str, ds, S: int, what: str, **kw) -> dict:
    """``train_partitioned`` of a fresh ``app`` model on ``ds`` at ``S``
    shards (``PART_EPOCHS`` epochs unless ``kw`` says, dropout 0, the
    kernel path) with its launches (counted from 0 just before), the
    partition's host build timed first, and the obs ring counters."""
    from repro_torch import obs
    from repro_torch.core.partition import stage_plan
    from repro_torch.models.gnn import gat, gcn, sage
    from repro_torch.models.gnn.common import make_partitioned_bundle
    from repro_torch.models.gnn.train import train_partitioned

    g, feats, labels, train_mask, n_classes = _part_data(ds)
    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    model = mod.init(torch.Generator().manual_seed(0), feats.shape[1],
                     PART_HIDDEN, n_classes, device="cuda")
    t0 = time.perf_counter()
    pg = make_partitioned_bundle(g, S).pg
    plan = stage_plan(pg)
    stages = len(plan.stages)
    build_s = time.perf_counter() - t0
    kw.setdefault("epochs", PART_EPOCHS)
    obs.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, hist = train_partitioned(mod.forward_partitioned, model, g, feats,
                                labels, train_mask, n_shards=S, drop=0.0,
                                seed=1, **kw)
    launches = read_counts()
    snap = obs.snapshot()
    ring = {k: snap.get(f"comm.ring.{k}", {}).get("value", 0)
            for k in ("raw_bytes", "wire_bytes", "pad_slots")}
    loss = hist["loss"]
    if not all(np.isfinite(loss)):
        raise AssertionError(f"{what}: loss {loss}")
    st = pg.stats
    return {"app": app, "shards": S, "stages": stages,
            "parts": (plan.local is not None) + (plan.remote is not None),
            "cut_fraction": st.cut_fraction, "eb": st.eb,
            "pad_ratio": st.pad_ratio,
            "ragged_pad_ratio": st.ragged_pad_ratio,
            "plan_build_s": build_s,
            "epoch_ms": [t * 1e3 for t in hist["epoch_time"]],
            "epoch_ms_median": statistics.median(hist["epoch_time"]) * 1e3,
            "loss": loss, "refreshed": hist["refreshed"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "ring_counters": ring, "launches": launches}


def partition_runs(ds) -> list:
    """Phase 18 (c): ``train_partitioned`` per app at every
    ``PART_SHARDS`` (exact; launches (epochs + 1 warm-up) × a step's, the
    loss falling), GCN with a delayed halo (``PART_HALO``: a stale epoch
    launches the local graph alone), GCN at ``PART_PREC_SHARDS`` in fp32
    / bf16 × none / int8 (raw / wire bytes ≥ ``PART_INT8_MIN_RATIO`` at
    fp32; bf16 × int8's final loss within ``PART_LOSS_BF16_TOL`` of
    fp32's)."""
    from repro_torch.optim import Precision

    rows = []
    for app in ("gcn", "sage", "gat"):
        for S in PART_SHARDS:
            r = _train_run(app, ds, S, f"{app} s{S}")
            check_launches(f"{app} partitioned s{S}", r["launches"],
                           partitioned_launches(app, r["stages"]),
                           PART_EPOCHS + 1)
            if not r["loss"][-1] < r["loss"][0]:
                raise AssertionError(f"{app} s{S}: loss {r['loss']}")
            rows.append({"phase": "train_partitioned", "mode": "exact",
                         "dataset": PART_DATASET, **r})
            emit(rows[-1])
    from repro_torch.models.gnn import gcn

    S, k, epochs = PART_HALO
    r = _train_run("gcn", ds, S, "gcn delayed", halo_staleness=k,
                   init_halo_fn=gcn.init_halo, epochs=epochs)
    n_ref = sum(r["refreshed"]) + 1     # the warm-up runs one of each
    n_stale = epochs - sum(r["refreshed"]) + 1
    want = {key: partitioned_launches("gcn", r["stages"], r["parts"]).get(
        key, 0) * n_ref + partitioned_launches("gcn", r["stages"], 1).get(
            key, 0) * n_stale for key in r["launches"]}
    check_launches("gcn delayed", r["launches"], want, 1)
    ep = r["epoch_ms"]
    r.update(halo_staleness=k, refresh_epoch_ms=[
        t for t, f in zip(ep, r["refreshed"]) if f], stale_epoch_ms=[
        t for t, f in zip(ep, r["refreshed"]) if not f])
    rows.append({"phase": "train_partitioned", "mode": "delayed",
                 "dataset": PART_DATASET, **r})
    emit(rows[-1])
    base = None
    S = PART_PREC_SHARDS
    for pname, comm in (("fp32", "none"), ("bf16", "none"),
                        ("fp32", "int8"), ("bf16", "int8")):
        prec = Precision.parse(pname, comm=comm)
        r = _train_run("gcn", ds, S, f"gcn {prec.tag()}", precision=prec,
                       init_comm_fn=gcn.init_comm if comm == "int8"
                       else None)
        check_launches(f"gcn {prec.tag()}", r["launches"],
                       partitioned_launches("gcn", r["stages"],
                                            r["parts"] if comm == "int8"
                                            else 0), PART_EPOCHS + 1)
        base = r["loss"][-1] if base is None else base
        rc = r["ring_counters"]
        r.update(precision=prec.tag(), loss_delta_vs_fp32=r["loss"][-1] - base,
                 raw_over_wire=rc["raw_bytes"] / max(rc["wire_bytes"], 1))
        rows.append({"phase": "train_partitioned", "mode": "precision",
                     "dataset": PART_DATASET, **r})
        emit(rows[-1])
        if comm == "int8" and pname == "fp32" and not (
                r["raw_over_wire"] >= PART_INT8_MIN_RATIO):
            raise AssertionError(f"int8 wire: {rc}")
        if comm == "int8" and pname == "bf16" and not (
                abs(r["loss_delta_vs_fp32"]) <= PART_LOSS_BF16_TOL):
            raise AssertionError(f"bf16 x int8 loss: {r['loss']}")
    return rows


def partition_powerlaw(gen) -> dict:
    """Phase 18 (d): the benchmark's power-law leg (R-MAT, ``hash`` at
    ``PART_POWERLAW``'s shards and width): the dense (S²·eb) and ragged
    slot and pad + wire bills, one ring pass's forward and backward
    (∂ of Σ out²) on the kernel path — bit-identical, launches exact —
    against the plain path and the single-graph segment route, timed."""
    from repro_torch.core import from_coo, gspmm, planner
    from repro_torch.core.partition import ring_gspmm, stage_plan
    from repro_torch.data.synthetic import rmat_graph

    n_log2, nnz, seed, S, F = PART_POWERLAW
    src, dst, n = rmat_graph(n_log2, nnz, seed=seed)
    g = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    pg = planner.get_plan_cache(g).partition(S, "hash")
    st = pg.stats
    stages = st.ragged_stages if st.ragged_stages >= 0 else S - 1
    wire_d = S * (S - 1) * pg.rows * F * 4
    wire_r = S * stages * pg.rows * F * 4
    pad_d = (S * S * st.eb - g.n_edges) * F * 4
    pad_r = (st.ragged_slots - g.n_edges) * F * 4
    x = torch.randn(n, F, generator=gen).cuda()
    w = pg.scatter_edges(torch.ones(g.n_edges, device=g.device))

    def run(strategy):
        xx = x.clone().requires_grad_()
        if strategy == "segment":
            out = gspmm(g, "u_copy_add_v", u=xx, strategy="segment")
        else:
            out = pg.gather_nodes(ring_gspmm(pg, pg.scatter_nodes(xx), w,
                                             strategy=strategy))
        (gx,) = torch.autograd.grad((out ** 2).sum(), xx)
        return torch.cat([out.detach(), gx], dim=1)

    run("kernel")
    reset_counts()
    got = bit_identical("powerlaw ring", lambda: run("kernel"))
    n_stages = len(stage_plan(pg).stages)
    launches = read_counts()
    check_launches("powerlaw ring", launches, {"spmm_csr": 2 * n_stages}, 2)
    plain, ref = run("plain"), run("segment")
    torch.cuda.synchronize()
    mx = float(ref.abs().max())
    row = {"phase": "partition_powerlaw", "n_log2": n_log2,
           "edges": g.n_edges, "shards": S, "F": F, "mode": "hash",
           "stages": n_stages, "dense_slots": S * S * st.eb,
           "ragged_slots": st.ragged_slots,
           "padwire_bytes_dense": pad_d + wire_d,
           "padwire_bytes_ragged": pad_r + wire_r,
           "max_abs_err_vs_plain": max_err(got, plain),
           "max_abs_err_vs_segment": max_err(got, ref),
           "max_abs_segment": mx,
           "fwd_bwd_kernel_ms": time_ms(lambda: run("kernel"), reps=10),
           "fwd_bwd_plain_ms": time_ms(lambda: run("plain"), reps=10),
           "fwd_bwd_segment_ms": time_ms(lambda: run("segment"), reps=10),
           "launches": launches}
    emit(row)
    tol = 1e-4 * mx + 1e-6
    if not (row["max_abs_err_vs_plain"] <= tol
            and row["max_abs_err_vs_segment"] <= tol):
        raise AssertionError(f"powerlaw ring: {row}")
    return row


def partition_heavy(app: str, dataset) -> dict:
    """Phase 18 (e): the heavy case, ``app`` on ``reddit-like`` at Fig.
    2's width (``PART_HEAVY``): ``train_partitioned`` epochs in turns
    kernel, plain, plain, kernel (launches exact), beside the
    single-device ``train_full_graph`` kernel epoch, with peak memory;
    one traced partitioned step (the ring's B1 share of its device time
    and of the step)."""
    from repro_torch.core.partition import stage_plan
    from repro_torch.models.gnn import gcn, sage
    from repro_torch.models.gnn.common import (make_bundle,
                                               make_partitioned_bundle)
    from repro_torch.models.gnn.train import (make_partitioned_train_step,
                                              train_full_graph,
                                              train_partitioned)

    name, S, hidden, epochs = PART_HEAVY
    g, feats, labels, train_mask, n_classes = _part_data(dataset)
    mod = {"gcn": gcn, "sage": sage}[app]
    model = mod.init(torch.Generator().manual_seed(0), feats.shape[1],
                     hidden, n_classes, device="cuda")
    pb = make_partitioned_bundle(g, S)
    stages = len(stage_plan(pb.pg).stages)
    want = partitioned_launches(app, stages)
    runs = epoch_runs(
        f"{app} partitioned {name}", model, lambda m, st: train_partitioned(
            mod.forward_partitioned, m, g, feats, labels, train_mask,
            n_shards=S, epochs=epochs, drop=0.0, strategy=st)[1],
        {"kernel": "kernel", "plain": "plain"},
        {k: want.get(k, 0) * (epochs + 1) for k in read_counts()})
    import copy
    single = copy.deepcopy(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, hist = train_full_graph(
        lambda *a, **kw: mod.forward(*a, **dict(kw, drop=0.0)), single,
        make_bundle(g), feats, labels, train_mask, epochs=epochs)
    single_row = {"epoch_ms_median": statistics.median(
        hist["epoch_time"]) * 1e3, "loss": hist["loss"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    pg = pb.pg
    xp, yp, mp = (pg.scatter_nodes(torch.from_numpy(a).cuda())
                  for a in (feats, labels.astype(np.int64), train_mask))
    opt_init, step = make_partitioned_train_step(mod.forward_partitioned)
    m = copy.deepcopy(model)
    state = opt_init(m)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one_step():
        float(step(m, state, 0, pb, xp, yp, mp, None, None, gen)[1])

    traced = trace_step(one_step, sum(want.values()))
    ring_us = sum(e["total_us"] for e in traced["port_kernels"])
    row = {"phase": "train_partitioned_heavy", "app": app, "dataset": name,
           "shards": S, "hidden": hidden, "epochs": epochs,
           "stages": stages, **runs, "single_device_kernel": single_row,
           "partitioned_over_single": runs["kernel"]["epoch_ms_median"]
           / single_row["epoch_ms_median"],
           "trace": traced, "ring_kernel_us": ring_us,
           "ring_share_of_device": ring_us / max(
               traced["device_us_total"], 1e-9),
           "ring_share_of_step": ring_us / max(traced["wall_us_profiled"],
                                               1e-9),
           "launches": runs["kernel"]["launches"]}
    emit(row)
    return row


# --------------------------------------------------------------------- #
# 20. the mesh ring: S ranks of a gloo group on one card
# --------------------------------------------------------------------- #
def mesh_kernels(g, gen, rows: dict) -> dict:
    """Phase 20's kernel rows (in this process): B1 on rank 0's busiest
    local stage graph of ``PART_HEAVY``'s partition of ``g`` (its row's
    bucket, rows × rows) at ``MESH_B1["stage"]`` and on the reverse of its
    busiest column bucket (∂x) at ``MESH_B1["reverse"]``, each held to its
    float64 plain version, timed beside its bound and library call."""
    from repro_torch.core.partition import RankPlan
    from repro_torch.models.gnn.common import make_partitioned_bundle

    S = PART_HEAVY[1]
    pb = make_partitioned_bundle(g, S)
    plan = RankPlan(pb.pg, 0)
    fwd = max((b for b in plan.fwd if b is not None), key=lambda b: b.k)
    bwd = max((b for b in plan.bwd if b is not None), key=lambda b: b.k)
    name = f"reddit_s{S}_rank0"
    for label, gg, w_row, idx, shapes in (
            (f"{name}_bucket{fwd.i}{fwd.j}", fwd.part.g, pb.gcn_w[0],
             fwd.part.canon, MESH_B1["stage"]),
            (f"{name}_bucket{bwd.i}{bwd.j}_rev", bwd.part.rev,
             pb.gcn_w[bwd.i], bwd.part.rev_canon, MESH_B1["reverse"])):
        check_b1(gg, w_row.reshape(-1).index_select(0, idx).contiguous(),
                 gen, label, rows, shapes, fp64=True)
    row = {"phase": "mesh_plan", "graph": "reddit-like", "shards": S,
           "rank": 0, "fwd_edges": [b and b.k for b in plan.fwd],
           "bwd_edges": [b and b.k for b in plan.bwd],
           "checked": [[fwd.i, fwd.j], [bwd.i, bwd.j]]}
    emit(row)
    return row


class _Exchange:
    """Times (host clock) and sizes what this rank's ring hops and
    all-reduces move, by wrapping ``core/transport``'s ``Hop`` and
    ``all_reduce_sum`` for the life of the process (a child of phase
    20): on ``gloo`` every tensor stages through host memory."""

    def __init__(self):
        from repro_torch.core import transport
        from repro_torch.models.gnn import train as gnn_train

        self.reset()
        init, wait, reduce = (transport.Hop.__init__, transport.Hop.wait,
                              transport.all_reduce_sum)
        ex = self

        def hop_init(hop, group, tensors, step, tag):
            t0 = time.perf_counter()
            init(hop, group, tensors, step, tag)
            ex.ms += (time.perf_counter() - t0) * 1e3
            ex.hops += 1
            ex.sent_bytes += sum(t.numel() * t.element_size()
                                 for t in tensors)

        def hop_wait(hop):
            t0 = time.perf_counter()
            out = wait(hop)
            ex.ms += (time.perf_counter() - t0) * 1e3
            return out

        def all_reduce(tensors, group):
            t0 = time.perf_counter()
            out = reduce(tensors, group)
            ex.reduce_ms += (time.perf_counter() - t0) * 1e3
            return out

        transport.Hop.__init__, transport.Hop.wait = hop_init, hop_wait
        gnn_train.all_reduce_sum = all_reduce

    def reset(self):
        self.ms = self.reduce_ms = 0.0
        self.hops = self.sent_bytes = 0

    def read(self) -> dict:
        return {"transport": "gloo via host, one card",
                "exchange_ms": self.ms, "hops": self.hops,
                "sent_bytes": self.sent_bytes,
                "allreduce_ms": self.reduce_ms}


def _mesh_tol(ref: torch.Tensor) -> float:
    return 1e-4 * float(ref.abs().max()) + 1e-6


def mesh_ops(ds, group, S: int, rank: int) -> dict:
    """Phase 20 (a) on one rank: the op cases on ``pubmed-like`` at ``S``
    shards — ``ring_gspmm`` (GCN's norm at d = 64, and a per-head weight
    against (4, 16) features), its int8 form, the delayed halo's refresh
    and stale steps, the partitioned attention (edge values, bucket
    softmax, per-head sum) — forward and every gradient on the kernel
    route, this rank's rows against the port's emulated ring on the card
    (kernel route), within 1e-4·max|ref| + 1e-6. Returns each case's
    max error."""
    from repro_torch.core import partition as tp
    from repro_torch.core.edge_softmax import fused_attention_partitioned
    from repro_torch.models.gnn.common import make_partitioned_bundle

    g = ds[0]
    pb = make_partitioned_bundle(g, S)
    pg = pb.pg
    gen = torch.Generator().manual_seed(20 + S)
    me = slice(rank * pg.rows, (rank + 1) * pg.rows)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    def run(fn, whole, mesh_args, n_diff):
        """``fn(*args[, mesh])`` and the grads of Σ out·ct w.r.t. its first
        ``n_diff`` args, whole (emulated) and on this rank (mesh); the
        largest error, each within its tolerance or raise."""
        outs, ct = {}, None
        for name, args, kw in (("emu", whole, {}),
                               ("mesh", mesh_args, {"mesh": group})):
            leaves = [a.clone().requires_grad_() if i < n_diff else a
                      for i, a in enumerate(args)]
            out = fn(*leaves, **kw)
            out = out if isinstance(out, tuple) else (out,)
            if ct is None:
                ct = rnd(*out[0].shape)
            grads = torch.autograd.grad(
                (out[0] * (ct if name == "emu" else ct[me])).sum(),
                leaves[:n_diff])
            outs[name] = [o.detach() for o in out] + list(grads)
        torch.cuda.synchronize()
        worst = 0.0
        for got, ref in zip(outs["mesh"], outs["emu"]):
            ref = ref[me] if ref.shape[0] == pg.n_pad else (
                ref[rank:rank + 1] if ref.shape[0] == S else ref)
            err = max_err(got, ref)
            if not err <= _mesh_tol(ref):
                raise AssertionError(f"mesh ring S={S} rank {rank}: off "
                                     f"by {err}")
            worst = max(worst, err)
        return worst

    x = rnd(pg.n_pad, 64)
    heads = rnd(pg.n_pad, 4, 16)
    alpha = pg.scatter_edges(torch.rand(g.n_edges, 4, generator=gen).cuda())
    el, er = rnd(pg.n_pad, 4), rnd(pg.n_pad, 4)
    res = rnd(pg.n_pad, 64) * 0.01
    stale = rnd(pg.n_pad, 64)
    w = pb.gcn_w
    row = slice(rank, rank + 1)
    errs = {
        "ring_gspmm": run(lambda a, b, **kw: tp.ring_gspmm(
            pg, a, b, strategy="kernel", **kw), (x, w), (x[me], w[row]), 2),
        "ring_gspmm_per_head": run(lambda a, b, **kw: tp.ring_gspmm(
            pg, a, b, strategy="kernel", **kw), (heads, alpha),
            (heads[me], alpha[row]), 2),
        "ring_gspmm_int8": run(lambda a, r, **kw: tp.ring_gspmm(
            pg, a, w[row] if kw else w, comm="int8", residual=r,
            strategy="kernel", **kw), (x, res), (x[me], res[me]), 1),
        "attention": run(lambda a, b, c, **kw: fused_attention_partitioned(
            pg, a, b, c, strategy="kernel", **kw), (el, er, heads),
            (el[me], er[me], heads[me]), 3)}
    for refresh in (True, False):
        errs[f"delayed_refresh={refresh}"] = run(
            lambda a, s, **kw: tp.ring_gspmm_delayed(
                pg, a, w[row] if kw else w, s, refresh, strategy="kernel",
                **kw), (x, stale), (x[me], stale[me]), 1)
    return errs


def _app_model(app: str, d_in: int, hidden: int, n_classes: int):
    from repro_torch.models.gnn import gat, gcn, sage

    mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
    return mod, mod.init(torch.Generator().manual_seed(0), d_in, hidden,
                         n_classes, device="cuda")


def _flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def mesh_train(ds, group, S: int, rank: int, ex: _Exchange) -> list:
    """Phase 20 (b) on one rank: ``train_partitioned`` of GCN / SAGE / GAT
    on ``pubmed-like`` at ``PART_HIDDEN``, ``MESH_EPOCHS`` epochs, dropout
    0, on the mesh ring, then the emulated ring on the card: per-epoch
    losses within 1e-4, the parameters bit-equal across the ranks, the
    run's launches (counted from 0 just before it) ``MESH_EPOCHS`` + 1
    (the warm-up) times this rank's step (``mesh_launches``)."""
    from repro_torch import obs
    from repro_torch.core.partition import rank_plan, stage_plan
    from repro_torch.core.transport import all_gather_rows
    from repro_torch.models.gnn.common import make_partitioned_bundle
    from repro_torch.models.gnn.train import train_partitioned

    g, feats, labels, train_mask, _, n_classes = ds
    pg = make_partitioned_bundle(g, S).pg
    plan = rank_plan(pg, group)
    n_fwd = sum(b is not None for b in plan.fwd)
    n_bwd = sum(b is not None for b in plan.bwd)
    stages = len(stage_plan(pg).stages)
    rows = []
    for app in ("gcn", "sage", "gat"):
        hists = {}
        for where in ("mesh", "emulated"):
            mod, model = _app_model(app, feats.shape[1], PART_HIDDEN,
                                    n_classes)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            obs.reset_metrics()
            ex.reset()
            reset_counts()
            _, hist = train_partitioned(
                mod.forward_partitioned, model, g, feats, labels,
                train_mask, n_shards=S, epochs=MESH_EPOCHS, drop=0.0, seed=1,
                mesh=group if where == "mesh" else None)
            launches = read_counts()
            snap = obs.snapshot()
            hists[where] = dict(
                hist, launches=launches, exchange=ex.read(),
                ring_counters={k: snap.get(f"comm.ring.{k}", {}).get(
                    "value", 0) for k in ("raw_bytes", "wire_bytes",
                                          "pad_slots")},
                peak=torch.cuda.max_memory_allocated())
            if where == "mesh":
                flat = _flat(model)
                every = all_gather_rows(flat[None], group)
                equal = all(torch.equal(every[0], r) for r in every)
        want = mesh_launches(app, n_fwd, n_bwd)
        mesh, emu = hists["mesh"], hists["emulated"]
        check_launches(f"{app} mesh s{S} rank {rank}", mesh["launches"],
                       want, MESH_EPOCHS + 1)
        dl = max(abs(a - b) for a, b in zip(mesh["loss"], emu["loss"]))
        row = {"app": app, "shards": S, "rank": rank,
               "n_fwd": n_fwd, "n_bwd": n_bwd, "stages": stages,
               "step_launches": want,
               "equal_to_emulated_step": want == partitioned_launches(
                   app, stages),
               "launches": mesh["launches"],
               "loss": mesh["loss"], "loss_emulated": emu["loss"],
               "loss_max_abs_diff": dl,
               "params_equal_across_ranks": equal,
               "epoch_ms_median": statistics.median(
                   mesh["epoch_time"]) * 1e3,
               "emulated_epoch_ms_median": statistics.median(
                   emu["epoch_time"]) * 1e3,
               "exchange": mesh["exchange"],
               "ring_counters": mesh["ring_counters"],
               "max_memory_allocated_bytes": mesh["peak"]}
        rows.append(row)
        if not (dl <= 1e-4 and equal and all(np.isfinite(mesh["loss"]))):
            raise AssertionError(f"mesh training: {row}")
    return rows


def mesh_heavy(ds, group, rank: int, ex: _Exchange) -> list:
    """Phase 20 (c) on one rank: GCN and SAGE on ``reddit-like`` at
    ``PART_HEAVY`` (S = 4, hidden 16, 5 epochs) on the mesh ring: epoch
    ms, this rank's exchange (ms, bytes; gloo through the host) and
    all-reduce ms, its peak memory, its launches; one step traced on rank
    0 (the port's kernels' device ms on that rank)."""
    from repro_torch.models.gnn.common import (make_partitioned_bundle,
                                               shard_partitioned)
    from repro_torch.models.gnn.train import (make_partitioned_train_step,
                                              train_partitioned)

    _, S, hidden, epochs = PART_HEAVY
    g, feats, labels, train_mask, _, n_classes = ds
    rows = []
    for app in ("gcn", "sage"):
        mod, model = _app_model(app, feats.shape[1], hidden, n_classes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ex.reset()
        reset_counts()
        _, hist = train_partitioned(mod.forward_partitioned, model, g, feats,
                                    labels, train_mask, n_shards=S,
                                    epochs=epochs, drop=0.0, mesh=group)
        launches = read_counts()
        xfer = ex.read()
        peak = torch.cuda.max_memory_allocated()
        pb = make_partitioned_bundle(g, S, mesh=group)
        whole = [pb.pg.scatter_nodes(torch.from_numpy(a).cuda())
                 for a in (feats, labels.astype(np.int64), train_mask)]
        _, xp, yp, mp = shard_partitioned(pb, *whole)
        opt_init, step = make_partitioned_train_step(mod.forward_partitioned)
        state = opt_init(model)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def one_step():
            float(step(model, state, 0, pb, xp, yp, mp, None, None, gen)[1])

        traced = None
        if rank == 0:
            traced = trace(one_step)
        else:
            one_step()
            one_step()
        ep = hist["epoch_time"]
        rows.append({
            "app": app, "shards": S, "hidden": hidden, "epochs": epochs,
            "rank": rank, "epoch_ms": [t * 1e3 for t in ep],
            "epoch_ms_median": statistics.median(ep) * 1e3,
            "loss": hist["loss"], "launches": launches, **xfer,
            "exchange_ms_per_epoch": xfer["exchange_ms"] / (epochs + 1),
            "max_memory_allocated_bytes": peak,
            "trace": traced and {k: traced[k] for k in (
                "device_us_total", "wall_us_profiled", "port_kernels",
                "port_launches", "device_busy_share_profiled")},
            "kernel_device_ms": traced and sum(
                e["total_us"] for e in traced["port_kernels"]) / 1e3})
        if not all(np.isfinite(hist["loss"])):
            raise AssertionError(f"mesh heavy {app}: {hist['loss']}")
    return rows


def _mesh_rank(rank: int, world: int, root: str) -> None:
    """One rank of phase 20 (a spawned child: it loads the kernels the
    parent built, and uses cuda:0 and ``gloo``): (a) and (b) at every
    ``MESH_SHARDS`` (a smaller S on a sub-group of the first ranks), (c)
    at ``PART_HEAVY``'s S; its rows pickled to ``root``."""
    import datetime
    import pickle

    import torch.distributed as dist
    from repro_torch.data.synthetic import make_node_dataset
    from repro_torch.launch.mesh import make_shard_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/pg", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        ex = _Exchange()
        out = {"ops": {}, "train": []}
        pub = make_node_dataset(PART_DATASET, device="cuda")
        for S in MESH_SHARDS:
            group = make_shard_mesh(S)
            if rank < S:
                out["ops"][S] = mesh_ops(pub, group, S, rank)
                out["train"] += mesh_train(pub, group, S, rank, ex)
            dist.barrier()
        del pub
        red = make_node_dataset(PART_HEAVY[0], device="cuda")
        out["heavy"] = mesh_heavy(red, make_shard_mesh(PART_HEAVY[1]), rank,
                                  ex)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_mesh_ranks(fn, args: tuple, what: str) -> None:
    """``fn(rank, *args)`` on ``MESH_RANKS`` processes (start method
    spawn: this process holds a CUDA context), joined under
    ``MESH_SPAWN_LIMIT_S``; a rank that fails fails the run."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=MESH_RANKS, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + MESH_SPAWN_LIMIT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{what} ranks still running after "
                               f"{MESH_SPAWN_LIMIT_S} s")


def mesh_phase(heavy_rows: list) -> list:
    """Phase 20 (a–c): ``MESH_RANKS`` ranks spawned (start method spawn:
    this process holds a CUDA context) on this card, joined under
    ``MESH_SPAWN_LIMIT_S``; a rank that fails fails the run. Emits the
    rows, with phase 18's emulated and single-device heavy epochs beside
    the mesh's; returns the training runs (their launches count on the
    main path)."""
    import pickle
    import tempfile

    root = tempfile.mkdtemp(prefix="mesh_ring_")
    try:
        spawn_mesh_ranks(_mesh_rank, (MESH_RANKS, root), "phase 20")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for S in MESH_SHARDS:
        errs = {r: ranks[r]["ops"][S] for r in range(S)}
        emit({"phase": "mesh_ops", "dataset": PART_DATASET, "shards": S,
              "route": "kernel", "reference": "emulated ring, kernel route",
              "max_abs_err": max(e for r in errs.values()
                                 for e in r.values()),
              "per_rank": errs})
    runs = []
    for row in (r for rk in ranks for r in rk["train"]):
        emit({"phase": "mesh_train", "dataset": PART_DATASET,
              "hidden": PART_HIDDEN, **row})
        runs.append(row)
    emulated = {r["app"]: r for r in heavy_rows}
    for app in ("gcn", "sage"):
        per_rank = [r for rk in ranks for r in rk["heavy"] if r["app"] == app]
        base = emulated[app]
        row = {"phase": "mesh_heavy", "app": app, "dataset": PART_HEAVY[0],
               "shards": PART_HEAVY[1], "hidden": PART_HEAVY[2],
               "epoch_ms_median": max(r["epoch_ms_median"] for r in per_rank),
               "emulated_epoch_ms_median":
                   base["kernel"]["epoch_ms_median"],
               "single_device_epoch_ms_median":
                   base["single_device_kernel"]["epoch_ms_median"],
               "kernel_device_ms_rank0": per_rank[0]["kernel_device_ms"],
               "per_rank": per_rank}
        emit(row)
        runs += per_rank
    return runs


# --------------------------------------------------------------------- #
# 19. the LM stack: the smoke configs card against CPU, a checkpoint
# resume on the card, llama3.2-3b at its full published width, the
# attention's backward residency
# --------------------------------------------------------------------- #
def lm_ratio(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """max|got - ref| over the tolerance 1e-4·max|ref| + 1e-6; raises
    when it is above 1."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}")
    tol = 1e-4 * float(ref.abs().max()) + 1e-6
    r = float((got - ref).abs().max()) / tol
    if not r <= 1.0:
        raise AssertionError(f"{what}: error {r:.3g} × its tolerance")
    return r


def lm_batch(cfg, B: int, S: int, device, seed: int = 0) -> dict:
    """The smoke tests' batch: tokens, plus frames (encdec) or 3-D
    positions (vlm), from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                       dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["positions"] = torch.arange(S, dtype=torch.int32).expand(
            3, B, S).contiguous()
    return {k: v.to(device) for k, v in batch.items()}


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts / sequences, dict keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def lm_serve_path(model, cfg, batch, S: int, device) -> list:
    """Prefill the first ``S`` tokens, then decode the next two (the
    batch's own, so both devices decode the same tokens): each step's
    logits and the cache's tensors after it."""
    from repro_torch.models.lm import model as lm

    B = batch["tokens"].shape[0]
    memory = positions = None
    if cfg.family == "encdec":
        with torch.no_grad():
            memory = lm.encode(model, batch["frames"])
    if cfg.family == "vlm":
        positions = batch["positions"][:, :, :S]
    cache = lm.init_cache(cfg, B, LM_SMOKE[2], torch.float32, device)
    logits, cache = lm.prefill(model, batch["tokens"][:, :S], cache,
                               positions=positions, memory=memory)
    out = [(logits, [t.clone() for t in tree_leaves(cache)])]
    for i in range(2):
        logits, cache = lm.decode_step(
            model, batch["tokens"][:, S + i], cache,
            torch.tensor(S + i, device=device))
        out.append((logits, [t.clone() for t in tree_leaves(cache)]))
    return out


def lm_smoke(arch: str) -> dict:
    """Phase 19 (a) for one smoke config: card against CPU on the same
    weights, the MoE routing, the SSM decode, a 5-step train run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm.moe import moe_route

    t0 = time.perf_counter()
    cfg = get_smoke_config(arch)
    B, S, MAX = LM_SMOKE
    models = {"cpu": lm.init_params(cfg, seed=0, max_seq=MAX, device="cpu")}
    models["cuda"] = copy.deepcopy(models["cpu"]).to("cuda")
    res = {}
    for dev, model in models.items():
        batch = lm_batch(cfg, B, S, dev)
        loss = lm.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        route = None
        if cfg.family == "moe":
            x = lm.embed_tokens(model, batch["tokens"]).reshape(B * S, -1)
            route = moe_route(model.blocks[0].moe, cfg, x)
        res[dev] = (loss, grads, lm_serve_path(model, cfg, batch, S // 2,
                                               dev), route)
    (lc, gcpu, sc, rc), (lg, gg, sg, rg) = res["cpu"], res["cuda"]
    ratios = {"loss": lm_ratio(lg, lc, f"{arch} loss"),
              "grads": max(lm_ratio(a, b, f"{arch} grad")
                           for a, b in zip(gg, gcpu)),
              "prefill_logits": lm_ratio(sg[0][0], sc[0][0], "prefill"),
              "decode_logits": max(lm_ratio(sg[i][0], sc[i][0], "decode")
                                   for i in (1, 2)),
              "caches": max(lm_ratio(a, b, f"{arch} cache")
                            for (_, ca), (_, cb) in zip(sg, sc)
                            for a, b in zip(ca, cb))}
    row = {"phase": "lm_smoke", "arch": arch, "family": cfg.family,
           "loss_cpu": lc.item(), "loss_cuda": lg.item(),
           "err_over_tol": ratios}
    if rc is not None:
        for f in ("gate_idx", "keep"):
            if not torch.equal(getattr(rg, f).cpu(), getattr(rc, f)):
                raise AssertionError(f"{arch}: MoE {f} differs card / CPU")
        row["moe"] = {"gate_idx_equal": True, "keep_equal": True,
                      "dropped": int((~rc.keep).sum()),
                      "choices": int(rc.keep.numel())}
    if cfg.family in ("ssm", "hybrid"):
        model = models["cuda"]
        toks = lm_batch(cfg, 1, 9, "cuda", seed=2)["tokens"]
        full, _ = lm.prefill(model, toks, lm.init_cache(
            cfg, 1, MAX, torch.float32, "cuda"))
        _, c2 = lm.prefill(model, toks[:, :8], lm.init_cache(
            cfg, 1, MAX, torch.float32, "cuda"))
        step, _ = lm.decode_step(model, toks[:, 8], c2,
                                 torch.tensor(8, device="cuda"))
        err = float(((step - full).abs() / (2e-3 + 2e-3 * full.abs())).max())
        if not err <= 1.0:
            raise AssertionError(f"{arch}: decode vs prefill {err:.3g} × "
                                 f"2e-3")
        row["ssm_decode_over_tol"] = err
    model = copy.deepcopy(models["cuda"])
    zeros = [torch.zeros(p.shape, device="cuda") for p in model.parameters()]
    state = TrainState(model, zeros, [z.clone() for z in zeros], 0)
    mb = 2 if arch == LM_MICROBATCH else 1
    step_fn = make_train_step(cfg, microbatch=mb)
    batch = lm_batch(cfg, B, S, "cuda", seed=1)
    losses = []
    for _ in range(LM_STEPS):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: train losses {losses}")
    row.update({"microbatch": mb, "train_losses": losses,
                "seconds": time.perf_counter() - t0})
    emit(row)
    return row


def lm_checkpoint(dtype: str) -> dict:
    """Phase 19 (b): the llama smoke train state in ``dtype`` saved from
    the card after two steps and restored onto it (every leaf bit-equal,
    params and moments on the card), then the third step after the
    restore bit-equal to the uninterrupted third step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import (init_state, load_state_tree,
                                          make_train_step, state_tree)
    from repro_torch.launch.train import synthetic_batch

    cfg = dataclasses.replace(get_smoke_config(LM_FULL), dtype=dtype)
    step_fn = make_train_step(cfg)
    batches = [synthetic_batch(cfg, i, 2, 16, device="cuda")
               for i in range(3)]
    state = init_state(cfg, seed=0, device="cuda")
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(LM_CKPT_DIR)
    saved = [t.clone() for t in tree_leaves(state_tree(state))]
    t0 = time.perf_counter()
    mgr.save(state_tree(state), 2)
    save_s = time.perf_counter() - t0
    state, _ = step_fn(state, batches[2])
    after = [t.clone() for t in tree_leaves(state_tree(state))]

    fresh = init_state(cfg, seed=1, device="cuda")
    t0 = time.perf_counter()
    tree, n = mgr.restore_latest(state_tree(fresh))
    restore_s = time.perf_counter() - t0
    leaves = tree_leaves(tree)
    if n != 2 or len(leaves) != len(saved):
        raise AssertionError(f"restored step {n}, {len(leaves)} leaves")
    card = next(fresh.params.parameters()).device
    for got, want in zip(leaves, saved):
        if got.dim() and got.device != card:
            raise AssertionError("a restored leaf is not on the card")
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError("a restored leaf differs from the saved")
    fresh = load_state_tree(fresh, tree)
    fresh, _ = step_fn(fresh, batches[2])
    for got, want in zip(tree_leaves(state_tree(fresh)), after):
        if not torch.equal(got, want):
            raise AssertionError("the step after the restore differs "
                                 "from the uninterrupted step")
    nbytes = sum(os.path.getsize(os.path.join(LM_CKPT_DIR, "step_2", f))
                 for f in os.listdir(os.path.join(LM_CKPT_DIR, "step_2")))
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    row = {"phase": "lm_checkpoint", "arch": cfg.name, "dtype": dtype,
           "leaves": len(saved), "bytes": nbytes,
           "bf16_leaves": sum(t.dtype == torch.bfloat16 for t in saved),
           "save_s": save_s, "restore_s": restore_s,
           "restored_bit_exact": True, "resumed_step_bit_exact": True}
    emit(row)
    return row


def lm_full() -> list:
    """Phase 19 (c): ``LM_FULL`` at its full published config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models.lm import model as lm

    cfg = get_config(LM_FULL)
    params, active = cfg.param_count(), cfg.active_param_count()
    # bf16 params and grads, fp32 AdamW moments, before activations
    reckoned = params * (2 + 2 + 8)
    free, total = torch.cuda.mem_get_info()
    if reckoned > 0.8 * free:
        raise AssertionError(f"{LM_FULL}: {reckoned / 1e9:.1f} GB reckoned "
                             f"against {free / 1e9:.1f} GB free")
    rows = []

    # a 2-layer fp32 copy at full width, card against CPU
    t0 = time.perf_counter()
    layers, B, S = LM_PARITY
    cfg2 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    cpu = lm.init_params(cfg2, seed=0, device="cpu")
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to("cuda"))):
        batch = lm_batch(cfg2, B, S, dev)
        with torch.no_grad():
            loss = lm.loss_fn(model, batch)
        logits, _ = lm.prefill(model, batch["tokens"], lm.init_cache(
            cfg2, B, S, torch.float32, dev))
        out[dev] = (loss, logits)
        del model
    del cpu
    rows.append({"phase": "lm_full_parity", "arch": cfg.name,
                 "n_layers": layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab, "batch": B, "seq": S,
                 "loss_cpu": float(out["cpu"][0]),
                 "loss_cuda": float(out["cuda"][0]),
                 "loss_over_tol": lm_ratio(out["cuda"][0], out["cpu"][0],
                                           "full-width loss"),
                 "logits_over_tol": lm_ratio(out["cuda"][1], out["cpu"][1],
                                             "full-width logits"),
                 "seconds": time.perf_counter() - t0})
    emit(rows[-1])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # training through the launcher: 1 warm-up step, then timed steps
    B, S, n = LM_TRAIN
    torch.cuda.reset_peak_memory_stats()
    res = train.main(["--arch", LM_FULL, "--steps", str(n), "--batch",
                      str(B), "--seq", str(S), "--fixed-batch",
                      "--log-every", "1", "--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{LM_FULL}: train losses {losses}")
    step_s = statistics.median(res["step_s"][1:])
    tflops = 6 * active * B * S / step_s / 1e12
    rows.append({"phase": "lm_full_train", "arch": cfg.name,
                 "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                 "params": params, "active_params": active,
                 "reckoned_gb": reckoned / 1e9, "free_gb": free / 1e9,
                 "reduced": [], "batch": B, "seq": S, "losses": losses,
                 "warmup_ms": res["step_s"][0] * 1e3,
                 "step_ms": [t * 1e3 for t in res["step_s"][1:]],
                 "step_ms_median": step_s * 1e3,
                 "tokens_per_s": B * S / step_s, "model_tflops": tflops,
                 "share_of_989": tflops * 1e12 / BF16_FLOPS_PER_S,
                 "peak_gb": peak / 1e9})
    emit(rows[-1])
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # serving through the launcher, twice: the same tokens
    B, S, gen = LM_SERVE
    torch.cuda.reset_peak_memory_stats()
    runs = [serve.main(["--arch", LM_FULL, "--batch", str(B),
                        "--prompt-len", str(S), "--gen", str(gen),
                        "--device", "cuda"]) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(runs[0]["tokens"], runs[1]["tokens"]):
        raise AssertionError(f"{LM_FULL}: two serve runs generated "
                             f"different tokens")
    pre_s = runs[1]["prefill_s"]
    rows.append({"phase": "lm_full_serve", "arch": cfg.name,
                 "n_layers": cfg.n_layers, "reduced": [], "batch": B,
                 "prompt": S, "decode_steps": gen - 1,
                 "prefill_ms": [r["prefill_s"] * 1e3 for r in runs],
                 "decode_ms_per_step": [r["decode_s"] * 1e3 / (gen - 1)
                                        for r in runs],
                 "prefill_tokens_per_s": B * S / pre_s,
                 "prefill_model_tflops": 2 * active * B * S / pre_s / 1e12,
                 "prefill_share_of_989": 2 * active * B * S / pre_s
                 / BF16_FLOPS_PER_S,
                 "decode_tokens_per_s": B * (gen - 1) / runs[1]["decode_s"],
                 "tokens_equal": True, "sample": runs[1]["tokens"][0, :8]
                 .tolist(), "peak_gb": peak / 1e9})
    emit(rows[-1])
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(lm_trace(cfg))
    return rows


def lm_trace(cfg) -> dict:
    """One train step (``LM_TRAIN``'s batch) and one decode step
    (``LM_SERVE``'s, after its prefill) of the full config under
    ``torch.profiler``: device time by operation and the busy share. A
    reading only."""
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.lm import model as lm

    B, S, _ = LM_TRAIN
    step_fn = make_train_step(cfg)
    batch = synthetic_batch(cfg, 0, B, S, device="cuda")
    box = [init_state(cfg, device="cuda")]

    def train_step():
        box[0], metrics = step_fn(box[0], batch)
        float(metrics["loss"])

    traced = {"train_step": trace(train_step)}
    del box
    gc.collect()
    torch.cuda.empty_cache()
    B, S, gen = LM_SERVE
    model = lm.init_params(cfg, max_seq=S + gen, device="cuda")
    cache = lm.init_cache(cfg, B, S + gen, lm.lm_dtype(cfg), "cuda")
    tokens = synthetic_batch(cfg, 0, B, S, device="cuda")["tokens"]
    logits, cache = lm.prefill(model, tokens, cache)
    tok, pos = logits.argmax(-1), torch.tensor(S, device="cuda")

    def decode():   # the same position each call: the same work
        lm.decode_step(model, tok, cache, pos)
        torch.cuda.synchronize()

    traced["decode_step"] = trace(decode)
    row = {"phase": "lm_full_trace", "arch": cfg.name, **{
        k: {f: v[f] for f in ("device_events", "device_us_total",
                              "wall_us_profiled",
                              "device_busy_share_profiled", "top",
                              "top_host")}
        for k, v in traced.items()}}
    emit(row)
    return row


def lm_attention_residency() -> dict:
    """Phase 19 (d)(i): what ``blockwise_attention`` keeps from its
    forward for its backward on the card (``memory_allocated`` after the
    forward less before it, the output excluded, after a no-grad call of
    the same shapes). Each KV block's body is
    checkpointed, so that is each block's running (acc, m, denom) and q's
    fp32 copy, held to ``nblk·B·H·S·(Dh + 2)·4 + B·H·S·Dh·4`` plus
    ``LM_ATTN_RESIDENCY_SLACK``, beside what keeping every block's scores
    and probabilities would take. The output and gradients of
    ``sum(out·w)`` are held to the same call on the CPU."""
    from repro_torch.models.lm.layers import blockwise_attention

    B, H, Dh, S, block = LM_ATTN_RESIDENCY
    nblk = -(-S // block)
    gen = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(B, S, H, Dh, generator=gen) for _ in range(4))
    out = {}
    for dev in ("cuda", "cpu"):
        qkv = [t.to(dev).requires_grad_() for t in (q, k, v)]
        wd = w.to(dev)
        if dev == "cuda":
            # a no-grad call first: the first matmul allocates cuBLAS's
            # workspace (32 MiB), which lives as long as the process
            with torch.no_grad():
                blockwise_attention(*qkv, causal=True, block=block)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
        o = blockwise_attention(*qkv, causal=True, block=block)
        if dev == "cuda":
            torch.cuda.synchronize()
            held = (torch.cuda.memory_allocated() - base
                    - o.numel() * o.element_size())
        (o * wd).sum().backward()
        out[dev] = [o.detach()] + [t.grad for t in qkv]
        del qkv, wd, o
    bound = (nblk * B * H * S * (Dh + 2) * 4 + B * H * S * Dh * 4
             + LM_ATTN_RESIDENCY_SLACK)
    scores = 2 * nblk * B * H * S * block * 4
    row = {"phase": "lm_attention_residency", "card": _card(),
           "batch": B, "heads": H, "head_dim": Dh, "seq": S,
           "kv_block": block, "held_bytes": held, "bound_bytes": bound,
           "every_block_scores_bytes": scores,
           "over_tol": [lm_ratio(g, c, f"attention {n}") for n, g, c in zip(
               ("out", "dq", "dk", "dv"), out["cuda"], out["cpu"])]}
    emit(row)
    if not held <= bound:
        raise AssertionError(f"blockwise_attention held {held / 1e9:.3f} GB "
                             f"for its backward, bound {bound / 1e9:.3f}")
    return row


def _residency_row(what: str, cfg, reduced: list, res: dict, peak: int
                   ) -> dict:
    losses, step_s = res["losses"], res["step_s"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: train losses {losses}")
    row = {"phase": what, "card": _card(), "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "reduced": reduced, "batch": LM_RESIDENCY_TRAIN[0],
           "seq": LM_RESIDENCY_TRAIN[1], "losses": losses,
           "reckoned_state_gb": cfg.param_count() * (2 + 2 + 8) / 1e9,
           "warmup_ms": step_s[0] * 1e3,
           "step_ms": [t * 1e3 for t in step_s[1:]],
           "step_ms_median": statistics.median(step_s[1:]) * 1e3,
           "peak_gb": peak / 1e9}
    emit(row)
    return row


def lm_residency_train() -> list:
    """Phase 19 (d)(ii)-(iii): a long-sequence train step's peak, step
    time and reckoned state (bf16 params and grads, fp32 moments) for
    ``LM_FULL`` at its published config, through ``train.main``, and
    for ``LM_RESIDENCY_HYBRID`` at its published width cut in depth (two
    applications of its shared attention block, which runs outside the
    block remat)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.steps import init_state, make_train_step

    B, S, n = LM_RESIDENCY_TRAIN
    rows = []
    torch.cuda.reset_peak_memory_stats()
    res = train.main(["--arch", LM_FULL, "--steps", str(n), "--batch",
                      str(B), "--seq", str(S), "--fixed-batch",
                      "--log-every", "1", "--device", "cuda"])
    rows.append(_residency_row("lm_residency_train", get_config(LM_FULL), [],
                               res, torch.cuda.max_memory_allocated()))
    del res
    gc.collect()
    torch.cuda.empty_cache()

    arch, layers = LM_RESIDENCY_HYBRID
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg)
    state = init_state(cfg, device="cuda")
    batch = train.synthetic_batch(cfg, 0, B, S, device="cuda")
    res = {"losses": [], "step_s": []}
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["losses"].append(float(metrics["loss"]))
    rows.append(_residency_row(
        "lm_residency_train", cfg,
        [f"n_layers {full.n_layers} -> {layers}"], res,
        torch.cuda.max_memory_allocated()))
    del state, batch, res
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def lm_phase() -> None:
    """Phase 19: (a) every smoke config, (b) the checkpoint resume,
    (c) the full-width config, (d) attention's backward residency."""
    from repro_torch.configs import ARCHS

    t0 = time.perf_counter()
    for arch in ARCHS:
        lm_smoke(arch)
    torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        lm_checkpoint(dtype)
    gc.collect()
    torch.cuda.empty_cache()
    lm_full()
    gc.collect()
    torch.cuda.empty_cache()
    lm_attention_residency()
    gc.collect()
    torch.cuda.empty_cache()
    lm_residency_train()
    emit({"phase": "lm_done", "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------------- #
# 21. the LM mesh: one LM over MESH_RANKS gloo ranks on this card
# --------------------------------------------------------------------- #
class _LMExchange:
    """Times (host clock) and sizes this rank's collectives for the life of
    the process (a child of phase 21 or 22), in four parts: the per-block
    parameter gathers (``launch.fsdp``'s ``gather_shards``: bytes
    received), their gradients' reduce-scatters (``launch.fsdp``'s
    ``reduce_scatter_cat``: float32 operand bytes), the step's other
    reductions (``launch.steps``' ``all_reduce_sum``: the gradients of
    leaves replicated over a batch axis, the loss, the norm), and the
    activations of the model axis's split (every other
    ``torch.distributed`` collective: ms inside the call, which excludes
    the host staging, and operand bytes by JAX's convention). Also the
    gathers' count and the peak of gathered bytes alive at once
    (``fsdp.stats``), and the bytes of every leaf as the call's plan
    gathers it (``steps.gather_plan``'s shapes: what a working copy of
    the whole model would hold). On ``gloo`` every byte stages through
    host memory."""

    def __init__(self):
        import torch.distributed as dist

        from repro_torch.launch import fsdp, steps

        self.fsdp = fsdp
        self.reset()
        self.inside = False
        self.copy_bytes = 0
        gather, scatter = fsdp.gather_shards, fsdp.reduce_scatter_cat
        reduce, plan = steps.all_reduce_sum, steps.gather_plan
        ex = self

        def gather_shards(locals_, placements, mesh, over):
            t0 = time.perf_counter()
            ex.inside = True
            try:
                out = gather(locals_, placements, mesh, over)
            finally:
                ex.inside = False
            ex.gather_ms += (time.perf_counter() - t0) * 1e3
            ex.gather_bytes += sum(o.numel() * o.element_size() for o in out)
            ex.gather_bytes -= sum(t.numel() * t.element_size()
                                   for t in locals_)
            return out

        def reduce_scatter_cat(tensors, group, dims):
            t0 = time.perf_counter()
            ex.inside = True
            try:
                out = scatter(tensors, group, dims)
            finally:
                ex.inside = False
            ex.scatter_ms += (time.perf_counter() - t0) * 1e3
            ex.scatter_bytes += sum(t.numel() * t.element_size()
                                    for t in tensors)
            return out

        def all_reduce_sum(tensors, group, dtype=None):
            t0 = time.perf_counter()
            ex.inside = True
            try:
                out = reduce(tensors, group, dtype=dtype)
            finally:
                ex.inside = False
            ex.reduce_ms += (time.perf_counter() - t0) * 1e3
            ex.reduce_bytes += sum(t.numel() for t in tensors) * (
                dtype or tensors[0].dtype).itemsize
            return out

        def gather_plan(sharded, split=None):
            got = plan(sharded, split)
            dtypes = {n: p.dtype for n, p in sharded.named_parameters()}
            ex.copy_bytes = sum(int(np.prod(s)) * dtypes[n].itemsize
                                for n, s in got.shapes.items())
            return got

        def activation(fn, operand: int):
            def call(*args, **kwargs):
                if ex.inside:
                    return fn(*args, **kwargs)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                ex.act_ms += (time.perf_counter() - t0) * 1e3
                t = args[operand]
                ex.act_bytes += t.numel() * t.element_size()
                ex.act_calls += 1
                return out
            return call

        dist.all_gather = activation(dist.all_gather, 1)
        dist.reduce_scatter_tensor = activation(dist.reduce_scatter_tensor, 1)
        dist.all_reduce = activation(dist.all_reduce, 0)
        fsdp.gather_shards = gather_shards
        fsdp.reduce_scatter_cat = reduce_scatter_cat
        steps.all_reduce_sum = all_reduce_sum
        steps.gather_plan = gather_plan

    def reset(self):
        self.gather_ms = self.scatter_ms = self.reduce_ms = self.act_ms = 0.0
        self.gather_bytes = self.scatter_bytes = self.reduce_bytes = 0
        self.act_bytes = self.act_calls = 0
        self.fsdp.reset_stats()

    def read(self) -> dict:
        st = self.fsdp.stats()
        return {"gather_ms": self.gather_ms,
                "gather_bytes_received": self.gather_bytes,
                "gathers": st["gathers"],
                "gathered_bytes_live_peak": st["peak_live_bytes"],
                "working_copy_bytes_from_shapes": self.copy_bytes,
                "reduce_scatter_ms": self.scatter_ms,
                "reduce_scatter_bytes": self.scatter_bytes,
                "allreduce_ms": self.reduce_ms,
                "allreduce_bytes": self.reduce_bytes,
                "activation_ms": self.act_ms,
                "activation_bytes": self.act_bytes,
                "activation_calls": self.act_calls}


def _lm_mesh_steps(cfg, state, step_fn, mesh, batches) -> tuple:
    """``step_fn`` over ``batches`` under ``mesh`` (a ``MeshShape`` or a
    process mesh); the state and the losses."""
    from repro_torch.pjit_utils import ambient_mesh

    losses = []
    with ambient_mesh(mesh):
        for b in batches:
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
    return state, losses


def _lm_mesh_batches(cfg, n: int, B: int, S: int) -> list:
    from repro_torch.launch.train import synthetic_batch

    return [synthetic_batch(cfg, i, B, S, device="cuda") for i in range(n)]


def _lm_mesh_chunks(state, mesh) -> list:
    """Per sharded leaf of the state: (this rank's coordinates on the mesh
    dims that shard it, a digest of its local bits)."""
    import hashlib

    from repro_torch.launch.steps import state_tree

    coord = mesh.get_coordinate()
    out = []
    for leaf in tree_leaves(state_tree(state)):
        if hasattr(leaf, "placements"):
            local = leaf.to_local().detach().contiguous().cpu()
            out.append((tuple(c for c, p in zip(coord, leaf.placements)
                              if p.is_shard()),
                        hashlib.sha1(local.reshape(-1).view(torch.uint8)
                                     .numpy().tobytes()).hexdigest()))
    return out


def _lm_mesh_full_run(cfg, state, step_fn, mesh, ex) -> dict:
    """``LM_MESH_FULL``'s warm-up and timed steps on a fixed batch: the
    losses, host-clock step ms (each ending in the loss read), the
    exchange per step and peak memory; on a process mesh, then one more
    step under ``op_analysis`` (its counts: the rank's FLOPs, collective
    bytes by kind, the largest collective sites)."""
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.pjit_utils import ambient_mesh

    _, B, S, warm, timed = LM_MESH_FULL
    batch = synthetic_batch(cfg, 0, B, S, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, exchange = [], [], []
    with ambient_mesh(mesh):
        for _ in range(warm + timed):
            if ex is not None:
                ex.reset()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if ex is not None:
                exchange.append(ex.read())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts = None
        if ex is not None:
            with OpAnalysis() as oa:
                oa.name(dict(state.params.named_parameters()))
                state, m = step_fn(state, batch)
                float(m["loss"])
            counts = _count_row(oa)
    return {"losses": losses, "warmup_ms": step_ms[:warm],
            "step_ms": step_ms[warm:],
            "step_ms_median": statistics.median(step_ms[warm:]),
            "exchange_per_step": exchange[warm:], "peak_gb": peak_gb,
            "counts": counts}


def _count_row(oa) -> dict:
    """An ``op_analysis`` count's FLOPs, collectives, largest sites and
    the split's activation collectives by site, kind and dtype."""
    got = oa.analyze()
    return {"flops_hlo": got["flops_hlo"],
            "collective_bytes": got["collective_bytes"],
            "collective_counts": got["collective_counts"],
            "host_copy_bytes": got["host_copy_bytes"],
            "top_collectives": oa.top_collectives(6),
            "activation_collectives": _activation_collectives(oa)}


def _activation_collectives(oa) -> list:
    """The split's activation collectives ``oa`` counted (every site but
    ``LM_NOT_ACTIVATION_SITES``), summed by (site, kind, dtype): count,
    bytes, the largest operand; largest first."""
    rows = {}
    for r in oa.top_collectives(None):
        site = r["site"] or LM_BACKWARD_SITE
        if site in LM_NOT_ACTIVATION_SITES:
            continue
        row = rows.setdefault((site, r["kind"], r["dtype"]), {
            "site": site, "kind": r["kind"], "dtype": r["dtype"],
            "count": 0, "bytes": 0, "bytes_each_max": 0})
        row["count"] += r["count"]
        row["bytes"] += r["bytes_total"]
        row["bytes_each_max"] = max(row["bytes_each_max"], r["bytes_each"])
    return sorted(rows.values(), key=lambda r: -r["bytes"])


def _check_activation_collectives(cfg, what: str, rows: list) -> dict:
    """Hold a split row's activation collectives (``rows``: one rank's
    :func:`_activation_collectives`) to the split's design: no train or
    prefill collective at ``mamba2_split``; every reduction in the model's
    dtype but at ``LM_FP32_SITES`` (float32 all-reduces) and the float32
    leaves' gradients. Returns the bytes by dtype."""
    from repro_torch.models.lm import model as lm

    dtype = str(lm.lm_dtype(cfg)).replace("torch.", "")
    fp32_leaf = max(p.numel() * 4 for p in lm.LM(
        dataclasses.replace(cfg, n_layers=1), device="meta",
        init=False).parameters() if p.dtype == torch.float32)
    by_dtype = {}
    for r in rows:
        by_dtype[r["dtype"]] = by_dtype.get(r["dtype"], 0) + r["bytes"]
        if what != "decode" and r["site"] == LM_MAMBA2_SPLIT_SITE:
            raise AssertionError(f"{cfg.name} {what}: a collective at "
                                 f"mamba2_split: {r}")
        if r["kind"] == "all-gather" or r["dtype"] == dtype:
            continue
        if not (r["dtype"] == "float32" and r["kind"] == "all-reduce" and (
                r["site"] in LM_FP32_SITES or (
                    r["site"] in LM_FP32_GRAD_SITES
                    and r["bytes_each_max"] <= fp32_leaf))):
            raise AssertionError(f"{cfg.name} {what}: a {r['dtype']} "
                                 f"reduction in a {dtype} model: {r}")
    return by_dtype


def _lm_mesh_grads(cfg, state, mesh, batch) -> list:
    """The mesh step's gradients of ``batch`` (before the clip), each
    whole, in ``parameters()`` order: the rank's shards' (each summed over
    'data', ÷ its size), gathered."""
    from repro_torch.launch import steps
    from repro_torch.models.lm.tp import make_split
    from repro_torch.pjit_utils import ambient_mesh, full_tensors, to_dtensor

    with ambient_mesh(mesh):
        rows = steps._rank_rows(cfg, mesh, batch)
        split = make_split(cfg, mesh, steps._seq_len(rows))
        _, grads = steps._shard_grads(cfg, state.params, mesh, [rows], split)
    return [g.cpu() for g in full_tensors([
        to_dtensor(g, mesh, p.placements, p.shape)
        for g, p in zip(grads, state.params.parameters())])]


def _lm_one_rank_grads(cfg, state, batch) -> list:
    """One rank's gradients of ``batch`` under ``MeshShape(LM_MESH)``."""
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape, ambient_mesh

    params = list(state.params.parameters())
    with ambient_mesh(MeshShape(LM_MESH)):
        loss = lm.loss_fn(state.params, batch)
        return [g.cpu() for g in torch.autograd.grad(loss, params)]


def _lm_mesh_main(rank: int, root: str, ex: _LMExchange) -> dict:
    """Phase 21 (a), (b)'s save and (c) on one rank of the (2, 2) mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (init_state, make_train_step,
                                          state_bytes, state_tree)
    from repro_torch.pjit_utils import full_tensors

    mesh = make_mesh(LM_MESH, ("data", "model"), device="cuda")
    B, S, n = LM_MESH_BATCH
    out = {"rank": rank, "parity": {}}
    for arch in LM_MESH_ARCHS:
        cfg = get_smoke_config(arch)
        grads = _lm_mesh_grads(cfg, init_state(
            cfg, seed=0, max_seq=S, device="cuda", mesh=mesh), mesh,
            _lm_mesh_batches(cfg, 1, B, S)[0])
        state, losses = _lm_mesh_steps(
            cfg, init_state(cfg, seed=0, max_seq=S, device="cuda",
                            mesh=mesh),
            make_train_step(cfg, mesh=mesh), mesh,
            _lm_mesh_batches(cfg, n, B, S))
        gathered = [full_tensors([v])[0].cpu()
                    for v in tree_leaves(state_tree(state).params)]
        out["parity"][arch] = {"losses": losses,
                               "chunks": _lm_mesh_chunks(state, mesh),
                               "params": gathered if rank == 0 else None,
                               "grads": grads if rank == 0 else None}
    cfg = get_smoke_config(LM_FULL)
    state, losses = _lm_mesh_steps(
        cfg, init_state(cfg, seed=0, device="cuda", mesh=mesh),
        make_train_step(cfg, mesh=mesh), mesh,
        _lm_mesh_batches(cfg, 2, B, S))
    CheckpointManager(os.path.join(root, "ckpt")).save(state_tree(state), 2)
    out["elastic_saved_losses"] = losses
    del state
    gc.collect()
    torch.cuda.empty_cache()
    layers = LM_MESH_FULL[0]
    cfg = dataclasses.replace(get_config(LM_FULL), n_layers=layers)
    state = init_state(cfg, seed=0, device="cuda", mesh=mesh)
    out["full_state_bytes"] = state_bytes(state)
    out["full"] = _lm_mesh_full_run(cfg, state, make_train_step(
        cfg, mesh=mesh), mesh, ex)
    out["more"] = {}
    for arch, layers in LM_MESH_FULL_MORE:
        del state
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        state = init_state(cfg, seed=0, device="cuda", mesh=mesh)
        out["more"][arch] = {"state_bytes": state_bytes(state),
                             **_lm_mesh_full_run(cfg, state, make_train_step(
                                 cfg, mesh=mesh), mesh, ex)}
    return out


def _lm_mesh_restore(rank: int, root: str) -> dict:
    """Phase 21 (b): the (2, 2) checkpoint restored onto (4, 1), step 3."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (eval_param_shapes, init_state,
                                          load_state_tree, make_train_step,
                                          state_placements, state_tree)
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.pjit_utils import axis_sizes

    mesh = make_mesh(LM_MESH_ELASTIC[1], ("data", "model"), device="cuda")
    cfg = get_smoke_config(LM_FULL)
    B, S, _ = LM_MESH_BATCH
    state = init_state(cfg, seed=1, device="cuda", mesh=mesh)
    tree, n = CheckpointManager(os.path.join(root, "ckpt")).restore_latest(
        state_tree(state), mesh=mesh, shardings=state_placements(
            eval_param_shapes(cfg), cfg, mesh))
    state = load_state_tree(state, tree)
    wq = tree.params["blocks"]["attn"]["wq"]
    _, losses = _lm_mesh_steps(cfg, state, make_train_step(cfg, mesh=mesh),
                               mesh, [synthetic_batch(cfg, 2, B, S,
                                                      device="cuda")])
    return {"rank": rank, "step": n, "state_step": state.step,
            "data": axis_sizes(wq.device_mesh)["data"], "loss": losses[0]}


def _lm_mesh_rank(rank: int, world: int, root: str, job: str) -> None:
    """One rank of phase 21 (a spawned child on cuda:0 over ``gloo``):
    ``job`` "main" or "restore"; its result pickled to ``root``."""
    import datetime
    import pickle

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/pg_{job}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        out = (_lm_mesh_main(rank, root, _LMExchange()) if job == "main"
               else _lm_mesh_restore(rank, root))
        with open(os.path.join(root, f"{job}{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn_lm_mesh(root: str, job: str) -> list:
    """``MESH_RANKS`` ranks of ``job``; their results, in rank order."""
    import pickle

    spawn_mesh_ranks(_lm_mesh_rank, (MESH_RANKS, root, job),
                     f"phase 21 ({job})")
    out = []
    for r in range(MESH_RANKS):
        with open(os.path.join(root, f"{job}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def lm_mesh_phase() -> tuple:
    """Phase 21 (a–c): the one-rank references here, then the two spawns
    on this card; every check raises. Returns the one-rank step's median
    ms (phase 22's roofline reads it)."""
    import tempfile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.steps import (init_state, make_train_step,
                                          state_bytes, state_tree)
    from repro_torch.pjit_utils import MeshShape

    t0 = time.perf_counter()
    shape = MeshShape(LM_MESH)
    B, S, n = LM_MESH_BATCH
    refs = {}
    for arch in LM_MESH_ARCHS:
        cfg = get_smoke_config(arch)
        state = init_state(cfg, seed=0, max_seq=S, device="cuda")
        grads = _lm_one_rank_grads(cfg, state,
                                   _lm_mesh_batches(cfg, 1, B, S)[0])
        state, losses = _lm_mesh_steps(
            cfg, state, make_train_step(cfg), shape,
            _lm_mesh_batches(cfg, n, B, S))
        refs[arch] = (losses, [v.cpu() for v in
                               tree_leaves(state_tree(state).params)],
                      grads)
    cfg = get_smoke_config(LM_FULL)
    _, elastic_ref = _lm_mesh_steps(
        cfg, init_state(cfg, seed=0, device="cuda"), make_train_step(cfg),
        shape, _lm_mesh_batches(cfg, 3, B, S))
    layers = LM_MESH_FULL[0]
    cfg = dataclasses.replace(get_config(LM_FULL), n_layers=layers)
    state = init_state(cfg, seed=0, device="cuda")
    one_bytes = state_bytes(state)
    work_bytes = sum(p.numel() * p.element_size()
                     for p in state.params.parameters())
    one = _lm_mesh_full_run(cfg, state, make_train_step(cfg), None, None)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    specs_bytes = _specs_state_bytes(cfg)
    # the other full-width rows' one-rank references, under the mesh's
    # semantics (the MoE's token blocks)
    more = {}
    for arch, n_layers in LM_MESH_FULL_MORE:
        c = dataclasses.replace(get_config(arch), n_layers=n_layers)
        state = init_state(c, seed=0, device="cuda")
        more[arch] = {"one_rank": _lm_mesh_full_run(
            c, state, make_train_step(c), shape, None),
            "one_rank_state_bytes": state_bytes(state),
            "specs_state_bytes_per_rank": _specs_state_bytes(c)}
        del state
        gc.collect()
        torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="lm_mesh_")
    try:
        ranks = _spawn_lm_mesh(root, "main")
        restored = _spawn_lm_mesh(root, "restore")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (a) each rank's losses and rank 0's params against the one rank
    moved = 1e-2 * 3e-4 * n          # 1% of lr (the default) × the steps
    for arch, (want, params, grads) in refs.items():
        errs = [_rel(a, b) for r in ranks
                for a, b in zip(r["parity"][arch]["losses"], want)]
        if not max(errs) <= LM_MESH_TOL:
            raise AssertionError(f"{arch}: mesh losses off by {max(errs)}")
        g_ratio = 0.0
        for got, ref in zip(ranks[0]["parity"][arch]["grads"], grads):
            tol = 1e-4 * float(ref.float().abs().max()) + 1e-6
            g_ratio = max(g_ratio, float((got.float() - ref.float()).abs()
                                         .max()) / tol)
        if not g_ratio <= 1.0:
            raise AssertionError(f"{arch}: mesh grads {g_ratio:.3g} × tol")
        ratio = None
        if arch in LM_MESH_PARAMS_ARCHS:
            ratio = 0.0
            for got, ref in zip(ranks[0]["parity"][arch]["params"], params):
                tol = 1e-4 * float(ref.float().abs().max()) + 1e-6 + moved
                ratio = max(ratio, float((got.float() - ref.float()).abs()
                                         .max()) / tol)
            if not ratio <= 1.0:
                raise AssertionError(f"{arch}: mesh params {ratio:.3g} × "
                                     f"tol")
        chunks = [r["parity"][arch]["chunks"] for r in ranks]
        for i in range(len(chunks[0])):
            seen = {}
            for c in chunks:
                key, digest = c[i]
                if seen.setdefault(key, digest) != digest:
                    raise AssertionError(f"{arch}: ranks holding chunk {key} "
                                         f"of state leaf {i} differ")
        emit({"phase": "lm_mesh_parity", "arch": arch, "mesh": list(LM_MESH),
              "ranks": MESH_RANKS, "batch": B, "seq": S,
              "reference": "one rank, ambient MeshShape((2, 2))",
              "losses_one_rank": want,
              "losses_rank0": ranks[0]["parity"][arch]["losses"],
              "loss_rel_err_max": max(errs), "grads_err_over_tol": g_ratio,
              "params_err_over_tol": ratio,
              "same_chunk_bits_equal": True})

    # (b) the restore onto (4, 1) and its step 3
    want = elastic_ref[2]
    for r in restored:
        if (r["step"], r["state_step"], r["data"]) != (2, 2, 4):
            raise AssertionError(f"restore: {r}")
        if not _rel(r["loss"], want) <= LM_MESH_TOL:
            raise AssertionError(f"restored step 3 loss {r['loss']} against "
                                 f"{want}")
    emit({"phase": "lm_mesh_elastic", "arch": LM_FULL, "smoke": True,
          "saved_on": list(LM_MESH_ELASTIC[0]),
          "restored_on": list(LM_MESH_ELASTIC[1]), "data": 4,
          "loss_step3": [r["loss"] for r in restored],
          "uninterrupted_loss_step3": want,
          "rel_err_max": max(_rel(r["loss"], want) for r in restored)})

    # (c) the full width on (2, 2) against one rank
    errs = [_rel(a, b) for r in ranks
            for a, b in zip(r["full"]["losses"], one["losses"])]
    for r in ranks:
        losses = r["full"]["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"full width, rank {r['rank']}: {losses}")
        if r["full_state_bytes"] != specs_bytes:
            raise AssertionError(f"rank {r['rank']} holds "
                                 f"{r['full_state_bytes']} state bytes, the "
                                 f"specs {specs_bytes}")
    if not max(errs) <= LM_MESH_FULL_TOL:
        raise AssertionError(f"full-width mesh losses off by {max(errs)}")
    full = get_config(LM_FULL)
    emit({"phase": "lm_mesh_full", "arch": full.name, "mesh": list(LM_MESH),
          "card": _card(), "ranks": MESH_RANKS, "n_layers": layers,
          "d_model": full.d_model,
          "n_heads": full.n_heads, "n_kv_heads": full.n_kv_heads,
          "d_ff": full.d_ff, "vocab": full.vocab, "dtype": full.dtype,
          "reduced": [f"n_layers {full.n_layers} -> {layers}: four ranks "
                      f"share one card"],
          "batch": LM_MESH_FULL[1], "seq": LM_MESH_FULL[2],
          "transport": "gloo through the host, one card: not an NVLink or "
                       "NCCL number",
          "loss_rel_err_max": max(errs), "one_rank": one,
          "one_rank_state_bytes": one_bytes,
          "specs_state_bytes_per_rank": specs_bytes,
          "working_copy_bytes": work_bytes,
          "per_rank": [{"rank": r["rank"], "state_bytes":
                        r["full_state_bytes"], **r["full"]} for r in ranks]})
    emit(_split_row("lm_mesh_split", "train step", full, ranks,
                    lambda r: r["full"]))
    for arch, n_layers in LM_MESH_FULL_MORE:
        _lm_mesh_full_more(arch, n_layers, ranks, more[arch])
    emit({"phase": "lm_mesh_done", "seconds": time.perf_counter() - t0})
    return one["step_ms_median"], {
        LM_FULL: ranks[0]["full"]["counts"],
        **{a: ranks[0]["more"][a]["counts"] for a, _ in LM_MESH_FULL_MORE}}


def _specs_state_bytes(cfg) -> int:
    """A rank's bytes of ``cfg``'s train state under JAX's specs on
    ``MeshShape(LM_MESH)``: its params in their dtype, μ and ν in
    float32."""
    from repro_torch.launch.shardings import param_specs, shard_shape
    from repro_torch.launch.steps import eval_param_shapes
    from repro_torch.pjit_utils import MeshShape

    shape = MeshShape(LM_MESH)
    shapes = eval_param_shapes(cfg)

    def pairs(spec, leaf):       # (spec, shape leaf), dict keys sorted
        if isinstance(leaf, dict):
            return [x for k in sorted(leaf) for x in pairs(spec[k], leaf[k])]
        return [(spec, leaf)]

    return sum(int(np.prod(shard_shape(leaf.shape, spec, shape)))
               * (leaf.dtype.itemsize + 8)
               for spec, leaf in pairs(param_specs(shapes, cfg, shape),
                                       shapes))


def _lm_mesh_full_more(arch: str, layers: int, ranks: list, ref: dict
                       ) -> None:
    """Phase 21 (c) for a ``LM_MESH_FULL_MORE`` row: each rank's losses
    finite, falling and within ``LM_MESH_FULL_TOL`` of one rank's under
    ``MeshShape(LM_MESH)``, its state bytes the specs'; its row and its
    split row emitted."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    want = ref["one_rank"]["losses"]
    errs = []
    for r in ranks:
        run = r["more"][arch]
        losses = run["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{arch} full width, rank {r['rank']}: "
                                 f"{losses}")
        if run["state_bytes"] != ref["specs_state_bytes_per_rank"]:
            raise AssertionError(f"{arch}: rank {r['rank']} holds "
                                 f"{run['state_bytes']} state bytes, the "
                                 f"specs {ref['specs_state_bytes_per_rank']}")
        errs += [_rel(a, b) for a, b in zip(losses, want)]
    if not max(errs) <= LM_MESH_FULL_TOL:
        raise AssertionError(f"{arch} full-width mesh losses off by "
                             f"{max(errs)}")
    cfg = dataclasses.replace(full, n_layers=layers)
    split = _split_modes(cfg, LM_MESH_FULL[2])
    emit({"phase": "lm_mesh_full", "arch": full.name, "mesh": list(LM_MESH),
          "card": _card(), "ranks": MESH_RANKS, "n_layers": layers,
          "d_model": full.d_model,
          "n_heads": full.n_heads, "d_ff": full.d_ff,
          "n_experts": full.n_experts, "ssm_heads": (
              full.ssm_heads if full.ssm_state else None),
          "vocab": full.vocab, "dtype": full.dtype, "split": split,
          "reduced": [f"n_layers {full.n_layers} -> {layers}: four ranks "
                      f"share one card"],
          "batch": LM_MESH_FULL[1], "seq": LM_MESH_FULL[2],
          "reference": "one rank, ambient MeshShape((2, 2))",
          "transport": "gloo through the host, one card: not an NVLink or "
                       "NCCL number",
          "loss_rel_err_max": max(errs), "loss_tol": LM_MESH_FULL_TOL,
          **ref, "per_rank": [{"rank": r["rank"], **{
              k: v for k, v in r["more"][arch].items() if k != "counts"}}
              for r in ranks]})
    emit(_split_row("lm_mesh_split", "train step", full, ranks,
                    lambda r: r["more"][arch], layers))


def _split_modes(cfg, seq_len: int, kind: str = "train") -> dict:
    """The model axis's split modes of ``cfg`` in a ``kind`` call over
    ``seq_len`` positions on a model axis of ``LM_MESH[1]``
    (``tp.Split``'s, read here without a process group)."""
    from repro_torch.models.lm.tp import Split

    sp = Split(cfg, None, None, LM_MESH[1], 0, seq_len % LM_MESH[1] == 0,
               "", kind=kind)
    return {"sp": sp.sp,
            "moe": sp.moe if cfg.n_experts else None,
            "mixer": sp.mixer if cfg.ssm_state else None,
            "conv": sp.conv if cfg.ssm_state else None}


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def _split_row(phase: str, what: str, full, ranks, part,
               layers: int = LM_MESH_FULL[0]) -> dict:
    """Per rank: the FLOPs ``op_analysis`` counted in ``what`` on the
    process mesh, the split's activation collectives it counted by site,
    kind and dtype (held by :func:`_check_activation_collectives`), the
    median over the timed calls of the per-block parameter gathers (ms,
    bytes, count, the gathered bytes alive at once at their peak, beside
    the bytes of a whole working copy), the gradients' reduce-scatters,
    the other reductions and the split's activation collectives (ms and
    bytes), and the peak. ``part(rank result)`` is the run's dict
    (``counts``, ``exchange_per_step``, ``peak_gb``)."""
    rows = []
    for r in ranks:
        run = part(r)
        ex = run["exchange_per_step"]
        acts = run["counts"]["activation_collectives"]

        def med(k):
            return statistics.median(e[k] for e in ex)

        rows.append({"rank": r["rank"],
                     "flops_hlo": run["counts"]["flops_hlo"],
                     "collective_bytes": run["counts"]["collective_bytes"],
                     "activation_bytes_by_dtype":
                         _check_activation_collectives(full, what, acts),
                     "activation_collectives": acts,
                     "gather_ms": med("gather_ms"),
                     "gather_bytes_received": med("gather_bytes_received"),
                     "gathers": med("gathers"),
                     "gathered_bytes_live_peak": med(
                         "gathered_bytes_live_peak"),
                     "working_copy_bytes_from_shapes": med(
                         "working_copy_bytes_from_shapes"),
                     "reduce_scatter_ms": med("reduce_scatter_ms"),
                     "reduce_scatter_bytes": med("reduce_scatter_bytes"),
                     "allreduce_ms": med("allreduce_ms"),
                     "allreduce_bytes": med("allreduce_bytes"),
                     "activation_ms": med("activation_ms"),
                     "activation_bytes": med("activation_bytes"),
                     "activation_calls": med("activation_calls"),
                     "peak_gb": run["peak_gb"]})
    return {"phase": phase, "what": what, "arch": full.name,
            "n_layers": layers, "mesh": list(LM_MESH), "card": _card(),
            "transport": "gloo through the host, one card: not an NVLink "
                         "or NCCL number", "per_rank": rows}


# --------------------------------------------------------------------- #
# 22. LM serving over the mesh, and the dry run's counts on the card
# --------------------------------------------------------------------- #
def _serve_smoke_inputs(cfg, model, device) -> tuple:
    """The smoke serve case's prompt (seed 3) and, for encdec, the
    encoder memory of its frames."""
    from repro_torch.models.lm import model as lm

    B, P, _ = LM_SERVE_MESH_SMOKE
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)),
                             dtype=torch.int32, device=device)
    extras = {}
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.normal(size=(B, cfg.enc_seq,
                                                  cfg.d_model)),
                                 dtype=torch.float32, device=device)
        with torch.no_grad():
            extras["memory"] = lm.encode(model, frames)
    return tokens, extras


def _serve_smoke_one_rank(arch: str) -> dict:
    """Phase 22 (a)'s reference: prefill and the greedy decode steps on
    one rank under ``ambient_mesh(MeshShape(LM_MESH))``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape, ambient_mesh

    cfg = get_smoke_config(arch)
    B, P, MAX = LM_SERVE_MESH_SMOKE
    model = lm.init_params(cfg, seed=0, max_seq=MAX, device="cuda")
    tokens, extras = _serve_smoke_inputs(cfg, model, "cuda")
    cache = lm.init_cache(cfg, B, MAX, torch.float32, "cuda")
    logits_all, toks = [], []
    with ambient_mesh(MeshShape(LM_MESH)):
        logits, cache = make_prefill_step(cfg)(model, tokens, cache, extras)
        decode = make_decode_step(cfg)
        for i in range(LM_SERVE_MESH_STEPS + 1):
            logits_all.append(logits.cpu())
            toks.append(logits.argmax(-1).to(torch.int32))
            if i < LM_SERVE_MESH_STEPS:
                logits, cache = decode(model, toks[-1], cache,
                                       torch.tensor(P + i, device="cuda"), {})
    return {"logits": logits_all, "tokens": [t.cpu() for t in toks]}


def _serve_mesh_smoke(arch: str, mesh) -> dict:
    """Phase 22 (a) on one rank of the process mesh: the mesh prefill, the
    cache resharded to the decode specs, the greedy decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import full_tensors

    cfg = get_smoke_config(arch)
    B, P, MAX = LM_SERVE_MESH_SMOKE
    model = lm.init_params(cfg, seed=0, max_seq=MAX, device="cuda")
    tokens, extras = _serve_smoke_inputs(cfg, model, "cuda")
    steps.shard_model(model, mesh)
    cache = steps.init_mesh_cache(cfg, B, MAX, torch.float32, mesh,
                                  kind="prefill", device="cuda")
    out = {"bytes": {"prefill": steps.cache_bytes(cache)}}
    logits, cache = steps.make_prefill_step(cfg, mesh=mesh)(
        model, tokens, cache, extras)
    cache = steps.reshard_cache(cache, cfg, mesh, kind="decode")
    out["bytes"]["decode"] = steps.cache_bytes(cache)
    decode = steps.make_decode_step(cfg, mesh=mesh)
    logits_all, toks = [], []
    for i in range(LM_SERVE_MESH_STEPS + 1):
        full = full_tensors([logits])[0]
        logits_all.append(full.cpu())
        toks.append(full.argmax(-1).to(torch.int32))
        if i < LM_SERVE_MESH_STEPS:
            logits, cache = decode(model, toks[-1], cache,
                                   torch.tensor(P + i, device="cuda"), {})
    out.update({"logits": logits_all, "tokens": [t.cpu() for t in toks]})
    return out


def _serve_full_cfg(row):
    """A phase 22 (b) row's model config: the arch at the row's depth and
    dtype."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(row[0]), n_layers=row[1],
                               dtype=row[5])


def _serve_full_model(row):
    """A phase 22 (b) row's model on the card: drawn (seed 0) in its
    config's dtype and cast to the row's, so a row and its twin
    (:func:`_served`) hold the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as lm

    cfg, drawn = _serve_full_cfg(row), get_config(row[0]).dtype
    model = lm.init_params(dataclasses.replace(cfg, dtype=drawn), seed=0,
                           device="cuda")
    if cfg.dtype == drawn:
        return model
    model.cfg = cfg
    return model.to(dtype=lm.lm_dtype(cfg))


def _served(row) -> tuple:
    """The runs of a phase 22 (b) row: the row, and where its dtype is not
    its config's, its twin in the config's dtype."""
    from repro_torch.configs import get_config

    dtype = get_config(row[0]).dtype
    return (row,) if row[5] == dtype else (row, row[:5] + (dtype,))


def _row_key(row) -> str:
    """A phase 22 (b) run's key in the results: arch, layers and dtype."""
    return f"{row[0]}@{row[1]}:{row[5]}"


def _serve_full_case(row=LM_SERVE_MESH_FULL_ROWS[0]):
    """A phase 22 (b) row's model config (:func:`_serve_full_cfg`), its
    cache span and its prompt (seed 4)."""
    arch, layers, B, P, n, _ = row
    cfg = _serve_full_cfg(row)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, P)), dtype=torch.int32, device="cuda")
    return cfg, P + n + 2, tokens


def _serve_full_one_rank(row, feed=None) -> dict:
    """A phase 22 (b) row's reference: the same model
    (:func:`_serve_full_model`) and prompt on one rank under
    ``ambient_mesh(MeshShape(LM_MESH))``: the prefill, then greedy decode
    at the positions (b) decodes at, or decode fed ``feed`` (a twin: its
    row's tokens). Its logits (the prefill's and each decode step's) and
    the tokens, which (b)'s ranks are fed."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape, ambient_mesh

    cfg, MAX, tokens = _serve_full_case(row)
    _, _, B, P, n, _ = row
    model = _serve_full_model(row)
    cache = lm.init_cache(cfg, B, MAX, lm.lm_dtype(cfg), "cuda")
    logits_all, toks = [], []
    with torch.no_grad(), ambient_mesh(MeshShape(LM_MESH)):
        logits, cache = make_prefill_step(cfg)(model, tokens, cache, {})
        decode = make_decode_step(cfg)
        for i in range(n + 2):
            logits_all.append(logits.cpu())
            toks.append(logits.argmax(-1).to(torch.int32) if feed is None
                        else feed[i].to("cuda"))
            if i <= n:
                logits, cache = decode(model, toks[-1], cache, torch.tensor(
                    P + i, dtype=torch.int32, device="cuda"), {})
    return {"logits": logits_all, "tokens": torch.stack(toks).cpu()}


def _serve_mesh_full(rank: int, mesh, ex, feed: torch.Tensor, row) -> dict:
    """A phase 22 (b) row on one rank: the arch at its published width,
    the row's depth, served over the mesh: a warm-up and a timed prefill
    (each on a fresh cache), a warm-up and the timed decode steps fed the
    one-rank reference's greedy tokens ``feed``, host-clock ms and the
    exchange per call, each call's logits gathered after its timing; then
    one more decode step under ``op_analysis`` (phase 22 (c) holds it to
    the dry run's fake count of the same step)."""
    from repro_torch.launch import steps
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.steps import named_leaves
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import full_tensors

    cfg, MAX, tokens = _serve_full_case(row)
    _, _, B, P, n, _ = row
    feed = feed.to("cuda")
    model = _serve_full_model(row)
    steps.shard_model(model, mesh)
    prefill = steps.make_prefill_step(cfg, mesh=mesh)
    decode = steps.make_decode_step(cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        ex.reset()
        t0 = time.perf_counter()
        logits, _ = fn()
        torch.cuda.synchronize()
        ms, moved = (time.perf_counter() - t0) * 1e3, ex.read()
        return full_tensors([logits])[0].cpu(), ms, moved

    pre = []
    for _ in range(2):
        cache = steps.init_mesh_cache(cfg, B, MAX, lm.lm_dtype(cfg), mesh,
                                      kind="prefill", device="cuda")
        pre.append(timed(lambda: prefill(model, tokens, cache, {})))
    dec = [timed(lambda i=i: decode(model, feed[i], cache, torch.tensor(
        P + i, dtype=torch.int32, device="cuda"), {}))
        for i in range(n + 1)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_nbytes = steps.cache_bytes(cache)
    with OpAnalysis() as oa:
        oa.name(dict(named_leaves(cache, "cache")))
        decode(model, feed[n + 1], cache, torch.tensor(
            P + n + 1, dtype=torch.int32, device="cuda"), {})
    fresh = steps.init_mesh_cache(cfg, B, MAX, lm.lm_dtype(cfg), mesh,
                                  kind="prefill", device="cuda")
    with OpAnalysis() as pre_oa:
        pre_oa.name(dict(named_leaves(fresh, "cache")))
        prefill(model, tokens, fresh, {})
        torch.cuda.synchronize()
    return {"prefill_ms": [r[1] for r in pre],
            "prefill_exchange": pre[1][2],
            "decode_warmup_ms": dec[0][1],
            "decode_ms": [r[1] for r in dec[1:]],
            "decode_ms_median": statistics.median(r[1] for r in dec[1:]),
            "decode_exchange": dec[1][2],
            "decode_exchange_per_step": [r[2] for r in dec[1:]],
            "cache_bytes": cache_nbytes, "peak_gb": peak_gb,
            "logits": [pre[1][0]] + [r[0] for r in dec],
            "counts": oa.analyze() if rank == 0 else None,
            "decode_counts": _count_row(oa),
            "prefill_counts": _count_row(pre_oa)}


def _serve_mesh_rank(rank: int, world: int, root: str) -> None:
    """One rank of phase 22 (a spawned child on cuda:0 over ``gloo``)."""
    import datetime
    import pickle

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{root}/pg_serve", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_mesh

        ex = _LMExchange()
        mesh = make_mesh(LM_MESH, ("data", "model"), device="cuda")
        out = {"rank": rank,
               "smoke": {a: _serve_mesh_smoke(a, mesh)
                         for a in LM_SERVE_MESH_ARCHS}, "full": {}}
        for run in [r for row in LM_SERVE_MESH_FULL_ROWS
                    for r in _served(row)]:
            gc.collect()
            torch.cuda.empty_cache()
            out["full"][_row_key(run)] = _serve_mesh_full(
                rank, mesh, ex, torch.load(os.path.join(
                    root, f"full_feed_{_row_key(run)}.pt")), run)
        with open(os.path.join(root, f"serve{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _cache_spec_bytes(cfg, kind: str) -> int:
    """A rank's bytes of the smoke cache under ``cache_specs(kind=)`` on
    ``MeshShape(LM_MESH)``, counted from the specs."""
    from repro_torch.launch.shardings import cache_specs, shard_shape
    from repro_torch.launch.steps import tree_leaves
    from repro_torch.models.lm import model as lm
    from repro_torch.pjit_utils import MeshShape

    B, _, MAX = LM_SERVE_MESH_SMOKE
    mesh = MeshShape(LM_MESH)
    shapes = lm.init_cache(cfg, B, MAX, torch.float32, "meta")
    specs = cache_specs(cfg, mesh, batch_size=B, seq_len=MAX, kind=kind)
    return sum(int(np.prod(shard_shape(t.shape, sp, mesh))) * t.element_size()
               for t, sp in zip(tree_leaves(shapes), tree_leaves(specs)))


def _roofline(what: str, counts: dict, measured_ms: float, model_flops,
              link: float) -> dict:
    """The roofline terms of ``counts`` at the H100 datasheet constants
    (``launch/roofline.py``) beside a measured time."""
    from repro_torch.launch import roofline

    terms = {"compute": counts["flops_hlo"] / roofline.PEAK_FLOPS * 1e3,
             "memory": counts["hbm_bytes_est"] / roofline.HBM_BW * 1e3,
             "collective": counts["collective_total"] / link * 1e3}
    bound = max(terms.values())
    return {"step": what, "terms_ms": terms,
            "bound_by": max(terms, key=terms.get), "bound_ms": bound,
            "measured_ms": measured_ms,
            "fraction_of_roofline": bound / measured_ms,
            "model_flops": model_flops,
            "model_flops_share_of_counted": (
                model_flops / counts["flops_hlo"] if model_flops else None),
            "model_tflops_measured": (model_flops / measured_ms / 1e9
                                      if model_flops else None)}


def _same_counts(what: str, real: dict, fake: dict) -> dict:
    """Hold the real step's counts to the dry run's fake count of the
    same step: FLOPs, collective bytes by kind, and the HBM estimate less
    the real step's host staging (a gloo group's copies, which the fake
    group's transport does not make) must be equal."""
    keys = ("flops_hlo", "collective_total")
    for k in keys:
        if real[k] != fake[k]:
            raise AssertionError(f"{what}: {k} real {real[k]} fake {fake[k]}")
    if real["collective_bytes"] != fake["collective_bytes"]:
        raise AssertionError(f"{what}: collectives real "
                             f"{real['collective_bytes']} fake "
                             f"{fake['collective_bytes']}")
    hbm_real = real["hbm_bytes_est"] - real["host_copy_bytes"]
    if hbm_real != fake["hbm_bytes_est"]:
        raise AssertionError(f"{what}: hbm_bytes_est real {hbm_real} (less "
                             f"{real['host_copy_bytes']} staged) fake "
                             f"{fake['hbm_bytes_est']}")
    return {"flops_hlo": real["flops_hlo"],
            "collective_bytes": real["collective_bytes"],
            "hbm_bytes_est": real["hbm_bytes_est"],
            "host_copy_bytes": real["host_copy_bytes"],
            "ops_real": real["ops"], "ops_fake": fake["ops"],
            "equal": True}


def _fake_counts(arch: str, shape: str, meshes=None, **kw) -> tuple:
    """The dry run's fake count of one step (``dryrun.build_cell`` on
    cuda) and its seconds, held EQUAL in FLOPs, collective bytes and the
    HBM estimate to the same cell faked on the CPU, as a host with a
    CPU-only torch counts it. ``meshes``: each device's fake mesh, or
    None for one rank."""
    from repro_torch.launch.dryrun import build_cell, fake_device
    from repro_torch.launch.op_analysis import OpAnalysis

    if fake_device() != "cuda":
        raise AssertionError("this torch is not built for CUDA")
    counts, secs = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, meshes and meshes[device],
                          device=device, **kw)
        oa = OpAnalysis()
        cell.step(oa)
        counts[device], secs[device] = oa.analyze(), time.perf_counter() - t0
    for k in ("flops_hlo", "collective_bytes", "collective_total",
              "hbm_bytes_est"):
        if counts["cuda"][k] != counts["cpu"][k]:
            raise AssertionError(f"{arch} × {shape}: {k} faked on cuda "
                                 f"{counts['cuda'][k]}, on the cpu "
                                 f"{counts['cpu'][k]}")
    return counts["cuda"], secs["cuda"]


def _counts_one_rank(one_rank_ms: float) -> list:
    """Phase 22 (c) on one rank: ``op_analysis`` over the real
    ``LM_FULL`` train step (``LM_TRAIN``'s batch) and decode step
    (``LM_SERVE``'s, after its prefill) on the card, each held to the dry
    run's fake count of the same step; the roofline beside the measured
    ms; and the roofline of phase 21's 2-layer one-rank step from its
    fake count beside the time phase 21 measured."""
    from repro_torch.configs import get_config
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.roofline import NVLINK_BW
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.lm import model as lm

    cfg = get_config(LM_FULL)
    active = cfg.active_param_count()
    rows = []
    # the train step
    B, S, _ = LM_TRAIN
    step_fn = make_train_step(cfg)
    batch = synthetic_batch(cfg, 0, B, S, device="cuda")
    state = init_state(cfg, device="cuda")
    with OpAnalysis() as oa:
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
    real = oa.analyze()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    del state, m, oa
    gc.collect()
    torch.cuda.empty_cache()
    fake, fake_s = _fake_counts(LM_FULL, "train_4k", cfg=cfg, batch_size=B,
                                seq_len=S)
    rows.append({"phase": "lm_counts", "step": "train", "arch": cfg.name,
                 "batch": B, "seq": S, "fake_build_run_s": fake_s,
                 "cpu_fake_equal": True,
                 **_same_counts("train step", real, fake),
                 "roofline": _roofline("train", real, step_ms,
                                       6 * active * B * S, NVLINK_BW)})
    emit(rows[-1])
    # the decode step, after the prefill
    B, P, gen = LM_SERVE
    MAX = P + gen
    model = lm.init_params(cfg, max_seq=MAX, device="cuda")
    cache = lm.init_cache(cfg, B, MAX, lm.lm_dtype(cfg), "cuda")
    tokens = synthetic_batch(cfg, 0, B, P, device="cuda")["tokens"]
    logits, cache = lm.prefill(model, tokens, cache)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.tensor(P, dtype=torch.int32, device="cuda")
    with OpAnalysis() as oa:
        lm.decode_step(model, tok, cache, pos)
        torch.cuda.synchronize()
    real = oa.analyze()

    def decode():   # the same position each call: the same work
        lm.decode_step(model, tok, cache, pos)

    dec_ms = time_ms(decode, reps=10, warmup=2)
    del model, cache, oa
    gc.collect()
    torch.cuda.empty_cache()
    fake, fake_s = _fake_counts(LM_FULL, "decode_32k", cfg=cfg,
                                batch_size=B, seq_len=MAX)
    rows.append({"phase": "lm_counts", "step": "decode", "arch": cfg.name,
                 "batch": B, "cache_len": MAX, "fake_build_run_s": fake_s,
                 "cpu_fake_equal": True,
                 **_same_counts("decode step", real, fake),
                 "roofline": _roofline("decode", real, dec_ms, 2 * active * B,
                                       NVLINK_BW)})
    emit(rows[-1])
    # phase 21's one-rank 2-layer step (B = 4 × 512): its fake count only
    layers, B, S = LM_MESH_FULL[:3]
    cfg2 = dataclasses.replace(cfg, n_layers=layers)
    fake, fake_s = _fake_counts(LM_FULL, "train_4k", cfg=cfg2, batch_size=B,
                                seq_len=S)
    rows.append({"phase": "lm_counts", "step": "train_2_layers",
                 "arch": cfg.name, "n_layers": layers, "batch": B, "seq": S,
                 "fake_build_run_s": fake_s, "cpu_fake_equal": True,
                 "flops_hlo": fake["flops_hlo"],
                 "hbm_bytes_est": fake["hbm_bytes_est"],
                 "measured_in": "phase 21 (one rank)",
                 "roofline": _roofline("train", fake, one_rank_ms,
                                       6 * cfg2.active_param_count() * B * S,
                                       NVLINK_BW)})
    emit(rows[-1])
    return rows


def _rank_batch(B: int) -> int:
    """A mesh rank's rows of a batch of ``B``: its block over 'data', or
    all of them where 'data' does not divide ``B``
    (``steps._rank_rows``)."""
    return B if B % LM_MESH[0] else B // LM_MESH[0]


def _counts_unsplit(arch: str, layers: int, split: dict,
                    serve=None) -> None:
    """Phase 22 (c): rank 0's counts of ``arch``'s split mesh steps at
    ``layers`` (``split``: "train" where phase 21 trained it; "prefill" and
    "decode" of its phase 22 (b) row ``serve``) beside the dry run's fake
    count of the same rows through the whole model on one rank, which is
    what each rank of the mesh steps computed before the model axis split
    the work."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    rows = {}
    if "train" in split:
        B, S = LM_MESH_FULL[1:3]
        rows["train"] = ("train_4k", _rank_batch(B), S)
    if serve is not None:
        cfg, MAX, _ = _serve_full_case(serve)
        _, _, B, P, _, _ = serve
        rows["prefill"] = ("prefill_32k", _rank_batch(B), P)
        rows["decode"] = ("decode_32k", _rank_batch(B), MAX)
    for what, (shape, b, seq) in rows.items():
        fake, fake_s = _fake_counts(arch, shape, cfg=cfg, batch_size=b,
                                    seq_len=seq)
        got = split[what]["flops_hlo"]
        if not 0 < got < fake["flops_hlo"]:
            raise AssertionError(f"{arch} mesh {what}: the split rank counts "
                                 f"{got} FLOPs, its rows unsplit "
                                 f"{fake['flops_hlo']}")
        emit({"phase": "lm_counts", "step": f"mesh_{what}_split",
              "arch": full.name, "n_layers": layers, "dtype": cfg.dtype,
              "mesh": list(LM_MESH), "rank": 0, "rows": b, "seq": seq,
              "flops_split": got, "flops_rows_unsplit": fake["flops_hlo"],
              "split_over_unsplit": got / fake["flops_hlo"],
              "collective_bytes_split": split[what]["collective_bytes"],
              "fake_build_run_s": fake_s,
              "unsplit": "the whole model on the rank's rows on one rank "
                         "(the dry run's fake count): each rank's work "
                         "before the model axis split it"})


def _counts_mesh(reals: dict) -> dict:
    """Phase 22 (c) over the mesh: rank 0's real decode step of each
    (b) row (``reals``: its count by :func:`_row_key`) held to the dry run's fake
    count of the same step on a fake group of ``LM_MESH`` (this process,
    rank 0 of it, then the group is closed)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_mesh

    out = {}
    try:
        meshes = {d: fake_mesh(LM_MESH, ("data", "model"), d)
                  for d in ("cuda", "cpu")}
        for row in LM_SERVE_MESH_FULL_ROWS:
            cfg, MAX, _ = _serve_full_case(row)
            fake, fake_s = _fake_counts(row[0], "decode_32k", meshes,
                                        cfg=cfg, batch_size=row[2],
                                        seq_len=MAX)
            out[_row_key(row)] = {
                "fake_build_run_s": fake_s, "cpu_fake_equal": True,
                **_same_counts(f"{_row_key(row)} mesh decode step",
                               reals[_row_key(row)], fake)}
    finally:
        dist.destroy_process_group()
    return out


def _rel_err(a, b) -> float:
    """max |a − b| over max |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


def _serve_twin_checks(row, ranks: list, refs: dict) -> dict:
    """A row's twin in its config's dtype (:func:`_served`), fed the row's
    tokens: each call's distance from the row's one-rank logits, on one
    rank and on each mesh rank; the mesh's (max over calls and ranks) must
    stay within ``LM_MESH_TWIN_RATIO`` times one rank's (max over
    calls)."""
    twin = _served(row)[1]
    truth, one = refs[_row_key(row)]["logits"], refs[_row_key(twin)]["logits"]
    one_err = [_rel_err(a, b) for a, b in zip(one, truth)]
    mesh_err = [[_rel_err(a, b) for a, b in zip(
        r["full"][_row_key(twin)]["logits"], truth)] for r in ranks]
    drift = [[_rel_err(a, b) for a, b in zip(
        r["full"][_row_key(twin)]["logits"], one)] for r in ranks]
    worst = max(max(e) for e in mesh_err)
    if not (0 < max(one_err) and worst <= LM_MESH_TWIN_RATIO * max(one_err)):
        raise AssertionError(f"{row[0]} {twin[5]} twin at {row[1]} layers: "
                             f"the mesh lies {worst} from the {row[5]} "
                             f"logits, one rank {max(one_err)}")
    return {"dtype": twin[5], "reference": f"one rank, {row[5]}, the same "
            f"weights and tokens", "one_rank_rel_err": one_err,
            "mesh_rel_err_per_rank": mesh_err,
            "mesh_vs_one_rank_rel_err_per_rank": drift,
            "ratio_max": worst / max(one_err),
            "ratio_bound": LM_MESH_TWIN_RATIO}


def _serve_full_checks(row, ranks: list, refs: dict) -> None:
    """Phase 22 (b)'s checks of one row and its rows emitted: each rank's
    logits (the prefill's, each decode step's) against one rank's within
    the bound; its greedy tokens equal, but where one rank's logits of the
    two tokens lie within that bound of each other (a near-tie); the twin
    (:func:`_serve_twin_checks`); no decode step gathers a cache leaf."""
    from repro_torch.configs import get_config

    arch, layers, B, P, n, dtype = row
    key = _row_key(row)
    ref = refs[key]
    full = get_config(arch)
    errs, near_ties = [], 0
    for r in ranks:
        for i, (a, b) in enumerate(zip(r["full"][key]["logits"],
                                       ref["logits"])):
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"{arch} full width, rank {r['rank']}: "
                                     f"non-finite logits in call {i}")
            bound = LM_MESH_FULL_TOL * float(b.abs().max())
            errs.append(_rel_err(a, b))
            got, want = a.argmax(-1), ref["tokens"][i].long()
            for k in (got != want).nonzero().flatten().tolist():
                gap = float(b[k, want[k]] - b[k, got[k]])
                if not gap <= bound:
                    raise AssertionError(
                        f"{arch} full width, rank {r['rank']}, call {i}, "
                        f"row {k}: greedy token {int(got[k])}, one rank's "
                        f"{int(want[k])} ahead by {gap} > {bound}")
                near_ties += 1
    if not max(errs) <= LM_MESH_FULL_TOL:
        raise AssertionError(f"{arch} full-width mesh logits off by "
                             f"{max(errs)}")
    reduced = []
    if layers < full.n_layers:
        reduced.append(f"n_layers {full.n_layers} -> {layers}: four ranks "
                       f"share one card")
    if dtype != full.dtype:
        reduced.append(f"dtype {full.dtype} -> {dtype}: at this depth one "
                       f"rank's {full.dtype} logits and the mesh's each lie "
                       f"farther than LM_MESH_FULL_TOL from {dtype}'s, so "
                       f"from each other too (twin)")
    cfg = _serve_full_cfg(row)
    emit({"phase": "lm_serve_mesh_full", "arch": full.name,
          "mesh": list(LM_MESH), "card": _card(), "ranks": MESH_RANKS,
          "n_layers": layers, "d_model": full.d_model,
          "n_experts": full.n_experts, "vocab": full.vocab,
          "dtype": dtype,
          "split": {k: _split_modes(cfg, q, k) for k, q in (("prefill", P),
                                                            ("decode", 1))},
          "reduced": reduced,
          "batch": B, "prompt": P, "decode_steps_timed": n,
          "working_copy_bytes_from_shapes": ranks[0]["full"][key][
              "decode_exchange"]["working_copy_bytes_from_shapes"],
          "reference": "one rank, ambient MeshShape((2, 2)), greedy tokens "
                       "fed to the ranks",
          "logits_rel_err_max": max(errs), "logits_tol": LM_MESH_FULL_TOL,
          "calls_held": len(ref["logits"]),
          "token_near_ties": near_ties,
          **({"twin": _serve_twin_checks(row, ranks, refs)}
             if len(_served(row)) > 1 else {}),
          "transport": "gloo through the host, one card: not an NVLink or "
                       "NCCL number",
          "per_rank": [{"rank": r["rank"], **{k: v for k, v in
                                              r["full"][key].items()
                                              if k not in (
                                                  "counts", "logits",
                                                  "decode_counts",
                                                  "prefill_counts")}}
                       for r in ranks]})
    for what, part, ex in (("prefill", "prefill_counts", "prefill_exchange"),
                           ("decode", "decode_counts",
                            "decode_exchange_per_step")):
        emit(_split_row("lm_serve_mesh_split", what, cfg, ranks,
                        lambda r, part=part, ex=ex: {
                            "counts": r["full"][key][part],
                            "exchange_per_step": (
                                r["full"][key][ex]
                                if isinstance(r["full"][key][ex], list)
                                else [r["full"][key][ex]]),
                            "peak_gb": r["full"][key]["peak_gb"]},
                        layers))
        for r in ranks:
            cached = [x for x in r["full"][key][part]["top_collectives"]
                      if "cache." in x["names"]]
            if cached:
                raise AssertionError(f"{arch}: rank {r['rank']}'s {what} "
                                     f"gathers cache leaves: {cached}")


def lm_serve_mesh_phase(one_rank_ms: float, mesh_train: dict) -> None:
    """Phase 22 (a–c): the one-rank references here, the spawn of
    ``MESH_RANKS`` ranks, the checks, then the counts; every check
    raises. ``one_rank_ms``: phase 21's one-rank step (its roofline);
    ``mesh_train``: rank 0's count of phase 21's split mesh step, by
    arch."""
    import pickle
    import tempfile

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.roofline import NVLINK_BW

    t0 = time.perf_counter()
    refs = {a: _serve_smoke_one_rank(a) for a in LM_SERVE_MESH_ARCHS}
    root = tempfile.mkdtemp(prefix="lm_serve_mesh_")
    try:
        ref_full = {}
        for row in LM_SERVE_MESH_FULL_ROWS:
            for run in _served(row):
                ref_full[_row_key(run)] = _serve_full_one_rank(
                    run, None if run is row else ref_full[_row_key(row)][
                        "tokens"])
                torch.save(ref_full[_row_key(run)]["tokens"], os.path.join(
                    root, f"full_feed_{_row_key(run)}.pt"))
                gc.collect()
                torch.cuda.empty_cache()
        spawn_mesh_ranks(_serve_mesh_rank, (MESH_RANKS, root), "phase 22")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"serve{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t_spawn = time.perf_counter() - t0

    # (a) each rank's logits and tokens against one rank's, cache bytes
    for arch in LM_SERVE_MESH_ARCHS:
        cfg = get_smoke_config(arch)
        want = {k: _cache_spec_bytes(cfg, k) for k in ("prefill", "decode")}
        ref = refs[arch]
        errs = []
        for r in ranks:
            got = r["smoke"][arch]
            if got["bytes"] != want:
                raise AssertionError(f"{arch}: rank {r['rank']} holds cache "
                                     f"bytes {got['bytes']}, specs {want}")
            for a, b in zip(got["logits"], ref["logits"]):
                errs.append(float((a - b).abs().max() / b.abs().max()))
            for a, b in zip(got["tokens"], ref["tokens"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{arch}: rank {r['rank']} greedy "
                                         f"tokens differ from one rank's")
        if not max(errs) <= LM_SERVE_MESH_TOL:
            raise AssertionError(f"{arch}: mesh logits off by {max(errs)}")
        emit({"phase": "lm_serve_mesh_parity", "arch": arch,
              "mesh": list(LM_MESH), "ranks": MESH_RANKS,
              "batch": LM_SERVE_MESH_SMOKE[0],
              "prompt": LM_SERVE_MESH_SMOKE[1],
              "decode_steps": LM_SERVE_MESH_STEPS,
              "reference": "one rank, ambient MeshShape((2, 2))",
              "logits_rel_err_max": max(errs), "tokens_equal": True,
              "cache_bytes_per_rank": want, "cache_bytes_equal_specs": True})

    # (b) each full-width row against one rank's
    for row in LM_SERVE_MESH_FULL_ROWS:
        _serve_full_checks(row, ranks, ref_full)

    # (c) the counts: each row's mesh decode step, then one rank's steps
    t1 = time.perf_counter()
    mesh = _counts_mesh({_row_key(row): ranks[0]["full"][_row_key(row)][
        "counts"] for row in LM_SERVE_MESH_FULL_ROWS})
    for row in LM_SERVE_MESH_FULL_ROWS:
        arch, layers, B = row[:3]
        cfg, res = _serve_full_cfg(row), ranks[0]["full"][_row_key(row)]
        emit({"phase": "lm_counts", "step": "mesh_decode", "arch": cfg.name,
              "n_layers": layers, "dtype": cfg.dtype, "mesh": list(LM_MESH),
              "rank": 0, **mesh[_row_key(row)],
              "roofline": _roofline("mesh decode", res["counts"],
                                    res["decode_ms_median"],
                                    2 * cfg.active_param_count()
                                    * _rank_batch(B), NVLINK_BW)})
    # phase 21 trained these archs at these depths
    trained = dict(((LM_FULL, LM_MESH_FULL[0]),) + LM_MESH_FULL_MORE)
    for row in LM_SERVE_MESH_FULL_ROWS:
        arch, layers = row[:2]
        res = ranks[0]["full"][_row_key(row)]
        split = {"prefill": res["prefill_counts"],
                 "decode": res["decode_counts"]}
        if trained.get(arch) == layers:
            split["train"] = mesh_train[arch]
        _counts_unsplit(arch, layers, split, row)
    for arch, layers in LM_MESH_FULL_MORE:
        if (arch, layers) not in (row[:2] for row in LM_SERVE_MESH_FULL_ROWS):
            _counts_unsplit(arch, layers, {"train": mesh_train[arch]})
    gc.collect()
    torch.cuda.empty_cache()
    _counts_one_rank(one_rank_ms)
    emit({"phase": "lm_serve_mesh_done", "spawn_s": t_spawn,
          "counts_s": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0})


def summary(name, source, replaces, main_rows, all_rows, launches,
            block_rows=()):
    def total(key):
        vals = [r[key] for r in main_rows]
        return None if any(v is None for v in vals) else sum(vals)

    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(main_rows, key=lambda r: r["bound_ms"])[
                "bound_by"],
            "library_ms": total("library_ms"),
            "shapes": [shape_entry(r) for r in main_rows],
            "block_shapes": [shape_entry(r) for r in block_rows]}


def shape_entry(r: dict) -> dict:
    return {k: r[k] for k in (
        "dtype", "graph", "op", "binop", "lhs", "rhs", "d", "de", "heads",
        "reduce", "H", "F", "kernel_ms", "kernel_device_ms", "kernel_cold_ms",
        "fp32_kernel_device_ms", "canonical_device_ms", "library_ms",
        "library_device_ms", "library_cold_ms", "plain_ms", "bound_ms",
        "max_abs_err") if k in r}


def main() -> int:
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from benchmarks.torch_sddmm_walks import CANONICAL_SRC
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2

    # 1. environment
    smi = _card()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    sources = _build.SOURCES + (CANONICAL_SRC,)
    per_source = _build.build(sources)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": per_source, "nvcc": _build.nvcc_path()})
    for name in sources:
        report = [ln for ln in _build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        emit({"phase": "ptxas", "source": name, "report": report})

    kernels = gnn_phases()
    # 19. the LM stack, after the GNN phases' tensors are freed
    gc.collect()
    torch.cuda.empty_cache()
    lm_phase()
    # 21. the LM mesh: four gloo ranks of one LM on this card
    gc.collect()
    torch.cuda.empty_cache()
    one_rank_ms, mesh_train = lm_mesh_phase()
    # 22. serving over the mesh; the dry run's counts against the card
    gc.collect()
    torch.cuda.empty_cache()
    lm_serve_mesh_phase(one_rank_ms, mesh_train)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def gnn_phases() -> dict:
    """Phases 3-18 and 20; returns the kernels summary line."""
    from repro_torch.data.synthetic import make_node_dataset, rmat_graph
    from repro_torch.core.graph import from_coo
    from repro_torch.kernels.edge_softmax.ops import SOFTMAX_SEGMENT_EDGES
    from repro_torch.kernels.rowsplit import SEGMENT_EDGES, row_split
    from repro_torch.models.gnn.common import make_bundle, pad_features

    # 3. kernels, with and without zero-in-degree rows
    gen = torch.Generator().manual_seed(0)
    b1_rows, b2_rows, b3_rows, b4_rows, b5_rows = {}, {}, {}, {}, {}
    dataset = make_node_dataset("reddit-like", device="cuda")
    g_loops = dataset[0]
    src, dst, n = rmat_graph(16, 600_000, seed=0)
    g_bare = from_coo(src, dst, n_src=n, n_dst=n, device="cuda")
    for label, g in (("self_loops", g_loops), ("no_self_loops", g_bare)):
        lists = []
        for K in (SEGMENT_EDGES, SOFTMAX_SEGMENT_EDGES):   # B1 / B2, B5
            t0 = time.perf_counter()
            rs = row_split(g, K)
            lists.append({"K": rs.K, "segments": rs.n_segments,
                          "split_rows": rs.n_split,
                          "partial_slots": rs.n_partials,
                          "longest_segment": rs.max_segment,
                          "build_s": time.perf_counter() - t0})
        emit({"phase": "graph", "graph": label, "n_nodes": g.n_dst,
              "n_edges": g.n_edges,
              "max_in_degree": int(g.host.in_degrees.max()),
              "zero_in_degree_rows": int((g.host.in_degrees == 0).sum()),
              "work_lists": lists})
        w = make_bundle(g).gcn_norm.index_select(0, g.long("eid"))
        check_b1(g, w.contiguous(), gen, label, b1_rows)
        check_b2(g, gen, label, b2_rows)
        check_b3(g, gen, label, b3_rows)
        check_b4(g, gen, label, b4_rows)
        check_b5(g, gen, label, b5_rows)
    # 3b. the same kernels on the two blocks of a sampled fan-out batch
    block_rows = {k: {} for k in ("spmm_csr", "fused_attention_csr",
                                  "sddmm_csr", "binary_reduce_csr",
                                  "edge_softmax_csr")}
    check_blocks(g_loops, gen, block_rows)
    del g_bare
    torch.cuda.empty_cache()

    # 4. serve through the entry points a user calls; 5. GAT's modes
    served = {}
    for app in ("gcn", "sage", "gat"):
        served[app], srv = serve_app(app)
    forward = forward_gat(srv)
    trace_gat_refresh(srv)
    del srv
    torch.cuda.empty_cache()

    # 7. fan-out serving; 8. fan-out = layer-wise at the full fan-out;
    # 9. auto resolving per class
    fanned = [serve_fanout_app(app) for app in ("gcn", "sage", "gat")]
    torch.cuda.empty_cache()
    exact = serve_exact()
    torch.cuda.empty_cache()
    auto = [serve_auto_app(app) for app in ("gcn", "sage", "gat")]
    torch.cuda.empty_cache()

    # 11. full-graph training: the backward kernels, GAT's attention
    # chain, the B4 specs' kernel-route grads, then each app
    t0 = time.perf_counter()
    train_kernels(g_loops, gen, {"spmm_csr": b1_rows, "sddmm_csr": b3_rows,
                                 "binary_reduce_csr": b4_rows})
    check_attention_chain(g_loops, gen)
    check_gspmm_grads(g_loops, gen)
    _, feats, labels, train_mask, val_mask, n_classes = dataset
    data = (make_bundle(g_loops),
            *(torch.from_numpy(a).cuda()
              for a in (feats, labels, train_mask, val_mask)), n_classes)
    trained = [train_app(app, data) for app in ("gcn", "sage", "gat")]
    del data
    torch.cuda.empty_cache()
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})

    # 12. sampled minibatch training: the block backward kernels on one
    # training batch's Gᵀ, each app's step grads, train_sampled's runs,
    # one profiled SAGE step
    t0 = time.perf_counter()
    sampled_rows = {"spmm_csr": {}, "binary_reduce_csr": {}}
    mb = sampled_batch(g_loops, labels, train_mask, (10, 10), 64)
    sampled_block_kernels(mb, gen, sampled_rows)
    feats_pad = pad_features(feats, "cuda")
    sampled_steps = [sampled_grads(app, hidden, mb, feats_pad, n_classes)
                     for app, hidden in (("sage", 64), ("gcn", 16),
                                         ("gat", 16))]
    del feats_pad, mb
    torch.cuda.empty_cache()
    prod = make_node_dataset("products-like", device="cuda")
    sets = {"reddit-like": (g_loops, feats, labels, train_mask, n_classes),
            "products-like": (prod[0], prod[1], prod[2], prod[3], prod[5])}
    sampled = [sampled_runs(app, ds, sets[ds], fo, b, h, nb,
                            "train_sampled_sage" if i == 0 else None)
               for i, (app, ds, fo, b, h, nb) in enumerate(SAMPLED_RUNS)]
    trace_sampled_step(sets["products-like"], *SAMPLED_RUNS[0][2:5])
    del prod, sets
    torch.cuda.empty_cache()
    emit({"phase": "train_sampled_done",
          "seconds": time.perf_counter() - t0})

    # 13. the relational apps: hetero_gspmm alone per operand form, each
    # app's forward, R-GCN served in every mode
    t0 = time.perf_counter()
    rel_rows = {"spmm_csr": {}, "sddmm_csr": {}, "binary_reduce_csr": {}}
    hetero_forms(gen, rel_rows["spmm_csr"])
    n_forms = len(rel_rows["spmm_csr"])
    relational = relational_forwards(gen, rel_rows["spmm_csr"],
                                     rel_rows["sddmm_csr"])
    torch.cuda.empty_cache()
    relational += rgcn_sessions(gen, rel_rows["binary_reduce_csr"])
    torch.cuda.empty_cache()
    emit({"phase": "relational_done", "seconds": time.perf_counter() - t0})

    # 14. relational training: the backward kernels at the steps' shapes,
    # each app's step grads and epochs, sampled R-GCN
    t0 = time.perf_counter()
    train_rel_rows = {"spmm_csr": {}, "sddmm_csr": {}}
    rel_trained = train_relational(gen, train_rel_rows)
    torch.cuda.empty_cache()
    rel_trained += train_relational_sampled(gen, train_rel_rows)
    torch.cuda.empty_cache()
    emit({"phase": "train_relational_done",
          "seconds": time.perf_counter() - t0})

    # 15. the layout routes: pack builds, gspmm's routes, training under
    # "ell", block push, hetero's ell / push, the ragged attention grads
    t0 = time.perf_counter()
    rg_skew = skewed_relgraph()
    strategy_packs(g_loops, rg_skew)
    strategy_gspmm(g_loops, gen)
    torch.cuda.empty_cache()
    ell_trained = strategy_train(g_loops, dataset)
    torch.cuda.empty_cache()
    strategy_blocks(g_loops, gen)
    strategy_hetero(rg_skew, gen)
    strategy_attention(g_loops, gen)
    del rg_skew
    torch.cuda.empty_cache()
    emit({"phase": "strategies_done", "seconds": time.perf_counter() - t0})

    # 16. the planner: the cuda row's fit, each main-path op's predicted
    # and measured rankings, autotune on the card, the plan log and the
    # drift report of a serve, a step per app and a sampled epoch
    t0 = time.perf_counter()
    planner_fit(g_loops, gen)
    torch.cuda.empty_cache()
    planner_rank(g_loops, gen)
    torch.cuda.empty_cache()
    mb = sampled_batch(g_loops, labels, train_mask, PLANNER_SAMPLED[0],
                       PLANNER_SAMPLED[1])
    planner_autotune(g_loops, gen, mb)
    del mb
    torch.cuda.empty_cache()
    planner_drift(g_loops, dataset)
    torch.cuda.empty_cache()
    emit({"phase": "planner_done", "seconds": time.perf_counter() - t0})

    # 17. mixed-precision training: the bf16 kernels at a bf16 step's
    # shapes, each app's bf16 step and epochs (full graph, sampled,
    # relational), the cuda:bf16 row and auto's bf16 choices
    t0 = time.perf_counter()
    from repro_torch.core.graph import reverse

    bf16_rows = {k: {} for k in ("spmm_csr", "sddmm_csr", "sddmm_csr:copy",
                                 "binary_reduce_csr")}
    w_all = make_bundle(g_loops).gcn_norm
    for label, gr in (("self_loops", g_loops), ("reverse", reverse(g_loops))):
        check_bf16_kernels(gr, w_all.index_select(0, gr.long("eid"))
                           .contiguous(), gen, label, bf16_rows)
    torch.cuda.empty_cache()
    data = (make_bundle(g_loops),
            *(torch.from_numpy(a).cuda()
              for a in (feats, labels, train_mask, val_mask)), n_classes)
    bf16_full = [train_bf16_full(app, data) for app in ("gcn", "sage", "gat")]
    del data
    torch.cuda.empty_cache()
    prod = make_node_dataset("products-like", device="cuda")
    bf16_sampled = train_bf16_sampled(g_loops, feats, labels, train_mask,
                                      n_classes, (prod[0], prod[1], prod[2],
                                                  prod[3], prod[5]))
    del prod
    torch.cuda.empty_cache()
    bf16_rel = train_bf16_relational(gen)
    torch.cuda.empty_cache()
    bf16_planner(g_loops, gen)
    torch.cuda.empty_cache()
    emit({"phase": "train_bf16_done", "seconds": time.perf_counter() - t0})

    # 18. partitioned training: the kernels on the ring's stage graphs,
    # one step per app and mode against the plain ring, train_partitioned
    # at every shard count, delayed and in precision × comm, the
    # power-law leg, the heavy case on reddit-like
    t0 = time.perf_counter()
    part_rows = {k: {} for k in ("spmm_csr", "sddmm_csr",
                                 "binary_reduce_csr", "edge_softmax_csr")}
    part_rows["bf16"] = {"spmm_csr": {}}
    pub = make_node_dataset(PART_DATASET, device="cuda")
    partition_kernels(pub[0], g_loops, gen, part_rows)
    torch.cuda.empty_cache()
    part_steps = [partition_step(app, pub) for app in ("gcn", "sage", "gat")]
    part_runs = partition_runs(pub)
    del pub
    part_runs.append(partition_powerlaw(gen))
    torch.cuda.empty_cache()
    part_runs += [partition_heavy(app, dataset) for app in ("gcn", "sage")]
    torch.cuda.empty_cache()
    emit({"phase": "train_partitioned_done",
          "seconds": time.perf_counter() - t0})

    # 20. the mesh ring: B1 on a rank's local stage graphs here, then the
    # ops, training and the heavy case on spawned gloo ranks
    t0 = time.perf_counter()
    mesh_rows = {}
    mesh_kernels(g_loops, gen, mesh_rows)
    torch.cuda.empty_cache()
    mesh_runs = mesh_phase(part_runs[-2:])
    emit({"phase": "mesh_done", "seconds": time.perf_counter() - t0})

    # launches on the main path: every serve, forward, fan-out and
    # training run, each counted from 0 just before it
    bf16_runs = bf16_full + [r for r in bf16_sampled + bf16_rel
                             if r["phase"] != "train_bf16_grads"]
    bf16_steps = bf16_full + [r for r in bf16_sampled + bf16_rel
                              if r["phase"] != "train_sampled"]
    runs = (list(served.values()) + list(forward.values()) + fanned + exact
            + auto + trained + sampled + relational + rel_trained
            + ell_trained + bf16_runs + part_runs + mesh_runs
            + [{"launches": r["step_launches"]}
               for r in trained + sampled_steps + rel_trained + bf16_steps]
            + [{"launches": m["step_launches"]} for r in part_steps
               for m in r["modes"].values()])
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    # the main path's shapes: serving's, and training's backward ones (B3
    # e_div_v and B4 on G have the forward's shapes)
    main = {
        "spmm_csr": [b1_rows[("self_loops", d, r)] for d, r in B1_MAIN]
        + [b1_rows[(label, d, r)] for label, shapes in TRAIN_B1.items()
           for d, r in shapes],
        "fused_attention_csr": [b2_rows[("self_loops", H, F)]
                                for H, F in B2_SHAPES],
        "sddmm_csr": [b3_rows[("self_loops",) + k] for k in B3_MAIN],
        "sddmm_csr:copy": [b3_rows[("self_loops",) + k] for k in TRAIN_B3
                           if k[0] == "copy"],
        "binary_reduce_csr": [b4_rows[("self_loops",) + k] for k in B4_MAIN]
        + [b4_rows[("reverse",) + k] for k in TRAIN_B4],
        "edge_softmax_csr": [b5_rows[("self_loops", H)] for H in B5_SHAPES]}
    # and the relational forwards' and R-GCN fan-out's (B1 on the
    # relation-expanded graphs, B3 dot / add / copy, B4 on its blocks);
    # the hetero_gspmm rows alone (the first n_forms) are checks only
    rel_b3 = list(rel_rows["sddmm_csr"].values())
    main["spmm_csr"] += list(rel_rows["spmm_csr"].values())[n_forms:]
    main["sddmm_csr"] += [r for r in rel_b3 if r["op"] != "copy"]
    main["sddmm_csr:copy"] += [r for r in rel_b3 if r["op"] == "copy"]
    main["binary_reduce_csr"] += list(rel_rows["binary_reduce_csr"].values())
    # and relational training's (B1 on the expansions' reverses and on
    # each sampled block's expanded Gᵀ, B3 dot for MoNet's ∂e)
    main["spmm_csr"] += list(train_rel_rows["spmm_csr"].values())
    main["sddmm_csr"] += list(train_rel_rows["sddmm_csr"].values())
    b3_all = {**b3_rows, **rel_rows["sddmm_csr"],
              **train_rel_rows["sddmm_csr"]}
    every = {"spmm_csr": {**b1_rows, **rel_rows["spmm_csr"],
                          **train_rel_rows["spmm_csr"]},
             "fused_attention_csr": b2_rows,
             "sddmm_csr": {k: r for k, r in b3_all.items()
                           if r["op"] != "copy"},
             "sddmm_csr:copy": {k: r for k, r in b3_all.items()
                                if r["op"] == "copy"},
             "binary_reduce_csr": {**b4_rows,
                                   **rel_rows["binary_reduce_csr"]},
             "edge_softmax_csr": b5_rows}
    # and the bf16 kernels at a bf16 training step's shapes
    for name, bf16 in bf16_rows.items():
        main[name] += list(bf16.values())
        every[name].update(bf16)
    # and partitioned training's, on the ring's stage graphs
    for name, rows in list(part_rows.items()) + list(
            part_rows["bf16"].items()):
        if name != "bf16":
            main[name] += list(rows.values())
            every[name].update(rows)
    # and the mesh ring's: B1 on a rank's local stage graphs
    main["spmm_csr"] += list(mesh_rows.values())
    every["spmm_csr"].update(mesh_rows)
    blocks = {k: list(v.values()) for k, v in block_rows.items()}
    blocks["sddmm_csr:copy"] = []
    for k, v in sampled_rows.items():      # the block Gᵀ rows
        blocks[k] += list(v.values())
    return {"kernels": [
        summary(name, SOURCES[name.split(":")[0]], REPLACES[name],
                main[name], list(every[name].values()) + blocks[name],
                launches[name], blocks[name])
        for name in main]}


if __name__ == "__main__":
    sys.exit(main())
