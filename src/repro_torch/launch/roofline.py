"""Roofline report from the dry-run JSONs, at H100 constants (port of
``repro/launch/roofline.py``, which prices v5e).

Per (arch × shape × mesh):
    compute term    = FLOPs/device          / 989.4 TFLOP/s (dense bf16)
    memory term     = HBM bytes/device      / 3.35 TB/s (HBM3)
    collective term = collective bytes/dev  / 450 GB/s (NVLink 4, one
                      direction, a mesh within one 8-GPU node) or 50 GB/s
                      (NDR InfiniBand 400 Gb/s a GPU, a mesh that spans
                      nodes: on (16, 16) and (2, 16, 16) every axis does)

Each constant is the H100 SXM5 datasheet's figure at 700 W: a datasheet
number, not a measurement. FLOPs and collective bytes come from the cell's
``tripaware`` counts (the port's ``op_analysis``, JAX's
``hlo_analysis``); the memory term uses JAX's analytic model, sized by the
cell's own mesh. MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D
(serve); ``useful_ratio`` = MODEL_FLOPS per device / counted FLOPs per
device measures how much counted compute is useful (remat, replicated
attention, padding lower it; in the port, the work a mode of the model
axis's split runs whole on every 'model' rank). ``roofline_row``
reads a cell JSON of either package.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod]
                          [--md] [--out-dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Tuple

# H100 SXM5 datasheet, 700 W
PEAK_FLOPS = 989.4e12        # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s a direction a GPU, NVLink 4
NET_BW = 50e9                # bytes/s a GPU, NDR InfiniBand 400 Gb/s
NODE_GPUS = 8                # GPUs an NVLink domain (HGX H100)

OUT_DIR = os.path.join("experiments", "dryrun_torch")


def load_cells(mesh: str = "pod", out_dir: str = OUT_DIR) -> List[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("ok"):
            out.append(r)
    return out


def mesh_shape(r: dict) -> Tuple[int, ...]:
    """The cell's mesh dims: its ``mesh_shape``, or read from JAX's label
    ("pod-16x16", "multipod-2x16x16", "debug-2x4")."""
    if r.get("mesh_shape"):
        return tuple(r["mesh_shape"])
    return tuple(int(x) for x in r["mesh"].split("-")[-1].split("x"))


def link_bw(r: dict) -> float:
    """NVLink's rate when the whole mesh fits one node, else the network's
    (every byte priced at the slower link)."""
    n = 1
    for d in mesh_shape(r):
        n *= d
    return NVLINK_BW if n <= NODE_GPUS else NET_BW


def analytic_hbm_bytes(r: dict) -> float:
    """Per-device HBM traffic model (bytes/step), JAX's:
      train   = 3 passes over TP-shard weights + optimizer state sweep
                + activation write/read per layer (remat ≈ ×2)
      prefill = 1 pass over weights + activations + cache write
      decode  = 1 pass over weights + full cache read + slot write
    with the 'model' and 'data' sizes of the cell's mesh (JAX's fixes
    model = 16, data = chips / 16: the same on its meshes)."""
    from ..configs import SHAPES, get_config
    cfg = get_config(r["arch"])
    sh = SHAPES[r["shape"]]
    chips = r["n_chips"]
    model_ax = mesh_shape(r)[-1]
    data_ax = chips // model_ax
    B, S = sh["global_batch"], sh["seq_len"]
    B_loc = max(B // data_ax, 1)
    N = cfg.param_count()
    W = N * 2                                   # bf16 weights
    D = cfg.d_model

    # per-token activation bytes per layer (residual stream, bf16),
    # sharded over model between blocks
    act_layer = B_loc * S * D * 2 / model_ax
    L = cfg.n_layers + cfg.n_enc_layers

    # kv-cache bytes (global)
    if cfg.family in ("ssm",):
        cache = 0
    else:
        n_attn = (cfg.n_layers // cfg.shared_attn_every
                  if cfg.family == "hybrid" else
                  cfg.n_layers + cfg.n_enc_layers)
        kv_s = min(S, cfg.sliding_window) if (
            cfg.sliding_window and r["shape"] == "long_500k") else S
        cache = n_attn * 2 * cfg.n_kv_heads * cfg.head_dim * kv_s * B * 2

    if r["kind"] == "train":
        w_traffic = 3 * W / model_ax            # fwd + bwd + remat-fwd
        opt = 32 * N / chips                    # f32 m,v,p,g read+write
        act = 8 * act_layer * L                 # write/read ×(fwd,bwd,remat)
        ce = 2 * 2 * B_loc * S * cfg.vocab * 4 / model_ax
        return w_traffic + opt + act + ce
    if r["kind"] == "prefill":
        return W / model_ax + 4 * act_layer * L + cache / chips
    # decode: own weight shard + the FSDP-gathered TP-shard copy + cache
    return W / chips + W / model_ax + cache / chips


def roofline_row(r: dict) -> Optional[dict]:
    ta = r.get("tripaware", {})
    if "flops_hlo" not in ta:
        return None
    chips = r["n_chips"]
    flops_dev = ta["flops_hlo"]
    hbm_dev = analytic_hbm_bytes(r)
    coll_dev = ta.get("collective_total", 0.0)

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = hbm_dev / HBM_BW
    t_coll = coll_dev / link_bw(r)

    mult = 6 if r["kind"] == "train" else 2
    model_flops = mult * r["active_params"] * r["tokens_global"]
    model_dev = model_flops / chips
    useful = model_dev / flops_dev if flops_dev else 0.0

    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    t_bound = max(terms.values())
    # achievable MFU if perfectly overlapped = useful work over bound time
    mfu_bound = model_dev / PEAK_FLOPS / t_bound if t_bound else 0.0
    return {
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "kind": r["kind"], "package": r.get("package", "repro"),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "link_bytes_per_s": link_bw(r),
        "bottleneck": bottleneck,
        "model_flops_dev": model_dev, "hlo_flops_dev": flops_dev,
        "useful_ratio": useful,
        "roofline_fraction": mfu_bound,
        "temp_bytes_dev": r.get("memory_analysis", {}).get(
            "temp_size_in_bytes"),
        "arg_bytes_dev": r.get("memory_analysis", {}).get(
            "argument_size_in_bytes"),
    }


def what_would_help(row: dict) -> str:
    b = row["bottleneck"]
    if b == "compute":
        if row["useful_ratio"] < 0.5:
            return ("compute-bound but mostly waste: cut what is repeated "
                    "(remat, work the 'model' ranks repeat; useful "
                    f"{row['useful_ratio']:.0%})")
        return "compute-bound: larger per-GPU batch or faster kernels"
    if b == "memory":
        return ("memory-bound: raise arithmetic intensity (fuse, cut remat "
                "re-reads, quantize weights for decode)")
    return ("collective-bound: shrink/overlap collectives (gather per block, "
            "reduce-scatter instead of all-reduce, bf16 or int8 grads)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod",
                    help="the cells' mesh suffix: pod, multipod (or the "
                         "suffix of cells written by hand, e.g. debug)")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    rows = []
    for r in load_cells(args.mesh, args.out_dir):
        row = roofline_row(r)
        if row:
            rows.append(row)
    rows.sort(key=lambda x: (x["arch"], x["shape"]))

    if args.md:
        print("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | "
              "t_coll (ms) | bound | useful | roofline frac |")
        print("|---|---|---|---|---|---|---|---|---|")
        for x in rows:
            print(f"| {x['arch']} | {x['shape']} | {x['mesh']} "
                  f"| {x['t_compute_s']*1e3:.1f} "
                  f"| {x['t_memory_s']*1e3:.1f} "
                  f"| {x['t_collective_s']*1e3:.1f} "
                  f"| {x['bottleneck']} "
                  f"| {x['useful_ratio']:.2f} "
                  f"| {x['roofline_fraction']:.2f} |")
    else:
        for x in rows:
            print(json.dumps(x))
            print("  ->", what_would_help(x))


if __name__ == "__main__":
    main()
