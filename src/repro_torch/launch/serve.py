"""Batched LM serving loop: prefill, then greedy or temperature decode
with a KV cache (port of ``repro/launch/serve.py``, one card).

Usage (on the card; ``--device cpu`` runs on the host):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b \\
      --smoke --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device, synchronize
from ..models.lm.model import (decode_step, encode, init_cache, init_params,
                               lm_dtype, prefill)

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI on ``argv``; returns the generated tokens (B, gen) and
    the prefill / decode times (s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    B, S = args.batch, args.prompt_len
    max_seq = S + args.gen
    model = init_params(cfg, seed=args.seed, max_seq=max_seq, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=dev)

    memory = None
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
        with torch.no_grad():
            memory = encode(model, torch.as_tensor(
                frames, dtype=torch.float32, device=dev))
    positions = None
    if cfg.family == "vlm":
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(3, B, S)
    cache = init_cache(cfg, B, max_seq, lm_dtype(cfg), dev)

    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, prompts, cache, positions=positions,
                            memory=memory)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tok = torch.argmax(logits, -1)
    out_tokens = [tok]
    pos = torch.full((), S, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    # decode reads cross-attention K/V from the cache (filled at prefill)
    for _ in range(args.gen - 1):
        logits, cache = decode_step(model, tok, cache, pos)
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, -1)
        out_tokens.append(tok)
        pos = pos + 1
    synchronize(dev)
    t_decode = time.perf_counter() - t0

    tokens = torch.stack(out_tokens, 1).cpu().numpy()
    print(f"[serve] arch={cfg.name} batch={B} prompt={S} gen={args.gen}")
    print(f"[serve] prefill {t_prefill*1e3:.1f} ms "
          f"({B*S/max(t_prefill,1e-9):.0f} tok/s)")
    print(f"[serve] decode  {t_decode*1e3:.1f} ms "
          f"({B*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample tokens[0,:8] = {tokens[0, :8].tolist()}")
    return {"arch": cfg.name, "tokens": tokens, "prefill_s": t_prefill,
            "decode_s": t_decode}


if __name__ == "__main__":
    main()
