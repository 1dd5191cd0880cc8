#!/usr/bin/env python3
"""The one-token whole-model kernel (B4, `model_decode_mega`) alone at
Llama-2-7B widths on one NVIDIA GPU, on a symmetric and an asymmetric grid.

    python3 scripts/torch_mega4_times.py [--reps N] [--grids sym,asym] [--pos 200]

Builds the random-weight Llama-2-7B of chip_smoke.py (int4 g128, bf16, 32
layers; seed 0 symmetric, seed 1 asymmetric) and stacks it as the server
does (`megadecode.stack_serving`): the symmetric stack carries one zero a
linear and no bias table, the asymmetric one a table per linear. On a cache
of T=384 int8 rows (chip_smoke.random_int8_cache) at each position it times
`model_decode_mega` with CUDA events (chip_smoke.time_ms: L2 flushed before
each launch) and prints one JSON row a grid: the route's counters, the
tables streamed, the kernel's ms. Run it from two trees in one call to
compare them on the same card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grids", default="sym,asym")
    ap.add_argument("--pos", default="200")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_mega4_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import model_fused as mf
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, T = "cuda", 384
    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}  tree: {HERE}")
    _build.load("model_mega4")
    cfg = LlamaConfig.llama2_7b()
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    rows = []
    for grid in args.grids.split(","):
        symmetric = grid == "sym"
        model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
            cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0 if symmetric else 1,
            device=dev, symmetric=symmetric)))
        stack, meta = stack_serving(model)
        x = llama.embed(model.params, torch.tensor([[11]], device=dev))
        for pos in (int(p) for p in args.pos.split(",")):
            gen = torch.Generator(device=dev).manual_seed(7)
            per_layer = [chip_smoke.random_int8_cache(cfg, T, pos, dev, gen)
                         for _ in range(cfg.num_layers)]
            cache = {f: torch.stack([c[f][0] for c in per_layer]) for f in per_layer[0]}
            del per_layer
            cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
            cos, sin = cos.reshape(-1), sin.reshape(-1)
            run = lambda: mf.model_decode_mega(stack, x, cos, sin, cache, pos, cfg, meta)
            before, before4 = mf.launches, mf.launches_mega4
            run()
            torch.cuda.synchronize()
            row = dict(grid=grid, pos=pos, T=T, launches=mf.launches - before,
                       launches_mega4=mf.launches_mega4 - before4,
                       tables=sorted(k for k in stack if k.endswith("z")),
                       ms=chip_smoke.time_ms(run, args.reps, flush))
            chip_smoke.log(f"  {grid} pos={pos}: {row['ms']:.4f} ms, mega4 launches "
                           f"{row['launches_mega4']}, tables {row['tables']}")
            rows.append(row)
        del model, stack
        torch.cuda.empty_cache()
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
