#!/usr/bin/env python3
"""The per-layer decode kernel (B2, `block_decode_mega`) alone at Llama-2-7B
widths on one NVIDIA GPU, on a symmetric and an asymmetric grid.

    python3 scripts/torch_block_times.py [--tree PATH] [--reps N] [--rows sym:200,sym:0,asym:200]

Builds one layer of the random-weight Llama-2-7B of chip_smoke.py (int4
g128, bf16; seed 0 symmetric, seed 1 asymmetric), served as
`fuse_for_serving` serves it, and on chip_smoke.check_block's inputs (a
cache of T=384 int8 rows from chip_smoke.random_int8_cache, x from the same
generator) times `block_decode_rows` at each (grid, position) with CUDA
events (chip_smoke.time_ms: L2 flushed before each launch). Prints one JSON
list, a row a (grid, position): the launches of one call by counter (the
route it took), the kernel's ms. `--tree` runs the package and chip_smoke.py
of another checkout (a parent commit unpacked with `git archive`), so that
both kernels are timed on the same card in one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout whose package to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", default="sym:200,sym:0,asym:200")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_block_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import block_fused as bf
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, T = "cuda", 384
    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}  tree: {tree}")
    cfg = LlamaConfig.llama2_7b()
    one = dataclasses.replace(cfg, num_layers=1)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    counters = [n for n in ("launches", "launches_mega4") if hasattr(bf, n)]
    rows, models = [], {}
    for grid, pos in (r.split(":") for r in args.rows.split(",")):
        if grid not in models:
            models[grid] = fuse_for_serving(Model(config=one, params=build_quantized_llama(
                one, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0 if grid == "sym" else 1,
                device=dev, symmetric=grid == "sym")))
        blk, pos = models[grid].params["layers"][0], int(pos)
        gen = torch.Generator(device=dev).manual_seed(2)
        cache = chip_smoke.random_int8_cache(cfg, T, pos, dev, gen)
        x = torch.randn(1, 1, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
        cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
        cos, sin = cos.reshape(-1), sin.reshape(-1)
        run = lambda: bf.block_decode_rows(blk, blk["mega"], x, cos, sin, cache, pos, cfg)
        before = {n: getattr(bf, n) for n in counters}
        run()
        torch.cuda.synchronize()
        row = dict(grid=grid, pos=pos, T=T,
                   launches={n: getattr(bf, n) - before[n] for n in counters},
                   ms=chip_smoke.time_ms(run, args.reps, flush))
        chip_smoke.log(f"  {grid} pos={pos}: {row['ms']:.4f} ms, launches {row['launches']}")
        rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
