#!/usr/bin/env python3
"""The paged flash decode (B8, `paged_flash_attention`) alone at Llama-2-7B
widths on one NVIDIA GPU.

    python3 scripts/torch_paged_times.py [--tree PATH] [--reps N] [--chunk-rows 16,32,64]

Runs chip_smoke.check_paged_attention of the tree at its rows: 8 (4 slots
at positions 37/200/333/511, pages of 16, 32 a slot, bf16 q over an f32
pool), 8b (one slot at position 511) and 8c (the row-8 positions with a GQA
group of 4, Hkv = H/4). Each check holds the kernel against its plain
version and the same bits on a second launch, and times it with CUDA events
after an L2 flush (chip_smoke.time_ms), beside SDPA over the pre-gathered
pages. `--chunk-rows` times each row at each chunk of that many rows
(`paged_attention.CHUNK_ROWS`; trees whose kernel has no split ignore it).
Prints ptxas's report of the paged kernel's instances, then one JSON list, a
row a (row, chunk): ms, bound ms, library ms. `--batcher N` instead times N
`PagedBatcher` steps at 4 active slots on the random-weight Llama-2-7B of
chip_smoke.py (int4 g128, bf16, seed 0; pages of 16, an f32 pool; prompts of
16-200 tokens from seed 11, as chip_smoke's `paged_batcher_step_4` window),
five times: the wall of each run (host clock, ending in a synchronize) and,
from torch.profiler over a sixth run, the device time by kernel
(scripts/torch_kernel_tools.py). `--tree`
runs the package and chip_smoke.py of another checkout (a parent commit
unpacked with `git archive`), so that both kernels are timed on the same
card in one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = {"8": dict(), "8b": dict(positions=(511,)), "8c": dict(gqa=4)}


def batcher_window(steps):
    """Walls and device time of `steps` PagedBatcher steps (see the module
    docstring)."""
    import numpy as np
    import torch

    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.serving.paged import PagedBatcher
    from torch_kernel_tools import device_window

    cfg = LlamaConfig.llama2_7b()
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device="cuda")))
    b = PagedBatcher(model, n_slots=4, page_size=16, n_pages=1 + 4 * 32, pages_per_slot=32)
    rng = np.random.default_rng(11)
    for n in rng.integers(16, 201, 4):
        b.add_request(rng.integers(0, cfg.vocab_size, (int(n),)), max_new_tokens=7 * steps + 8)
    walls, by_name = device_window(lambda: [b.step() for _ in range(steps)])
    if any(r is None for r in b.slot_req):
        raise AssertionError("a slot freed during the window")
    res = dict(steps=steps, walls_ms=walls, device_ms=sum(by_name.values()),
               paged_attention_ms=sum(v for k, v in by_name.items() if "paged" in k),
               top_kernels_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    chip_smoke.log(f"  PagedBatcher, {steps} steps at 4 slots: walls "
                   f"{[round(w, 3) for w in walls]} ms; device {res['device_ms']:.3f} ms, of "
                   f"it the paged attention {res['paged_attention_ms']:.3f} ms")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout whose package to time")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rows", default="8,8b,8c")
    ap.add_argument("--chunk-rows", default="", help="comma-separated chunk sizes in rows")
    ap.add_argument("--batcher", type=int, default=0, help="time this many PagedBatcher steps")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("torch_paged_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import paged_attention as pa

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}  tree: {tree}")
    if args.batcher:
        print(json.dumps(batcher_window(args.batcher)))
        return 0
    for line in _build.ptxas_log("paged_attention").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            chip_smoke.log("  ptxas: " + line.strip())
    cfg = LlamaConfig.llama2_7b()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    chunks = [int(c) for c in args.chunk_rows.split(",") if c] if hasattr(pa, "CHUNK_ROWS") else []
    out = []
    for chunk in chunks or [None]:
        if chunk is not None:
            pa.CHUNK_ROWS = chunk
        for name in args.rows.split(","):
            spec = dict(ROWS[name])
            c = cfg
            if "gqa" in spec:
                c = dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // spec.pop("gqa"))
            chip_smoke.log(f" row {name}, chunk rows {chunk}")
            (r,) = chip_smoke.check_paged_attention(c, "cuda", flush, args.reps, **spec)
            out.append(dict(row=name, chunk_rows=chunk, shape=r["shape"], ms=r["ms"],
                            bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
