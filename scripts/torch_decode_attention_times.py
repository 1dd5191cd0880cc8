#!/usr/bin/env python3
"""The decode attention (B6, `fused_decode_attention`) alone at Llama-2-7B
widths on one NVIDIA GPU.

    python3 scripts/torch_decode_attention_times.py [--tree PATH] [--reps N]
        [--rows 6,6long,6c,6d] [--chunk-rows 32,64,128]

Runs chip_smoke.check_decode_attention of the tree at its rows: 6 (H = Hkv
= 32, D = 128, T = 384 at pos 200, bf16 rows over an int8 cache), 6long (T
= 2048 at pos 2047), 6c (T = 4096 at pos 4095, Llama-2's full context) and
6d (Mistral-7B's groups of 4, Hkv = 8, T = 2048 at pos 2047); on request
also 6m (row 6long's shape at pos 1023) and 6e (row 6d's groups at row 6's
T = 384 and pos 200). Each check
holds the kernel against its plain version (the new row's codes and scales
bit-equal) and times it with CUDA events after an L2 flush
(chip_smoke.time_ms), beside SDPA over the pre-dequantized history; this
script adds `torch.sum` over a tensor of the row's bytes after the same
flush. `--chunk-rows` times each row at each chunk of that many rows (a
multiple of 32, in place of `decode_attention.split_plan`'s own; trees
whose kernel has no split ignore it).
Prints ptxas's report of the decode attention's instances, then one JSON
list, a row a (row, chunk): ms, bound ms, library ms, plain ms, sum ms.
`--window N` instead times N `engine.decode_loop` steps of the unfused
random-weight Llama-2-7B of chip_smoke.py (int4 g128, bf16, seed 0) after a
1920-token prompt (seed 24), T = 2048, as chip_smoke's
`generate_unfused_long_8` window: the wall of each of five runs (host
clock, ending in a synchronize) and, from torch.profiler over a sixth run,
the device time by kernel. `--tree` runs the package and chip_smoke.py of
another checkout (a parent commit unpacked with `git archive`), so that both
kernels are timed on the same card in one call. Its rows' inputs
(`row_inputs`) serve scripts/torch_decode_phases.py and
torch_decode_variants.py too.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = {"6": (1, (384, 200)), "6long": (1, (2048, 2047)), "6c": (1, (4096, 4095)),
        "6d": (4, (2048, 2047)), "6m": (1, (2048, 1023)), "6e": (4, (384, 200))}
# (GQA group, (T, pos))


def row_inputs(name, gen):
    """A row's inputs at Llama-2-7B widths on the card: (q, k, v, cos, sin,
    [cache_k, cache_v, k_scale, v_scale], pos, the wrapper's keywords), bf16
    rows from `gen` over chip_smoke.random_int8_cache."""
    import torch

    import chip_smoke
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig

    group, (T, pos) = ROWS[name]
    cfg = LlamaConfig.llama2_7b()
    c = dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // group)
    H, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    q, k, v = (torch.randn(1, n * D, generator=gen, device="cuda").to(torch.bfloat16)
               for n in (H, Hkv, Hkv))
    cache = chip_smoke.random_int8_cache(c, T, pos, "cuda", gen)
    cache = [cache[f][0] for f in ("k", "v", "k_scale", "v_scale")]
    cos, sin = (t.reshape(-1) for t in llama.rope_tables(c, torch.tensor([pos], device="cuda")))
    return q, k, v, cos, sin, cache, pos, dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)


def unfused_window(steps, S=1920, T=2048):
    """Walls and device time of `steps` decode steps (see the module
    docstring)."""
    import torch

    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from torch_kernel_tools import device_window

    cfg = LlamaConfig.llama2_7b()
    model = Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device="cuda"))
    walls, by_name = device_window(chip_smoke.unfused_decode_window(model, cfg, "cuda", S=S, T=T,
                                                                    n=steps))
    dev_ms = sum(by_name.values())
    b6 = sum(v for k, v in by_name.items() if "decode" in k and "attention" in k
             or "decode_split_kernel" in k)
    res = dict(steps=steps, prompt=S, max_len=T, walls_ms=walls, device_ms=dev_ms,
               busy_share=dev_ms / min(walls), decode_attention_ms=b6,
               top_kernels_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    chip_smoke.log(f"  {steps} unfused decode steps after {S} tokens: walls "
                   f"{[round(w, 3) for w in walls]} ms; device {dev_ms:.3f} ms, of it the "
                   f"decode attention {b6:.3f} ms")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout whose package to time")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rows", default="6,6long,6c,6d")
    ap.add_argument("--chunk-rows", default="", help="comma-separated chunk sizes in rows")
    ap.add_argument("--window", type=int, default=0, help="time this many unfused decode steps")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_attention_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import decode_attention as da
    from torch_kernel_tools import sum_ms

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}  tree: {tree}")
    if args.window:
        print(json.dumps(unfused_window(args.window)))
        return 0
    for line in _build.ptxas_log("decode_attention").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            chip_smoke.log("  ptxas: " + line.strip())
    cfg = LlamaConfig.llama2_7b()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    chunks = [int(c) for c in args.chunk_rows.split(",") if c] if hasattr(da, "split_plan") else []
    plan = getattr(da, "split_plan", None)
    out = []
    try:
        for chunk in chunks or [None]:
            if chunk is not None:
                da.split_plan = functools.partial(plan, chunk_rows=chunk)
            for name in args.rows.split(","):
                group, case = ROWS[name]
                c = dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // group)
                chip_smoke.log(f" row {name}, chunk rows {chunk}")
                (r,) = chip_smoke.check_decode_attention(c, "cuda", flush, args.reps,
                                                         cases=(case,))
                s_ms = sum_ms(r["bytes"], args.reps, flush)
                chip_smoke.log(f"    torch.sum over the row's {r['bytes'] / 1e6:.3f} MB: "
                               f"{s_ms:.4f} ms")
                out.append(dict(row=name, chunk_rows=chunk, shape=r["shape"], ms=r["ms"],
                                bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                                plain_ms=r["plain_ms"], sum_ms=s_ms))
    finally:
        if plan is not None:
            da.split_plan = plan
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
