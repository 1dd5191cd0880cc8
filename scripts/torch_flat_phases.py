#!/usr/bin/env python3
"""Where the port's flat decode kernel (B3, 4-bit words) spends its time, phase by
phase, on one NVIDIA GPU.

    python3 scripts/torch_flat_phases.py [--sass] [--seg KSEG]

Copies mi_optimize_tpu_torch/csrc/ to build/flat_phases/csrc/, where thread 0 of
every block of model_flat_kernel<T, 4> (flat4_model in flat_model.cuh) stamps
%globaltimer at each step of its phase loop: before and after the residual,
after the GEMV, after priming the next GEMV, after the grid barrier, and in P1
after attention and its barrier (scripts/torch_kernel_tools.py). It builds
the copy with the package's nvcc flags, times the package's own build and
the stamped copy with CUDA events at Llama-2-7B (random int4 g128 weights,
bf16, T = 384, positions 200 and 0), and prints, over layers 1..L-1, the
mean and the slowest block's microseconds of each segment (a barrier's is
the wait of the blocks that reached it first).
`--seg KSEG` also times the multi-token kernel (model_flat_seg_kernel<T, 4>,
the same loop once a token) for KSEG tokens from position 200 and prints its
last token's segments, which overwrite the earlier tokens' stamps.
`--sass` also counts, in cuobjdump's SASS of the package's build, the
instructions of model_flat_kernel<bf16, 4> (with --seg, also of
model_flat_seg_kernel<bf16, 4>) and of its chunk loop (the innermost loop
holding its mma instructions: static size, every path).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# thread 0 of each block stamps step k of loop step l (136 steps at most, 272 blocks)
STAMP_DIMS = (136, 8, 272)
FT_MACRO = "#define FT(l, k) if (threadIdx.x == 0) g_pt[l][k][blockIdx.x] = gtime();"
# (line of flat4_model, the same line with its stamp)
STAMP_AT = [
    ("    const bool lm = st == 4 * L;\n", "    const bool lm = st == 4 * L;\n    FT(st, 0)\n"),
    ("    float* out = lm ? f.logits", "    FT(st, 1)\n    float* out = lm ? f.logits"),
    ("    if constexpr (X::kSeg) {\n      if (!lm) fg_prime",
     "    FT(st, 2)\n    if constexpr (X::kSeg) {\n      if (!lm) fg_prime"),
    ("    grid.sync();\n    if (p == 0) {\n",
     "    FT(st, 3)\n    grid.sync();\n    FT(st, 4)\n    if (p == 0) {\n"),
    ("      grid.sync();\n    }\n  }\n",
     "      FT(st, 5)\n      grid.sync();\n      FT(st, 6)\n    }\n  }\n")]
# (step of the loop: 0 qkv, 1 o_proj, 2 gate/up, 3 down_proj; decoder phase,
# segment, first stamp, last stamp)
SEGMENTS = [(0, "P1", "residual", 0, 1), (0, "P1", "qkv GEMV", 1, 2), (0, "P1", "prime", 2, 3),
            (0, "P1", "barrier", 3, 4), (0, "P2", "attention", 4, 5), (0, "P2", "barrier", 5, 6),
            (1, "P3", "o_proj GEMV", 1, 2), (1, "P3", "prime", 2, 3), (1, "P3", "barrier", 3, 4),
            (2, "P4", "residual", 0, 1), (2, "P4", "gate/up GEMV", 1, 2), (2, "P4", "prime", 2, 3),
            (2, "P4", "barrier", 3, 4), (3, "P5", "down_proj GEMV", 1, 2), (3, "P5", "prime", 2, 3),
            (3, "P5", "barrier", 3, 4)]


def ptxas_line(log):
    """Registers and spills of model_flat_kernel<bf16, 4> from an nvcc log."""
    import chip_smoke

    rows = chip_smoke.ptxas_rows(log, r"model_flat_kernelI13__nv_bfloat16Li4E", lambda m: "")
    if not rows:
        raise SystemExit("ptxas reported no model_flat_kernel<bf16, 4>")
    r = rows[0]
    return (f"{r['stack']} bytes stack frame, {r['spill_stores']} bytes spill stores, "
            f"{r['spill_loads']} bytes spill loads; {r.get('registers')} registers")


def sass_counts(lib, cuobjdump, kernel="model_flat_kernel"):
    """Print the SASS instructions of `kernel`<bf16, 4> in `lib` and of the
    smallest loop (a backward branch) around its first mma."""
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f"{kernel}I13__nv_bfloat16Li4E" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    first = next(a for a, op in ins if "HMMA" in op)
    loops = [(t, a) for a, op in ins for t in [int(x, 16) for x in
                                               re.findall(r"BRA[^;]*?0x([0-9a-f]+)", op)]
             if t <= first <= a]
    lo, hi = min(loops, key=lambda x: x[1] - x[0])
    n = sum(lo <= a <= hi for a, _ in ins)
    print(f"SASS: {kernel}<bf16, 4> {len(ins)} instructions; its chunk loop {n} "
          f"({sum('HMMA' in op for a, op in ins if lo <= a <= hi)} mma)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", action="store_true", help="count the kernel's SASS instructions")
    ap.add_argument("--seg", type=int, default=0, help="also the multi-token kernel, KSEG tokens")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_flat_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch_kernel_tools as tk
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import _build, coop_plan
    from mi_optimize_tpu_torch.ops import model_flat as mf
    from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat, stack_flat
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    print(f"gpu: {cs.nvidia_smi_line()}")
    # the stamps in flat_model.cuh (the loop that model_flat.cu's kernel runs)
    src = tk.stamped_copy("flat_phases", "flat_model.cuh", '#include "flat_gemv.cuh"\n',
                          tk.stamp_prelude(STAMP_DIMS, FT_MACRO), STAMP_AT)
    out = os.path.join(src, "model_flat.so")
    proc = tk.start_build(src, "model_flat.cu", out)
    plain = _build.load("model_flat")  # the package's build, meanwhile
    log = tk.finish_build(proc, "the stamped copy")
    print(f"ptxas (package): {ptxas_line(_build.ptxas_log('model_flat'))}")
    print(f"ptxas (stamped): {ptxas_line(log)}")
    stamped = ctypes.CDLL(out)
    if args.sass:
        for kernel in ("model_flat_kernel",) + (("model_flat_seg_kernel",) if args.seg else ()):
            sass_counts(plain._name, os.path.join(os.path.dirname(_build.nvcc_path()),
                                                  "cuobjdump"), kernel)
    cfg = LlamaConfig.llama2_7b()
    dev = "cuda"
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device=dev, symmetric=True)))
    fstack, fmeta = stack_flat(model)
    plans = mf.flat_plans(cfg, fmeta, coop_plan.sm_count(torch.device(dev)))
    print("plan (ws, splits):", [pl[3:] for pl in plans])
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    L = cfg.num_layers

    def report(what, run):
        ms = {lib: cs.time_ms(lambda: run(lib), 10, flush)
              for lib in (plain, stamped)}  # the stamps are the last timed launch's
        buf = tk.read_stamps(stamped, STAMP_DIMS)
        t = buf[:, :, :264].astype(np.float64) / 1e3
        layer = np.mean([t[4 * (l + 1), 0, 0] - t[4 * l, 0, 0] for l in range(1, L - 1)])
        lm = t[4 * L, 2] - t[4 * L, 1]
        print(f"{what}: {ms[plain]:.4f} ms package build, {ms[stamped]:.4f} ms stamped; "
              f"a layer {layer:.2f} us; lm_head GEMV mean {lm.mean():.2f}, "
              f"slowest {lm.max():.2f} us")
        for p, phase, name, a, b in SEGMENTS:
            d = np.stack([t[4 * l + p, b] - t[4 * l + p, a] for l in range(1, L)])
            print(f"  {phase} {name:15s} mean {d.mean():7.2f}  "
                  f"slowest block {d.max(axis=1).mean():7.2f} us")

    for pos in (200, 0):
        gen = torch.Generator(device=dev).manual_seed(3)
        cache = stack_cache_flat([cs.random_int8_cache(cfg, 384, pos, dev, gen) for _ in range(L)])
        x = llama.embed(model.params, torch.tensor([[7]], device=dev))
        cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
        cos, sin = cos.reshape(-1), sin.reshape(-1)
        report(f"T=384 pos={pos}", lambda lib: mf.flat_launch(
            "mi_model_decode_flat", fstack, x, cos, sin, cache, pos, cfg, fmeta, lib=lib))
        if args.seg and pos:
            k = args.seg
            cos, sin = llama.rope_tables(cfg, pos + torch.arange(k, device=dev))
            report(f"T=384 pos0={pos} kseg={k}, token {k - 1}", lambda lib: mf.flat_launch(
                "mi_model_decode_flat_seg", fstack, x, cos, sin, cache, pos, cfg, fmeta, kseg=k,
                emb=model.params["embed"], lib=lib))
    return 0


if __name__ == "__main__":
    sys.exit(main())
