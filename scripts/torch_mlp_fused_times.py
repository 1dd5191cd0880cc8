#!/usr/bin/env python3
"""The fused MLP (B7) alone at Llama-2-7B widths on one NVIDIA GPU: the checks
and times of chip_smoke.py's phase 2 row for it, without the rest of the run.

    python3 scripts/torch_mlp_fused_times.py [--reps N] [--M 1,128,2048]

Builds mlp_fused.cu and dequant_matmul.cu, makes one layer of the unfused
random-weight Llama-2-7B (int4 g128, bf16, seed 0, as chip_smoke.py's), and
runs `chip_smoke.check_mlp_fused` on it: each M's instance, its error
against the plain version, and CUDA-event times of the kernel, PR 5's
CUDA-core kernels on the same inputs, the plain version and the unfused
route, with the P1/P2 split of the "mma" route from torch.profiler.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--M", default="1,128,2048")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_mlp_fused_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import _build

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    _build.load("mlp_fused")
    _build.load("dequant_matmul")
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=1)
    blk = Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0,
        device="cuda")).params["layers"][0]
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    rows = chip_smoke.check_mlp_fused(blk, LlamaConfig.llama2_7b(), "cuda", flush, args.reps,
                                      tuple(int(m) for m in args.M.split(",")))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
