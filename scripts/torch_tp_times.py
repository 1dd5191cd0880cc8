#!/usr/bin/env python3
"""Time the tensor-parallel kernels of one checkout on one NVIDIA GPU: B5(e)
(`tp_kernel`, chip_smoke.check_mega_batch_tp: dense and paged at the batched
row's positions 0/17/64/127/128/200/383/510, and dense with one slot at 510
and seven at 0), B11 (`ring_chunk`, chip_smoke.check_ring) and the batched
kernel's mode (a) row (chip_smoke.check_mega_batch), each with that
checkout's own checks and timers, on the Llama-2-7B random-weight model
(int4 g128, bf16, seed 0, as chip_smoke.py builds it).

    python3 scripts/torch_tp_times.py [--tree DIR] [--build-only] [--report PATH]

--tree: the checkout to run (default: this one), e.g. a parent unpacked
with `git archive` under build/; run parent, this, this, parent in one call
to compare them on one card. --build-only builds that checkout's three
sources (model_fused, model_fused_tp, overlap) and stops: start the two
trees' builds together first. The report (JSON) holds the GPU line, the
kernel rows and ptxas's rows of the three sources' instances.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("model_fused", "model_fused_tp", "overlap")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="the checkout whose package and checks run")
    ap.add_argument("--build-only", action="store_true", help="build the kernels and stop")
    ap.add_argument("--report", help="write the rows as JSON to this path")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_tp_times: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mi_optimize_tpu_torch.ops import _build

    t0 = time.perf_counter()
    jobs = {n: _build._start(n) for n in SOURCES}
    for n in SOURCES:
        _build._finish(n, jobs[n])
    cs.log(f"{tree}: built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    if args.build_only:
        return 0

    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.log(f"gpu: {smi}")
    ptxas = []
    for source, pattern, label in cs.PTXAS_KERNELS:
        if source in SOURCES:
            ptxas += cs.ptxas_rows(_build.ptxas_log(source), pattern, label)
    for r in ptxas:
        cs.log(f"  ptxas: {r['instance']}: {r.get('registers')} registers, "
               f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")
    dev = "cuda"
    cfg = LlamaConfig.llama2_7b()
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device=dev, symmetric=True)))
    stack, meta = stack_serving(model)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    dense = [0, 17, 64, 127, 128, 200, 383, 510]
    rows = cs.check_mega_batch(model, stack, meta, cfg, dev, flush, 5, dense)
    rows += cs.check_mega_batch_tp(model, stack, meta, cfg, dev, flush, 5, dense)
    rows += cs.check_mega_batch_tp(model, stack, meta, cfg, dev, flush, 5, dense, paged=True)
    rows += cs.check_mega_batch_tp(model, stack, meta, cfg, dev, flush, 5, [510] + [0] * 7)
    rows += cs.check_ring(model, cfg, dev, flush, 5)
    for r in rows:
        extra = f", CUDA-core tiles {r['cuda_core_ms']:.4f} ms" if r.get("cuda_core_ms") else ""
        cs.log(f"row {r['name']} | {r['shape']} | {r['ms']:.4f} ms{extra} | plain "
               f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        keep = ("name", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "cuda_core_ms",
                "max_abs_err", "bytes", "flops")
        with open(args.report, "w") as f:
            json.dump({"tree": tree, "gpu": smi, "ptxas": ptxas,
                       "rows": [{k: r.get(k) for k in keep} for r in rows]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
