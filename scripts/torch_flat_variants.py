#!/usr/bin/env python3
"""Build copies of csrc/model_flat.cu side by side and time the flat kernels
of each on one NVIDIA GPU: ptxas's registers and spills of the 4-bit
instances, then the multi-token flat decode (B10) and the flat kernel (B3)
at Llama-2-7B width.

    python3 scripts/torch_flat_variants.py DIR [DIR ...] [--models 7b,draft] [--kseg 5]

Each DIR holds a copy of mi_optimize_tpu_torch/csrc (model_flat.cu and the
headers it includes), edited; the package's own csrc may be one of them.
Each is built with the package's nvcc flags (one nvcc each, all started
together) into build/flat_variants/<i>.so (scripts/torch_kernel_tools.py),
and ptxas's rows of its 4-bit instances are printed. On chip_smoke.py's
random-weight Llama-2-7B (int4 g128, bf16, seed 0) and its planted 2-layer
draft, from position 200 of a random int8 history
(chip_smoke.random_int8_cache), it checks that each build's segment gives
the package build's bits, then times with CUDA events (chip_smoke.time_ms:
L2 flushed before each call): kseg launches of the package build's flat
kernel, one after the other (as chip_smoke.check_flat_seg times them), then
in turn over the builds and again in reverse order the segment of kseg
tokens and one flat launch.
Prints one JSON list, a row a (build, model).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# the 4-bit flat instances whose ptxas rows are printed
PTXAS_PATTERN = r"(model_flat(?:_seg)?_kernel)I(f|13__nv_bfloat16)Li4E"


def ptxas_label(m):
    return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, 4>"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--models", default="7b,draft")
    ap.add_argument("--kseg", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flat_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_kernel_tools as tk
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import model_flat as mf
    from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat, stack_flat
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
    from mi_optimize_tpu_torch.utils.planted import planted_pair

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    libs = [(d, lib, rows) for d, (lib, rows) in zip(args.dirs, tk.build_copies(
        args.dirs, "model_flat.cu", "flat_variants", PTXAS_PATTERN, ptxas_label))]

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, T, pos0, kseg = "cuda", 384, 200, args.kseg
    cfg = LlamaConfig.llama2_7b()
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    result = []
    for name in args.models.split(","):
        if name == "7b":
            model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
                cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device=dev)))
        else:
            model = fuse_for_serving(planted_pair(cfg, draft_layers=2, device=dev)[1])
        mcfg = model.config
        fstack, fmeta = stack_flat(model)
        gen = torch.Generator(device=dev).manual_seed(40 + mcfg.num_layers)
        cache = stack_cache_flat([chip_smoke.random_int8_cache(mcfg, T, pos0, dev, gen)
                                  for _ in range(mcfg.num_layers)])
        x = llama.embed(model.params, torch.tensor([[7]], device=dev))
        cos, sin = llama.rope_tables(mcfg, pos0 + torch.arange(kseg, device=dev))
        emb = model.params["embed"]
        seg = lambda lib: mf.flat_launch("mi_model_decode_flat_seg", fstack, x, cos, sin, cache,
                                         pos0, mcfg, fmeta, kseg=kseg, emb=emb, lib=lib)
        flat = lambda lib: mf.flat_launch("mi_model_decode_flat", fstack, x, cos[:1], sin[:1],
                                          cache, pos0, mcfg, fmeta, lib=lib)
        want = seg(None)

        def flat_chain():  # kseg one-token launches of the package build, as chip_smoke times them
            for t in range(kseg):
                mf.flat_launch("mi_model_decode_flat", fstack, x, cos[t:t + 1], sin[t:t + 1],
                               cache, pos0 + t, mcfg, fmeta)

        chain_ms = chip_smoke.time_ms(flat_chain, args.reps, flush)
        chip_smoke.log(f"  {name}: {kseg} model_decode_flat launches {chain_ms:.4f} ms")
        times = {d: {"seg": [], "flat": []} for d, _, _ in libs}
        for order in (libs, libs[::-1]):
            for d, lib, _ in order:
                got = seg(lib)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                times[d]["same_bits"] = same
                times[d]["seg"].append(chip_smoke.time_ms(lambda: seg(lib), args.reps, flush))
                times[d]["flat"].append(chip_smoke.time_ms(lambda: flat(lib), args.reps, flush))
        for d, _, rows in libs:
            t = times[d]
            row = dict(build=d, model=name, kseg=kseg, seg_ms=t["seg"], flat_ms=t["flat"],
                       flat_chain_ms=chain_ms, same_bits=t["same_bits"], ptxas=rows)
            chip_smoke.log(f"  {name} {d}: segment {t['seg']} ms, flat {t['flat']} ms, "
                           f"bits {'same' if t['same_bits'] else 'DIFFERENT'}")
            result.append(row)
        del model, fstack, cache
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
