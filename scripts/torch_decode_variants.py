#!/usr/bin/env python3
"""Build copies of csrc/decode_attention.cu side by side and time the decode
attention (B6) of each on one NVIDIA GPU.

    python3 scripts/torch_decode_variants.py DIR [DIR ...] [--rows 6,6long,6c,6d]
        [--chunk-rows 0,64] [--reps N]

Each DIR holds a copy of mi_optimize_tpu_torch/csrc (decode_attention.cu and
the headers it includes), edited; the package's own csrc may be one of them.
Each is built with the package's nvcc flags (one nvcc each, all started
together) into build/decode_variants/<i>.so, and ptxas's registers, spills
and stack of each decode_split_kernel instance are printed
(scripts/torch_kernel_tools.py). On the inputs of
scripts/torch_decode_attention_times.py's rows (chip_smoke.random_int8_cache,
bf16 rows), each build runs through the package's wrapper at each chunk of
`--chunk-rows` rows (a multiple of 32; 0: the split plan's own chunk); the
report gives its output's largest difference from the plain version
relative to max|plain|, whether its output and cache equal the first
build's bits (an ablation that skips work will not), and its time with CUDA
events after an L2 flush (chip_smoke.time_ms), in turn over the builds and
again in reverse order. Prints one JSON list, a row a (build, row,
chunk).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rows", default="6,6long,6c,6d")
    ap.add_argument("--chunk-rows", default="0")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_kernel_tools as tk
    from torch_decode_attention_times import row_inputs
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import decode_attention as da

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    (_, pattern, label), = [k for k in chip_smoke.PTXAS_KERNELS if k[0] == "decode_attention"]
    libs = [lib for lib, _ in tk.build_copies(args.dirs, "decode_attention.cu", "decode_variants",
                                              pattern, label)]
    own = _build.load("decode_attention")
    plan = da.split_plan
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = []
    try:
        for chunk in [int(c) for c in args.chunk_rows.split(",")]:
            da.split_plan = functools.partial(plan, chunk_rows=chunk or None)
            for name in args.rows.split(","):
                q, k, v, cos, sin, cache, pos, kw = row_inputs(name, gen)
                ref = da.fused_decode_attention_ref(q, k, v, cos, sin, *[t.clone() for t in cache],
                                                    pos, **kw)[0]
                first = None
                res = []
                for i, lib in enumerate(libs):
                    _build._libs["decode_attention"] = lib
                    mine = [t.clone() for t in cache]
                    got = da.fused_decode_attention(q, k, v, cos, sin, *mine, pos, **kw)[0]
                    torch.cuda.synchronize()
                    if first is None:
                        first = (got, mine)
                    same = bool(torch.equal(got, first[0]) and all(
                        torch.equal(a, b) for a, b in zip(mine, first[1])))
                    err = float((got - ref).abs().max() / ref.abs().max())
                    res.append(dict(build=args.dirs[i], row=name, chunk_rows=chunk,
                                    rel_err=err, same_bits=same, ms=[]))
                order = list(range(len(libs)))
                for i in order + order[::-1]:
                    _build._libs["decode_attention"] = libs[i]
                    mine = [t.clone() for t in cache]
                    res[i]["ms"].append(chip_smoke.time_ms(
                        lambda: da.fused_decode_attention(q, k, v, cos, sin, *mine, pos, **kw),
                        args.reps, flush))
                for r in res:
                    chip_smoke.log(f"  {r['build']} row {name} chunk {chunk}: "
                                   f"{' / '.join(f'{m:.4f}' for m in r['ms'])} ms, error "
                                   f"{r['rel_err']:.2e} of max|plain|, same bits "
                                   f"{r['same_bits']}")
                out += res
    finally:
        _build._libs["decode_attention"] = own
        da.split_plan = plan
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
