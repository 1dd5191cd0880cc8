#!/usr/bin/env python3
"""Where the decode attention (B6, csrc/decode_attention.cu) spends its
time, block by block, on one NVIDIA GPU.

    python3 scripts/torch_decode_phases.py [--rows 6,6long,6c,6d] [--reps N]

Copies mi_optimize_tpu_torch/csrc/ to build/decode_phases/csrc/, where thread 0 of
every block of decode_split_kernel stamps %globaltimer and its SM: at entry,
once its q heads are roped (and, in the chunk that holds the position, the
new row made), once its first slab has landed, after its slab loop, at its
arrival and after the last item's merge (scripts/torch_kernel_tools.py). It
builds the copy with the package's nvcc flags and runs it through the package's wrapper
(`_build.load` pointed at the copy) on the inputs of
scripts/torch_decode_attention_times.py's rows. For the package's own build
it prints the time of one launch after an L2 flush (chip_smoke.time_ms)
beside torch.sum over as many bytes as the row's live history after the same
flush; for the stamped copy, the span from the first block's entry to the
last stamp, the blocks and SMs, and each step's mean and slowest time over
the blocks (the merge over the last items). Prints one JSON list, a row a
row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# (a line of decode_split_kernel, the same line with its stamp); stamp 6 is the SM
STAMP_AT = [
    ("  const int c = blockIdx.x, n_live = gridDim.x;",
     "  PT_(0)\n  PT_SM(6)\n  const int c = blockIdx.x, n_live = gridDim.x;"),
    ("  rs.init(qs, nr, D, lane);\n", "  rs.init(qs, nr, D, lane);\n  PT_(1)\n"),
    ("    fetch(u + RING - 1);        // into the stage slab u - 1 left\n",
     "    fetch(u + RING - 1);        // into the stage slab u - 1 left\n    if (u == 0) PT_(2)\n"),
    ("  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n  PT_(3)\n"),
    ("  if (!is_last) return;\n", "  PT_(4)\n  if (!is_last) return;\n"),
    ("out[(long)h * D + tid + DT * i] = A[h][i] / L[h];\n}\n",
     "out[(long)h * D + tid + DT * i] = A[h][i] / L[h];\n  PT_(5)\n}\n"),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="6,6long,6c,6d")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_kernel_tools as tk
    from torch_decode_attention_times import row_inputs
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import decode_attention as da

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    src = tk.stamped_copy("decode_phases", "decode_attention.cu", '#include "decode_common.cuh"\n',
                          tk.stamp_prelude((7, tk.MAXB)), STAMP_AT)
    lib = os.path.join(os.path.dirname(src), "libdecode_stamped.so")
    tk.finish_build(tk.start_build(src, "decode_attention.cu", lib), "the stamped copy")
    stamped = ctypes.CDLL(lib)
    own = _build.load("decode_attention")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for name in args.rows.split(","):
        q, k, v, cos, sin, cache, pos, kw = row_inputs(name, gen)
        H, Hkv, D = kw["n_heads"], kw["n_kv_heads"], kw["head_dim"]
        run = lambda: da.fused_decode_attention(q, k, v, cos, sin, *cache, pos, **kw)[0]
        res = dict(row=name, split=da.split_plan(H, Hkv, D, kw["max_len"], pos))
        res["flushed_ms"] = chip_smoke.time_ms(run, args.reps, flush)
        res["sum_of_live_bytes_ms"] = tk.sum_ms((pos + 1) * Hkv * (2 * D + 8), args.reps, flush)
        # the stamped copy through the same wrapper, against the package's bits
        want = run()
        _build._libs["decode_attention"] = stamped
        try:
            tk.clear_stamps(stamped)
            flush.zero_()
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError("the stamped copy gave other bits")
            t = tk.read_stamps(stamped, (7, tk.MAXB))
        finally:
            _build._libs["decode_attention"] = own
        blk = t[6] > 0
        t0 = t[0][blk].min()
        st = {k: (t[k][blk].astype(np.int64) - int(t0)) / 1e3 for k in range(6)}
        last = t[5][blk] > 0
        us = lambda x: [float(x.mean()), float(x.max())] if x.size else None
        res.update(
            blocks=int(blk.sum()), sms=int(len(set(t[6][blk]))),
            span_us=float(max(st[k][t[k][blk] > 0].max() for k in range(6)
                              if (t[k][blk] > 0).any())),
            entry_us=us(st[0]), prologue_us=us(st[1] - st[0]),
            first_slab_us=us(st[2] - st[1]), loop_us=us(st[3] - st[2]),
            loop_end_us=us(st[3]),
            arrival_us=us((st[4] - st[3])[t[4][blk] > 0]),
            merge_us=us((st[5] - st[4])[last]))
        chip_smoke.log(f"  row {name}: {json.dumps(res)}")
        out.append(res)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
