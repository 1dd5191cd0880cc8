#!/usr/bin/env python3
"""Where the paged flash decode (B8, csrc/paged_attention.cu) spends its
time, block by block, on one NVIDIA GPU.

    python3 scripts/torch_paged_phases.py [--rows 8,8b,8c] [--reps N]

Copies mi_optimize_tpu_torch/csrc/ to build/paged_phases/csrc/, where thread 0 of
every block of paged_split_kernel stamps %globaltimer and its SM: at entry,
once its first slab has landed, after its slab loop, after its arrival (the
last item only) and after its merge. It builds the copy with the package's
nvcc flags and runs it through the package's wrapper (`_build.load`
pointed at the copy) on chip_smoke.check_paged_attention's inputs of each
row (as in scripts/torch_paged_times.py). For the package's own build it
prints the time of one launch after an L2 flush (chip_smoke.time_ms, which
writes the flush buffer, and the same after a flush that reads it), of one
of 20 back-to-back launches (CUDA events), and torch.profiler's device time
a launch; beside them, torch.sum over as many bytes as the row's live k/v
rows after either flush; for the stamped copy, the span from the first block's entry
to the last stamp, the blocks that read rows and those that exit at once,
the spread of entry times, each step's mean and slowest time over the
blocks that read rows, and the merge of the last items. Prints one JSON
list, a row a row.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

# (a line of paged_split_kernel, the same line with its stamp); stamp 5 is the SM
STAMP_AT = [
    ("  const int c = blockIdx.x, b = blockIdx.z;\n",
     "  PT_(0)\n  PT_SM(5)\n  const int c = blockIdx.x, b = blockIdx.z;\n"),
    ("    fetch(u + RING - 1);        // into the stage slab u - 1 left\n",
     "    fetch(u + RING - 1);        // into the stage slab u - 1 left\n    if (u == 0) PT_(1)\n"),
    ("  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n  PT_(2)\n"),
    ("  if (!is_last) return;\n", "  if (!is_last) return;\n  PT_(3)\n"),
    ("    out[(bh0 + h) * D + tid] = from_f<TQ>(A / L);\n  }\n}\n",
     "    out[(bh0 + h) * D + tid] = from_f<TQ>(A / L);\n  }\n  PT_(4)\n}\n"),
]


def row_inputs(cfg, positions, P=16, pps=32, dev="cuda"):
    """chip_smoke.check_paged_attention's inputs: bf16 q, f32 pool."""
    import torch

    from mi_optimize_tpu_torch.ops import paged_attention as pa

    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, n_pages = len(positions), 1 + len(positions) * pps
    gen = torch.Generator(device=dev).manual_seed(14)
    q32 = torch.randn(B, H * D, generator=gen, device=dev)
    pk = torch.randn(n_pages, P, Hkv, D, generator=gen, device=dev)
    pv = torch.randn(n_pages, P, Hkv, D, generator=gen, device=dev)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(
        B, pps).int().cpu()
    tdev, pdev = (t.to(dev) for t in pa.check_table(table, positions, B, n_pages, P))
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, page_size=P)
    return (q32.to(torch.bfloat16), pk, pv, tdev, pdev), kw


def read_flushed_ms(fn, reps, flush):
    """chip_smoke.time_ms with an L2 flush that reads `flush` (a sum)
    instead of writing it."""
    import torch

    import chip_smoke

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.sum(dtype=torch.int32)
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="8,8b,8c")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_paged_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_kernel_tools as tk
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import paged_attention as pa

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    src = tk.stamped_copy("paged_phases", "paged_attention.cu", '#include "decode_common.cuh"\n',
                          tk.stamp_prelude((6, tk.MAXB)), STAMP_AT)
    lib = os.path.join(os.path.dirname(src), "libpaged_stamped.so")
    tk.finish_build(tk.start_build(src, "paged_attention.cu", lib), "the stamped copy")
    stamped = ctypes.CDLL(lib)
    own = _build.load("paged_attention")
    cfg = LlamaConfig.llama2_7b()
    rows = {"8": (cfg, (37, 200, 333, 511)), "8b": (cfg, (511,)),
            "8c": (dataclasses.replace(cfg, num_kv_heads=cfg.num_heads // 4), (37, 200, 333, 511))}
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    out = []
    for name in args.rows.split(","):
        c, positions = rows[name]
        inputs, kw = row_inputs(c, positions)
        res = dict(row=name, positions=list(positions), n_kv_heads=c.num_kv_heads,
                   split=pa.split_plan(c.num_heads, c.num_kv_heads, 16, 32))
        run = lambda: pa.paged_flash_attention(*inputs, **kw)
        res["flushed_ms"] = chip_smoke.time_ms(run, args.reps, flush)
        # the same after a flush that reads (L2 left clean, not dirty), and a
        # library read of the row's live k/v bytes (torch.sum) after each
        res["read_flushed_ms"] = read_flushed_ms(run, args.reps, flush)
        kv_bytes = sum(p + 1 for p in positions) * c.num_kv_heads * c.head_dim * 2 * 4
        res["sum_of_live_bytes_ms"] = tk.sum_ms(kv_bytes, args.reps, flush)
        res["sum_of_live_bytes_read_flushed_ms"] = tk.sum_ms(kv_bytes, args.reps, flush,
                                                             read_flushed_ms)
        run()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            run()
        b.record()
        b.synchronize()
        res["back_to_back_ms"] = a.elapsed_time(b) / 20
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        res["profiler_ms"] = dev_us / 1e3 / 20
        # the stamped copy through the same wrapper
        _build._libs["paged_attention"] = stamped
        try:
            want = run()
            tk.clear_stamps(stamped)
            flush.zero_()
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError("the stamped copy gave other bits")
            t = tk.read_stamps(stamped, (6, tk.MAXB))
        finally:
            _build._libs["paged_attention"] = own
        live = t[5] > 0
        t0 = t[0][live].min()
        st = {k: (t[k][live].astype(np.int64) - int(t0)) / 1e3 for k in range(5)}
        read = live & (t[2] > 0)
        last = read & (t[4] > 0)
        us = lambda x: [float(x.mean()), float(x.max())] if x.size else None
        res.update(
            blocks=int(live.sum()), blocks_reading=int(read.sum()), sms=int(len(set(t[5][live]))),
            span_us=float(max(st[k][t[k][live] > 0].max() for k in range(5)
                              if (t[k][live] > 0).any())),
            entry_us=us(st[0][read[live]]),
            first_slab_us=us((st[1] - st[0])[read[live]]),
            loop_us=us((st[2] - st[0])[read[live]]),
            loop_end_us=us(st[2][read[live]]),
            arrival_us=us((st[3] - st[2])[last[live]]),
            merge_us=us((st[4] - st[3])[last[live]]))
        chip_smoke.log(f"  row {name}: {json.dumps(res)}")
        out.append(res)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
