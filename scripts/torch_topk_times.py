#!/usr/bin/env python3
"""The sampling step's device top-k (serving/paged.py::_topk, which
PagedMegaBatcher's top-k sampling and beam_search pull) on one NVIDIA GPU,
beside other ways of the same.

    python3 scripts/torch_topk_times.py [--reps N] [--rows 1,4,8] [--ks 8,256]

On seeded bf16 logits [B, 32000] (Llama-2's vocabulary) it times, for each
B and k:
  paged_topk    paged._topk: a stable sort of each row's order-preserving
                int32 keys of the values, the first k taken;
  topk_lexsort  torch.topk, then the ids of equal values put in order on the
                host by np.lexsort (PagedMegaBatcher before, which could keep
                a higher id among equal values at the k-th place);
  float_sort    a stable sort of the f32 row itself (-0.0 ties +0.0);
  int64_keys    one torch.topk over int64 keys of the value's int32 key
                above the id's complement.
Each row gives the device ms of the device part alone (CUDA events after an
L2 flush, chip_smoke.time_ms) and the host wall ms of the whole call with
its pull to the host and any host ordering (mean of --reps calls), and
whether its ids equal paged_topk's. Prints the card's name and power limit
first, then one JSON row a case.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rows", default="1,4,8")
    ap.add_argument("--ks", default="8,256")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_topk_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.serving.paged import _topk

    def topk_dev(lg, k):
        v, i = torch.topk(lg.to(torch.float32), k, dim=-1)
        return v, i.to(torch.int32)

    def float_sort(lg, k):
        v, i = torch.sort(lg.to(torch.float32), dim=-1, descending=True, stable=True)
        return v[:, :k], i[:, :k].to(torch.int32)

    def int64_keys(lg, k):
        lf = lg.to(torch.float32)
        n = lf.shape[-1]
        bits = lf.view(torch.int32)
        key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
        ids = torch.arange(n, device=lf.device, dtype=torch.int64)
        top = torch.topk((key << 32) | (n - 1 - ids), k, dim=-1).values
        i = n - 1 - (top & 0xFFFFFFFF)
        return lf.gather(-1, i), i.to(torch.int32)

    def pulled(dev_fn, host_order):
        def call(lg, k):
            v, i = dev_fn(lg, k)
            packed = torch.stack([v, i.view(torch.float32)]).cpu().numpy()
            vals, ids = packed[0], packed[1].view(np.int32)
            if host_order:
                order = np.lexsort((ids, -vals), axis=-1)
                vals = np.take_along_axis(vals, order, -1)
                ids = np.take_along_axis(ids, order, -1)
            return vals, ids
        return call

    ways = {"paged_topk": (_topk, pulled(_topk, False)),
            "topk_lexsort": (topk_dev, pulled(topk_dev, True)),
            "float_sort": (float_sort, pulled(float_sort, False)),
            "int64_keys": (int64_keys, pulled(int64_keys, False))}
    print(f"gpu: {chip_smoke.nvidia_smi_line()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in map(int, args.rows.split(",")):
        lg = (torch.randn(B, 32000, generator=gen, device="cuda") * 4).to(torch.bfloat16)
        for k in map(int, args.ks.split(",")):
            want = ways["paged_topk"][1](lg, k)[1]
            for name, (dev_fn, call) in ways.items():
                ms = chip_smoke.time_ms(lambda: dev_fn(lg, k), 50, flush)
                call(lg, k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    got = call(lg, k)[1]
                wall = (time.perf_counter() - t0) / args.reps * 1e3
                print(json.dumps(dict(way=name, B=B, k=k, device_ms=ms, wall_ms_with_pull=wall,
                                      ids_equal_paged_topk=bool(np.array_equal(got, want)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
