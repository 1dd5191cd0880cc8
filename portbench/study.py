"""Readings that a cell's limits for `correct` are set from.

    python3 portbench/study.py --workload <cell> --seeds 11,12,13 --seconds 25 \
        [--controls N] [--out <file>.jsonl]

For each seed, in one process: the cell's run as the benchmark makes it (a
shorter window at the cell's own load, long enough to finish its longest
requests), then the program's reading of each compared number and the
control's reading on the same sample (`drivers/<kind>.py`'s `control`: the
nearest lower precision, which has to come out as not correct), the control
on the first `--controls` seeds only where that is given. The
benchmark's own runs never run the control. Without a CUDA card it exits
with 2.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 2
    from mi_optimize_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell, cfg, mix, limits = harness.cell_parts(ROOT, bench, args.workload)
    driver = harness.load_module(ROOT, f"portbench/drivers/{mix['kind']}.py",
                                 f"portbench_driver_{mix['kind']}")
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = harness.Run(cell=cell, cfg=cfg, mix=mix, limits=limits, seed=seed,
                          seconds=args.seconds, trace=False, device=dev, t_start=t)
        driver.drive(run)
        ctl = driver.control(run) if args.controls is None or i < args.controls else None
        kept = {k: v for k, v in run.details.items() if not k.startswith("_")}
        rec = {"workload": args.workload, "seed": seed, "program": kept, "control": ctl,
               "sample": len(run.sample), "wall_s": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        del run
        harness.free_device_memory(dev)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
