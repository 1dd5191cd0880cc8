"""Run cells of the benchmark several times, one process a run, and keep
every result line.

    python3 portbench/repeat.py --workload <cell> --seeds 11,12,13 --seconds 51 \
        [--trace 0|1] [--out <file>.jsonl]

Each run is `portbench/run.py` in a process of its own, as the benchmark's
check runs it; the result line, the exit code, the wall seconds and the end
of standard error go to `--out` (one JSON object a run), and a summary of
each run to standard output. The card's name and power limit come first.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    out = open(args.out, "a") if args.out else None
    rc_all = 0
    for cell in args.workload:
        for seed in [int(s) for s in args.seeds.split(",")]:
            cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": cell, "seed": seed, "trace": args.trace, "rc": p.returncode,
                   "wall_s": wall, "result": res, "stderr_tail": p.stderr[-3000:]}
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            rc_all = rc_all or p.returncode
            if res is None:
                print(f"{cell} seed {seed}: rc {p.returncode}, no result, {wall:.1f} s\n"
                      f"{p.stderr[-3000:]}", flush=True)
                continue
            m = {k: round(v["value"], 4) for k, v in res["metrics"].items()}
            c = {k: (round(v["value"], 5), v["limit"]) for k, v in res["checks"].items()}
            print(f"{cell} seed {seed} trace {args.trace}: rc {p.returncode} wall {wall:.1f} s "
                  f"correct {res['correct']} attempted {res['attempted']} failed {res['failed']} "
                  f"{m} checks {c} peak {res['device']['memory_peak_bytes']}", flush=True)
            if "breakdown" in res:
                print(f"  busy {res['device'].get('busy_s')} window {res['device'].get('window_s')}"
                      f" {json.dumps(res['breakdown'])}", flush=True)
    if out:
        out.close()
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
