"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's model on the card from the seed, warms the cell's own
shapes, drives the port (`mi_optimize_tpu_torch`, from this checkout) for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output
(the numbers compared, each beside its limit, as the last lines of standard
error). Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits with 2; with JAX or the JAX package loaded once
the window has closed, with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["USE_FLAX"] = "0"   # keep transformers, if anything loads it, off JAX

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r}; one of {sorted(cells)}", 2)
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return fail(f"the cell needs {chips} CUDA device(s); {n} found", 2)

    import mi_optimize_tpu_torch
    from mi_optimize_tpu_torch.ops import _build

    here = os.path.dirname(os.path.abspath(mi_optimize_tpu_torch.__file__))
    if os.path.dirname(here) != ROOT:
        return fail(f"the program was imported from {here}, not from this checkout", 2)
    t_import = time.perf_counter() - T_START
    t_build = time.perf_counter()
    _build.build_all()             # the first run in a checkout compiles; later ones load
    t_build = time.perf_counter() - t_build
    t_ctx = time.perf_counter()
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")  # the CUDA context, timed apart from the model's set-up
    torch.cuda.synchronize()
    t_ctx = time.perf_counter() - t_ctx
    torch.cuda.reset_peak_memory_stats()
    run, result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package was loaded: {found}", 3)
    phases = {"setup.import": t_import, "setup.build": t_build, "setup.context": t_ctx}
    phases.update({n: b - a for n, a, b in run.spans.items if n.startswith(("setup.", "check"))})
    print("phases (s): " + ", ".join(f"{n} {v:.3f}" for n, v in phases.items()), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
