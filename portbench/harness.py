"""Runs one cell of BENCHMARK.json once and builds its result line.

Everything a cell needs is found by name: the cell's entry names a
configuration (`configs[].file`) and a traffic mix (`portbench/traffic/<mix>.json`),
the mix names its driver (`portbench/drivers/<kind>.py`), each metric of the
cell has its reader (`portbench/metrics/<metric>.py`, or for a name with a
dot `portbench/metrics/<stem>.py`, the stem being the part before the first
dot: one reader serves `mfu.decode` and `mfu.ppl`), and the cell's limits
for `correct` are in `portbench/limits/<cell>.json`. A new cell, mix or
metric is new files and entries; no code here changes.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .stats import Spans

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mi_optimize_tpu")


@dataclass
class Run:
    """What one run of a cell records; the metric readers take it."""
    cell: dict
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                               # process start, monotonic s
    spans: Spans = field(default_factory=Spans)
    t0: Optional[float] = None                   # the measured window
    t1: Optional[float] = None
    requests: List[Any] = field(default_factory=list)    # serving: one record a request
    work: List[Tuple[str, Any, float, float]] = field(default_factory=list)
    scored: List[Tuple[int, float]] = field(default_factory=list)  # evaluation: (tokens, t)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    device_trace: Any = None                     # trace.Trace of a --trace 1 run
    span_offset: float = 0.0                     # system clock - monotonic clock, s
    sample: List[Any] = field(default_factory=list)      # what the check compares
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    details: Dict[str, Any] = field(default_factory=dict)  # every number the check worked out

    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def load_module(root: str, rel: str, name: str):
    """A module from a file under the benchmark's folder (names may hold dots)."""
    path = os.path.join(root, rel)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_file(root: str, name: str) -> str:
    """The reader of metric `name`: metrics/<name>.py, else metrics/<stem>.py."""
    own = f"portbench/metrics/{name}.py"
    if os.path.exists(os.path.join(root, own)):
        return own
    return f"portbench/metrics/{name.split('.')[0]}.py"


def cell_parts(root: str, bench: dict, name: str):
    """(cell, configuration dict, mix dict, limits dict) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root, conf["file"])
    mix = load_json(root, f"portbench/traffic/{cell['traffic']}.json")
    limits = load_json(root, f"portbench/limits/{name}.json")
    return cell, cfg, mix, limits


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (on)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def device_info(run: Run) -> dict:
    import torch

    dev = torch.device(run.device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(run.memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(run.memory_peak)}
    if run.device_trace is not None:
        info["busy_s"] = run.device_trace.busy_s()
        info["window_s"] = run.device_trace.window_s()
    return info


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Tuple[Run, dict]:
    """Drive one cell once on `device`: set-up, the window, the check.
    Returns the run and its result object."""
    bench = load_json(root, "BENCHMARK.json")
    cell, cfg, mix, limits = cell_parts(root, bench, name)
    run = Run(cell=cell, cfg=cfg, mix=mix, limits=limits, seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start)
    driver = load_module(root, f"portbench/drivers/{mix['kind']}.py",
                         f"portbench_driver_{mix['kind']}")
    driver.drive(run)
    gc.collect()
    metrics = {}
    for m in metrics_of(bench, name, trace):
        reader = load_module(root, metric_file(root, m["name"]),
                             "portbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": run.correct(), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info(run)}
    if run.device_trace is not None:
        from .trace import to_epoch

        spans = to_epoch(run.spans.items, run.span_offset)
        result["breakdown"] = {"device_ops": run.device_trace.top_ops(),
                               "idle_gaps": run.device_trace.idle_gaps(spans)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return run, result


def free_device_memory(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def read_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0
