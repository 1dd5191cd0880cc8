"""Structured observability: per-run JSON manifests + timing/tracing helpers.

Port of mi_optimize_tpu/utils/observability.py: `config_hash` (the JAX
package's hash for the same config), `RunManifest` (config hash, metrics and
per-phase wall-clock, written as JSON next to the checkpoint) and `trace`,
here on torch.profiler: it writes a Chrome trace into the log directory
(default MI_TPU_TRACE_DIR, else mi_tpu_trace in the temporary directory).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import tempfile
import time
from dataclasses import asdict, is_dataclass
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)


def config_hash(cfg) -> str:
    d = asdict(cfg) if is_dataclass(cfg) else dict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class RunManifest:
    """Accumulates phases/metrics for one run; writes a single JSON artifact."""

    def __init__(self, name: str, config=None):
        self.data: Dict[str, Any] = {
            "name": name,
            "started_at": time.time(),
            "phases": {},
            "metrics": {},
        }
        if config is not None:
            self.data["config"] = asdict(config) if is_dataclass(config) else config
            self.data["config_hash"] = config_hash(config)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.data["phases"][name] = round(time.time() - t0, 3)
            log.info("phase %s: %.2fs", name, self.data["phases"][name])

    def metric(self, name: str, value):
        self.data["metrics"][name] = value

    def save(self, path: str):
        self.data["finished_at"] = time.time()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.data, f, indent=2, default=float)
        return path


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler context over the CPU and, where present, the card;
    on exit its Chrome trace is written to `logdir`/trace_<time>.json."""
    import torch

    logdir = logdir or os.environ.get(
        "MI_TPU_TRACE_DIR", os.path.join(tempfile.gettempdir(), "mi_tpu_trace"))
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))
