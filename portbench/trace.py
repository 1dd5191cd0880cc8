"""The device trace of a `--trace 1` run: torch.profiler over the window.

Only the device's activity is recorded (kernels, copies, sets): no host op
is traced, so the trace costs little on the host. The profiler's timestamps
are nanoseconds of the system clock; the harness's spans are on the
monotonic clock, and `to_epoch` maps one to the other.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .stats import gaps, union_seconds

_TEMPLATE = re.compile(r"<[^<>]*>")


def short_name(name: str) -> str:
    """A kernel's function name without its return type, anonymous
    namespaces, template arguments and parameter list:
    `void (anonymous namespace)::f<4, true>(Args)` -> `f`."""
    s = name.replace("(anonymous namespace)::", "")
    while True:
        t = _TEMPLATE.sub("", s)
        if t == s:
            break
        s = t
    s = s.split("(")[0].strip()
    if s.startswith("void "):
        s = s[len("void "):]
    return s or name


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start, end) s
    t0: float = 0.0          # the traced window, s of the system clock
    t1: float = 0.0

    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_seconds([(max(a, self.t0), min(b, self.t1)) for _, a, b in self.kernels
                              if b > self.t0 and a < self.t1])

    def device_seconds(self, pattern: str) -> float:
        """Summed duration of the operations whose short name matches."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.kernels if rx.search(short_name(n)))

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.kernels if rx.search(short_name(n)))

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.kernels:
            s = short_name(n)
            by[s] = by.get(s, 0.0) + (b - a)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, spans: Sequence[Tuple[str, float, float]], k: int = 10) -> List[List]:
        """The device's idle seconds in the window, by the host span (system
        clock) each gap's middle falls in ("between calls" where none)."""
        by: Dict[str, float] = {}
        ss = sorted(spans, key=lambda s: s[1])
        for a, b in gaps([(x, y) for _, x, y in self.kernels], self.t0, self.t1):
            mid = 0.5 * (a + b)
            name = "between calls"
            for n, s0, s1 in ss:
                if s0 <= mid <= s1:
                    name = n
                    break
                if s0 > mid:
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Tracer:
    """torch.profiler on the device's activity alone, started and stopped at
    call boundaries (after a synchronize). On a CPU device (the CPU tests'
    rehearsal of a traced run) the host's operators stand in for it."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.trace = Trace()

    def _sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        self._sync()
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA if self.cuda else act.CPU])
        self.prof.start()
        self.trace.t0 = time.time_ns() / 1e9

    def stop(self) -> Trace:
        import torch

        self._sync()
        self.trace.t1 = time.time_ns() / 1e9
        self.prof.stop()
        kind = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != kind or e.is_user_annotation():
                continue
            a = e.start_ns() / 1e9
            self.trace.kernels.append((e.name(), a, a + e.duration_ns() / 1e9))
        self.prof = None
        return self.trace


def to_epoch(perf_spans: Sequence[Tuple[str, float, float]], offset: float):
    """Spans on the monotonic clock, shifted onto the system clock."""
    return [(n, a + offset, b + offset) for n, a, b in perf_spans]


def clock_offset() -> float:
    """System clock minus monotonic clock, s."""
    return time.time_ns() / 1e9 - time.perf_counter()
