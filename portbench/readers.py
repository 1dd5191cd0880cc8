"""What the metric readers under portbench/metrics/ share.

A reader takes a finished `harness.Run` and returns its metric's value, or
None where the run holds nothing to read (the metric is then left out of
the result line). A share of a roofline or of a peak is never returned as 0
for want of data.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from . import roofline, stats

# kernel short names (trace.short_name) of the tensor-core products: the
# dequant-matmul's tiles and its split-K sum, and the fused MLP's tiles
GEMM_KERNELS = r"^(mma_kernel|splitk_sum|mlp_mma_kernel)$"
BATCH_KERNEL = r"^batch_kernel$"


def work(run, kind: str) -> List:
    """The payloads of the `kind` calls that lie wholly inside the window."""
    return [p for k, p, a, b in run.work if k == kind and a >= run.t0 and b <= run.t1]


def window_s(run) -> float:
    return run.t1 - run.t0


def token_times(run) -> Iterable[List[float]]:
    return (r.times for r in run.requests)


def output_tokens(run) -> int:
    return sum(1 for ts in token_times(run) for t in ts if run.in_window(t))


def itl_ms(run) -> List[float]:
    """Every gap between consecutive output tokens of a request, both
    tokens inside the window."""
    out = []
    for ts in token_times(run):
        for a, b in zip(ts, ts[1:]):
            if run.in_window(a) and run.in_window(b):
                out.append((b - a) * 1e3)
    return out


def ttft_ms(run) -> List[float]:
    """Send to first token of every request sent inside the window."""
    return [(r.times[0] - r.sent) * 1e3 for r in run.requests
            if run.in_window(r.sent) and r.times]


def span_p50_ms(run, name: str) -> Optional[float]:
    v = stats.percentile(run.spans.durations(name, run.t0, run.t1), 50)
    return None if v is None else v * 1e3


def window_cost_s(run) -> float:
    """The least time the chip could spend on every call of the window."""
    s = roofline.Shapes(run.cfg)
    t = sum(roofline.decode_step_cost([p for w in waves for p in w], s).seconds()
            for waves in work(run, "step"))
    t += sum(roofline.prefill_cost(n, s).seconds() for n in work(run, "prefill"))
    t += sum(roofline.ppl_batch_cost(b, n, s).seconds() for b, n in work(run, "batch"))
    return t


def mfu(run) -> Optional[float]:
    """% of the chip's peak: the roofline time of the window's work over the
    window's wall."""
    t = window_cost_s(run)
    return 100.0 * t / window_s(run) if t > 0 else None


def idle_share(run) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    tr = run.device_trace
    if tr is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def kernel_share(run, pattern: str, bound_s: float) -> Optional[float]:
    """% of the roofline: the bound of the work over the device time of the
    kernels named by `pattern`."""
    tr = run.device_trace
    if tr is None or bound_s <= 0:
        return None
    dev = tr.device_seconds(pattern)
    return 100.0 * bound_s / dev if dev > 0 else None


def gemm_share(run) -> Optional[float]:
    """The tensor-core products of the window's prefills and loss batches,
    each launch's bound on its own."""
    s = roofline.Shapes(run.cfg)
    bound = sum(c.seconds() for n in work(run, "prefill") for c in roofline.prefill_gemms(n, s))
    bound += sum(c.seconds() for b, n in work(run, "batch") for c in roofline.ppl_gemms(b, n, s))
    return kernel_share(run, GEMM_KERNELS, bound)


def batch_kernel_share(run) -> Optional[float]:
    """Every launch of the batched decode kernel in the window; None where
    the trace holds another number of launches than the steps made."""
    s = roofline.Shapes(run.cfg)
    launches = [w for waves in work(run, "step") for w in waves]
    tr = run.device_trace
    if tr is None or tr.count(BATCH_KERNEL) != len(launches):
        return None
    bound = sum(roofline.batch_kernel_cost(w, s).seconds() for w in launches)
    return kernel_share(run, BATCH_KERNEL, bound)
