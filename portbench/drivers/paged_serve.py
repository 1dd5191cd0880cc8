"""paged_serve: closed-loop clients on the port's PagedMegaBatcher.

The port's model, fused for serving (`fuse_for_serving`), is served by
`serving.paged.PagedMegaBatcher` over a page pool of `n_pages`. `clients`
clients each keep one greedy request in flight: a client sends its next
request the moment its last one completes. Each loop turn admits every
waiting request (`add_request`: a prefill through `engine.prefill`, its first
token pulled to the host) and then makes one `step()` (every active slot's
next token through the batched whole-model kernel in waves, the argmax
pulled to the host), as the batcher's own `run_all` does.

Set-up starts every client with a warm request whose output is cut so that
the clients finish at evenly spread steps, and runs the loop until the last
of those has finished: the window then opens on a loop in its steady state,
and every shape it uses (prefills, 1 to 4 waves) has run once.

Correctness: once the window has closed and the program's state is freed,
a sample of the requests finished in the window (the longest among them) is
run through the plain reference over its prompt and served tokens. Each
served token is read by the gap of its reference logit below the
reference's best at its position; the cell's limits name which of the
widest gap (`max_gap`) and the mean gap (`mean_gap`) are compared, and each
request must have served all its tokens (`short_requests`).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch

from portbench import harness, program, traffic
from portbench.reference.compare import control_gaps, served_gaps
from portbench.reference.model import Reference


@dataclass
class Rec:
    """One request as the client sees it."""
    client: int
    spec: traffic.Req
    sent: float
    obj: Any = None                      # the batcher's Request (its served tokens)
    times: List[float] = field(default_factory=list)   # arrival of each output token
    done: float = -1.0
    warm: bool = False


class Loop:
    def __init__(self, batcher, run: harness.Run):
        self.b = batcher
        self.run = run
        self.stream = traffic.requests(run.mix, run.cfg["vocab_size"], run.seed)
        self.pending = collections.deque()
        self.live = {}
        self.finished: List[Rec] = []

    def send(self, client: int, spec, t: float, warm: bool = False) -> None:
        self.pending.append(Rec(client, spec, t, warm=warm))

    def admit(self) -> None:
        b, run = self.b, self.run
        while self.pending:
            rec = self.pending[0]
            a = time.perf_counter()
            with run.spans.span("prefill"):
                rid = b.add_request(rec.spec.prompt, rec.spec.max_new)
            t = time.perf_counter()
            if rid is None:              # the pool cannot take it now: try after a step
                run.failed += 1
                return
            self.pending.popleft()
            rec.obj = next(r for r in b.slot_req if r is not None and r.rid == rid)
            rec.times.append(t)
            self.live[rid] = rec
            run.requests.append(rec)
            run.work.append(("prefill", len(rec.spec.prompt), a, t))

    def step(self) -> None:
        b, run = self.b, self.run
        active = [i for i, r in enumerate(b.slot_req) if r is not None]
        if not active:
            return
        pos = [int(b.positions[i]) for i in active]
        # the rows of each launch of the batched kernel: one launch over every
        # slot up to the wave size, else waves of the active slots
        w = b._wave_size()
        if b.n_slots <= w:
            waves = [[int(p) for p in b.positions]]
        else:
            waves = [pos[o:o + w] for o in range(0, len(pos), w)]
        a = time.perf_counter()
        with run.spans.span("step"):
            out = b.step()
        t = time.perf_counter()
        run.work.append(("step", waves, a, t))
        for rid in out:
            rec = self.live[rid]
            rec.times.append(t)
            if rec.obj.done:
                rec.done = t
                del self.live[rid]
                self.finished.append(rec)
                self.send(rec.client, next(self.stream), t)

    def turn(self) -> None:
        self.admit()
        self.step()


def _sample(run: harness.Run, finished: List[Rec]) -> List[Rec]:
    """The requests finished in the window that the check runs: the longest
    and the rest drawn from the seed."""
    pool = [r for r in finished if run.in_window(r.done) and not r.warm]
    if not pool:
        return []
    n = min(run.mix["check_requests"], len(pool))
    longest = max(range(len(pool)), key=lambda i: len(pool[i].spec.prompt) + len(pool[i].obj.tokens))
    rest = [i for i in range(len(pool)) if i != longest]
    pick = traffic.rng(run.seed, 4).permutation(len(rest))[:n - 1]
    return [pool[longest]] + [pool[rest[int(i)]] for i in pick]


def _inputs(sample: List[Rec]):
    """Each sampled request's prompt and served tokens but the last, the
    position of its first served token's logits, and its served tokens."""
    seqs, starts, toks = [], [], []
    for r in sample:
        served = np.asarray(r.obj.tokens, np.int64)
        seqs.append(torch.as_tensor(np.concatenate([r.spec.prompt, served[:-1]])))
        starts.append(len(r.spec.prompt) - 1)
        toks.append(torch.as_tensor(served))
    return seqs, starts, toks


def _numbers(ref_logits, toks, pick=None) -> dict:
    """The widest and the mean gap below the reference's best over every
    sampled served token (`pick`: the control's logits choose the tokens)."""
    gaps = torch.cat([served_gaps(r, t) if pick is None else control_gaps(r, c)
                      for r, t, c in zip(ref_logits, toks, pick or toks)])
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.double().mean()),
            "flip_share": float((gaps > 0).double().mean()), "tokens": int(gaps.numel())}


def check(run: harness.Run) -> None:
    """The gaps of the served tokens below the reference's best, and the
    requests that served another number of tokens than they asked for; the
    numbers compared are those the cell's limits name."""
    sample = run.sample
    short = sum(1 for r in sample if len(r.obj.tokens) != r.spec.max_new)
    nums = {"short_requests": float(short), "max_gap": float("inf"), "mean_gap": float("inf")}
    if sample:
        seqs, starts, toks = _inputs(sample)
        ref = Reference(run.cfg, run.seed, run.device, kv_cache=True)
        nums.update(_numbers(ref.logits(seqs, starts), toks))
    run.details = nums
    run.checks = {k: (nums[k], float(v)) for k, v in run.limits.items()}


def control(run: harness.Run) -> dict:
    """The control's readings on the run's sample: the reference with float8
    e4m3 activations at every decoder linear (the Hopper tensor cores' step
    below bfloat16), judged as the program is, through the token it puts
    first at each served position. Not part of a run."""
    seqs, starts, toks = _inputs(run.sample)
    ref = Reference(run.cfg, run.seed, run.device, kv_cache=True).logits(seqs, starts)
    ctl = Reference(run.cfg, run.seed, run.device, kv_cache=True, act="fp8").logits(seqs, starts)
    return _numbers(ref, toks, pick=ctl)


def drive(run: harness.Run) -> None:
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    mix = run.mix
    with run.spans.span("setup.model"):
        model = program.build(run.cfg, run.seed, run.device, fused=True)
        b = PagedMegaBatcher(model, n_slots=mix["slots"], max_len=mix["max_len"],
                             page_size=mix["page_size"], n_pages=mix["n_pages"])
    loop = Loop(b, run)
    now = time.perf_counter()
    for c, spec in enumerate(traffic.warm_requests(mix, run.cfg["vocab_size"], run.seed)):
        loop.send(c, spec, now, warm=True)
    with run.spans.span("setup.warm"):
        while any(r.warm for r in loop.pending) or any(r.warm for r in loop.live.values()):
            loop.turn()
    run.failed = 0

    tracer = None
    if run.trace:
        from portbench.trace import Tracer, clock_offset

        tracer = Tracer(run.device)
        tracer.start()
        run.span_offset = clock_offset()
    run.t0 = time.perf_counter()
    deadline = run.t0 + run.seconds
    while time.perf_counter() < deadline:
        loop.turn()
    run.t1 = time.perf_counter()
    if tracer is not None:
        run.device_trace = tracer.stop()
    loop.admit()                  # the requests sent in the last turn get their first token
    run.attempted = sum(1 for r in run.requests if run.in_window(r.sent))
    run.memory_peak = harness.read_peak(run.device)

    run.sample = _sample(run, loop.finished)
    del loop, b, model
    harness.free_device_memory(run.device)
    with run.spans.span("check"):
        check(run)
