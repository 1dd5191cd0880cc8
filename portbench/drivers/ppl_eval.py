"""ppl_eval: perplexity evaluation through the port's `eval.ppl.batch_loss`.

The port's model as `quant.api.quantize` hands it over (unfused: separate
q/k/v and gate/up/down linears; on the card the products take the tensor-core
dequant-matmul and the fused MLP, attention the stock path). Each batch of
the mix is moved to the card and scored as `compute_ppl` does it: the
token-mean loss and its count, both pulled to the host. Set-up scores one
batch.

Correctness: once the window has closed and `memory_peak_bytes` is read, a
sample of `check_batches` of the window's batches, drawn from the seed, is
scored again by the forward that `batch_loss` runs (`llama.forward` on the
same model, kernels and [batch, seq_len] shape), whose logits give each
token's NLL and the token the program puts first. The program's state is
then freed and the plain reference scores the same rows. The numbers:

- `nll_rms`: the root mean square over the sample of each batch's loss, as
  the window produced it, minus the reference's. A batch's loss averages its
  2047 tokens' rounding away, so a lower precision moves it little.
- `tok_nll_rms`: the root mean square, over every sampled token, of the
  program's NLL of that token minus the reference's.
- `mean_gap`, `max_gap`: the gap of the program's first choice below the
  reference's best logit, over every sampled position.
- `short_batches`: batches that scored another count of tokens than
  batch x (seq_len - 1).

The cell's limits name which are compared. `rerun_gap`, the largest gap
between a batch's loss in the window and the mean of its tokens' NLL in the
second scoring, is recorded and not compared.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from portbench import harness, program, traffic
from portbench.reference.model import LOGIT_ROWS, Reference


@dataclass
class Batch:
    """One batch of the window: its ids, the loss and count the window
    produced, and (sampled batches) each row's per-token NLL and first
    choices from the second scoring."""
    ids: np.ndarray
    loss: float
    count: int
    nll: Optional[List[torch.Tensor]] = None
    pick: Optional[List[torch.Tensor]] = None


def score(model, ids: np.ndarray):
    """One batch as compute_ppl's loop body scores it: (mean loss, count)."""
    from mi_optimize_tpu_torch.eval.ppl import batch_loss

    dev = model.params["embed"].device
    loss, count = batch_loss(model, torch.as_tensor(np.asarray(ids), device=dev))
    return float(loss), int(count)


@torch.no_grad()
def rescore(model, ids: np.ndarray):
    """Each row's per-token NLL [seq_len - 1] and first choices from the
    forward that `batch_loss` runs on this model; the log-softmax in float32
    as `causal_lm_loss` takes it, in blocks of rows."""
    from mi_optimize_tpu_torch.models import llama

    dev = model.params["embed"].device
    x = torch.as_tensor(np.asarray(ids), device=dev)
    logits = llama.forward(model.params, model.config, x)
    nll, pick = [], []
    for b in range(x.shape[0]):
        tgt = x[b, 1:].to(torch.long)
        n, p = [], []
        for a in range(0, tgt.numel(), LOGIT_ROWS):
            z = logits[b, a:a + LOGIT_ROWS][: tgt.numel() - a].float()
            t = tgt[a:a + z.shape[0]]
            n.append(torch.logsumexp(z, dim=-1) - z.gather(1, t[:, None])[:, 0])
            p.append(z.argmax(dim=-1))
        nll.append(torch.cat(n).cpu())
        pick.append(torch.cat(p).cpu())
    return nll, pick


def _rows(sample: List[Batch]) -> List[torch.Tensor]:
    return [torch.as_tensor(row) for b in sample for row in b.ids]


def _numbers(losses: List[float], nll: List[torch.Tensor], ref_nll: List[torch.Tensor],
             gaps: List[torch.Tensor], rows_per_batch: int) -> dict:
    """Over the sample: the batches' loss gaps (root mean square, largest),
    the tokens' NLL gaps (root mean square, largest) and the first choices'
    gaps below the reference's best (mean, largest, share above 0)."""
    ref = [r.double().cpu() for r in ref_nll]
    ref_loss = [float(torch.cat(ref[i:i + rows_per_batch]).mean())
                for i in range(0, len(ref), rows_per_batch)]
    d = [p - r for p, r in zip(losses, ref_loss)]
    t = torch.cat([a.double() for a in nll]) - torch.cat(ref)
    g = torch.cat([x.double().cpu() for x in gaps])
    return {"nll_rms": float(np.sqrt(np.mean(np.square(d)))), "nll_gap": max(abs(x) for x in d),
            "tok_nll_rms": float(t.square().mean().sqrt()), "tok_nll_max": float(t.abs().max()),
            "mean_gap": float(g.mean()), "max_gap": float(g.max()),
            "flip_share": float((g > 0).double().mean()), "tokens": int(t.numel())}


def check(run: harness.Run) -> None:
    """The numbers above, from the sample's second scoring and the plain
    reference; the numbers compared are those the cell's limits name."""
    mix = run.mix
    want = mix["batch"] * (mix["seq_len"] - 1)
    nums = {"short_batches": float(sum(1 for b in run.sample if b.count != want))}
    nums.update({k: float("inf") for k in run.limits if k not in nums})
    if run.sample:
        picks = [p for b in run.sample for p in b.pick]
        ref_nll, (gaps,) = Reference(run.cfg, run.seed, run.device, kv_cache=False).token_scores(
            _rows(run.sample), [picks])
        nll = [n for b in run.sample for n in b.nll]
        nums.update(_numbers([b.loss for b in run.sample], nll, ref_nll, gaps, mix["batch"]))
        nums["rerun_gap"] = max(abs(b.loss - float(torch.cat(b.nll).double().mean()))
                                for b in run.sample)
        run.details["_ref_nll"] = ref_nll
    run.details.update(nums)
    run.checks = {k: (nums[k], float(v)) for k, v in run.limits.items()}


def control(run: harness.Run) -> dict:
    """The controls' readings on the run's sample, judged as the program is:
    the program's own routes below its bfloat16 activations on the same
    weights and batches, each decoder linear's input fake-quantized (the
    lm_head weight-only, as calibrated models keep it): float8 e4m3 with one
    scale a tensor (`quant.fp8`), and W4A8's int8 with one scale a token
    (`models.synthetic.with_w4a8`). A control's batch loss is the mean of its
    tokens' NLL. Returns the float8 readings, the int8 ones under "w4a8".
    Not part of a run."""
    import dataclasses

    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear
    from mi_optimize_tpu_torch.models.synthetic import with_w4a8

    def fp8(params):
        def one(v):
            if not isinstance(v, QuantizedLinear):
                return v
            return v.replace(spec=dataclasses.replace(v.spec, abit=8, fp8_format="e4m3"))
        return dict(params, layers=[{k: one(v) for k, v in blk.items()}
                                    for blk in params["layers"]])

    base = program.build(run.cfg, run.seed, run.device, fused=False)
    scored = {}
    for name, route in (("fp8", fp8), ("w4a8", with_w4a8)):
        model = Model(config=base.config, params=route(base.params))
        scored[name] = [rescore(model, b.ids) for b in run.sample]
        del model
    del base
    harness.free_device_memory(run.device)
    ref_nll = run.details["_ref_nll"]
    names = list(scored)
    picks = [[p for _, pk in scored[n] for p in pk] for n in names]
    _, gaps = Reference(run.cfg, run.seed, run.device, kv_cache=False).token_scores(
        _rows(run.sample), picks)
    out = {}
    for n, g in zip(names, gaps):
        nll = [x for nl, _ in scored[n] for x in nl]
        losses = [float(torch.cat(nl).double().mean()) for nl, _ in scored[n]]
        out[n] = _numbers(losses, nll, ref_nll, g, run.mix["batch"])
    return dict(out["fp8"], w4a8=out["w4a8"])


def drive(run: harness.Run) -> None:
    mix = run.mix
    with run.spans.span("setup.model"):
        model = program.build(run.cfg, run.seed, run.device, fused=False)
    stream = traffic.batches(mix, run.cfg["vocab_size"], run.seed)
    with run.spans.span("setup.warm"):
        score(model, next(stream))

    tracer = None
    if run.trace:
        from portbench.trace import Tracer, clock_offset

        tracer = Tracer(run.device)
        tracer.start()
        run.span_offset = clock_offset()
    done: List[Any] = []
    run.t0 = time.perf_counter()
    deadline = run.t0 + run.seconds
    while time.perf_counter() < deadline:
        ids = next(stream)
        a = time.perf_counter()
        with run.spans.span("batch"):
            loss, count = score(model, ids)
        t = time.perf_counter()
        run.work.append(("batch", ids.shape, a, t))
        run.scored.append((count, t))
        done.append(Batch(ids, loss, count))
    run.t1 = time.perf_counter()
    if tracer is not None:
        run.device_trace = tracer.stop()
    run.attempted = len(done)
    run.memory_peak = harness.read_peak(run.device)

    pick = traffic.rng(run.seed, 4).permutation(len(done))[:mix["check_batches"]]
    run.sample = [done[int(i)] for i in sorted(pick)]
    with run.spans.span("check.program"):
        for b in run.sample:
            b.nll, b.pick = rescore(model, b.ids)
    del model, done
    harness.free_device_memory(run.device)
    with run.spans.span("check"):
        check(run)
