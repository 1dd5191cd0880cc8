"""Benchmark facade: the evaluation entry point.

Port of mi_optimize_tpu/eval/benchmark.py:
  eval_ppl       wikitext2 / PTB / C4 perplexity (token-weighted NLL, then
                 exp, through eval.ppl.compute_ppl)
  eval_ceval     C-Eval MCQA, 0/5-shot, ABCD-logit argmax (eval.mcqa)
  eval_cmmlu     CMMLU MCQA, same protocol
  eval_boss      BOSS OOD suite through greedy generation + metrics (eval.boss)
  eval_lmeval    lm-eval-harness adapter: loglikelihood / rolling /
                 greedy_until executors over the registered tasks
                 (eval.lmeval.evaluate_tasks)
  eval_latency   forward latency percentiles, decode tokens/s against the
                 HBM roofline and the whole-model kernel alone (eval.latency)
The evaluation runs on `device` ("cuda" unless the caller asks for the CPU);
a model whose tensors live elsewhere is moved there for the call.
"""
from __future__ import annotations

import logging
from typing import Dict

from ..models.model import Model
from .ppl import compute_ppl

log = logging.getLogger(__name__)


class Benchmark:
    def __init__(self, fused: bool = True, device=None):
        self.fused = fused
        self.device = device

    def _on_device(self, model: Model) -> Model:
        return model.on(self.device)

    def _ppl(self, model: Model, batches) -> float:
        return compute_ppl(self._on_device(model), batches, fused=self.fused)

    # ---------------- perplexity ----------------
    def eval_wiki2_ppl(self, model: Model, tokenizer, seqlen=2048, nsamples=40):
        from ..datasets.calibration import get_wikitext2

        batches = get_wikitext2(tokenizer, split="test", nsamples=nsamples, seqlen=seqlen)
        return self._ppl(model, batches)

    def eval_ptb_ppl(self, model: Model, tokenizer, seqlen=2048, nsamples=None):
        from ..datasets.calibration import get_ptb

        batches = get_ptb(tokenizer, split="test", seqlen=seqlen)
        if nsamples:
            batches = batches[:nsamples]
        return self._ppl(model, batches)

    def eval_c4_ppl(self, model: Model, tokenizer, seqlen=2048, nsamples=40):
        from ..datasets.calibration import get_c4

        batches = get_c4(tokenizer, nsamples=nsamples, seqlen=seqlen)
        return self._ppl(model, batches)

    def eval_ppl(self, model: Model, tokenizer, test_dataset="wikitext2", **kw) -> Dict[str, float]:
        names = test_dataset.split(",") if isinstance(test_dataset, str) else test_dataset
        out = {}
        for name in names:
            fn = {"wikitext2": self.eval_wiki2_ppl, "ptb": self.eval_ptb_ppl,
                  "c4": self.eval_c4_ppl}[name]
            out[name] = fn(model, tokenizer, **kw)
            log.info("ppl[%s] = %.4f", name, out[name])
        return out

    # ---------------- MCQA ----------------
    def eval_ceval(self, model: Model, tokenizer, model_type="llama", subject="all",
                   num_shot=0, **kw):
        from .mcqa import eval_ceval

        return eval_ceval(self._on_device(model), tokenizer, subject=subject,
                          num_shot=num_shot, fused=self.fused, **kw)

    def eval_cmmlu(self, model: Model, tokenizer, model_type="llama", subject="all",
                   num_shot=0, **kw):
        from .mcqa import eval_cmmlu

        return eval_cmmlu(self._on_device(model), tokenizer, subject=subject,
                          num_shot=num_shot, fused=self.fused, **kw)

    # ---------------- BOSS ----------------
    def eval_boss(self, model: Model, tokenizer, test_dataset="QuestionAnswering_advqa",
                  split="test", ICL_split="test", num_shot=0, **kw):
        from .boss import eval_boss

        return eval_boss(self._on_device(model), tokenizer, test_dataset=test_dataset,
                         split=split, num_shot=num_shot, fused=self.fused, **kw)

    # ---------------- lm-eval adapter ----------------
    def eval_lmeval(self, model: Model, tokenizer, eval_tasks, num_shot=0, **kw):
        from .lmeval import evaluate_tasks

        return evaluate_tasks(self._on_device(model), tokenizer, eval_tasks, num_shot=num_shot,
                              fused=self.fused, **kw)

    # ---------------- latency / throughput ----------------
    def eval_latency(self, model: Model, batch=1, seqlen=128, **kw):
        from .latency import decode_throughput, forward_latency

        model = self._on_device(model)
        return {
            "forward": forward_latency(model, batch=batch, seqlen=seqlen, fused=self.fused,
                                       device=self.device),
            "decode": decode_throughput(model, batch=batch, fused=self.fused,
                                        device=self.device, **kw),
        }
