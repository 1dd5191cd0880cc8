"""lm-eval-harness adapter: loglikelihood / rolling / greedy_until executors.

Port of mi_optimize_tpu/eval/lmeval.py. The reference toolbox vendors
EleutherAI's lm-eval; this implements the harness's interface natively:
request types, length-sorted executors, Task / MultipleChoiceTask /
PerplexityTask result processing, and a registry of offline-runnable tasks
(eval/lmeval_tasks.py, lmeval_gen_tasks.py, lmeval_more_tasks.py).

Executor semantics (the reference's lmeval.py):
  loglikelihood          length-sorted, full-vocab log_softmax, continuation
                         token gather + greedy-match flag
  loglikelihood_rolling  disjoint max_length windows over the full doc
  greedy_until           greedy decode with a stop-sequence split

The forward runs on the device of the model's tensors (Benchmark moves the
model to its device). The JAX package pads each request to a power-of-two
bucket to bound its recompiles; the causal logits of the real positions do
not depend on the padding, so the port runs each request at its own length.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..datasets.tokenizer import encode_ids
from ..models import llama
from ..models.model import Model
from ..serving import generate

log = logging.getLogger(__name__)


class Reorderer:
    """Sort requests for batching, restore the original order."""

    def __init__(self, arr, sort_fn):
        self.size = len(arr)
        self.order = sorted(range(len(arr)), key=lambda i: sort_fn(arr[i]))
        self.arr = [arr[i] for i in self.order]

    def get_reordered(self):
        return self.arr

    def get_original(self, results):
        out = [None] * self.size
        for pos, i in enumerate(self.order):
            out[i] = results[pos]
        return out


class LMEvalModel:
    """The model behind the three lm-eval request primitives."""

    def __init__(self, model: Model, tokenizer, fused=True, max_length=2048):
        self.model = model
        self.tokenizer = tokenizer
        self.fused = fused
        self.max_length = min(max_length, model.config.max_seq_len)

    def _enc(self, text: str) -> List[int]:
        return list(encode_ids(self.tokenizer, text)[0])

    @torch.no_grad()
    def _ll_tokens(self, ctx_tokens: List[int], cont_tokens: List[int]) -> Tuple[float, bool]:
        # the reference feeds (ctx+cont)[-(max_length+1):][:-1]: the final
        # continuation token needs only its predecessor's logits
        ids = (ctx_tokens + cont_tokens)[-(self.max_length + 1):]
        nctx = len(ids) - len(cont_tokens)
        dev = self.model.params["embed"].device
        inp = torch.as_tensor([ids[:-1]], device=dev)
        logits = llama.forward(self.model.params, self.model.config, inp, fused=self.fused)
        lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
        # the logprob of token t given ids[:t] lives at position t-1
        rows = torch.arange(nctx - 1, len(ids) - 1, device=dev)
        tgt = torch.as_tensor(ids[nctx:], device=dev)
        vals = lp[rows, tgt].cpu().tolist()
        greedy = bool((lp[rows].argmax(-1) == tgt).all())
        ll = 0.0
        for v in vals:   # left to right in float64, as the reference (not sum()'s
            ll += v      # compensated sum)
        return ll, greedy

    # the reference hardcodes token id 2 as the empty-context / rolling-window
    # prefix (lmeval.py `context_enc=[2]`, `prefix_token=2`); a vocabulary
    # too small for it falls back to the tokenizer's bos id
    PREFIX_TOKEN = 2

    def _prefix_token(self) -> int:
        vocab = getattr(self.model.config, "vocab_size", None)
        if vocab is None or vocab > self.PREFIX_TOKEN:
            return self.PREFIX_TOKEN
        bos = getattr(self.tokenizer, "bos_token_id", None)
        return bos if bos is not None else 0

    def loglikelihood(self, requests: Sequence[Tuple[str, str]]):
        reorder = Reorderer(list(requests), lambda r: -len(r[0] + r[1]))
        out = []
        for ctx, cont in reorder.get_reordered():
            ctx_t = self._enc(ctx) if ctx else [self._prefix_token()]
            cont_t = self._enc(cont)
            out.append(self._ll_tokens(ctx_t, cont_t))
        return reorder.get_original(out)

    def _rolling_windows(self, toks: List[int]):
        """get_rolling_token_windows(context_len=1) + make_disjoint_window:
        every token of the doc is scored exactly once, the first behind the
        prefix token."""
        prefix = self._prefix_token()
        max_len = self.max_length
        if not toks:
            return
        first = min(max_len, len(toks))
        yield [prefix], toks[:first]
        predicted = first
        while predicted < len(toks):
            wpl = min(len(toks) - predicted, max_len)
            end = predicted + wpl
            ctx_full = toks[max(0, end - max_len - 1): end - 1]
            yield ctx_full[: len(ctx_full) - (wpl - 1)], toks[end - wpl: end]
            predicted += wpl

    def loglikelihood_rolling(self, requests: Sequence[str]):
        out = []
        for text in requests:
            toks = self._enc(text)
            ll = 0.0
            for ctx, cont in self._rolling_windows(toks):
                ll += self._ll_tokens(ctx, cont)[0]
            out.append(ll)
        return out

    def greedy_until(self, requests: Sequence[Tuple[str, List[str]]], max_new_tokens=256):
        out = []
        for ctx, stops in requests:
            ids = encode_ids(self.tokenizer, ctx)[:, -(self.max_length - max_new_tokens):]
            gen = generate(self.model, ids, max_new_tokens=max_new_tokens, temperature=0.0,
                           fused=self.fused, max_len=self.max_length)
            text = self.tokenizer.decode(gen[0, ids.shape[1]:])
            for s in stops:
                text = text.split(s)[0]
            out.append(text)
        return out


# ---------------------------------------------------------------------------
# Task abstraction (the harness's base.py)
# ---------------------------------------------------------------------------

class Task:
    """Minimal lm-eval Task: docs -> requests -> per-doc metrics -> aggregate."""

    request_type = "loglikelihood"

    def docs(self) -> List[dict]:
        raise NotImplementedError

    def fewshot_context(self, doc, num_shot: int, rng) -> str:
        raise NotImplementedError

    def construct_requests(self, doc, ctx):
        raise NotImplementedError

    def process_results(self, doc, results) -> Dict[str, float]:
        raise NotImplementedError

    def aggregate(self, metrics: List[Dict[str, float]]) -> Dict[str, float]:
        keys = metrics[0].keys() if metrics else []
        return {k: float(np.mean([m[k] for m in metrics])) for k in keys}


class MultipleChoiceTask(Task):
    """acc + length-normalized acc_norm over choice loglikelihoods."""

    def choices(self, doc) -> List[str]:
        raise NotImplementedError

    def gold(self, doc) -> int:
        raise NotImplementedError

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + c) for c in self.choices(doc)]

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        gold = self.gold(doc)
        acc = 1.0 if int(np.argmax(lls)) == gold else 0.0
        norm = [ll / max(len(c), 1) for ll, c in zip(lls, self.choices(doc))]
        acc_norm = 1.0 if int(np.argmax(norm)) == gold else 0.0
        return {"acc": acc, "acc_norm": acc_norm}


class PerplexityTask(Task):
    """word_perplexity / byte_perplexity / bits_per_byte."""

    request_type = "loglikelihood_rolling"

    def fewshot_context(self, doc, num_shot, rng):
        return ""

    def construct_requests(self, doc, ctx):
        return doc["text"]

    def process_results(self, doc, ll):
        words = max(len(doc["text"].split()), 1)
        nbytes = max(len(doc["text"].encode("utf-8")), 1)
        return {"word_nll": -ll / words, "byte_nll": -ll / nbytes}

    def aggregate(self, metrics):
        wn = float(np.mean([m["word_nll"] for m in metrics]))
        bn = float(np.mean([m["byte_nll"] for m in metrics]))
        return {
            "word_perplexity": float(np.exp(wn)),
            "byte_perplexity": float(np.exp(bn)),
            "bits_per_byte": bn / np.log(2),
        }


TASK_REGISTRY: Dict[str, Callable[[], Task]] = {}


def register_task(name):
    def deco(cls):
        TASK_REGISTRY[name] = cls
        return cls
    return deco


def expand_task_names(eval_tasks) -> List[str]:
    """Alias and bundle expansion with the reference's semantics: 'anli' ->
    the three rounds, 'blimp' -> all 67 UIDs, 'arc' -> easy + challenge, and
    the 'all_tasks_0s' / 'all_tasks_5s' / 'test_tasks' bundles (only as the
    sole entry, the reference's len == 1 guard)."""
    from . import lmeval_tasks  # noqa: F401  (registry side-effect)

    tasks = [eval_tasks] if isinstance(eval_tasks, str) else list(eval_tasks)
    blimp = sorted(n for n in TASK_REGISTRY if n.startswith("blimp_"))
    crows = [n for n in TASK_REGISTRY if n.startswith("crows_pairs_")]
    shared = (["winogrande", "wsc273", "race", "anli_r1", "anli_r2", "anli_r3",
               "pubmedqa"],
              ["openbookqa", "arc_easy", "arc_challenge", "sciq", "swag",
               "piqa", "hellaswag"],
              ["glue_mnli", "glue_mnli_mismatched", "glue_rte", "glue_qnli",
               "glue_sst", "glue_wnli", "mathqa", "mc_taco", "mutual",
               "mutual_plus", "qa4mre_2011", "qa4mre_2012", "qa4mre_2013",
               "toxigen"])
    bundles = {
        "all_tasks_0s": shared[0] + shared[1] + crows + shared[2],
        "all_tasks_5s": shared[0] + blimp + shared[1] + shared[2]
                        + ["triviaqa"],
        "test_tasks": [],
    }
    if "anli" in tasks:
        tasks.remove("anli")
        tasks += ["anli_r1", "anli_r2", "anli_r3"]
    if "blimp" in tasks:
        tasks.remove("blimp")
        tasks += blimp
    if "arc" in tasks:
        tasks.remove("arc")
        tasks += ["arc_easy", "arc_challenge"]
    for bundle, expansion in bundles.items():
        if bundle in tasks and len(tasks) == 1:
            tasks = list(expansion)
    return tasks


def evaluate_tasks(model: Model, tokenizer, eval_tasks, num_shot=0, fused=True,
                   max_docs=None, seed=1234,
                   allow_empty=False) -> Dict[str, Dict[str, float]]:
    """Every task's aggregate metrics and its doc count `n`. A task with no
    docs raises, unless allow_empty records n = 0."""
    from . import lmeval_tasks  # noqa: F401  (registry side-effect)

    eval_tasks = expand_task_names(eval_tasks)
    lm = LMEvalModel(model, tokenizer, fused=fused)
    rng = np.random.default_rng(seed)
    results = {}
    for name in eval_tasks:
        if name not in TASK_REGISTRY:
            raise ValueError(f"unknown lm-eval task {name!r}; have {sorted(TASK_REGISTRY)}")
        task = TASK_REGISTRY[name]()
        docs = task.docs()
        if not docs:
            # never let a run "succeed" while evaluating nothing
            if not allow_empty:
                raise RuntimeError(
                    f"lm-eval task {name!r} produced 0 docs (dataset missing/"
                    "offline?); pass allow_empty=True to record n=0 instead")
            results[name] = {"n": 0}
            log.warning("lmeval[%s] had no docs — recorded n=0", name)
            continue
        if max_docs:
            docs = docs[:max_docs]
        metrics = []
        for doc in docs:
            ctx = task.fewshot_context(doc, num_shot, rng)
            reqs = task.construct_requests(doc, ctx)
            if task.request_type == "loglikelihood":
                res = lm.loglikelihood(reqs)
            elif task.request_type == "loglikelihood_rolling":
                res = lm.loglikelihood_rolling([reqs])[0]
            elif task.request_type == "mixed":
                # typed dispatch per request (squad2 / qasper mix greedy_until
                # and loglikelihood in one doc)
                res = [lm.loglikelihood([payload])[0] if kind == "loglikelihood"
                       else lm.greedy_until([payload])[0]
                       for kind, payload in reqs]
            else:
                res = lm.greedy_until(reqs)
            metrics.append(task.process_results(doc, res))
        results[name] = dict(task.aggregate(metrics), n=len(metrics))
        log.info("lmeval[%s] = %s", name, results[name])
    return results
