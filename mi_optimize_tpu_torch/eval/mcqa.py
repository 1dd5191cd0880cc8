"""C-Eval / CMMLU MCQA evaluation: the ABCD-logit argmax protocol.

Port of mi_optimize_tpu/eval/mcqa.py (the reference toolbox's
Benchmark.eval_ceval / eval_cmmlu): per subject, per question, prompt =
few-shot prefix + "\\n\\n" + question (0-shot: the bare question); the answer
is the argmax over the logits at the last prompt token of the ids of
"A"/"B"/"C"/"D". ChatGLM models answer by greedy generation and the regex
CoT extraction instead. Category accuracy rolls up as in the reference.

Prompts are right-padded to power-of-two buckets as in the JAX package
(padding after position L-1 cannot change the causal logits at L-1). The
forward runs on the device of the model's tensors.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..datasets import mcqa as D
from ..datasets.tokenizer import encode_ids
from ..models import llama
from ..models.model import Model

log = logging.getLogger(__name__)


@torch.no_grad()
def _last_logits(params, cfg, ids, last_idx, fused=True):
    logits = llama.forward(params, cfg, ids, fused=fused)
    return logits[torch.arange(ids.shape[0], device=ids.device), last_idx]


def _bucket(n: int, cap: int) -> int:
    b = 32
    while b < n:
        b *= 2
    return min(b, cap)


def _letter_ids(tokenizer):
    ids = []
    for c in "ABCD":
        enc = tokenizer.encode(c) if hasattr(tokenizer, "encode") else encode_ids(tokenizer, c)[0]
        ids.append(int(np.asarray(enc).reshape(-1)[-1]))
    return ids


def _eval_bench(bench: str, model: Model, tokenizer, subject="all", num_shot=0,
                split=None, fewshot_split=None, fused=True,
                max_questions=None, max_len=None, model_type="llama") -> Dict:
    split = split or ("val" if bench == "ceval" else "test")
    fewshot_split = fewshot_split or split
    cfg = model.config
    dev = model.params["embed"].device
    max_len = max_len or cfg.max_seq_len
    letters = _letter_ids(tokenizer)
    per_subject: Dict[str, Dict] = {}

    for sub in D.get_subjects(bench, subject):
        questions, answers = D.get_subject_testset(bench, sub, split=split)
        if not questions:
            continue
        if max_questions:
            questions, answers = questions[:max_questions], answers[:max_questions]
        prefix = ""
        if num_shot:
            prefix = D.get_fewshot_prefix(bench, subject=[sub], split=fewshot_split,
                                          question=num_shot)
        correct = 0
        for q, a in zip(questions, answers):
            prompt = (prefix + "\n\n" + q) if prefix else q
            if model_type == "chatglm":
                # generation + regex CoT extraction
                from ..serving import generate

                ids = encode_ids(tokenizer, prompt)[:, -(max_len - 64):]
                out = generate(model, ids, max_new_tokens=64, temperature=0.0,
                               fused=fused, max_len=max_len)
                resp = tokenizer.decode(out[0, ids.shape[1]:]).strip()
                pred = D.extract_cot_answer(q, resp)
            else:
                # 1-token ABCD-logit argmax
                ids = encode_ids(tokenizer, prompt)[0][-max_len:]
                L = len(ids)
                B = _bucket(L, max_len)
                padded = np.zeros((1, B), np.int64)
                padded[0, :L] = ids
                logits = _last_logits(model.params, cfg, torch.as_tensor(padded, device=dev),
                                      torch.as_tensor([L - 1], device=dev), fused)
                scores = logits[0].to(torch.float32).cpu().numpy()[letters]
                pred = "ABCD"[int(np.argmax(scores))]
            correct += pred == a
        total = len(questions)
        per_subject[sub] = {"total": total, "correct": correct,
                            "ratio": correct / max(total, 1)}
        log.info("%s/%s: %d/%d", bench, sub, correct, total)

    return D.aggregate_categories(bench, per_subject)


def eval_ceval(model, tokenizer, subject="all", num_shot=0, split="val",
               model_type="llama", **kw):
    if model_type == "llama" and getattr(model, "family", "llama") == "chatglm":
        model_type = "chatglm"
    return _eval_bench("ceval", model, tokenizer, subject=subject,
                       num_shot=num_shot, split=split, model_type=model_type, **kw)


def eval_cmmlu(model, tokenizer, subject="all", num_shot=0, split="test",
               model_type="llama", **kw):
    if model_type == "llama" and getattr(model, "family", "llama") == "chatglm":
        model_type = "chatglm"
    return _eval_bench("cmmlu", model, tokenizer, subject=subject,
                       num_shot=num_shot, split=split, model_type=model_type, **kw)
