"""BOSS OOD-suite evaluation: greedy generation + task metrics.

Port of mi_optimize_tpu/eval/boss.py (the reference toolbox's
Benchmark.eval_boss and benchmark/boss/metrics.py): per-task MAX_TOKENS,
zero/few-shot prompt + greedy decode through serving.generate, answer
normalization with the truncation fixes 'ent' -> entailment, 'ben' ->
benign, 'to' -> toxic, token F1 + exact match for QA.
"""
from __future__ import annotations

import logging
import re
import string
from collections import Counter
from typing import Dict, List

from ..datasets import boss as D
from ..datasets.tokenizer import encode_ids
from ..models.model import Model
from ..serving import generate

log = logging.getLogger(__name__)

MAX_TOKENS = {
    "SentimentAnalysis": 2,
    "ToxicDetection": 1,
    "NaturalLanguageInference": 1,
    "QuestionAnswering": 5,
}


def normalize_answer(task: str, s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = " ".join(s.split())
    if task == "NaturalLanguageInference" and s == "ent":
        s = "entailment"
    elif task == "ToxicDetection":
        if s == "ben":
            s = "benign"
        elif s == "to":
            s = "toxic"
    return s


def f1_score(task, prediction, ground_truth):
    p = normalize_answer(task, prediction).split()
    g = normalize_answer(task, ground_truth).split()
    common = Counter(p) & Counter(g)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(p)
    recall = num_same / len(g)
    return 2 * precision * recall / (precision + recall)


def exact_match(task, prediction, ground_truth):
    return normalize_answer(task, prediction) == normalize_answer(task, ground_truth)


def compute_metric(task: str, predictions: List[str], references) -> Dict:
    if task in ("SentimentAnalysis", "ToxicDetection", "NaturalLanguageInference"):
        hits = sum(1 for p, r in zip(predictions, references)
                   if normalize_answer(task, p) == r)
        return {"accuracy": 100.0 * hits / max(len(references), 1)}
    if task == "QuestionAnswering":
        em = f1 = 0.0
        for pred, gts in zip(predictions, references):
            em += max((exact_match(task, pred, gt) for gt in gts), default=0)
            f1 += max((f1_score(task, pred, gt) for gt in gts), default=0.0)
        n = max(len(references), 1)
        return {"exact_match": 100.0 * em / n, "f1": 100.0 * f1 / n}
    raise ValueError(f"unsupported BOSS task {task}")


def eval_boss(model: Model, tokenizer, test_dataset="QuestionAnswering_advqa",
              split="test", num_shot=0, fused=True, max_questions=None,
              max_len=None) -> Dict:
    task, dataset = test_dataset.split("_", 1)
    questions, answers = D.get_testdata_boss(task, dataset, split=split)
    if max_questions:
        questions, answers = questions[:max_questions], answers[:max_questions]
    prefix = (D.get_fewshot_prompt(task, dataset, num_shot) if num_shot
              else D.get_zeroshot_prompt(task))
    cfg = model.config
    max_len = max_len or cfg.max_seq_len
    max_new = MAX_TOKENS[task]
    preds = []
    for q in questions:
        ids = encode_ids(tokenizer, prefix + q)[:, -(max_len - max_new):]
        out = generate(model, ids, max_new_tokens=max_new, temperature=0.0,
                       fused=fused, max_len=max_len)
        text = tokenizer.decode(out[0, ids.shape[1]:])
        preds.append(text.strip("\n").strip())
    return compute_metric(task, preds, answers)
