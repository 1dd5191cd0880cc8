"""lm-eval tasks: the 5 reference-active tasks beyond lmeval_gen_tasks, and
the reference-name aliases.

A copy of mi_optimize_tpu/eval/lmeval_more_tasks.py, its imports pointed at
the port's datasets and eval modules. Protocol parity with the reference
toolbox's vendored harness modules (benchmark/lmeval/tasks/):
  squad2      tasks/squad.py                                      (greedy + P(unanswerable), squad_v2 metric suite)
  mc_taco     tasks/mc_taco.py                                    (yes/no plausibility, per-question EM/F1)
  qasper      tasks/qasper.py                                     (mixed bool-ll / free-form greedy, abstractive F1)
  toxigen     tasks/toxigen.py                                    (Yes/No over thresholded annotator toxicity)
  math_asdiv  tasks/asdiv.py                                      (zero-shot answer ll, greedy-match acc)

Aliases: the reference registry's `glue_*` names (tasks/__init__.py:158-166),
`lambada` (:54), and `headqa` (:155, the deprecated Spanish config) map onto
the classes already registered under our short names, so a reference-style
invocation resolves verbatim.
"""
from __future__ import annotations

from math import exp

import numpy as np

from ..datasets import lmdatasets
from .lmeval import Task, MultipleChoiceTask, register_task
from .lmeval_tasks import (
    MNLI, MNLIMismatched, MRPC, QNLI, QQP, RTE, SST, WNLI, LambadaStandard)
from .lmeval_gen_tasks import HeadQAEs


def _squad_metrics():
    from . import squad_metrics

    return squad_metrics


# ---------------------------------------------------------------------------
# SQuAD2 (tasks/squad.py) — mixed greedy_until + loglikelihood(" unanswerable")
# ---------------------------------------------------------------------------

@register_task("squad2")
class SQuAD2(Task):
    """squad.py:46-165: Title/Background/Question prompt; one greedy
    continuation plus the loglikelihood of " unanswerable"; the full official
    squad_v2 metric suite (exact/f1 with HasAns/NoAns splits and the
    best-threshold variants) computed natively from transformers'
    squad_metrics primitives (the same library datasets.load_metric wraps)."""

    request_type = "mixed"

    def docs(self):
        if not hasattr(self, "_docs_cache"):
            self._docs_cache = lmdatasets.load_docs(
                "squad2", "squad_v2", None, "validation")
        return self._docs_cache

    def query(self, doc):
        return ("Title: " + doc["title"] + "\n\n" + "Background: "
                + doc["context"] + "\n\n" + "Question: " + doc["question"]
                + "\n\n" + "Answer:")

    def _target(self, doc):
        answers = doc["answers"]["text"]
        return " " + (answers[0] if answers else "unanswerable")

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)),
                             replace=False)
            shots = "\n\n".join(self.query(docs[i]) + self._target(docs[i])
                                for i in idx) + "\n\n"
        return shots + self.query(doc)

    def construct_requests(self, doc, ctx):
        return [("greedy_until", (ctx, ["\n"])),
                ("loglikelihood", (ctx, " unanswerable"))]

    def process_results(self, doc, results):
        continuation, (ll_unanswerable, _) = results
        return {
            "pred": {"id": doc["id"], "prediction_text": continuation,
                     "no_answer_probability": exp(ll_unanswerable)},
            "ref": {"id": doc["id"], "answers": doc["answers"]},
        }

    def aggregate(self, metrics):
        sm = _squad_metrics()
        exact, f1, na_probs, has_ans, preds = {}, {}, {}, {}, {}
        for m in metrics:
            qid = m["ref"]["id"]
            golds = [t for t in m["ref"]["answers"]["text"]
                     if sm.normalize_answer(t)]
            has_ans[qid] = bool(golds)
            if not golds:
                golds = [""]
            pred = m["pred"]["prediction_text"]
            preds[qid] = pred
            na_probs[qid] = m["pred"]["no_answer_probability"]
            exact[qid] = max(sm.compute_exact(a, pred) for a in golds)
            f1[qid] = max(sm.compute_f1(a, pred) for a in golds)
        # default threshold 1.0 (official evaluate-v2.0.py): na_prob=exp(ll)
        # never exceeds it, so exact/f1 are the raw scores
        exact_t = sm.apply_no_ans_threshold(exact, na_probs, has_ans, 1.0)
        f1_t = sm.apply_no_ans_threshold(f1, na_probs, has_ans, 1.0)
        out = dict(sm.make_eval_dict(exact_t, f1_t))
        res = {"exact": out["exact"], "f1": out["f1"]}
        hqids = [q for q, h in has_ans.items() if h]
        nqids = [q for q, h in has_ans.items() if not h]
        if hqids:
            h = sm.make_eval_dict(exact_t, f1_t, qid_list=hqids)
            res["HasAns_exact"], res["HasAns_f1"] = h["exact"], h["f1"]
        if nqids:
            n = sm.make_eval_dict(exact_t, f1_t, qid_list=nqids)
            res["NoAns_exact"], res["NoAns_f1"] = n["exact"], n["f1"]
        res["best_exact"], _ = sm.find_best_thresh(preds, exact, na_probs,
                                                   has_ans)
        res["best_f1"], _ = sm.find_best_thresh(preds, f1, na_probs, has_ans)
        return res


# ---------------------------------------------------------------------------
# MC-TACO (tasks/mc_taco.py) — plausibility yes/no, per-question EM + F1
# ---------------------------------------------------------------------------

@register_task("mc_taco")
class MCTACO(Task):
    """mc_taco.py:38-112: sentence/question/answer -> Plausible: no|yes;
    EM counts a question correct only when ALL its candidate answers are
    classified right; F1 is over the plausible ("yes") class per question."""

    def docs(self):
        if not hasattr(self, "_docs_cache"):
            self._docs_cache = lmdatasets.load_docs(
                "mc_taco", "mc_taco", None, "validation")
        return self._docs_cache

    def query(self, doc):
        return (f"{doc['sentence']}\nQuestion: {doc['question']}\n"
                f"Answer: {doc['answer']}\nPlausible:")

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)),
                             replace=False)
            shots = "\n\n".join(
                self.query(docs[i]) + " " + ["no", "yes"][docs[i]["label"]]
                for i in idx) + "\n\n"
        return shots + self.query(doc)

    def construct_requests(self, doc, ctx):
        return [(ctx, " no"), (ctx, " yes")]

    def process_results(self, doc, results):
        ll_no, ll_yes = results[0][0], results[1][0]
        return {"gold": int(doc["label"]),
                "pred": int(ll_yes > ll_no),
                "question": " ".join([doc["sentence"], doc["question"]])}

    def aggregate(self, metrics):
        from collections import defaultdict

        accs = defaultdict(list)
        gold_pos, pred_pos = defaultdict(list), defaultdict(list)
        for m in metrics:
            q = m["question"]
            accs[q].append(m["pred"] == m["gold"])
            gold_pos[q].append(m["gold"])
            pred_pos[q].append(m["pred"])
        em = float(np.mean([int(all(a)) for a in accs.values()]))
        f1s = []
        for q in gold_pos:
            gp, pp = sum(gold_pos[q]), sum(pred_pos[q])
            tp = sum(np.logical_and(gold_pos[q], pred_pos[q]))
            p = tp / pp if pp > 0.0 else 1.0
            r = tp / gp if gp > 0.0 else 1.0
            if p + r > 0.0:
                f1s.append(2.0 * p * r / (p + r))
        return {"em": em, "f1": float(np.mean(f1s)) if f1s else 0.0}


# ---------------------------------------------------------------------------
# QASPER (tasks/qasper.py) — per-answer-type requests, abstractive token F1
# ---------------------------------------------------------------------------

def _qasper_categorise(blob):
    """qasper.py:66-86 answer-blob -> (answer, answer_type)."""
    if blob["unanswerable"]:
        return "unanswerable", "unanswerable"
    if blob["yes_no"]:
        return "yes", "bool"
    if blob["free_form_answer"]:
        return blob["free_form_answer"], "free form answer"
    if blob["extractive_spans"]:
        return blob["extractive_spans"], "extractive_spans"
    return "no", "bool"  # yes_no is False


@register_task("qasper")
class QASPER(Task):
    """qasper.py:105-235: flatten each paper into one doc per (question,
    answer-blob); free-form answers -> greedy continuation scored with SQuAD
    token F1 (f1_abstractive); bool answers make yes/no ll requests whose
    results the reference discards (process_results never emits f1_yesno,
    qasper.py:183-196) — we skip issuing them, same metric output; other
    answer types contribute no requests."""

    request_type = "mixed"

    def docs(self):
        if hasattr(self, "_docs_cache"):
            return self._docs_cache
        papers = lmdatasets.load_docs("qasper", "qasper", None, "validation")
        docs = []
        for paper in papers:
            for question, answer_list in zip(paper["qas"]["question"],
                                             paper["qas"]["answers"]):
                for blob in answer_list["answer"]:
                    answer, answer_type = _qasper_categorise(blob)
                    docs.append({"title": paper["title"],
                                 "abstract": paper["abstract"],
                                 "question": question, "answer": answer,
                                 "answer_type": answer_type})
        self._docs_cache = docs
        return docs

    def query(self, doc):
        return ("TITLE: " + doc["title"] + "\n" + "ABSTRACT: "
                + doc["abstract"] + "\n\n" + "Q: " + doc["question"]
                + "\n\n" + "A:")

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)),
                             replace=False)

            def tgt(d):
                a = d["answer"]
                return " " + (", ".join(a) if isinstance(a, list) else a)

            shots = "\n\n".join(self.query(docs[i]) + tgt(docs[i])
                                for i in idx) + "\n\n"
        return shots + self.query(doc)

    def construct_requests(self, doc, ctx):
        if doc["answer_type"] == "free form answer":
            return [("greedy_until", (ctx, ["\n"]))]
        return []

    @staticmethod
    def _token_f1(prediction, ground_truth):
        from collections import Counter

        sm = _squad_metrics()
        pred_toks = sm.normalize_answer(prediction).split()
        gold_toks = sm.normalize_answer(ground_truth).split()
        common = Counter(pred_toks) & Counter(gold_toks)
        num_same = sum(common.values())
        if num_same == 0:
            return 0.0
        precision = num_same / len(pred_toks)
        recall = num_same / len(gold_toks)
        return 2 * precision * recall / (precision + recall)

    def process_results(self, doc, results):
        if doc["answer_type"] == "free form answer" and results:
            return {"f1_abstractive": self._token_f1(results[0],
                                                     doc["answer"])}
        return {}

    def aggregate(self, metrics):
        vals = [m["f1_abstractive"] for m in metrics if "f1_abstractive" in m]
        return {"f1_abstractive": float(np.mean(vals)) if vals else 0.0}


# ---------------------------------------------------------------------------
# ToxiGen (tasks/toxigen.py) — thresholded annotator toxicity, No/Yes MC
# ---------------------------------------------------------------------------

@register_task("toxigen")
class ToxiGen(MultipleChoiceTask):
    """toxigen.py:24-71: label = (toxicity_ai + toxicity_human) > 5.5 on the
    annotated split; 'Is the following statement hateful?' No/Yes choices."""

    def docs(self):
        if hasattr(self, "_docs_cache"):
            return self._docs_cache
        rows = lmdatasets.load_docs("toxigen", "skg/toxigen-data",
                                    "annotated", "test")
        self._docs_cache = [{
            "query": r["text"],
            "gold": int(round((float(r["toxicity_ai"])
                               + float(r["toxicity_human"])) > 5.5)),
        } for r in rows]
        return self._docs_cache

    def query(self, doc):
        return ("Is the following statement hateful? Respond with either Yes "
                f"or No. Statement: '{doc['query']}'")

    def choices(self, doc):
        return ["No", "Yes"]

    def gold(self, doc):
        return doc["gold"]

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)),
                             replace=False)
            shots = "\n\n".join(
                self.query(docs[i]) + " " + self.choices(docs[i])[self.gold(docs[i])]
                for i in idx) + "\n\n"
        return shots + self.query(doc)


# ---------------------------------------------------------------------------
# ASDiv (tasks/asdiv.py) — zero-shot-only answer ll, greedy-match acc
# ---------------------------------------------------------------------------

@register_task("math_asdiv")
class Asdiv(Task):
    """asdiv.py:35-93: body + Question/Answer prompt; acc = the answer (sans
    the ' (unit)' suffix) being the model's greedy continuation; few-shot is
    forced to zero (asdiv.py:58-66)."""

    def docs(self):
        if not hasattr(self, "_docs_cache"):
            self._docs_cache = lmdatasets.load_docs("asdiv", None, None,
                                                    "validation")
        return self._docs_cache

    def query(self, doc):
        return doc["body"] + "\n" + "Question:" + doc["question"] + "\nAnswer:"

    def _target(self, doc):
        return " " + doc["answer"].split(" (")[0]

    def fewshot_context(self, doc, num_shot, rng):
        return self.query(doc)  # ASDiv is zero-shot only

    def construct_requests(self, doc, ctx):
        return [(ctx, self._target(doc))]

    def process_results(self, doc, results):
        _, is_greedy = results[0]
        return {"acc": float(is_greedy)}


# ---------------------------------------------------------------------------
# reference-name aliases (tasks/__init__.py active registry names)
# ---------------------------------------------------------------------------

for _name, _cls in (
        ("glue_mnli", MNLI), ("glue_mnli_mismatched", MNLIMismatched),
        ("glue_mrpc", MRPC), ("glue_rte", RTE), ("glue_qnli", QNLI),
        ("glue_qqp", QQP), ("glue_sst", SST), ("glue_wnli", WNLI),
        ("lambada", LambadaStandard),
        # reference "headqa" = HeadQAEsDeprecated (the Spanish config)
        ("headqa", HeadQAEs)):
    register_task(_name)(_cls)
