"""Offline-runnable lm-eval tasks over the bundled corpora.

A copy of mi_optimize_tpu/eval/lmeval_tasks.py, its imports pointed at the
port's datasets and eval.lmeval. The reference registers ~190 remote-dataset tasks
(benchmark/lmeval/tasks/__init__.py:45-262); those need network. Here we
register the task *shapes* the harness exercises — multiple-choice (C-Eval /
CMMLU via loglikelihood over the four choice strings, the standard
hendrycks-style MC protocol) and rolling perplexity (wikitext) — over data
that resolves offline. Remote lm-eval task definitions can be added through
the same register_task hook when network/datasets are available.
"""
from __future__ import annotations

from typing import List

from ..datasets import mcqa as D
from .lmeval import MultipleChoiceTask, PerplexityTask, register_task


class _McqaBase(MultipleChoiceTask):
    bench = "ceval"
    subject_filter = "all"
    split = "val"

    def docs(self) -> List[dict]:
        docs = []
        for sub in D.get_subjects(self.bench, self.subject_filter):
            rows_fn = D._rows_ceval if self.bench == "ceval" else D._rows_cmmlu
            for r in rows_fn(sub, self.split):
                if str(r.get("answer", "")).strip().upper() in "ABCD" and r.get("question"):
                    docs.append(r)
        return docs

    def fewshot_context(self, doc, num_shot, rng):
        ctx = ""
        if num_shot:
            shots = D.get_questions(self.bench, subject=self.subject_filter,
                                    split=self.split, question=num_shot, answer=True)
            ctx = "\n\n".join(shots[:num_shot]) + "\n\n"
        return ctx + f"{doc['question']}\n答案："

    def choices(self, doc):
        return [doc[c] for c in "ABCD"]

    def gold(self, doc):
        return "ABCD".index(str(doc["answer"]).strip().upper())


@register_task("ceval_mc")
class CevalMC(_McqaBase):
    bench = "ceval"
    split = "val"


@register_task("cmmlu_mc")
class CmmluMC(_McqaBase):
    bench = "cmmlu"
    split = "test"


@register_task("wikitext")
class WikitextPPL(PerplexityTask):
    def docs(self):
        from ..datasets.calibration import _load_arrow_split, find_data_path

        path = find_data_path("wikitext")
        if path is None:
            return []
        ds = _load_arrow_split(path, "test")
        text = "\n\n".join(ds["text"])
        # split the corpus into paragraph docs like lm-eval's wikitext task
        return [{"text": t} for t in text.split("\n\n") if len(t) > 200][:64]


# ---------------------------------------------------------------------------
# standard harness tasks (HF datasets — resolved on demand; environments
# without network/caches simply get an empty doc list + a clear log line)
# ---------------------------------------------------------------------------

import logging

log = logging.getLogger(__name__)


def _hf_docs(path, name, split):
    from ..datasets.lmdatasets import hf_load

    try:
        return hf_load(path, name, split)
    except Exception as e:  # offline / no cache
        log.warning("lm-eval task dataset %s unavailable (%s)", path, e)
        return []


class _HFMultipleChoice(MultipleChoiceTask):
    """Generic hendrycks-style MC task over a HF dataset."""

    path: str
    name = None
    split = "validation"
    offline_key = None  # datasets/lmdatasets.py raw-format builder, if any

    def docs(self):
        # memoized: fewshot_context calls docs() per evaluated doc, which
        # would otherwise re-run load_dataset O(n) times
        if not hasattr(self, "_docs_cache"):
            if self.offline_key:
                from ..datasets import lmdatasets

                self._docs_cache = lmdatasets.load_docs(
                    self.offline_key, self.path, self.name, self.split)
            else:
                self._docs_cache = _hf_docs(self.path, self.name, self.split)
        return self._docs_cache

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)), replace=False)
            shots = "\n\n".join(
                self.query(docs[i]) + " " + self.choices(docs[i])[self.gold(docs[i])]
                for i in idx
            ) + "\n\n"
        return shots + self.query(doc)

    def query(self, doc) -> str:
        raise NotImplementedError


@register_task("hellaswag")
class HellaSwag(_HFMultipleChoice):
    """Protocol parity: tasks/hellaswag.py:52-68 (ctx_a+ctx_b.capitalize(),
    activity-label prefix, bracket-artifact scrub)."""

    path = "hellaswag"

    @staticmethod
    def _pre(text):
        import re

        text = text.strip().replace(" [title]", ". ")
        text = re.sub(r"\[.*?\]", "", text)
        return text.replace("  ", " ")

    def query(self, doc):
        ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
        return self._pre(doc["activity_label"] + ": " + ctx)

    def choices(self, doc):
        return [self._pre(e) for e in doc["endings"]]

    def gold(self, doc):
        return int(doc["label"])


@register_task("piqa")
class PiQA(_HFMultipleChoice):
    path = "piqa"

    def query(self, doc):
        return f"Question: {doc['goal']}\nAnswer:"

    def choices(self, doc):
        return [doc["sol1"], doc["sol2"]]

    def gold(self, doc):
        return int(doc["label"])


@register_task("winogrande")
class Winogrande(_HFMultipleChoice):
    """Partial-evaluation protocol (tasks/winogrande.py:56-100): ll of the
    shared TAIL given each option substituted for the pronoun."""

    path = "winogrande"
    name = "winogrande_xl"

    def query(self, doc):  # few-shot display form
        loc = doc["sentence"].index("_")
        return doc["sentence"][:loc] + doc["option" + doc["answer"]]

    def choices(self, doc):
        return [" " + doc["sentence"][doc["sentence"].index("_") + 1:].strip()] * 2

    def gold(self, doc):
        return int(doc["answer"]) - 1

    def construct_requests(self, doc, ctx):
        loc = doc["sentence"].index("_")
        tail = " " + doc["sentence"][loc + 1:].strip()
        shots = ctx[: len(ctx) - len(self.query(doc))]
        return [(shots + doc["sentence"][:loc] + opt, tail)
                for opt in (doc["option1"], doc["option2"])]


@register_task("arc_easy")
class ArcEasy(_HFMultipleChoice):
    path = "ai2_arc"
    name = "ARC-Easy"
    split = "validation"

    def query(self, doc):
        return f"Question: {doc['question']}\nAnswer:"

    def choices(self, doc):
        return doc["choices"]["text"]

    def gold(self, doc):
        return doc["choices"]["label"].index(doc["answerKey"])


@register_task("arc_challenge")
class ArcChallenge(ArcEasy):
    name = "ARC-Challenge"


@register_task("boolq")
class BoolQ(_HFMultipleChoice):
    path = "super_glue"
    name = "boolq"

    def query(self, doc):
        return f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"

    def choices(self, doc):
        return ["no", "yes"]

    def gold(self, doc):
        return int(doc["label"])


def _detok(text: str) -> str:
    """general_detokenize parity (benchmark/lmeval/utils.py)."""
    import re

    text = text.replace(" n't", "n't").replace(" )", ")").replace("( ", "(")
    text = text.replace('" ', '"').replace(' "', '"')
    text = re.sub(r" (['.,])", r"\1", text)
    return text


# ---------------------------------------------------------------------------
# LAMBADA (tasks/lambada.py:31-99): ll + greedy-match acc of the final word
# ---------------------------------------------------------------------------

from .lmeval import Task
import numpy as _np


class _LambadaBase(Task):
    path: str
    name = None
    split = "validation"

    def docs(self):
        return _hf_docs(self.path, self.name, self.split)

    def fewshot_context(self, doc, num_shot, rng):
        return doc["text"].rsplit(" ", 1)[0]

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + doc["text"].rsplit(" ", 1)[1])]

    def process_results(self, doc, results):
        ll, greedy = results[0]
        return {"ll": ll, "acc": float(greedy)}

    def aggregate(self, metrics):
        return {
            "ppl": float(_np.exp(-_np.mean([m["ll"] for m in metrics]))),
            "acc": float(_np.mean([m["acc"] for m in metrics])),
        }


@register_task("lambada_standard")
class LambadaStandard(_LambadaBase):
    path = "lambada"


@register_task("lambada_openai")
class LambadaOpenAI(_LambadaBase):
    path = "EleutherAI/lambada_openai"
    name = "en"
    split = "test"


# ---------------------------------------------------------------------------
# more hendrycks-style MC tasks (protocol parity with the vendored registry)
# ---------------------------------------------------------------------------

@register_task("openbookqa")
class OpenBookQA(_HFMultipleChoice):
    """tasks/openbookqa.py:55-66: bare question stem, answer choices."""

    path = "openbookqa"
    name = "main"

    def query(self, doc):
        return doc["question_stem"]

    def choices(self, doc):
        return doc["choices"]["text"]

    def gold(self, doc):
        return ["A", "B", "C", "D"].index(doc["answerKey"].strip())


@register_task("sciq")
class SciQ(_HFMultipleChoice):
    """tasks/sciq.py:50-68: support passage + Question/Answer, gold last."""

    path = "sciq"

    def query(self, doc):
        return f"{doc['support']}\nQuestion: {doc['question']}\nAnswer:".strip()

    def choices(self, doc):
        return [doc["distractor1"], doc["distractor2"], doc["distractor3"],
                doc["correct_answer"]]

    def gold(self, doc):
        return 3


@register_task("logiqa")
class LogiQA(_HFMultipleChoice):
    """tasks/logiqa.py:55-88: Passage/Question/Choices block, answer letter."""

    path = "lucasmccabe/logiqa"
    split = "validation"
    offline_key = "logiqa"  # official Eval.txt via datasets/lmdatasets.py

    def query(self, doc):
        prompt = "Passage: " + doc["context"] + "\n"
        prompt += "Question: " + doc["query"] + "\nChoices:\n"
        for letter, option in zip("ABCD", doc["options"]):
            prompt += f"{letter}. {option}\n"
        return prompt + "Answer:"

    def choices(self, doc):
        return doc["options"]

    def gold(self, doc):
        return int(doc["correct_option"])


@register_task("mathqa")
class MathQA(_HFMultipleChoice):
    """tasks/mathqa.py:52-68: Question/Answer over regex-split options."""

    path = "math_qa"
    split = "validation"

    def query(self, doc):
        return "Question: " + doc["Problem"] + "\nAnswer:"

    def choices(self, doc):
        import re

        return [c[4:].rstrip(" ,") for c in
                re.findall(r"[abcd] \) .*?, |e \) .*?$", doc["options"])]

    def gold(self, doc):
        return ["a", "b", "c", "d", "e"].index(doc["correct"])


# ---------------------------------------------------------------------------
# GLUE / ANLI binary & ternary NLI tasks (tasks/glue.py, tasks/anli.py)
# ---------------------------------------------------------------------------

class _BinaryLL(_HFMultipleChoice):
    """Two-continuation classification; gold = label index into options."""

    options: tuple = (" yes", " no")

    def choices(self, doc):
        return list(self.options)

    def fewshot_context(self, doc, num_shot, rng):
        return super().fewshot_context(doc, num_shot, rng) if num_shot else self.query(doc)


@register_task("sst")
class SST(_BinaryLL):
    """glue.py:102-151: positive/negative sentiment."""

    path = "glue"
    name = "sst2"
    options = (" negative", " positive")  # label 0=negative, 1=positive

    def query(self, doc):
        return (f"{_detok(doc['sentence'])}\nQuestion: Is this sentence "
                "positive or negative?\nAnswer:")

    def gold(self, doc):
        return int(doc["label"])


@register_task("rte")
class RTE(_BinaryLL):
    """glue.py:327-375: True(entail)/False."""

    path = "glue"
    name = "rte"
    options = (" True", " False")

    def query(self, doc):
        return f"{doc['sentence1']}\nQuestion: {doc['sentence2']} True or False?\nAnswer:"

    def gold(self, doc):
        return int(doc["label"])  # 0 entailment -> True


@register_task("qnli")
class QNLI(_BinaryLL):
    """glue.py:223-272: does the response answer the question? yes/no."""

    path = "glue"
    name = "qnli"

    def query(self, doc):
        return (f"{doc['question']}\n{doc['sentence']}\nQuestion: Does this "
                "response answer the question?\nAnswer:")

    def gold(self, doc):
        return int(doc["label"])  # 0 entailment -> yes


@register_task("wnli")
class WNLI(_BinaryLL):
    path = "glue"
    name = "wnli"
    options = (" False", " True")  # label 1 = entailment = True

    def query(self, doc):
        return f"{doc['sentence1']}\nQuestion: {doc['sentence2']} True or False?\nAnswer:"

    def gold(self, doc):
        return int(doc["label"])


@register_task("mrpc")
class MRPC(_BinaryLL):
    """glue.py:381-430 (acc + F1)."""

    path = "glue"
    name = "mrpc"
    options = (" no", " yes")  # label 1 = equivalent = yes

    def query(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Do both sentences "
                "mean the same thing?\nAnswer:").format(
                    _detok(doc["sentence1"]), _detok(doc["sentence2"]))

    def gold(self, doc):
        return int(doc["label"])

    def process_results(self, doc, results):
        out = super().process_results(doc, results)
        lls = [r[0] for r in results]
        out["pred"] = float(_np.argmax(lls))
        out["gold_lbl"] = float(self.gold(doc))
        return out

    def aggregate(self, metrics):
        acc = float(_np.mean([m["acc"] for m in metrics]))
        preds = _np.array([m["pred"] for m in metrics])
        golds = _np.array([m["gold_lbl"] for m in metrics])
        tp = float(((preds == 1) & (golds == 1)).sum())
        fp = float(((preds == 1) & (golds == 0)).sum())
        fn = float(((preds == 0) & (golds == 1)).sum())
        f1 = 2 * tp / max(2 * tp + fp + fn, 1e-9)
        return {"acc": acc, "f1": f1}


@register_task("qqp")
class QQP(MRPC):
    """glue.py:434-488 (acc + F1)."""

    path = "glue"
    name = "qqp"

    def query(self, doc):
        return ("Question 1: {}\nQuestion 2: {}\nQuestion: Do both questions "
                "ask the same thing?\nAnswer:").format(
                    doc["question1"], doc["question2"])


class _TernaryNLI(_HFMultipleChoice):
    """True/Neither/False NLI (glue.py MNLI:180-201, anli.py:62-85)."""

    options = (" True", " Neither", " False")

    def choices(self, doc):
        return list(self.options)

    def gold(self, doc):
        return int(doc["label"])  # 0 entail, 1 neutral, 2 contradiction


@register_task("mnli")
class MNLI(_TernaryNLI):
    path = "glue"
    name = "mnli"
    split = "validation_matched"

    def query(self, doc):
        hyp = doc["hypothesis"].strip()
        hyp = hyp + ("" if hyp.endswith(".") else ".")
        return f"{doc['premise']}\nQuestion: {hyp} True, False or Neither?\nAnswer:"


@register_task("mnli_mismatched")
class MNLIMismatched(MNLI):
    split = "validation_mismatched"


class _ANLIBase(_TernaryNLI):
    path = "anli"
    round = 1

    @property
    def split(self):
        return f"dev_r{self.round}"

    @split.setter
    def split(self, v):
        pass

    def query(self, doc):
        return (doc["premise"] + "\nQuestion: " + doc["hypothesis"]
                + " True, False, or Neither?\nAnswer:")


@register_task("anli_r1")
class ANLIRound1(_ANLIBase):
    round = 1


@register_task("anli_r2")
class ANLIRound2(_ANLIBase):
    round = 2


@register_task("anli_r3")
class ANLIRound3(_ANLIBase):
    round = 3


# generation / QA / bias / linguistic tasks live in their own module; import
# for the registry side-effect so evaluate_tasks sees the full corpus
from . import lmeval_gen_tasks  # noqa: E402,F401
