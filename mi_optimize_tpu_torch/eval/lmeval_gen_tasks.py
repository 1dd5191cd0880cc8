"""Generation (greedy_until) + QA + bias/linguistic lm-eval tasks.

A copy of mi_optimize_tpu/eval/lmeval_gen_tasks.py, its imports pointed at
the port's datasets and eval modules. Protocol parity with the reference
toolbox's vendored harness task modules (benchmark/lmeval/tasks/):
  coqa        tasks/coqa.py                                        (greedy_until ["\\nQ:"], squad EM/F1 over multi-answers)
  drop        tasks/drop.py                                        (greedy_until ["."], bag EM / aligned-bag F1)
  triviaqa    tasks/triviaqa.py                                    (loglikelihood-any over deduped answer aliases)
  gsm8k       tasks/gsm8k.py                                       (greedy_until ["\\n"], '#### <num>' exact match)
  webqs       tasks/webqs.py                                       (loglikelihood-any over answers)
  blimp_*     tasks/blimp.py      (67 linguistic minimal-pair UIDs) (P(good) > P(bad) from empty context)
  crows_pairs_* tasks/crowspairs.py (24 english/french bias slices) (pct_stereotype + likelihood_difference)
  swag/race/headqa/mutual/qa4mre/pubmedqa/wsc273                    (multiple-choice protocols)

Dataset resolution is offline-first through datasets/lmdatasets.py; HF-hosted
tasks fall back to the HF cache and hard-fail loudly when nothing is available
(eval/lmeval.py::evaluate_tasks).
"""
from __future__ import annotations

import logging
import re
import string

import numpy as np

from ..datasets import lmdatasets
from .lmeval import Task, register_task
from .lmeval_tasks import _HFMultipleChoice, _detok, _hf_docs

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# squad-style answer normalization + EM/F1 (the functions of
# transformers.squad_metrics, which the reference imports in tasks/coqa.py;
# the port's own copy: eval/squad_metrics.py)
# ---------------------------------------------------------------------------

def _squad():
    from . import squad_metrics

    return squad_metrics


# ---------------------------------------------------------------------------
# CoQA (tasks/coqa.py)
# ---------------------------------------------------------------------------

@register_task("coqa")
class CoQA(Task):
    request_type = "greedy_until"

    def docs(self):
        return lmdatasets.load_docs("coqa", "coqa", None, "validation")

    def fewshot_context(self, doc, num_shot, rng):
        # the conversation history IS the few-shot context (doc_to_text :55-64)
        text = doc["story"] + "\n\n"
        qs = doc["questions"]["input_text"]
        ans = doc["answers"]["input_text"][:-1]
        for i, q in enumerate(qs):
            a = ans[i] if i < len(ans) else None
            text += f"Q: {q}\n\n" + (f"A: {a}\n\n" if a is not None else "A:")
        return text

    def construct_requests(self, doc, ctx):
        return [(ctx, ["\nQ:"])]

    @staticmethod
    def _answers(doc):
        turn = len(doc["questions"]["input_text"])
        answers = [doc["answers"]["input_text"][turn - 1]]
        for extra in (doc.get("additional_answers") or {}).values():
            a = extra["input_text"][turn - 1]
            if a.lower() not in map(str.lower, answers):
                answers.append(a)
        return answers

    @staticmethod
    def _scores(gold_list, pred):
        sm = _squad()
        em = f1 = 0.0
        if len(gold_list) > 1:
            # leave-one-out over golds (coqa.py:106-117)
            for i in range(len(gold_list)):
                rest = gold_list[:i] + gold_list[i + 1:]
                em += max(sm.compute_exact(a, pred) for a in rest)
                f1 += max(sm.compute_f1(a, pred) for a in rest)
        else:
            em += max(sm.compute_exact(a, pred) for a in gold_list)
            f1 += max(sm.compute_f1(a, pred) for a in gold_list)
        n = max(1, len(gold_list))
        return em / n, f1 / n

    def process_results(self, doc, results):
        pred = results[0].strip().split("\n")[0]
        em, f1 = self._scores(self._answers(doc), pred)
        return {"em": em, "f1": f1}


# ---------------------------------------------------------------------------
# DROP (tasks/drop.py) — numerically-aware bag EM/F1
# ---------------------------------------------------------------------------

_ARTICLES = re.compile(r"\b(a|an|the)\b", re.UNICODE)


def _drop_is_number(t):
    try:
        float(t)
        return True
    except ValueError:
        return False


def _drop_normalize(answer: str) -> str:
    def fix(token):
        token = token.lower()
        if not _drop_is_number(token):
            token = "".join(ch for ch in token if ch not in set(string.punctuation))
        else:
            token = str(float(token))
        token = _ARTICLES.sub(" ", token)
        return " ".join(token.split())

    tokens = [fix(t) for t in re.split(" |-", answer)]
    return " ".join(t for t in tokens if t.strip()).strip()


def _drop_bags(answer):
    spans = answer if isinstance(answer, (list, tuple)) else [answer]
    norm = [_drop_normalize(s) for s in spans]
    return norm, [set(s.split()) for s in norm]


def _drop_bag_f1(pred_bag, gold_bag):
    inter = len(gold_bag & pred_bag)
    p = inter / len(pred_bag) if pred_bag else 1.0
    r = inter / len(gold_bag) if gold_bag else 1.0
    return 2 * p * r / (p + r) if (p or r) else 0.0


def _drop_numbers_match(gold_bag, pred_bag):
    gn = {w for w in gold_bag if _drop_is_number(w)}
    pn = {w for w in pred_bag if _drop_is_number(w)}
    return (not gn and not pn) or bool(gn & pn)


def drop_metrics(predicted, gold):
    """(em, f1) per tasks/drop.py::get_metrics (aligned bags via Hungarian)."""
    from scipy.optimize import linear_sum_assignment

    p_norm, p_bags = _drop_bags(predicted)
    g_norm, g_bags = _drop_bags(gold)
    em = 1.0 if set(p_norm) == set(g_norm) and len(p_norm) == len(g_norm) else 0.0
    scores = np.zeros((len(g_bags), len(p_bags)))
    for gi, gb in enumerate(g_bags):
        for pi, pb in enumerate(p_bags):
            if _drop_numbers_match(gb, pb):
                scores[gi, pi] = _drop_bag_f1(pb, gb)
    rows, cols = linear_sum_assignment(-scores)
    maxes = np.zeros(max(len(g_bags), len(p_bags)))
    for r, c in zip(rows, cols):
        maxes[r] = max(maxes[r], scores[r, c])
    return em, round(float(np.mean(maxes)), 2)


@register_task("drop")
class DROP(Task):
    request_type = "greedy_until"

    def docs(self):
        return [self._process(d) for d in
                lmdatasets.load_docs("drop", "drop", None, "validation")]

    @staticmethod
    def _parse_answer(ans):
        if str(ans["number"]) != "":
            return (str(ans["number"]),)
        if ans["spans"]:
            return tuple(ans["spans"])
        d = ans["date"]
        return (" ".join([d["day"], d["month"], d["year"]]).strip(),)

    def _process(self, doc):
        seen, answers = set(), []
        va = doc.get("validated_answers") or {"number": [], "date": [], "spans": []}
        flat = [doc["answer"]] + [
            {"number": va["number"][i], "date": va["date"][i], "spans": va["spans"][i]}
            for i in range(len(va["number"]))
        ]
        for cand in flat:
            a = self._parse_answer(cand)
            if a not in seen:
                seen.add(a)
                answers.append(a)
        return {"id": doc.get("query_id", ""), "passage": doc["passage"],
                "question": doc["question"], "answers": answers}

    def fewshot_context(self, doc, num_shot, rng):
        return f"Passage: {doc['passage']}\nQuestion: {doc['question']}\nAnswer:"

    def construct_requests(self, doc, ctx):
        return [(ctx, ["."])]

    def process_results(self, doc, results):
        em = f1 = 0.0
        for gold in doc["answers"]:
            if gold[0].strip():
                e, f = drop_metrics(results, gold)
                em, f1 = max(em, e), max(f1, f)
        return {"em": em, "f1": f1}


# ---------------------------------------------------------------------------
# TriviaQA / WebQs (loglikelihood-any over answer aliases)
# ---------------------------------------------------------------------------

class _LLAny(Task):
    """acc = any alias continuation is the greedy completion (triviaqa.py:77-85)."""

    def aliases(self, doc):
        raise NotImplementedError

    @staticmethod
    def _remove_prefixes(aliases):
        aliases = sorted(aliases)
        out = [aliases[0]]
        for a in aliases[1:]:
            if not a.startswith(out[-1]):
                out.append(a)
        return out

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + a) for a in self._remove_prefixes(self.aliases(doc))]

    def process_results(self, doc, results):
        return {"acc": float(any(greedy for _, greedy in results))}


@register_task("triviaqa")
class TriviaQA(_LLAny):
    def docs(self):
        return lmdatasets.load_docs("triviaqa", "trivia_qa", "unfiltered.nocontext",
                                    "validation")

    def fewshot_context(self, doc, num_shot, rng):
        return f"Question: {doc['question']}\nAnswer:"

    def aliases(self, doc):
        return list(doc["answer"]["aliases"]) or [doc["answer"]["value"]]


@register_task("webqs")
class WebQs(_LLAny):
    def docs(self):
        return lmdatasets.load_docs("webqs", "web_questions", None, "test")

    def fewshot_context(self, doc, num_shot, rng):
        return f"Question: {doc['question']}\nAnswer:"

    def aliases(self, doc):
        return list(doc["answers"])


# ---------------------------------------------------------------------------
# GSM8K (tasks/gsm8k.py) — greedy_until + '#### <num>' extraction
# ---------------------------------------------------------------------------

_ANS_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
_INVALID = "[invalid]"


def gsm8k_extract(completion: str) -> str:
    m = _ANS_RE.search(completion)
    return m.group(1).strip().replace(",", "") if m else _INVALID


@register_task("gsm8k")
class GSM8K(Task):
    request_type = "greedy_until"

    def docs(self):
        if not hasattr(self, "_docs_cache"):  # fewshot calls docs() per doc
            self._docs_cache = lmdatasets.load_docs("gsm8k", "gsm8k", "main",
                                                    "test")
        return self._docs_cache

    def fewshot_context(self, doc, num_shot, rng):
        shots = ""
        if num_shot:
            docs = self.docs()
            idx = rng.choice(len(docs), size=min(num_shot, len(docs)), replace=False)
            shots = "\n\n".join(
                f"Question: {docs[i]['question']}\nAnswer: {docs[i]['answer']}"
                for i in idx) + "\n\n"
        return shots + "Question: " + doc["question"] + "\nAnswer:"

    def construct_requests(self, doc, ctx):
        return [(ctx, ["\n"])]

    def process_results(self, doc, results):
        gold = gsm8k_extract(doc["answer"])
        assert gold != _INVALID, "no ground-truth '#### <num>' in doc"
        return {"acc": float(gsm8k_extract(results[0]) == gold)}


# ---------------------------------------------------------------------------
# BLiMP — 67 linguistic minimal-pair UIDs (tasks/blimp.py); the UID list is
# the public benchmark's own config set (category-b constants)
# ---------------------------------------------------------------------------

BLIMP_UIDS = (
    "adjunct_island", "anaphor_gender_agreement", "anaphor_number_agreement",
    "animate_subject_passive", "animate_subject_trans", "causative",
    "complex_NP_island", "coordinate_structure_constraint_complex_left_branch",
    "coordinate_structure_constraint_object_extraction",
    "determiner_noun_agreement_1", "determiner_noun_agreement_2",
    "determiner_noun_agreement_irregular_1", "determiner_noun_agreement_irregular_2",
    "determiner_noun_agreement_with_adj_2",
    "determiner_noun_agreement_with_adj_irregular_1",
    "determiner_noun_agreement_with_adj_irregular_2",
    "determiner_noun_agreement_with_adjective_1",
    "distractor_agreement_relational_noun", "distractor_agreement_relative_clause",
    "drop_argument", "ellipsis_n_bar_1", "ellipsis_n_bar_2",
    "existential_there_object_raising", "existential_there_quantifiers_1",
    "existential_there_quantifiers_2", "existential_there_subject_raising",
    "expletive_it_object_raising", "inchoative", "intransitive",
    "irregular_past_participle_adjectives", "irregular_past_participle_verbs",
    "irregular_plural_subject_verb_agreement_1",
    "irregular_plural_subject_verb_agreement_2",
    "left_branch_island_echo_question", "left_branch_island_simple_question",
    "matrix_question_npi_licensor_present", "npi_present_1", "npi_present_2",
    "only_npi_licensor_present", "only_npi_scope", "passive_1", "passive_2",
    "principle_A_c_command", "principle_A_case_1", "principle_A_case_2",
    "principle_A_domain_1", "principle_A_domain_2", "principle_A_domain_3",
    "principle_A_reconstruction", "regular_plural_subject_verb_agreement_1",
    "regular_plural_subject_verb_agreement_2",
    "sentential_negation_npi_licensor_present", "sentential_negation_npi_scope",
    "sentential_subject_island", "superlative_quantifiers_1",
    "superlative_quantifiers_2", "tough_vs_raising_1", "tough_vs_raising_2",
    "transitive", "wh_island", "wh_questions_object_gap",
    "wh_questions_subject_gap", "wh_questions_subject_gap_long_distance",
    "wh_vs_that_no_gap", "wh_vs_that_no_gap_long_distance",
    "wh_vs_that_with_gap", "wh_vs_that_with_gap_long_distance",
)


class _Blimp(Task):
    """P(sentence_good) > P(sentence_bad), both from an empty context
    (tasks/blimp.py: construct_requests/process_results)."""

    uid: str = ""

    def docs(self):
        return _hf_docs("blimp", self.uid, "train")

    def fewshot_context(self, doc, num_shot, rng):
        # "few-shot" is nonsensical for minimal pairs (blimp.py comment)
        return ""

    def construct_requests(self, doc, ctx):
        return [("", doc["sentence_good"]), ("", doc["sentence_bad"])]

    def process_results(self, doc, results):
        return {"acc": float(results[0][0] > results[1][0])}


for _uid in BLIMP_UIDS:
    register_task(f"blimp_{_uid}")(type(f"Blimp_{_uid}", (_Blimp,), {"uid": _uid}))


# ---------------------------------------------------------------------------
# CrowS-Pairs — 24 english/french bias slices (tasks/crowspairs.py)
# ---------------------------------------------------------------------------

_CROWS_BIAS = ("race-color", "socioeconomic", "gender", "age", "religion",
               "disability", "sexual-orientation", "nationality",
               "physical-appearance", "autre")


class _CrowsPairs(Task):
    lang: str = "english"
    bias_type = None

    def docs(self):
        docs = _hf_docs("BigScienceBiasEval/crows_pairs_multilingual", self.lang,
                        "test")
        if self.bias_type is not None:
            docs = [d for d in docs if d["bias_type"].startswith(self.bias_type)]
        return docs

    def fewshot_context(self, doc, num_shot, rng):
        return ""

    def construct_requests(self, doc, ctx):
        return [("", doc["sent_more"]), ("", doc["sent_less"])]

    def process_results(self, doc, results):
        ll1, ll2 = results[0][0], results[1][0]
        return {"likelihood_difference": abs(ll1 - ll2),
                "pct_stereotype": float(ll1 > ll2)}


for _lang in ("english", "french"):
    register_task(f"crows_pairs_{_lang}")(
        type(f"CrowsPairs_{_lang}", (_CrowsPairs,), {"lang": _lang}))
    for _bt in _CROWS_BIAS:
        _nm = _bt.replace("-", "_")
        register_task(f"crows_pairs_{_lang}_{_nm}")(
            type(f"CrowsPairs_{_lang}_{_nm}", (_CrowsPairs,),
                 {"lang": _lang, "bias_type": _bt}))


# ---------------------------------------------------------------------------
# more multiple-choice protocols (swag/race/headqa/mutual/qa4mre/pubmedqa/wsc273)
# ---------------------------------------------------------------------------

@register_task("swag")
class SWAG(_HFMultipleChoice):
    """tasks/swag.py: startphrase -> 4 endings."""

    path = "swag"
    name = "regular"

    def query(self, doc):
        return doc["startphrase"]

    def choices(self, doc):
        return [doc["ending0"], doc["ending1"], doc["ending2"], doc["ending3"]]

    def gold(self, doc):
        return int(doc["label"])


@register_task("race")
class RACE(Task):
    """tasks/race.py (GPT-3 style): ONE doc per article — all prior Q/A pairs
    of the passage in the context (cloze '  _  .' questions rendered inline),
    only the LAST problem scored over its 4 options."""

    def docs(self):
        rows = _hf_docs("race", "high", "test")
        by_article = {}
        for r in rows:
            by_article.setdefault(r["article"], []).append(r)
        return [{"article": a,
                 "problems": [{"question": p["question"], "answer": p["answer"],
                               "options": list(p["options"])} for p in ps]}
                for a, ps in by_article.items()]

    @staticmethod
    def _gold_option(problem):
        return problem["options"]["ABCD".index(problem["answer"])]

    def fewshot_context(self, doc, num_shot, rng):
        text = "Article: " + doc["article"] + "\n\n"
        for p in doc["problems"][:-1]:
            if p["question"][-6:] == "  _  .":
                text += p["question"][-5:] + self._gold_option(p) + "\n"
            else:
                text += ("Question: " + p["question"] + "\n"
                         + "Answer: " + self._gold_option(p) + "\n")
        return text + doc["problems"][-1]["question"]

    def construct_requests(self, doc, ctx):
        return [(ctx, " " + opt) for opt in doc["problems"][-1]["options"]]

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        gold = "ABCD".index(doc["problems"][-1]["answer"])
        return {"acc": float(int(np.argmax(lls)) == gold)}


class _HeadQA(_HFMultipleChoice):
    """tasks/headqa.py: qtext -> ra (1-based gold) over answers list."""

    path = "head_qa"
    split = "test"

    def query(self, doc):
        return f"Question: {doc['qtext']}\nAnswer:"

    def choices(self, doc):
        return [a["atext"] for a in doc["answers"]]

    def gold(self, doc):
        return int(doc["ra"]) - 1


@register_task("headqa_en")
class HeadQAEn(_HeadQA):
    name = "en"
    offline_key = "headqa_en"  # official test_HEAD_EN.json


@register_task("headqa_es")
class HeadQAEs(_HeadQA):
    name = "es"
    offline_key = "headqa_es"  # official test_HEAD.json


class _MuTual(_HFMultipleChoice):
    """tasks/mutual.py: detokenized dialogue history -> 4 responses, reported
    as r@1 / r@2 / mrr over the raw loglikelihoods (mutual.py:71-77)."""

    path = "mutual"
    name = "mutual"

    def query(self, doc):
        return _detok(doc["article"])

    def choices(self, doc):
        return [_detok(o) for o in doc["options"]]

    def gold(self, doc):
        return "ABCD".index(doc["answers"])

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        gold = self.gold(doc)
        r1 = float(int(np.argmax(lls)) == gold)
        ranks = sorted(lls, reverse=True)
        gold_rank = ranks.index(lls[gold])
        r2 = float(gold_rank == 1) + r1
        return {"r@1": r1, "r@2": r2, "mrr": 1.0 / (gold_rank + 1)}


@register_task("mutual")
class MuTual(_MuTual):
    offline_key = "mutual"  # official dev/ txt-file directory


@register_task("mutual_plus")
class MuTualPlus(_MuTual):
    name = "mutual_plus"
    offline_key = "mutual_plus"


class _QA4MRE(_HFMultipleChoice):
    """tasks/qa4mre.py: document + question -> 5 options (1-based gold)."""

    path = "qa4mre"
    split = "train"

    def query(self, doc):
        return (f"{doc['document_str'].strip()}\nQuestion: {doc['question_str']}"
                "\nAnswer:")

    def choices(self, doc):
        return list(doc["answer_options"]["answer_str"])

    def gold(self, doc):
        return int(doc["correct_answer_id"]) - 1


for _year in ("2011", "2012", "2013"):
    register_task(f"qa4mre_{_year}")(
        type(f"QA4MRE_{_year}", (_QA4MRE,), {"name": f"{_year}.main.EN"}))


@register_task("pubmedqa")
class PubMedQA(_HFMultipleChoice):
    """tasks/pubmedqa.py: abstract contexts + question -> yes/no/maybe."""

    path = "pubmed_qa"
    name = "pqa_labeled"
    split = "train"

    def query(self, doc):
        ctxs = "\n".join(doc["context"]["contexts"])
        return f"Abstract: {ctxs}\nQuestion: {doc['question']}\nAnswer:"

    def choices(self, doc):
        return ["yes", "no", "maybe"]

    def gold(self, doc):
        return ["yes", "no", "maybe"].index(doc["final_decision"])


@register_task("wsc273")
class WSC273(Task):
    """tasks/wsc273.py partial-evaluation protocol: context = text up to the
    pronoun with the candidate substituted IN THE CONTEXT; only the tail after
    the pronoun is scored as the continuation (its likelihood is shared, the
    candidate's own likelihood is deliberately excluded)."""

    _UPPER_PRONOUNS = ("A", "An", "The", "She", "He", "It", "They", "My",
                       "His", "Her", "Their")

    def docs(self):
        return [self._process(d) for d in _hf_docs("winograd_wsc", "wsc273", "test")]

    def _process(self, doc):
        doc = dict(doc)
        # HF wsc273 is not partial-evaluation friendly (wsc273.py:69-75)
        doc["text"] = doc["text"].replace("  ", " ")
        doc["options"] = [self._normalize(doc, o) for o in doc["options"]]
        return doc

    def _normalize(self, doc, option):
        # 's for possessive-determiner pronouns; lowercase a sentence-internal
        # leading pronoun (wsc273.py:__normalize_option)
        if doc["pronoun"].lower() in ("my", "his", "her", "our", "their"):
            option += "'s"
        pronoun = option.split()[0]
        start_of_sentence = doc["text"][doc["pronoun_loc"] - 2] == "."
        if not start_of_sentence and pronoun in self._UPPER_PRONOUNS:
            option = option.replace(pronoun, pronoun.lower())
        return option

    @staticmethod
    def _target(doc):
        start = doc["pronoun_loc"] + len(doc["pronoun"])
        return " " + doc["text"][start:].strip()

    def fewshot_context(self, doc, num_shot, rng):
        return ""

    def construct_requests(self, doc, ctx):
        return [(doc["text"][: doc["pronoun_loc"]] + opt, self._target(doc))
                for opt in doc["options"]]

    def process_results(self, doc, results):
        lls = [r[0] for r in results]
        return {"acc": float(int(np.argmax(lls)) == int(doc["label"]))}


# squad2 / mc_taco / qasper / toxigen / math_asdiv and the reference-name
# aliases, imported for the registry side-effect
from . import lmeval_more_tasks  # noqa: E402,F401
