"""C-Eval / CMMLU MCQA data layer: subject maps, prompts, answer extraction.

A copy of mi_optimize_tpu/datasets/mcqa.py (pure Python: CSV through the
standard library). Protocol parity with the reference toolbox's loaders
(mi_optimize/datasets/load_ceval.py, load_cmmlu.py): the subject->category
taxonomies are the public benchmarks' own (52 C-Eval / 67 CMMLU subjects),
prompts are `question\\nA. ..\\nB. ..\\nC. ..\\nD. ..\\n答案：`, few-shot
prefixes start with the Chinese single-choice instruction title, and the CoT
answer extractor applies the same 8 regex patterns in order. Data resolves
offline from the bundled CSV dirs (datasets.calibration.find_data_path).
"""
from __future__ import annotations

import csv
import glob
import logging
import os
import random
import re
from itertools import islice
from typing import Dict, List, Optional, Tuple

from .calibration import find_data_path
from .tokenizer import encode_ids

log = logging.getLogger(__name__)

CEVAL_TASK2CTG = {
    # STEM
    **{s: "STEM" for s in (
        "computer_network", "operating_system", "computer_architecture",
        "college_programming", "college_physics", "college_chemistry",
        "advanced_mathematics", "probability_and_statistics", "discrete_mathematics",
        "electrical_engineer", "metrology_engineer", "high_school_mathematics",
        "high_school_physics", "high_school_chemistry", "high_school_biology",
        "middle_school_mathematics", "middle_school_biology", "middle_school_physics",
        "middle_school_chemistry", "veterinary_medicine")},
    **{s: "Social Science" for s in (
        "college_economics", "business_administration", "marxism",
        "mao_zedong_thought", "education_science", "teacher_qualification",
        "high_school_politics", "high_school_geography", "middle_school_politics",
        "middle_school_geography")},
    **{s: "Humanities" for s in (
        "modern_chinese_history", "ideological_and_moral_cultivation", "logic",
        "law", "chinese_language_and_literature", "art_studies",
        "professional_tour_guide", "legal_professional", "high_school_chinese",
        "high_school_history", "middle_school_history")},
    **{s: "Other" for s in (
        "civil_servant", "sports_science", "plant_protection", "basic_medicine",
        "clinical_medicine", "urban_and_rural_planner", "accountant", "fire_engineer",
        "environmental_impact_assessment_engineer", "tax_accountant", "physician")},
}

CMMLU_TASK2CTG = {
    **{s: "STEM" for s in (
        "anatomy", "astronomy", "college_actuarial_science",
        "college_engineering_hydrology", "college_mathematics",
        "college_medical_statistics", "computer_science", "conceptual_physics",
        "electrical_engineering", "elementary_mathematics", "genetics",
        "high_school_biology", "high_school_chemistry", "high_school_mathematics",
        "high_school_physics", "machine_learning", "virology")},
    **{s: "Humanities" for s in (
        "arts", "college_law", "global_facts", "international_law",
        "jurisprudence", "logical", "marxist_theory", "philosophy",
        "professional_law", "world_history", "world_religions")},
    **{s: "Social Sciences" for s in (
        "business_ethics", "college_education", "economics", "education",
        "high_school_geography", "journalism", "management", "marketing",
        "professional_accounting", "professional_psychology", "public_relations",
        "security_study", "sociology")},
    **{s: "China Specific" for s in (
        "ancient_chinese", "chinese_civil_service_exam", "chinese_driving_rule",
        "chinese_food_culture", "chinese_foreign_policy", "chinese_history",
        "chinese_literature", "chinese_teacher_qualification",
        "construction_project_management", "elementary_chinese",
        "elementary_commonsense", "ethnology", "high_school_politics",
        "modern_chinese", "traditional_chinese_medicine")},
    **{s: "Other" for s in (
        "agronomy", "clinical_knowledge", "college_medicine", "computer_security",
        "elementary_information_and_technology", "food_science", "human_sexuality",
        "legal_and_moral_basis", "nutrition", "professional_medicine",
        "sports_science")},
}

TITLE = "以下是中国考试的单项选择题，请选出其中的正确答案。"

_SS_NAME = {"ceval": "Social Science", "cmmlu": "Social Sciences"}


def get_subjects(bench: str, subject_name: str) -> Dict[str, str]:
    t2c = CEVAL_TASK2CTG if bench == "ceval" else CMMLU_TASK2CTG
    cat = {"hm": "Humanities", "st": "STEM", "ss": _SS_NAME[bench]}.get(subject_name)
    if cat is None:
        return dict(t2c)
    return {k: v for k, v in t2c.items() if v == cat}


def _rows_ceval(subject: str, split: str) -> List[dict]:
    base = find_data_path("ceval-exam")
    if base is None:
        raise FileNotFoundError("ceval-exam data not found; set MI_TPU_DATA_DIR")
    f = os.path.join(base, "ceval-exam-category", subject, f"{subject}_{split}.csv")
    if not os.path.exists(f):
        return []
    with open(f, encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


def _rows_cmmlu(subject: str, split: str) -> List[dict]:
    base = find_data_path("cmmlu_v1_0_1")
    if base is None:
        raise FileNotFoundError("cmmlu data not found; set MI_TPU_DATA_DIR")
    f = os.path.join(base, split, f"{subject}.csv")
    if not os.path.exists(f):
        return []
    out = []
    with open(f, encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            out.append({
                "question": row.get("Question", row.get("question", "")),
                "A": row["A"], "B": row["B"], "C": row["C"], "D": row["D"],
                "answer": row.get("Answer", row.get("answer", "")),
            })
    return out


def get_questions(bench: str, subject="all", split="test", question=4,
                  shuffle=False, seed=42, answer=False) -> List[str]:
    """Flat question-string list, `答案：` suffixed (reference get_ceval :92-132)."""
    subjects = list(get_subjects(bench, subject if subject in ("hm", "st", "ss") else "all"))
    if isinstance(subject, (list, tuple)):
        subjects = list(subject)
    rows_fn = _rows_ceval if bench == "ceval" else _rows_cmmlu
    out = []
    for sub in subjects:
        rows = rows_fn(sub, split)
        if not rows:
            continue
        n = len(rows) if question == "all" else min(int(question), len(rows))
        if shuffle:
            rng = random.Random(seed)
            rows = list(rows)
            rng.shuffle(rows)
        for r in islice(rows, n):
            choices = "\n".join(f"{c}. {r[c]}" for c in "ABCD")
            ans = f"{r['answer']}" if answer else ""
            out.append(f"{r['question']}\n{choices}\n答案：{ans}")
    return out


def get_subject_testset(bench: str, subject_name: str, split="test"):
    """Per-subject (questions, answers) for eval (reference get_testdaset_*)."""
    rows_fn = _rows_ceval if bench == "ceval" else _rows_cmmlu
    rows = rows_fn(subject_name, split)
    qs, ans = [], []
    for r in rows:
        choices = "\n".join(f"{c}. {r[c]}" for c in "ABCD")
        qs.append(f"{r['question']}\n{choices}\n答案：")
        ans.append(str(r["answer"]).strip().upper())
    return qs, ans


def get_fewshot_prefix(bench: str, subject="all", split="dev", question=5, seed=42) -> str:
    """Flat-text few-shot prompt with answers (reference get_fewshot_* llama path)."""
    shots = get_questions(bench, subject=subject, split=split, question=question,
                          shuffle=False, seed=seed, answer=True)
    prompt = TITLE + "\n"
    for content in shots:
        prompt = prompt + "\n\n" + content
    return prompt


def get_calibrate(bench: str, tokenizer, subject="all", nsamples=4, seqlen=2048,
                  split=None, **kw):
    split = split or ("test" if bench == "ceval" else "test-source")
    data = get_questions(bench, subject=subject, split=split, question=nsamples)
    return [encode_ids(tokenizer, d)[:, :seqlen] for d in data]


_ANSWER_PATTERNS = [
    r"([ABCD])是正确的", r"选项([ABCD])正确", r"答案为([ABCD])", r"答案是([ABCD])",
    r"答案([ABCD])", r"选择([ABCD])", r"答案：([ABCD])", r"选择答案([ABCD])",
]


def extract_cot_answer(question: str, response: str) -> str:
    """Regex CoT extraction (reference extract_cot_answer_ceval :176-216)."""
    choices = ["A", "B", "C", "D"]
    m = re.findall(r"所以答案是(.+?)。", response, re.M)
    if m and m[-1] in choices:
        return m[-1]
    for pat in _ANSWER_PATTERNS:
        m = re.search(pat, response, re.M)
        if m:
            return m.group(1)
    m = re.findall(r"[ABCD]", response, re.M)
    if len(m) == 1:
        return m[0]
    options = re.findall(r"\b[A-D]\.\s*(.*?)\n", question)
    hits = [c for c, o in zip(choices, options) if str(o) in response]
    if len(hits) == 1:
        return hits[0]
    return "-"


def aggregate_categories(bench: str, per_subject: Dict[str, Dict]) -> Dict:
    """Category rollup (reference classifi_results_* :219-241)."""
    t2c = CEVAL_TASK2CTG if bench == "ceval" else CMMLU_TASK2CTG
    cats: Dict[str, Dict] = {}
    for sub, st in per_subject.items():
        cat = t2c.get(sub)
        if cat is None:
            continue
        c = cats.setdefault(cat, {"total": 0, "correct": 0})
        c["total"] += st["total"]
        c["correct"] += st["correct"]
    for c in cats.values():
        c["ratio"] = c["correct"] / max(c["total"], 1)
    return {"subjects": per_subject, "categories": cats}
