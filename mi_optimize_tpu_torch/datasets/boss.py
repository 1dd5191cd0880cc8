"""BOSS OOD-benchmark data layer (QA / SentimentAnalysis / NLI / ToxicDetection).

A copy of mi_optimize_tpu/datasets/boss.py (pure Python: JSON and TSV
through the standard library), with the reference toolbox's protocol
(mi_optimize/datasets/load_boss.py):
  * json (QA) / tsv (classification) loaders with the same label mappings;
    NER is a pass-stub in the reference and is not covered
  * calibration strings "Question:.. Context:.. Answer:.." etc.
  * test prompts "Passage: .. // Question: .. // Answer:"
  * zero-shot instruction templates

As in the JAX package, few-shot examples are built from the dataset's own
train split under the reference's "### Example ###" scaffold, where the
reference hard-codes per-dataset example blocks.
"""
from __future__ import annotations

import csv
import json
import os
from itertools import islice
from typing import Dict, List, Tuple

from .calibration import find_data_path
from .tokenizer import encode_ids

SA_LABELS = {"0": "negative", "1": "positive", "2": "neutral"}
NLI_LABELS = {"0": "entailment", "1": "neutral", "2": "contradiction"}
TD_LABELS = {"0": "benign", "1": "toxic"}

TASKS = ("QuestionAnswering", "SentimentAnalysis", "NaturalLanguageInference",
         "ToxicDetection")

_INSTRUCTIONS = {
    "QuestionAnswering": (
        "Solve the extractive question answering task. Refering to the passage "
        "below and extract answer for the question. The answer should be the "
        "shortest phrase as it can be.",
        "Passage: {{Passage}} // Question: {{Question}} // Answer: {{Answer}}.",
    ),
    "SentimentAnalysis": (
        "Solve the sentiment analysis task. Options for sentiment: negative, "
        "positive, neutral.",
        "Text: {{Text}} // Prediction: {{Prediction}}",
    ),
    "NaturalLanguageInference": (
        "Solve the NLI task. Options for entailment relationship: entailment, "
        "neutral, contradiction.",
        "Premise: {{Premise}} // Hypothesis: {{Hypothesis}} // Prediction: {{Prediction}}",
    ),
    "ToxicDetection": (
        "Solve the toxic detection task. Options for toxicity: benign, toxic.",
        "Text: {{Text}} // Prediction: {{Prediction}}",
    ),
}


def _data_dir(task: str, dataset: str) -> str:
    base = find_data_path("BOSS")
    if base is None:
        raise FileNotFoundError("BOSS data not found; set MI_TPU_DATA_DIR")
    return os.path.join(base, task, dataset)


def load_examples(task: str, dataset: str, split: str) -> List[dict]:
    d = _data_dir(task, dataset)
    if task == "QuestionAnswering":
        out = []
        with open(os.path.join(d, f"{split}.json")) as f:
            for line in f:
                j = json.loads(line)
                out.append({"id": j["id"], "title": j.get("title", ""),
                            "context": j["context"], "question": j["question"],
                            "answers": j["answers"]["text"]})
        return out
    mapping = {"SentimentAnalysis": SA_LABELS, "NaturalLanguageInference": NLI_LABELS,
               "ToxicDetection": TD_LABELS}[task]
    out = []
    with open(os.path.join(d, f"{split}.tsv"), newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            if not row or not row.get("Label"):
                continue
            if task == "NaturalLanguageInference":
                out.append({"premise": row["Premise"], "hypothesis": row["Hypothesis"],
                            "label": mapping[row["Label"]]})
            else:
                out.append({"context": row["Text"], "answer": mapping[row["Label"]]})
    return out


def _example_str(task: str, ex: dict, with_answer: bool) -> str:
    if task == "QuestionAnswering":
        a = (" " + (ex["answers"][0] if ex["answers"] else "") + ".") if with_answer else ""
        return f"Passage: {ex['context']} // Question: {ex['question']} // Answer:{a}"
    if task == "NaturalLanguageInference":
        a = (" " + ex["label"]) if with_answer else ""
        return f"Premise: {ex['premise']} // Hypothesis: {ex['hypothesis']} // Prediction:{a}"
    a = (" " + ex["answer"]) if with_answer else ""
    return f"Text: {ex['context']} // Prediction:{a}"


def get_calibrate_strings(task: str, dataset: str, nsamples=128, split="train") -> List[str]:
    """Reference get_str (:69-114): 'Question:.. Context:.. Answer:..' style."""
    exs = load_examples(task, dataset, split)
    out = []
    for ex in islice(exs, nsamples):
        if task == "QuestionAnswering":
            out.append(f"Question:{ex['question']} Context:{ex['context']} Answer:{ex['answers']}")
        elif task == "NaturalLanguageInference":
            out.append(f"Premise:{ex['premise']} Hypothesis:{ex['hypothesis']} Label:{ex['label']}")
        else:
            out.append(f"Text:{ex['context']} Label:{ex['answer']}")
    return out


def get_calibrate_boss(tokenizer, task_name="QuestionAnswering", dataset_name="advqa",
                       nsamples=128, split="train", seqlen=2048, **kw):
    data = get_calibrate_strings(task_name, dataset_name, nsamples, split)
    return [encode_ids(tokenizer, s)[:, :seqlen] for s in data]


def get_zeroshot_prompt(task: str) -> str:
    instr, fmt = _INSTRUCTIONS[task]
    return (f"### Instruction ###\n{instr}\n### Format ###\n{fmt}\n### Input ###\n")


def get_fewshot_prompt(task: str, dataset: str, num_shot: int, split="train") -> str:
    instr, fmt = _INSTRUCTIONS[task]
    shots = load_examples(task, dataset, split)[:num_shot]
    examples = "\n".join(_example_str(task, ex, with_answer=True) for ex in shots)
    return (f"### Instruction ###\n{instr}\n### Format ###\n{fmt}\n"
            f"### Example ###\n{examples}\n### Input ###\n")


def get_testdata_boss(task: str, dataset: str, split="test") -> Tuple[List[str], List]:
    exs = load_examples(task, dataset, split)
    qs, ans = [], []
    for ex in exs:
        qs.append(_example_str(task, ex, with_answer=False))
        if task == "QuestionAnswering":
            ans.append(ex["answers"])
        elif task == "NaturalLanguageInference":
            ans.append(ex["label"])
        else:
            ans.append(ex["answer"])
    return qs, ans
