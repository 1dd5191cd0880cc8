"""Offline dataset builders for lm-eval tasks.

A copy of mi_optimize_tpu/datasets/lmdatasets.py (pure Python: JSON, CSV and
XML through the standard library). The reference toolbox's vendored HF
builder scripts (lmdatasets/coqa/coqa.py, drop/drop.py, triviaqa/triviaqa.py
and the rest) download the official raw files and emit HF rows; on a machine
with no network that download never runs. Here the same raw formats are
parsed directly from a local data directory:

    $MI_TPU_DATA_DIR/lmeval/<task>/<file>     (official raw JSON/JSONL)

Resolution order per task: (1) local raw file via its builder below,
(2) `hf_load` (the HF `datasets` package's cache or network, where present),
(3) empty list — `evaluate_tasks` hard-fails on empty docs unless the caller
opts into allow_empty, so an offline miss is loud, never a silent 0-doc "pass".

Each builder emits rows with the SAME schema the corresponding HF dataset (and
therefore the task protocol) expects, mirroring the reference builders'
_generate_examples field mappings.
"""
from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


def data_root() -> Optional[Path]:
    root = os.environ.get("MI_TPU_DATA_DIR")
    return Path(root) / "lmeval" if root else None


def _find(task: str, names) -> Optional[Path]:
    root = data_root()
    if root is None:
        return None
    for n in names:
        p = root / task / n
        if p.exists():
            return p
    return None


# ---------------------------------------------------------------------------
# raw-format parsers (one per official release format)
# ---------------------------------------------------------------------------

def build_coqa(path: Path) -> List[dict]:
    """Official coqa-dev-v1.0.json -> HF-columnar rows
    (reference lmdatasets/coqa/coqa.py::_generate_examples)."""
    data = json.loads(path.read_text(encoding="utf-8"))["data"]
    docs = []
    for row in data:
        doc = {
            "id": row["id"],
            "story": row["story"],
            "questions": {"input_text": [q["input_text"] for q in row["questions"]]},
            "answers": {"input_text": [a["input_text"] for a in row["answers"]]},
        }
        extra = row.get("additional_answers")
        if extra:
            doc["additional_answers"] = {
                k: {"input_text": [a["input_text"] for a in v]}
                for k, v in extra.items()
            }
        docs.append(doc)
    return docs


def build_drop(path: Path) -> List[dict]:
    """Official drop_dataset_dev.json -> one row per qa_pair with HF-columnar
    validated_answers (reference lmdatasets/drop/drop.py::_generate_examples)."""
    data = json.loads(path.read_text(encoding="utf-8"))
    docs = []
    for section_id, example in data.items():
        for qa in example["qa_pairs"]:
            ans = qa["answer"]
            validated = qa.get("validated_answers", [])
            docs.append({
                "section_id": section_id,
                "query_id": qa["query_id"],
                "passage": example["passage"],
                "question": qa["question"],
                "answer": {
                    "number": str(ans.get("number", "")),
                    "date": {k: str(ans.get("date", {}).get(k, ""))
                             for k in ("day", "month", "year")},
                    "spans": list(ans.get("spans", [])),
                },
                "validated_answers": {
                    "number": [str(v.get("number", "")) for v in validated],
                    "date": [{k: str(v.get("date", {}).get(k, ""))
                              for k in ("day", "month", "year")} for v in validated],
                    "spans": [list(v.get("spans", [])) for v in validated],
                },
            })
    return docs


def build_triviaqa(path: Path) -> List[dict]:
    """Official unfiltered-web-dev.json -> question/answer rows
    (reference lmdatasets/triviaqa/triviaqa.py::_generate_examples)."""
    data = json.loads(path.read_text(encoding="utf-8"))["Data"]
    return [{
        "question_id": d["QuestionId"],
        "question": d["Question"],
        "answer": {"aliases": list(d["Answer"]["Aliases"]),
                   "value": d["Answer"]["Value"]},
    } for d in data]


def build_gsm8k(path: Path) -> List[dict]:
    """Official test.jsonl ({question, answer} per line)."""
    docs = []
    with path.open(encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                docs.append(json.loads(line))
    return docs


def build_webqs(path: Path) -> List[dict]:
    """Official webquestions test JSON (url/targetValue rows) or a plain
    [{question, answers}] list."""
    data = json.loads(path.read_text(encoding="utf-8"))
    docs = []
    for d in data:
        if "answers" in d:
            docs.append({"question": d["question"], "answers": list(d["answers"])})
        else:  # original targetValue "(list (description A) (description B))"
            tv = d.get("targetValue", "")
            answers = [s.strip().rstrip(")").strip()
                       for s in tv.split("(description ")[1:]]
            answers = [a[1:-1] if a.startswith('"') and a.endswith('"') else a
                       for a in answers]
            docs.append({"question": d.get("utterance", d.get("question", "")),
                         "answers": answers})
    return docs


def build_asdiv(path: Path) -> List[dict]:
    """Official ASDiv.xml (nlu-asdiv-dataset) -> body/question/answer rows
    (reference lmdatasets/asdiv/asdiv.py:101-112)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    return [{
        "body": p.find("Body").text,
        "question": p.find("Question").text,
        "solution_type": p.find("Solution-Type").text,
        "answer": p.find("Answer").text,
        "formula": p.find("Formula").text,
    } for p in root.iter("Problem")]


def build_headqa(path: Path) -> List[dict]:
    """Official HEAD-QA exam JSON (test_HEAD{_EN}.json) -> question rows
    (reference lmdatasets/headqa/headqa.py:133-161)."""
    head_qa = json.loads(path.read_text(encoding="utf-8"))
    docs = []
    for exam in head_qa["exams"]:
        content = head_qa["exams"][exam]
        for q in content["data"]:
            docs.append({
                "name": content["name"].strip(),
                "year": content["year"].strip(),
                "category": content["category"].strip(),
                "qid": int(q["qid"].strip()),
                "qtext": q["qtext"].strip(),
                "ra": int(q["ra"].strip()),
                "answers": [{"aid": a["aid"], "atext": a["atext"].strip()}
                            for a in q["answers"]],
            })
    return docs


def build_logiqa(path: Path) -> List[dict]:
    """Official LogiQA Eval/Test/Train.txt (blank-line-separated blocks of
    label/context/question/options) -> HF rows with the `correct_option`
    index our LogiQA task reads (reference lmdatasets/logiqa/logiqa.py:111-125
    emits the letter as `label`; lucasmccabe/logiqa uses the index)."""
    def norm(text):
        return text.replace(".", ". ").strip()

    docs = []
    for block in path.read_text(encoding="utf-8").strip().split("\n\n"):
        lines = block.split("\n")
        docs.append({
            "label": lines[0].strip(),
            "correct_option": "abcd".index(lines[0].strip().lower()),
            "context": norm(lines[1]),
            "query": norm(lines[2]),
            "options": [norm(o[2:]) for o in lines[3:]],
        })
    return docs


def build_mutual(path: Path) -> List[dict]:
    """Directory of MuTual per-dialogue txt files (JSON bodies) -> rows
    (reference lmdatasets/mutual/mutual.py:117-133)."""
    docs = []
    for file in sorted(Path(path).iterdir()):
        if file.suffix != ".txt":
            continue
        s = file.read_text(encoding="utf-8")
        if not s:
            continue
        d = json.loads(s)
        docs.append({"answers": d["answers"], "options": d["options"],
                     "article": d["article"], "id": d["id"]})
    return docs


def build_ethics(path: Path, config: str = "commonsense") -> List[dict]:
    """Official hendrycks ethics.tar CSVs -> per-config rows
    (reference lmdatasets/hendrycks_ethics/hendrycks_ethics.py:178-230)."""
    import csv

    docs = []
    group_id = 0
    with path.open(newline="", encoding="utf-8") as f:
        if config == "utilitarianism":
            rows = csv.DictReader(f, fieldnames=["activity", "baseline"])
        else:
            rows = csv.DictReader(f)
        for key, row in enumerate(rows):
            if config == "deontology":
                if key % 4 == 0 and key != 0:
                    group_id += 1
                docs.append({"group_id": group_id, "label": row["label"],
                             "scenario": row["scenario"], "excuse": row["excuse"]})
            elif config == "justice":
                if key % 4 == 0 and key != 0:
                    group_id += 1
                docs.append({"group_id": group_id, "label": row["label"],
                             "scenario": row["scenario"]})
            elif config == "commonsense":
                docs.append({"label": row["label"], "input": row["input"],
                             "is_short": row["is_short"], "edited": row["edited"]})
            elif config == "virtue":
                if key % 5 == 0 and key != 0:
                    group_id += 1
                scenario, trait = row["scenario"].split(" [SEP] ")
                docs.append({"group_id": group_id, "label": row["label"],
                             "scenario": scenario, "trait": trait})
            else:  # utilitarianism
                docs.append({"activity": row["activity"],
                             "baseline": row["baseline"], "rating": ""})
    return docs


def build_math(path: Path) -> List[dict]:
    """Directory of MATH per-problem JSON files -> rows
    (reference lmdatasets/hendrycks_math/hendrycks_math.py:111-122)."""
    docs = []
    for file in sorted(Path(path).iterdir()):
        if file.suffix != ".json":
            continue
        d = json.loads(file.read_text(encoding="utf-8"))
        docs.append({"problem": d["problem"], "level": d["level"],
                     "type": d["type"], "solution": d["solution"]})
    return docs


def build_pile(path: Path, set_name: Optional[str] = None) -> List[dict]:
    """Official pile val/test.jsonl, optionally filtered to one pile_set_name
    (reference lmdatasets/pile/pile.py:119-126)."""
    docs = []
    with path.open(encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            name = d.get("meta", {}).get("pile_set_name")
            if set_name is None or name == set_name:
                docs.append({"text": d["text"], "pile_set_name": name})
    return docs


def build_sat(path: Path) -> List[dict]:
    """Official SAT-package-V3.txt analogy records -> rows
    (reference lmdatasets/sat_analogies/sat_analogies.py:103-129)."""
    data, record = [], []
    for line in path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line and record:
            data.append(record)
            record = []
        elif line and line[0] == "#":
            continue
        elif line:
            record.append(line)
    if record:
        data.append(record)
    return [{"source": r[-8], "stem": r[-7], "choices": r[-6:-1],
             "solution": r[-1]} for r in data]


def build_unscramble(path: Path) -> List[dict]:
    """GPT-3 unscramble jsonl ({context, completion} rows)
    (reference lmdatasets/unscramble/unscramble.py:103-110)."""
    docs = []
    with path.open(encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                d = json.loads(line)
                docs.append({"context": d["context"],
                             "completion": d["completion"]})
    return docs


def build_squad2(path: Path) -> List[dict]:
    """Official SQuAD dev-v2.0.json -> HF squad_v2 schema rows (one per
    question; answers columnar) for tasks/squad.py parity."""
    data = json.loads(path.read_text(encoding="utf-8"))["data"]
    docs = []
    for article in data:
        for para in article["paragraphs"]:
            for qa in para["qas"]:
                docs.append({
                    "id": qa["id"],
                    "title": article.get("title", ""),
                    "context": para["context"],
                    "question": qa["question"],
                    "answers": {
                        "text": [a["text"] for a in qa.get("answers", [])],
                        "answer_start": [a["answer_start"]
                                         for a in qa.get("answers", [])],
                    },
                })
    return docs


def build_mc_taco(path: Path) -> List[dict]:
    """Official MC-TACO dev/test TSV (sentence, question, answer, label,
    category per line) -> HF mc_taco schema (label 1 = plausible/yes)."""
    docs = []
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split("\t")
        sentence, question, answer, label = parts[0], parts[1], parts[2], parts[3]
        docs.append({
            "sentence": sentence, "question": question, "answer": answer,
            "label": 1 if label.strip().lower() == "yes" else 0,
            "category": parts[4] if len(parts) > 4 else "",
        })
    return docs


def build_qasper(path: Path) -> List[dict]:
    """Official qasper-dev-v0.3.json (paper id -> {title, abstract, qas}) ->
    HF qasper schema rows (qas columnar with per-question answer lists)."""
    data = json.loads(path.read_text(encoding="utf-8"))
    docs = []
    for paper in data.values():
        qas = paper.get("qas", [])
        docs.append({
            "title": paper.get("title", ""),
            "abstract": paper.get("abstract", ""),
            "qas": {
                "question": [q["question"] for q in qas],
                "answers": [{"answer": [a["answer"] for a in q.get("answers", [])]}
                            for q in qas],
            },
        })
    return docs


def build_toxigen(path: Path) -> List[dict]:
    """skg/toxigen-data annotated CSV (text, toxicity_ai, toxicity_human) ->
    rows the ToxiGen task thresholds (tasks/toxigen.py:54-59)."""
    import csv

    docs = []
    with path.open(newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            docs.append({
                "text": row["text"],
                "toxicity_ai": float(row["toxicity_ai"]),
                "toxicity_human": float(row["toxicity_human"]),
            })
    return docs


_BUILDERS: Dict[str, tuple] = {
    # task -> (candidate raw filenames, parser)
    "coqa": (("coqa-dev-v1.0.json", "dev.json", "validation.json"), build_coqa),
    "drop": (("drop_dataset_dev.json", "dev.json", "validation.json"), build_drop),
    "triviaqa": (("unfiltered-web-dev.json", "dev.json", "validation.json"),
                 build_triviaqa),
    "gsm8k": (("test.jsonl", "grade_school_math_test.jsonl"), build_gsm8k),
    "webqs": (("webquestions.examples.test.json", "test.json"), build_webqs),
    "asdiv": (("ASDiv.xml", "asdiv.xml"), build_asdiv),
    "headqa_en": (("test_HEAD_EN.json", "HEAD_EN/test_HEAD_EN.json"),
                  build_headqa),
    "headqa_es": (("test_HEAD.json", "HEAD/test_HEAD.json"), build_headqa),
    "logiqa": (("Eval.txt", "eval.txt", "validation.txt"), build_logiqa),
    "mutual": (("dev", "mutual/dev", "validation"), build_mutual),
    "mutual_plus": (("dev_plus", "mutual_plus/dev", "validation_plus"),
                    build_mutual),
    "sat_analogies": (("SAT-package-V3.txt",), build_sat),
    "squad2": (("dev-v2.0.json", "squad-dev-v2.0.json"), build_squad2),
    "mc_taco": (("dev_3783.tsv", "dev.tsv", "validation.tsv"), build_mc_taco),
    "qasper": (("qasper-dev-v0.3.json", "dev.json"), build_qasper),
    "toxigen": (("annotated_test.csv", "test.csv", "annotated.csv"),
                build_toxigen),
    # task families commented out of the reference registry still get their
    # raw-format parsers for data parity:
    "pile": (("val.jsonl", "validation.jsonl", "test.jsonl"), build_pile),
    "unscramble": (("cycle_letters_in_word.jsonl", "mid_word_1_anagrams.jsonl",
                    "mid_word_2_anagrams.jsonl", "random_insertion_in_word.jsonl",
                    "reversed_words.jsonl"), build_unscramble),
    "hendrycks_math": (("test", "MATH/test"), build_math),
}

# hendrycks ethics: per-config CSVs inside the official ethics.tar layout
for _cfg, _file in (("commonsense", "commonsense/cm_test.csv"),
                    ("deontology", "deontology/deontology_test.csv"),
                    ("justice", "justice/justice_test.csv"),
                    ("utilitarianism", "utilitarianism/util_test.csv"),
                    ("virtue", "virtue/virtue_test.csv")):
    def _mk(cfg):
        return lambda p: build_ethics(p, cfg)
    _BUILDERS[f"ethics_{_cfg}"] = (
        (_file, _file.split("/")[-1], f"{_cfg}.csv"), _mk(_cfg))


def load_docs(task: str, hf_path: Optional[str] = None, hf_name: Optional[str] = None,
              split: str = "validation") -> List[dict]:
    """Offline-first docs for `task`; see module docstring for the order."""
    ent = _BUILDERS.get(task)
    if ent is not None:
        p = _find(task, ent[0])
        if p is not None:
            docs = ent[1](p)
            log.info("lmdatasets[%s]: %d docs from %s", task, len(docs), p)
            return docs
    if hf_path is not None:
        try:
            return hf_load(hf_path, hf_name, split)
        except Exception as e:  # offline / no cache
            log.warning("lmdatasets[%s]: HF %s unavailable (%s)", task, hf_path, e)
    return []


def hf_load(path: str, name: Optional[str], split: str) -> List[dict]:
    """Rows of an HF dataset through the `datasets` package: the one place
    the tasks reach for data beyond MI_TPU_DATA_DIR."""
    from datasets import load_dataset

    return list(load_dataset(path, name, split=split))
