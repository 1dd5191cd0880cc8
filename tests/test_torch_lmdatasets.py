"""The port's offline lm-eval dataset builders (datasets/lmdatasets.py)
against the JAX package's: every builder of `_BUILDERS`, over the same raw
files written under tmp_path as MI_TPU_DATA_DIR/lmeval/<task>/, gives JAX's
docs exactly. The HF fallback is never reached: `datasets.load_dataset` and
the port's `hf_load` raise inside these tests."""
import json

import pytest

from mi_optimize_tpu.datasets import lmdatasets as jlmdatasets
from mi_optimize_tpu_torch.datasets import lmdatasets


def _json(obj):
    return json.dumps(obj)


def _jsonl(rows):
    return "\n".join(json.dumps(r) for r in rows) + "\n"


_HEADQA = {"exams": {"e1": {
    "name": "Exam ", "year": "2016 ", "category": "medicine ",
    "data": [{"qid": " 1", "qtext": " What? ", "ra": " 2",
              "answers": [{"aid": 1, "atext": " a1 "}, {"aid": 2, "atext": " a2 "}]},
             {"qid": "2", "qtext": "Which?", "ra": "1",
              "answers": [{"aid": 1, "atext": "x"}, {"aid": 2, "atext": "y"}]}]}}}
_MUTUAL = [("dev_1.txt", _json({"answers": "B", "options": ["m: no", "f: yes", "m: hm", "f: ok"],
                                 "article": "m: hi . f: hello .", "id": "dev_1"})),
           ("dev_2.txt", _json({"answers": "A", "options": ["a", "b", "c", "d"],
                                 "article": "f: bye .", "id": "dev_2"})),
           ("empty.txt", ""), ("notes.md", "skipped")]

# builder key -> [(path under lmeval/<key>/, file text)]
RAW = {
    "coqa": [("coqa-dev-v1.0.json", _json({"data": [{
        "id": "x", "source": "s", "story": "Once.",
        "questions": [{"input_text": "Who?", "turn_id": 1}],
        "answers": [{"input_text": "Bob", "turn_id": 1, "span_start": 0, "span_end": 3,
                     "span_text": "Bob"}],
        "additional_answers": {"0": [{"input_text": "Bobby", "turn_id": 1, "span_start": 0,
                                      "span_end": 3, "span_text": "Bob"}]}}]}))],
    "drop": [("drop_dataset_dev.json", _json({"sec1": {"passage": "P.", "qa_pairs": [
        {"question": "How many?", "query_id": "q1",
         "answer": {"number": "3", "date": {}, "spans": []},
         "validated_answers": [{"number": "", "date": {}, "spans": ["three"]}]},
        {"question": "When?", "query_id": "q2",
         "answer": {"number": "", "date": {"day": "1", "month": "May", "year": "1990"},
                    "spans": []}}]}}))],
    "triviaqa": [("unfiltered-web-dev.json", _json({"Data": [
        {"QuestionId": "1", "Question": "Q?", "QuestionSource": "",
         "Answer": {"Aliases": ["A", "An answer"], "Value": "A"}, "SearchResults": []}]}))],
    "gsm8k": [("test.jsonl", _jsonl({"question": f"q{i}", "answer": f"#### {i}"}
                                    for i in range(3)))],
    "webqs": [("webquestions.examples.test.json", _json([
        {"utterance": "what is x?", "targetValue": '(list (description "A") (description B))'},
        {"question": "who?", "answers": ["C"]}]))],
    "asdiv": [("ASDiv.xml", """<Machine-Reading-Corpus-File><ProblemSet>
      <Problem ID="1" Grade="1" Source="x"><Body>Seven red apples.</Body>
        <Question>How many apples?</Question><Solution-Type>Addition</Solution-Type>
        <Answer>7 (apples)</Answer><Formula>7=7</Formula></Problem>
      <Problem ID="2" Grade="2" Source="y"><Body>Two cats.</Body>
        <Question>How many?</Question><Solution-Type>A</Solution-Type>
        <Answer>2 (cats)</Answer><Formula>2=2</Formula></Problem>
      </ProblemSet></Machine-Reading-Corpus-File>""")],
    "headqa_en": [("test_HEAD_EN.json", _json(_HEADQA))],
    "headqa_es": [("HEAD/test_HEAD.json", _json(_HEADQA))],
    "logiqa": [("Eval.txt", "b\ncontext one.\nwhich?\nA.first\nB.second\nC.third\nD.fourth\n\n"
                            "a\ncontext two.\nwhat?\nA.w\nB.x\nC.y\nD.z")],
    "mutual": [("dev/" + n, t) for n, t in _MUTUAL],
    "mutual_plus": [("dev_plus/" + n, t) for n, t in _MUTUAL],
    "sat_analogies": [("SAT-package-V3.txt",
                       "# comment\n190 FROM REAL SATs\nlegend:ceremony\ndrawing:blueprint\n"
                       "furniture:chair\nmusic:instrument\nhero:worship\nfood:banquet\nb\n\n"
                       "191 FROM REAL SATs\nx:y\na:b\nc:d\ne:f\ng:h\ni:j\na")],
    "squad2": [("dev-v2.0.json", _json({"data": [{"title": "T", "paragraphs": [{
        "context": "Paris is in France.",
        "qas": [{"id": "q1", "question": "Where is Paris?",
                 "answers": [{"text": "France", "answer_start": 12}]},
                {"id": "q2", "question": "Where is Mars?", "answers": [],
                 "is_impossible": True}]}]}]}))],
    "mc_taco": [("dev_3783.tsv", "He ate.\tHow long?\t5 minutes\tyes\tEvent Duration\n"
                                 "He ate.\tHow long?\t5 centuries\tno\tEvent Duration\n\n"
                                 "She ran.\tWhen?\tat noon\tyes\n")],
    "qasper": [("qasper-dev-v0.3.json", _json({"p": {"title": "A Paper", "abstract": "We study X.",
                                                     "qas": [{"question": "What is X?",
                                                              "answers": [{"answer": {
                                                                  "unanswerable": False,
                                                                  "yes_no": None,
                                                                  "free_form_answer": "a thing",
                                                                  "extractive_spans": []}}]},
                                                             {"question": "Is X good?",
                                                              "answers": [{"answer": {
                                                                  "unanswerable": False,
                                                                  "yes_no": True,
                                                                  "free_form_answer": "",
                                                                  "extractive_spans": []}}]}]}}))],
    "toxigen": [("annotated_test.csv", "text,target_group,toxicity_ai,toxicity_human\n"
                                       "hello there,none,1.0,1.0\nbad stuff,g,4.0,4.3\n")],
    "pile": [("val.jsonl", _jsonl({"text": t, "meta": {"pile_set_name": n}}
                                  for t, n in (("a", "ArXiv"), ("b", "Github"))))],
    "unscramble": [("cycle_letters_in_word.jsonl",
                    _jsonl([{"context": "claude = ", "completion": "claude"},
                            {"context": "x = ", "completion": "y"}]))],
    "hendrycks_math": [("test/1.json", _json({"problem": "1+1?", "level": "Level 1",
                                              "type": "Algebra", "solution": "2"})),
                       ("test/2.json", _json({"problem": "2+2?", "level": "Level 2",
                                              "type": "Algebra", "solution": "4"}))],
    "ethics_commonsense": [("commonsense/cm_test.csv",
                            "label,input,is_short,edited\n1,He lied.,True,False\n"
                            "0,She helped.,False,True\n")],
    "ethics_deontology": [("deontology_test.csv", "label,scenario,excuse\n" + "".join(
        f"{i % 2},s{i},e{i}\n" for i in range(9)))],
    "ethics_justice": [("justice.csv", "label,scenario\n" + "".join(
        f"{i % 2},s{i}\n" for i in range(9)))],
    "ethics_utilitarianism": [("util_test.csv", "I ate pie.,I ate mud.\nA,B\n")],
    "ethics_virtue": [("virtue/virtue_test.csv", "label,scenario\n" + "".join(
        f"{i % 2},He acted {i}. [SEP] trait{i}\n" for i in range(11)))],
}


@pytest.fixture(autouse=True)
def no_hf(monkeypatch):
    """The HF fallback raises here: a test never reaches the network."""
    def refuse(*a, **kw):
        raise RuntimeError("the HF datasets fallback is not reached in the tests")

    try:
        import datasets
        monkeypatch.setattr(datasets, "load_dataset", refuse)
    except ImportError:
        pass
    monkeypatch.setattr(lmdatasets, "hf_load", refuse)


def write_raw(root, key):
    """RAW[key]'s files under root/lmeval/key/."""
    for rel, text in RAW[key]:
        p = root / "lmeval" / key / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text, encoding="utf-8")


def test_every_builder_has_raw_files():
    assert sorted(RAW) == sorted(lmdatasets._BUILDERS) == sorted(jlmdatasets._BUILDERS)
    for key, (names, _) in lmdatasets._BUILDERS.items():
        assert names == jlmdatasets._BUILDERS[key][0]


@pytest.mark.parametrize("key", sorted(RAW))
def test_builder_gives_jax_docs(tmp_path, monkeypatch, key):
    write_raw(tmp_path, key)
    monkeypatch.setenv("MI_TPU_DATA_DIR", str(tmp_path))
    got, want = lmdatasets.load_docs(key), jlmdatasets.load_docs(key)
    assert len(got) >= 1 and got == want


def test_missing_data_gives_no_docs_without_the_hf_fallback(tmp_path, monkeypatch):
    """No raw file and no HF path: []; with an HF path the fallback's failure
    is logged and [] returned, as the JAX package does."""
    monkeypatch.setenv("MI_TPU_DATA_DIR", str(tmp_path))
    assert lmdatasets.load_docs("coqa") == jlmdatasets.load_docs("coqa") == []
    assert lmdatasets.load_docs("coqa", "coqa") == jlmdatasets.load_docs("coqa", "coqa") == []
    monkeypatch.delenv("MI_TPU_DATA_DIR")
    assert lmdatasets.data_root() is None and lmdatasets.load_docs("gsm8k") == []
