"""The port's lm-eval adapter (eval/lmeval.py and the three task tables)
against the JAX package's.

- The task registry: the same names, each class's request type the same.
- expand_task_names on every bundle and alias: JAX's list.
- Reorderer and _rolling_windows: JAX's orders and windows.
- The SQuAD scores (eval/squad_metrics.py) equal transformers' functions,
  which the JAX package's coqa, squad2 and qasper tasks call.
- evaluate_tasks on the aligned small Llama (2 layers, h=512, int4 g128,
  V=300, f32), one task a case over raw files under tmp_path (and the
  checked-in wikitext for the rolling task), the port's fused route against
  JAX's fused=False: the same metrics (the perplexities, continuous in the
  loglikelihoods, within rtol 1e-5), each loglikelihood within rtol 1e-5 /
  atol 1e-4 with the same greedy flag, each greedy_until text equal.
  gsm8k decodes the harness's 256 tokens a request; squad2's greedy
  requests decode SQUAD2_NEW tokens in both packages (its loglikelihood
  requests as they are), to keep the file's time down.
The HF fallback is never reached (tests/test_torch_lmdatasets.py::no_hf)."""
import numpy as np
import pytest

from mi_optimize_tpu.datasets.tokenizer import ByteTokenizer as JByteTokenizer
from mi_optimize_tpu.eval import lmeval as jlmeval
from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
from mi_optimize_tpu_torch.eval import lmeval
from tests.test_torch_convert import small_models
from tests.test_torch_lmdatasets import no_hf, write_raw  # noqa: F401

LL_RTOL, LL_ATOL = 1e-5, 1e-4
# metrics continuous in the loglikelihoods, held within LL_RTOL; the others
# (counts, accuracies, F1 over the texts) exactly
CONTINUOUS = ("word_perplexity", "byte_perplexity", "bits_per_byte")

# task -> (the builder keys whose raw files it reads, tests/test_torch_lmdatasets.RAW;
# max_docs: one doc for the tasks that decode greedy tokens)
TASKS = {"mc_taco": (["mc_taco"], 2), "headqa": (["headqa_es"], 2),
         "math_asdiv": (["asdiv"], 2), "wikitext": ([], 2), "gsm8k": (["gsm8k"], 1),
         "squad2": (["squad2"], 1)}
SQUAD2_NEW = 32   # squad2's greedy_until budget in both packages


@pytest.fixture(scope="module")
def models():
    return small_models(seed=0, vocab_size=300)


def test_registry_matches_jax():
    lmeval.expand_task_names([])
    jlmeval.expand_task_names([])
    assert sorted(lmeval.TASK_REGISTRY) == sorted(jlmeval.TASK_REGISTRY)
    assert len(lmeval.TASK_REGISTRY) >= 140
    for name, cls in lmeval.TASK_REGISTRY.items():
        jcls = jlmeval.TASK_REGISTRY[name]
        assert cls.__module__.startswith("mi_optimize_tpu_torch.eval.lmeval")
        assert (cls.__name__, cls.request_type) == (jcls.__name__, jcls.request_type)


@pytest.mark.parametrize("tasks", [
    "wikitext", ["anli"], ["blimp"], ["arc"], ["anli", "arc", "piqa"], ["all_tasks_0s"],
    ["all_tasks_5s"], ["test_tasks"], ["all_tasks_0s", "piqa"], "glue_sst",
])
def test_expand_task_names_matches_jax(tasks):
    got = lmeval.expand_task_names(tasks)
    assert got == jlmeval.expand_task_names(tasks)
    assert all(t in lmeval.TASK_REGISTRY for t in got) or tasks == ["all_tasks_0s", "piqa"]


def test_reorderer_matches_jax():
    reqs = [("ab", "c"), ("", "x"), ("abcd", "ef"), ("a", "b"), ("abc", "")]
    key = lambda r: -len(r[0] + r[1])
    got, want = lmeval.Reorderer(reqs, key), jlmeval.Reorderer(reqs, key)
    assert got.get_reordered() == want.get_reordered()
    res = [f"r{i}" for i in range(len(reqs))]
    assert got.get_original(res) == want.get_original(res)


class _Cfg:
    def __init__(self, vocab, max_seq_len):
        self.vocab_size, self.max_seq_len = vocab, max_seq_len


class _Stub:
    def __init__(self, vocab, max_seq_len):
        self.config = _Cfg(vocab, max_seq_len)


@pytest.mark.parametrize("n_tok,max_length,vocab", [
    (0, 8, 300), (5, 8, 300), (8, 8, 300), (19, 8, 300), (40, 16, 300), (7, 8, 2),
])
def test_rolling_windows_match_jax(n_tok, max_length, vocab):
    toks = list(range(10, 10 + n_tok))
    got = lmeval.LMEvalModel(_Stub(vocab, 64), ByteTokenizer(), max_length=max_length)
    want = jlmeval.LMEvalModel(_Stub(vocab, 64), JByteTokenizer(), max_length=max_length)
    windows = list(got._rolling_windows(toks))
    assert windows == list(want._rolling_windows(toks))
    assert [t for _, cont in windows for t in cont] == toks


def _recorded(monkeypatch, cls, name, **fixed):
    """Wrap cls.name so that every call's result lands in the returned list;
    `fixed` keyword arguments go into every call."""
    seen, fn = [], getattr(cls, name)

    def wrapped(self, *a, **kw):
        out = fn(self, *a, **kw, **fixed)
        seen.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapped)
    return seen


@pytest.mark.parametrize("task", sorted(TASKS))
def test_evaluate_tasks_matches_jax(tmp_path, monkeypatch, models, task):
    jm, pm = models
    keys, max_docs = TASKS[task]
    for key in keys:
        write_raw(tmp_path, key)
    monkeypatch.setenv("MI_TPU_DATA_DIR", str(tmp_path))
    got_ll = _recorded(monkeypatch, lmeval.LMEvalModel, "_ll_tokens")
    want_ll = _recorded(monkeypatch, jlmeval.LMEvalModel, "_ll_tokens")
    budget = {"max_new_tokens": SQUAD2_NEW} if task == "squad2" else {}
    got_txt = _recorded(monkeypatch, lmeval.LMEvalModel, "greedy_until", **budget)
    want_txt = _recorded(monkeypatch, jlmeval.LMEvalModel, "greedy_until", **budget)
    want = jlmeval.evaluate_tasks(jm, JByteTokenizer(), [task], fused=False,
                                   max_docs=max_docs)
    got = lmeval.evaluate_tasks(pm, ByteTokenizer(), [task], max_docs=max_docs)
    assert got.keys() == want.keys() and got[task].keys() == want[task].keys()
    assert got[task]["n"] == want[task]["n"] >= 1
    for k, v in got[task].items():
        if k in CONTINUOUS:
            assert np.isclose(v, want[task][k], rtol=LL_RTOL, atol=0), k
        else:
            assert v == want[task][k], k
    assert len(got_ll) == len(want_ll) and len(got_txt) == len(want_txt)
    assert len(got_ll) + len(got_txt) >= 1
    for (g, gflag), (w, wflag) in zip(got_ll, want_ll):
        assert np.isclose(g, w, rtol=LL_RTOL, atol=LL_ATOL) and gflag == wflag
    assert got_txt == want_txt


def test_empty_task_raises_without_the_hf_fallback(tmp_path, monkeypatch, models):
    """A task with no docs fails loudly, or records n = 0 when asked."""
    _, pm = models
    monkeypatch.setenv("MI_TPU_DATA_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="0 docs"):
        lmeval.evaluate_tasks(pm, ByteTokenizer(), ["gsm8k"])
    assert lmeval.evaluate_tasks(pm, ByteTokenizer(), ["gsm8k"], allow_empty=True) == {
        "gsm8k": {"n": 0}}
    with pytest.raises(ValueError, match="unknown lm-eval task"):
        lmeval.evaluate_tasks(pm, ByteTokenizer(), ["no_such_task"])


ANSWERS = [("The Eagles.", "eagles"), ("white house", "big white house"), ("", ""),
           ("a", ""), ("12 points", "15 points"), ("Paris", "paris, France!"),
           ("an apple a day", "Apple  day"), ("yes", "yeah")]


@pytest.mark.parametrize("gold,pred", ANSWERS)
def test_squad_metrics_match_transformers(gold, pred):
    """The port's SQuAD scores (eval/squad_metrics.py) against the
    transformers functions the JAX package's tasks call."""
    sm = pytest.importorskip("transformers.data.metrics.squad_metrics")
    from mi_optimize_tpu_torch.eval import squad_metrics as ours

    assert ours.normalize_answer(gold) == sm.normalize_answer(gold)
    assert ours.compute_exact(gold, pred) == sm.compute_exact(gold, pred)
    assert ours.compute_f1(gold, pred) == sm.compute_f1(gold, pred)


def test_squad2_thresholds_match_transformers():
    sm = pytest.importorskip("transformers.data.metrics.squad_metrics")
    from mi_optimize_tpu_torch.eval import squad_metrics as ours

    rng = np.random.default_rng(4)
    qids = [f"q{i}" for i in range(12)]
    has = {q: bool(rng.integers(2)) for q in qids}
    na = {q: float(rng.random()) for q in qids}
    preds = {q: "" if rng.random() < 0.3 else "x" for q in qids}
    exact = {q: float(rng.integers(2)) for q in qids}
    f1 = {q: float(rng.random()) for q in qids}
    assert ours.apply_no_ans_threshold(f1, na, has, 0.5) == sm.apply_no_ans_threshold(
        f1, na, has, 0.5)
    hq = [q for q in qids if has[q]]
    assert ours.make_eval_dict(exact, f1) == sm.make_eval_dict(exact, f1)
    assert ours.make_eval_dict(exact, f1, qid_list=hq) == sm.make_eval_dict(exact, f1,
                                                                           qid_list=hq)
    assert ours.find_best_thresh(preds, f1, na, has) == sm.find_best_thresh(preds, f1, na, has)
