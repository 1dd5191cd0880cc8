"""The port's C-Eval / CMMLU / BOSS evaluation (eval/mcqa.py, eval/boss.py,
eval/benchmark.py) and their data layer (datasets/mcqa.py, ceval.py,
cmmlu.py, boss.py, the calibration loader's three new branches) against the
JAX package, on the checked-in data/ fixtures, JAX's tiny Llama (f32) and
the ByteTokenizer, fused=False on both sides.

- C-Eval (humanities, val) and CMMLU (humanities, test), 0- and 2-shot,
  through Benchmark: the same per-subject and per-category counts, and the
  same prediction for every question.
- BOSS QA (advqa): the same predictions and metrics; the metric helpers on
  golden strings.
- The ceval, cmmlu and boss calibration sets: JAX's token arrays exactly.
- Calibration batches of different lengths (the C-Eval set): the port's
  Hessians for each linear group equal JAX's own forward and reduction of
  each batch with the rope tables of its length, within 1e-5, where JAX's
  sequential_quantize takes the first batch's tables for all and raises; quantize builds
  the C-Eval set itself and runs GPTQ with a journal, and a second call
  resumes from it to the same words.
"""
import numpy as np
import pytest
import torch

from mi_optimize_tpu.datasets import calibration as JC
from mi_optimize_tpu.datasets.tokenizer import ByteTokenizer as JByteTokenizer
from mi_optimize_tpu.eval import boss as jboss
from mi_optimize_tpu.eval import mcqa as jmcqa
from mi_optimize_tpu.eval.benchmark import Benchmark as JBenchmark
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.quant.config import CalibrationConfig as JCalibrationConfig
from mi_optimize_tpu_torch.datasets import calibration as C
from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
from mi_optimize_tpu_torch.eval import boss, mcqa
from mi_optimize_tpu_torch.eval.benchmark import Benchmark
from mi_optimize_tpu_torch.quant.config import CalibrationConfig
from tests.test_torch_datasets import DATA, FIXTURES, bare  # noqa: F401
from tests.test_torch_convert import port_model


@pytest.fixture(scope="module")
def models():
    jm = JModel.tiny_llama()
    return jm, port_model(jm)


def _recorded(monkeypatch, module, name, take):
    """Wrap module.name so that every call's result passes through `take`
    into the returned list."""
    seen = []
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        seen.append(take(a, out))
        return out

    monkeypatch.setattr(module, name, wrapped)
    return seen


def _letters(scores_of):
    letters = mcqa._letter_ids(ByteTokenizer())
    return lambda a, out: "ABCD"[int(np.argmax(scores_of(out)[letters]))]


@pytest.mark.parametrize("bench,num_shot", [("ceval", 0), ("cmmlu", 0), ("ceval", 2)])
def test_mcqa_matches_jax(bare, monkeypatch, models, bench, num_shot):  # noqa: F811
    jm, pm = models
    want_p = _recorded(monkeypatch, jmcqa, "_last_logits",
                       _letters(lambda o: np.asarray(o[0], np.float32)))
    got_p = _recorded(monkeypatch, mcqa, "_last_logits",
                      _letters(lambda o: o[0].numpy()))
    kw = dict(subject="hm", num_shot=num_shot, max_questions=3)
    if num_shot:
        kw["fewshot_split"] = "dev"
    want = getattr(JBenchmark(fused=False), f"eval_{bench}")(jm, JByteTokenizer(), **kw)
    got = getattr(Benchmark(fused=False, device="cpu"), f"eval_{bench}")(pm, ByteTokenizer(),
                                                                          **kw)
    assert len(got["subjects"]) >= 5 and len(got_p) == len(want_p) >= 15
    assert got_p == want_p
    assert got == want


def test_boss_matches_jax(bare, monkeypatch, models):  # noqa: F811
    jm, pm = models
    want_p = _recorded(monkeypatch, jboss, "compute_metric", lambda a, out: list(a[1]))
    got_p = _recorded(monkeypatch, boss, "compute_metric", lambda a, out: list(a[1]))
    kw = dict(test_dataset="QuestionAnswering_advqa", max_questions=4)
    want = JBenchmark(fused=False).eval_boss(jm, JByteTokenizer(), **kw)
    got = Benchmark(fused=False, device="cpu").eval_boss(pm, ByteTokenizer(), **kw)
    assert len(got_p[0]) == 4 and got_p == want_p
    assert got == want and set(got) == {"exact_match", "f1"}


def test_boss_metrics_golden():
    assert boss.normalize_answer("ToxicDetection", "Ben.") == "benign"
    assert boss.normalize_answer("NaturalLanguageInference", "ent") == "entailment"
    assert boss.compute_metric("SentimentAnalysis", ["Positive!", "neg"],
                               ["positive", "negative"]) == {"accuracy": 50.0}
    got = boss.compute_metric("QuestionAnswering", ["the Eiffel tower", "x"],
                              [["Eiffel Tower"], ["y", "z"]])
    assert got == jboss.compute_metric("QuestionAnswering", ["the Eiffel tower", "x"],
                                       [["Eiffel Tower"], ["y", "z"]])
    assert got["exact_match"] == 50.0
    with pytest.raises(ValueError):
        boss.compute_metric("NER", [], [])


@pytest.mark.parametrize("name,kw", [("ceval", dict(nsamples=1, seqlen=256)),
                                     ("cmmlu", dict(nsamples=2, seqlen=128, subject="st")),
                                     ("boss", dict(nsamples=5, seqlen=4096))])
def test_calibration_sets_match_jax(bare, name, kw):  # noqa: F811
    got = C.get_calibrate_loader(ByteTokenizer(), CalibrationConfig(name=name, **kw))
    want = JC.get_calibrate_loader(JByteTokenizer(), JCalibrationConfig(name=name, **kw))
    assert len(got) == len(want) >= 5
    assert len({g.shape[1] for g in got}) > 1       # one length a question
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_varying_length_stats_match_jax_batch_by_batch(bare, models):  # noqa: F811
    import jax.numpy as jnp

    from mi_optimize_tpu.models import llama as jllama
    from mi_optimize_tpu.quant import calibrate as jcal
    from mi_optimize_tpu.quant.base import init_stats as jinit
    from mi_optimize_tpu.quant.base import update_stats_device as jupdate
    from mi_optimize_tpu_torch.quant import calibrate as cal

    jm, pm = models
    batches = C.get_calibrate_loader(
        ByteTokenizer(), CalibrationConfig(name="ceval", nsamples=1, seqlen=96, subject="hm"))
    lens = [b.shape[1] for b in batches]
    assert len(set(lens)) > 1
    rope = cal._Rope(pm.config, torch.device("cpu"))
    xs = [pm.params["embed"][torch.as_tensor(b)] for b in batches]
    blk = pm.params["layers"][0]
    jblk = jm.params["layers"][0]
    for lead in ("q_proj", "o_proj", "gate_proj", "down_proj"):
        n = blk[lead].in_features
        got = cal._collect_group_stats(blk, xs, rope, pm.config, lead, ("xtx",), n)
        want = jinit(("xtx",), n)
        for b in batches:
            S = b.shape[1]
            cos, sin = jllama.rope_tables(jm.config, jnp.arange(S))
            x = jllama.embed(jm.params, jnp.asarray(b))
            cap = jcal._stats_forward(jblk, x, cos, sin, jllama.causal_mask(S), jm.config, lead)
            want = jupdate(("xtx",), want, cap)
        assert int(got["nsamples"]) == int(want["nsamples"]) == len(batches)
        w = np.asarray(want["xtx"])
        np.testing.assert_allclose(got["xtx"].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_quantize_calibrates_on_ceval_with_a_journal(bare, models, tmp_path):  # noqa: F811
    """quantize builds the C-Eval set through the loader (questions of
    different lengths) and runs GPTQ with a journal; a second call resumes
    from the finished journal to the same words."""
    import mi_optimize_tpu_torch as pt
    from mi_optimize_tpu_torch.export import CalibrationJournal
    from mi_optimize_tpu_torch.quant import QuantConfig

    _, pm = models
    qcfg = QuantConfig.from_dict({"algo": "gptq", "wbit": "int4", "w_qtype": "per_group",
                                  "w_groupsize": 16, "blocksize": 32, "w_has_zero": True,
                                  "calibrate_config": {"name": "ceval", "nsamples": 1,
                                                       "seqlen": 64, "subject": "hm"}})
    j = CalibrationJournal(str(tmp_path))
    qm = pt.quantize(pm, qcfg, tokenizer=ByteTokenizer(), journal=j, device="cpu")
    assert j.last_completed() == pm.config.num_layers - 1
    again = pt.quantize(pm, qcfg, tokenizer=ByteTokenizer(), journal=j, device="cpu")
    for a, b in zip(qm.params["layers"], again.params["layers"]):
        for name in ("q_proj", "down_proj"):
            assert a[name].packed is not None and torch.equal(a[name].packed, b[name].packed)
            assert torch.equal(a[name].w_scale, b[name].w_scale)
