"""The port's data path (mi_optimize_tpu_torch.datasets, eval.benchmark)
against the JAX package, from the checked-in data/ and tests/fixtures/c4,
with no download: the Arrow IPC reader gives pyarrow's strings, the loaders
give JAX's token arrays exactly, and quantize with config-driven calibration
and Benchmark.eval_ppl agree with JAX's (PPL within 1% and 1e-4 relative)."""
import glob
import logging
import os

import numpy as np
import pytest

import mi_optimize_tpu as mt
import mi_optimize_tpu_torch as pt
from mi_optimize_tpu.datasets import calibration as JC
from mi_optimize_tpu.datasets.tokenizer import ByteTokenizer as JByteTokenizer
from mi_optimize_tpu.eval.benchmark import Benchmark as JBenchmark
from mi_optimize_tpu.eval.ppl import compute_ppl as jax_ppl
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.quant.config import CalibrationConfig as JCalibrationConfig
from mi_optimize_tpu_torch.datasets import calibration as C
from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
from mi_optimize_tpu_torch.eval.benchmark import Benchmark
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.quant.config import CalibrationConfig
from tests.test_torch_convert import port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ARROWS = sorted(glob.glob(os.path.join(DATA, "wikitext", "*.arrow"))
                + glob.glob(os.path.join(DATA, "ptb_text_only", "*.arrow")))


@pytest.fixture()
def bare(monkeypatch):
    """Both packages search the checked-in data/ and tests/fixtures only."""
    monkeypatch.delenv("MI_TPU_DATA_DIR", raising=False)
    monkeypatch.setattr(JC, "_search_dirs", lambda: (DATA, FIXTURES))
    monkeypatch.setattr(C, "_search_dirs", lambda: (DATA, FIXTURES))


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("path", ARROWS, ids=os.path.basename)
def test_arrow_reader_gives_pyarrows_strings(path):
    pa = pytest.importorskip("pyarrow")
    with open(path, "rb") as f:
        want = pa.ipc.open_stream(f).read_all().to_pydict()
    got = C.read_arrow_stream(path)
    assert list(got) == list(want) and len(next(iter(got.values()))) == 3000
    assert got == want


def test_arrow_reader_rejects_what_it_cannot_read(tmp_path):
    p = tmp_path / "empty.arrow"
    p.write_bytes(b"\xff\xff\xff\xff\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="no Arrow schema"):
        C.read_arrow_stream(str(p))


@pytest.mark.parametrize("name,split,kw", [
    ("wikitext2", "train", dict(nsamples=4, seqlen=128, seed=3)),
    ("wikitext2", "test", dict(nsamples=5, seqlen=256)),
    ("wikitext2", "test", dict(nsamples="all", seqlen=2048)),
    ("ptb", "test", dict(seqlen=512)),
    ("ptb", "train", dict(nsamples=3, seqlen=64, seed=1)),
])
def test_loaders_match_jax(bare, name, split, kw):
    fn, jfn = {"wikitext2": (C.get_wikitext2, JC.get_wikitext2),
               "ptb": (C.get_ptb, JC.get_ptb)}[name]
    _same(fn(ByteTokenizer(), split=split, **kw), jfn(JByteTokenizer(), split=split, **kw))


@pytest.mark.parametrize("split,nsamples", [("train", 3), ("validation", 2),
                                            ("validation", "all")])
def test_c4_matches_jax(monkeypatch, split, nsamples):
    monkeypatch.setenv("MI_TPU_DATA_DIR", FIXTURES)
    kw = dict(split=split, nsamples=nsamples, seqlen=256, seed=5)
    _same(C.get_c4(ByteTokenizer(), **kw), JC.get_c4(JByteTokenizer(), **kw))


@pytest.mark.parametrize("name,split", [("wikitext2", "train"), ("ptb", "train"),
                                        ("c4", "train")])
def test_calibrate_loader_matches_jax(bare, name, split):
    kw = dict(name=name, split=split, nsamples=4, seqlen=128, seed=2)
    _same(C.get_calibrate_loader(ByteTokenizer(), CalibrationConfig(**kw)),
          JC.get_calibrate_loader(JByteTokenizer(), JCalibrationConfig(**kw)))


def test_train_split_falls_back_to_validation(bare, caplog):
    with caplog.at_level(logging.WARNING, logger=C.__name__):
        got = C.get_wikitext2(ByteTokenizer(), split="train", nsamples=1, seqlen=64)
    assert got[0].shape == (1, 64)
    assert "using validation for calibration" in caplog.text


def test_not_ported_sets_raise(bare):
    # the C-Eval, CMMLU and BOSS sets are ported (tests/test_torch_eval_mcqa.py
    # holds them against JAX's), and so are lm-eval and the latency benchmark
    # (tests/test_torch_lmeval.py, test_torch_latency.py): only an unknown
    # set, an unknown lm-eval task or an HBM rate the CPU does not have raise
    for name in ("ceval", "cmmlu", "boss"):
        got = C.get_calibrate_loader(ByteTokenizer(), CalibrationConfig(name=name, nsamples=1))
        assert got and all(g.dtype == np.int64 and g.shape[0] == 1 for g in got)
    with pytest.raises(ValueError, match="unsupported"):
        C.get_calibrate_loader(ByteTokenizer(), CalibrationConfig(name="nope"))
    b = Benchmark(device="cpu")
    model = Model.tiny_llama(device="cpu")
    with pytest.raises(ValueError, match="unknown lm-eval task"):
        b.eval_lmeval(model, ByteTokenizer(), ["nope"])
    with pytest.raises(ValueError, match="hbm_bytes_per_s"):
        b.eval_latency(model, seqlen=8, prompt_len=8, decode_tokens=2)


def test_quantize_with_config_driven_calibration(bare):
    """quantize(model, config, tokenizer=...) builds its calibration set from
    the config through the datasets layer, as JAX's does."""
    d = {"quant_config": {
        "algo": "gptq",
        "kwargs": {"wbit": "int4", "w_groupsize": 16, "blocksize": 32, "w_has_zero": True},
        "calibrate_config": {"name": "wikitext2", "split": "train", "nsamples": 2,
                             "seqlen": 64}}}
    jm = JModel.tiny_llama(vocab_size=300)
    pm = port_model(jm)
    jq = mt.quantize(jm, d, tokenizer=JByteTokenizer())
    tq = pt.quantize(pm, d, tokenizer=ByteTokenizer(), device="cpu")
    batches = [np.random.default_rng(0).integers(0, 300, (1, 32))]
    got, want = compute_ppl(tq, batches, fused=False), jax_ppl(jq, batches, fused=False)
    assert np.isfinite(got) and abs(got - want) / want < 0.01


@pytest.mark.parametrize("datasets,kw", [(["wikitext2"], dict(seqlen=128, nsamples=2)),
                                         ("wikitext2,ptb", dict(seqlen=128, nsamples=2))])
def test_ppl_eval_from_fixtures(bare, datasets, kw):
    jm = JModel.tiny_llama(max_seq_len=256, vocab_size=300)
    want = JBenchmark().eval_ppl(jm, JByteTokenizer(), datasets, **kw)
    got = Benchmark(device="cpu").eval_ppl(port_model(jm), ByteTokenizer(), datasets, **kw)
    assert list(got) == list(want)
    for k in want:
        assert np.isfinite(got[k]) and got[k] > 1.0
        assert abs(got[k] - want[k]) / want[k] < 1e-4, (k, got[k], want[k])


def test_c4_ppl_from_fixture(monkeypatch):
    monkeypatch.setenv("MI_TPU_DATA_DIR", FIXTURES)
    jm = JModel.tiny_llama(max_seq_len=256, vocab_size=300)
    want = JBenchmark().eval_c4_ppl(jm, JByteTokenizer(), seqlen=128, nsamples=2)
    got = Benchmark(device="cpu").eval_c4_ppl(port_model(jm), ByteTokenizer(), seqlen=128,
                                              nsamples=2)
    assert abs(got - want) / want < 1e-4
