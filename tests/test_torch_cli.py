"""The port's CLI twins (mi_optimize_tpu_torch/cli/), each through its
`main([..., "--device", "cpu"])` on small checkpoints written under tmp_path.

- benchmark_ppl's JSON against the JAX package's Benchmark.eval_ppl on the
  same model (the aligned small Llama, int4 g128, saved by the port's
  export.save_model): within rtol 1e-5.
- quantize (an HF checkpoint of a tiny Llama, RTN int4 g16 from a YAML
  config) saves the words, scales and zeros of JAX's quantize of the same
  checkpoint, bit for bit (JAX's qparams jitted, as tests/test_torch_quant.py
  holds RTN).
- serve's batcher, paged (prefix cache; parallel samples), speculative
  (single stream and SpeculativeBatcher), paged speculative and beam modes
  against the port's own library calls on the same checkpoint.
- The other twins (benchmark_ceval, _cmmlu, _lm_eval, _latency, eval,
  inference, quantization, quantize_eval) against the port's library calls
  (latency: the keys and the byte counts; its times are the host's).
transformers' AutoTokenizer is replaced by the ByteTokenizer here, so no
test reaches the network; the HF datasets fallback raises
(tests/test_torch_lmdatasets.py::no_hf)."""
import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import mi_optimize_tpu as mt
from mi_optimize_tpu.datasets.tokenizer import ByteTokenizer as JByteTokenizer
from mi_optimize_tpu.eval.benchmark import Benchmark as JBenchmark
from mi_optimize_tpu.models.loader import load_llama_from_hf as jax_load
from mi_optimize_tpu.quant import rtn as jrtn
from mi_optimize_tpu_torch.cli import (benchmark_ceval, benchmark_cmmlu, benchmark_latency,
                                       benchmark_lm_eval, benchmark_ppl, eval as cli_eval,
                                       inference, quantization, quantize, quantize_eval, serve)
from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
from mi_optimize_tpu_torch.eval.benchmark import Benchmark
from mi_optimize_tpu_torch.eval.latency import decode_throughput, forward_latency
from mi_optimize_tpu_torch.export import load_model, save_model
from mi_optimize_tpu_torch.serving import generate
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, SpeculativeBatcher
from mi_optimize_tpu_torch.serving.beam import beam_search
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher, PagedSpeculativeBatcher
from mi_optimize_tpu_torch.serving.speculative import speculative_generate
from tests.test_loader import make_fake_hf_ckpt
from tests.test_torch_checkpoint import _arrays, _same_arrays
from tests.test_torch_convert import small_models
from tests.test_torch_lmdatasets import no_hf, write_raw  # noqa: F401

PROMPTS = ["Hello there", "The quick brown fox jumps", "a", "Once upon a time, in a land"]
EOS = ByteTokenizer().eos_token_id
RTN_YAML = """quant_config:
  algo: rtn
  kwargs: {wbit: int4, abit: float16, w_qtype: per_group, w_groupsize: 16,
           w_has_zero: false, w_unsign: true, quantization_type: dynamic}
"""


@pytest.fixture(autouse=True)
def byte_tokenizer(monkeypatch):
    """AutoTokenizer.from_pretrained gives the ByteTokenizer: no hub lookup."""
    transformers = pytest.importorskip("transformers")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda *a, **kw: ByteTokenizer()))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(JAX model, the port's model as the checkpoint reloads it, checkpoint
    dir, prompts file): the aligned small Llama (int4 g128, V=300)."""
    jm, pm = small_models(seed=2, vocab_size=300)
    root = tmp_path_factory.mktemp("cli")
    save_model(pm, str(root / "ckpt"))
    (root / "prompts.txt").write_text("\n".join(PROMPTS) + "\n\n")
    return jm, load_model(str(root / "ckpt"), device="cpu"), str(root / "ckpt"), str(
        root / "prompts.txt")


@pytest.fixture()
def mcqa_data(tmp_path, monkeypatch):
    """A C-Eval and a CMMLU subject of two questions each (the checked-in
    files' first rows), the only data the port's loaders see."""
    from mi_optimize_tpu_torch.datasets import calibration
    from tests.test_torch_datasets import DATA

    for src, dst in (("ceval-exam/ceval-exam-category/middle_school_geography/"
                      "middle_school_geography_val.csv",) * 2,
                     ("cmmlu_v1_0_1/test/anatomy.csv",) * 2):
        with open(f"{DATA}/{src}", encoding="utf-8") as f:
            rows = f.read().splitlines(keepends=True)[:3]
        (tmp_path / dst).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / dst).write_text("".join(rows), encoding="utf-8")
    monkeypatch.setattr(calibration, "_search_dirs", lambda: (str(tmp_path),))


def _ids(prompt):
    return ByteTokenizer()(prompt)["input_ids"]


def test_benchmark_ppl_matches_jax(ckpt, tmp_path):
    jm, _, path, _ = ckpt
    out = tmp_path / "ppl.json"
    got = benchmark_ppl.main(["--quantized-model", path, "--seqlen", "64", "--nsamples", "2",
                              "--device", "cpu", "--output-json", str(out)])
    want = JBenchmark(fused=False).eval_ppl(jm, JByteTokenizer(), "wikitext2", seqlen=64,
                                            nsamples=2)
    assert json.loads(out.read_text()) == got and got.keys() == want.keys() == {"wikitext2"}
    assert got["wikitext2"] == pytest.approx(want["wikitext2"], rel=1e-5)


@pytest.fixture(scope="module")
def hf_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    make_fake_hf_ckpt(root, vocab=300, hidden=64, inter=128, heads=4, kv=2)
    (root / "rtn.yaml").write_text(RTN_YAML)
    return root


def test_quantize_saves_jax_words(hf_ckpt, tmp_path):
    save = tmp_path / "q"
    quantize.main(["--model-path", str(hf_ckpt), "--quant-config", str(hf_ckpt / "rtn.yaml"),
                   "--save", str(save), "--device", "cpu"])
    jqd = jax.jit(jrtn.qparams.quantize_dequantize, static_argnums=(1, 2, 3),
                  static_argnames=("symmetric", "unsigned"))
    with mock.patch.object(jrtn.qparams, "quantize_dequantize", jqd):
        jq = mt.quantize(jax_load(str(hf_ckpt)), str(hf_ckpt / "rtn.yaml"))
    got = load_model(str(save), device="cpu")
    _same_arrays(_arrays(got.params), _arrays(jq.params))
    assert got.params["layers"][0]["q_proj"].packed is not None


def test_quantization_and_quantize_eval(hf_ckpt, tmp_path, mcqa_data):
    """The flag CLI and the pipeline CLI save what quantize saves; their
    C-Eval scores are Benchmark's on the saved model."""
    want = tmp_path / "want"
    quantize.main(["--model-path", str(hf_ckpt), "--quant-config", str(hf_ckpt / "rtn.yaml"),
                   "--save", str(want), "--device", "cpu"])
    ref = load_model(str(want), device="cpu")
    ceval = _json(Benchmark(device="cpu").eval_ceval(ref, ByteTokenizer()))
    a = tmp_path / "a"
    res = quantization.main(["--model-path", str(hf_ckpt), "--algo", "rtn", "--wbit", "int4",
                             "--w-groupsize", "16", "--save", str(a), "--benchmark", "ceval",
                             "--device", "cpu"])
    _same_arrays(_arrays(load_model(str(a), device="cpu").params), _arrays(ref.params))
    assert _json(res) == {"ceval": ceval}
    b, out = tmp_path / "b", tmp_path / "res.json"
    res = quantize_eval.main(["--model-path", str(hf_ckpt), "--quant-config",
                              str(hf_ckpt / "rtn.yaml"), "--save", str(b), "--eval-ceval",
                              "--output-json", str(out), "--device", "cpu"])
    _same_arrays(_arrays(load_model(str(b), device="cpu").params), _arrays(ref.params))
    assert _json(res)["ceval"] == ceval and json.loads(out.read_text()) == _json(res)


def _json(obj):
    return json.loads(json.dumps(obj, default=float))


def test_eval_and_inference(ckpt, mcqa_data):
    _, pm, path, _ = ckpt
    res = cli_eval.main(["--quantized-model", path, "--eval-ceval", "--eval-cmmlu",
                         "--device", "cpu"])
    bench = Benchmark(device="cpu")
    assert _json(res) == _json({"ceval": bench.eval_ceval(pm, ByteTokenizer()),
                                "cmmlu": bench.eval_cmmlu(pm, ByteTokenizer())})
    assert res["ceval"]["subjects"] and res["cmmlu"]["subjects"]
    out = inference.main(["--quantized-model", path, "--prompt", "Hi there",
                          "--max-new-tokens", "5", "--device", "cpu"])
    np.testing.assert_array_equal(out, generate(pm, _ids("Hi there"), max_new_tokens=5))


@pytest.mark.parametrize("which", ["ceval", "cmmlu"])
def test_mcqa_benchmarks(ckpt, mcqa_data, which):
    _, pm, path, _ = ckpt
    cli = {"ceval": benchmark_ceval, "cmmlu": benchmark_cmmlu}[which]
    got = cli.main(["--quantized-model", path, "--subject", "all", "--num-shot", "0",
                    "--device", "cpu"])
    want = getattr(Benchmark(device="cpu"), f"eval_{which}")(pm, ByteTokenizer(), subject="all")
    assert got == _json(want) and len(got["subjects"]) == 1


def test_benchmark_lm_eval(ckpt, tmp_path, monkeypatch):
    _, pm, path, _ = ckpt
    write_raw(tmp_path, "mc_taco")
    monkeypatch.setenv("MI_TPU_DATA_DIR", str(tmp_path))
    got = benchmark_lm_eval.main(["--quantized-model", path, "--tasks", "mc_taco",
                                  "--device", "cpu"])
    assert got == Benchmark(device="cpu").eval_lmeval(pm, ByteTokenizer(), ["mc_taco"])


def test_benchmark_latency(ckpt):
    _, pm, path, _ = ckpt
    """The twin returns Benchmark.eval_latency's result: the library's keys
    (from one short call of each function) and its weight bytes and bound."""
    got = benchmark_latency.main(["--quantized-model", path, "--seqlen", "16",
                                  "--hbm-bytes-per-s", "1e12", "--device", "cpu"])
    fwd = forward_latency(pm, seqlen=16, warmup=0, iters=1, device="cpu")
    dec = decode_throughput(pm, prompt_len=16, decode_tokens=1, warmup=0, device="cpu",
                            hbm_bytes_per_s=1e12)
    assert got.keys() == {"forward", "decode"} and got["forward"].keys() == fwd.keys()
    assert got["forward"]["seqlen"] == 16 and got["decode"].keys() == dec.keys()
    assert got["decode"]["weight_bytes"] == dec["weight_bytes"]
    assert got["decode"]["sol_step_ms"] == dec["sol_step_ms"]
    with pytest.raises(ValueError, match="hbm_bytes_per_s"):
        benchmark_latency.main(["--quantized-model", path, "--device", "cpu"])


def _loop(batcher, n_new, **kw):
    """serve's loop on a library batcher: every prompt admitted with the
    tokenizer's eos, stepped to the end; {key: tokens}."""
    reqs, pending = {}, list(enumerate(PROMPTS))
    while pending or any(r is not None for r in batcher.slot_req):
        while pending:
            i, p = pending[0]
            rid = batcher.add_request(_ids(p), max_new_tokens=n_new, eos_token_id=EOS, **kw)
            if rid is None:
                break
            for j, r_ in enumerate(rid if isinstance(rid, list) else [rid]):
                reqs[(i, j)] = next(r for r in batcher.slot_req if r and r.rid == r_)
            pending.pop(0)
        batcher.step()
    n = kw.get("n", 1)
    return {f"{i}.{j}" if n > 1 else str(i): r.tokens for (i, j), r in sorted(reqs.items())}


def _run_all(b):
    return {str(k): v for k, v in b.run_all([_ids(p) for p in PROMPTS], max_new_tokens=6).items()}


SERVE = {
    "batcher": ([], lambda m: _loop(ContinuousBatcher(m, n_slots=2, max_len=256,
                                                      cache_dtype=torch.int8), 6)),
    "paged_prefix": (["--paged", "--prefix-cache"],
                     lambda m: _loop(PagedMegaBatcher(m, n_slots=2, max_len=256,
                                                      prefix_cache=True), 6)),
    "paged_samples": (["--paged", "--n", "2", "--temperature", "0.8", "--seed", "3"],
                      lambda m: _loop(PagedMegaBatcher(m, n_slots=2, max_len=256), 6, n=2,
                                      temperature=0.8, top_p=1.0, top_k=0, seed=3)),
    "speculative": (["--speculative", "--slots", "1", "--k", "3"],
                    lambda m: {str(i): speculative_generate(
                        m, m, _ids(p), max_new_tokens=6, k=3, cache_dtype=torch.int8)[0][
                            0, len(p):].tolist() for i, p in enumerate(PROMPTS)}),
    "speculative_batcher": (["--speculative", "--k", "3"], lambda m: _run_all(
        SpeculativeBatcher(m, m, k=3, n_slots=2, max_len=256, cache_dtype=torch.int8))),
    "paged_speculative": (["--paged", "--speculative", "--k", "3"], lambda m: _run_all(
        PagedSpeculativeBatcher(m, m, k=3, n_slots=2, max_len=256))),
}


@pytest.mark.parametrize("mode", sorted(SERVE))
def test_serve_matches_the_library(ckpt, mode):
    _, pm, path, prompts = ckpt
    flags, ref = SERVE[mode]
    argv = ["--quantized-model", path, "--prompts", prompts, "--slots", "2", "--max-len", "256",
            "--max-new-tokens", "6", "--device", "cpu"] + flags
    got = serve.main(argv)
    want = ref(pm if mode == "speculative" else fuse_for_serving(pm))
    assert got["requests"] == want
    if mode == "paged_prefix":
        assert set(got["prefix_cache"]) >= {"hit_tokens", "miss_tokens"}


def test_serve_beam_matches_beam_search(ckpt):
    _, pm, path, prompts = ckpt
    got = serve.main(["--quantized-model", path, "--prompts", prompts, "--beam", "2",
                      "--max-len", "256", "--max-new-tokens", "4", "--device", "cpu"])
    fm = fuse_for_serving(pm)
    for i, p in enumerate(PROMPTS):
        want = beam_search(fm, _ids(p), beam_width=2, max_new_tokens=4, eos_token_id=EOS,
                           max_len=256)
        hyps = got["prompts"][str(i)]["hypotheses"]
        assert [h["tokens"] for h in hyps] == [list(t) for t, _ in want]
        assert [h["score"] for h in hyps] == pytest.approx([s for _, s in want])


def test_serve_refuses_a_prefix_cache_without_pages(ckpt):
    _, _, path, prompts = ckpt
    with pytest.raises(SystemExit):
        serve.main(["--quantized-model", path, "--prompts", prompts, "--prefix-cache",
                    "--device", "cpu"])


@pytest.mark.parametrize("cli", ["benchmark_ppl", "benchmark_ceval", "benchmark_cmmlu",
                                 "benchmark_lm_eval", "benchmark_latency", "eval", "inference",
                                 "quantization", "quantize", "quantize_eval", "serve"])
def test_device_defaults_to_the_card(ckpt, hf_ckpt, monkeypatch, capsys, cli):
    """Without --device a twin loads onto the card, and with no GPU it
    raises instead of moving to the CPU; --help names the flag."""
    import importlib

    _, _, path, prompts = ckpt
    mod = importlib.import_module(f"mi_optimize_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hf = ["--model-path", str(hf_ckpt)]
    argv = {"quantize": hf + ["--quant-config", str(hf_ckpt / "rtn.yaml")],
            "quantization": hf, "quantize_eval": hf + ["--quant-config",
                                                       str(hf_ckpt / "rtn.yaml")],
            "serve": ["--quantized-model", path, "--prompts", prompts]}.get(
        cli, ["--quantized-model", path])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
