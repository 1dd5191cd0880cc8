"""The port's latency benchmark (eval/latency.py, Benchmark.eval_latency)
against the JAX package's, on the CPU. No time is asserted: on the CPU the
numbers are only the host's.

- model_weight_bytes equals JAX's on the tiny Llama (f32) and the aligned
  small Llama (int4 g128, packed), converted by convert.from_jax_params.
- _percentiles equals JAX's on the same list.
- forward_latency, decode_throughput(device="cpu", hbm_bytes_per_s=...) and
  Benchmark.eval_latency return JAX's keys.
- kernel_breakdown on the small Llama fused for serving, over the
  whole-model kernel (B4) and the flat one (B3), their plain versions here:
  bytes_per_token is the stack's bytes plus the live k/v rows (t <= pos at
  each timed position, averaged), and the keys are JAX's with the streaming
  rate named for what it is (torch.sum's over as many bytes).
- The HBM rate: the table's for a known device name, the caller's when
  given; an unknown device with no rate raises."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.eval import latency as jlatency
from mi_optimize_tpu.eval.benchmark import Benchmark as JBenchmark
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu_torch.eval import latency
from mi_optimize_tpu_torch.eval.benchmark import Benchmark
from mi_optimize_tpu_torch.serving import engine
from mi_optimize_tpu_torch.serving.flatdecode import stack_cache_flat, stack_flat
from mi_optimize_tpu_torch.serving.megadecode import stack_cache, stack_serving
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_torch_convert import port_model, small_models

HBM = 1e12
JAX_KB_KEYS = {"nominal_hbm_gbps", "stream_microbench_gbps", "megakernel"}
JAX_MEGA_KEYS = {"kind", "ms_per_token", "bytes_per_token", "gbps", "pct_of_nominal_hbm",
                 "pct_of_stream_microbench", "pct_of_step"}
RENAMED = {"stream_microbench_gbps": "torch_sum_gbps",
           "pct_of_stream_microbench": "pct_of_torch_sum"}


@pytest.fixture(scope="module")
def tiny():
    jm = JModel.tiny_llama()
    return jm, port_model(jm)


@pytest.fixture(scope="module")
def small():
    return small_models(seed=1)


def _port_keys(keys):
    return {RENAMED.get(k, k) for k in keys}


@pytest.mark.parametrize("which", ["tiny", "small"])
def test_model_weight_bytes_matches_jax(request, which):
    jm, pm = request.getfixturevalue(which)
    assert latency.model_weight_bytes(pm) == jlatency.model_weight_bytes(jm) > 0


def test_model_weight_bytes_counts_a_served_model_once(small):
    """fuse_for_serving's concatenated linears hold the same words; the
    blocks' "mega" tables are views of their kernel tables, not weights."""
    _, pm = small
    fm = fuse_for_serving(pm)
    stack_serving(fm)
    assert latency.model_weight_bytes(fm) == latency.model_weight_bytes(pm)


@pytest.mark.parametrize("times", [[0.5], [3e-3, 1e-3, 2e-3], list(np.linspace(0.1, 2.0, 30))])
def test_percentiles_match_jax(times):
    assert latency._percentiles(times) == jlatency._percentiles(times)


def test_forward_latency_keys(tiny):
    jm, pm = tiny
    want = jlatency.forward_latency(jm, seqlen=16, warmup=1, iters=3)
    got = latency.forward_latency(pm, seqlen=16, warmup=1, iters=3, device="cpu")
    assert got.keys() == want.keys() and (got["batch"], got["seqlen"]) == (1, 16)
    assert 0 < got["p10_ms"] <= got["p50_ms"] <= got["p90_ms"]


def test_decode_throughput_keys(tiny):
    jm, pm = tiny
    want = jlatency.decode_throughput(jm, prompt_len=8, decode_tokens=3, fused=False)
    got = latency.decode_throughput(pm, prompt_len=8, decode_tokens=3, device="cpu",
                                    hbm_bytes_per_s=HBM)
    assert got.keys() == want.keys()
    assert got["weight_bytes"] == want["weight_bytes"]
    assert got["sol_step_ms"] == pytest.approx(got["weight_bytes"] / HBM * 1e3)
    assert got["roofline_frac"] == pytest.approx(got["sol_step_ms"] / got["step_ms"])


def test_benchmark_eval_latency_keys(tiny):
    jm, pm = tiny
    kw = dict(prompt_len=8, decode_tokens=3)
    want = JBenchmark(fused=False).eval_latency(jm, seqlen=16, **kw)
    got = Benchmark(device="cpu").eval_latency(pm, seqlen=16, hbm_bytes_per_s=HBM, **kw)
    assert got.keys() == want.keys()
    assert got["forward"].keys() == want["forward"].keys()
    assert got["decode"].keys() == want["decode"].keys()


def test_unknown_device_without_a_rate_raises(tiny, monkeypatch):
    _, pm = tiny
    with pytest.raises(ValueError, match="hbm_bytes_per_s"):
        latency.decode_throughput(pm, prompt_len=8, decode_tokens=2, device="cpu")
    cuda = torch.device("cuda")
    for name, rate in (("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        if rate is None:
            with pytest.raises(ValueError, match="A100"):
                latency.hbm_rate(cuda)
        else:
            assert latency.hbm_rate(cuda) == rate
        assert latency.hbm_rate(cuda, 2e12) == 2e12
    assert 819e9 not in latency.HBM_BYTES_PER_S.values()


@pytest.fixture(scope="module")
def served(small):
    """The small Llama fused for serving, a 12-token prefill into an int8
    cache of 128 rows, and its first token."""
    _, pm = small
    fm = fuse_for_serving(pm)
    cfg = fm.config
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)))
    logits, cache = engine.prefill(fm.params, cfg, ids,
                                   engine.init_cache(cfg, 1, 128, torch.int8, device="cpu"))
    return fm, cache, torch.argmax(logits, -1)[:, None]


@pytest.mark.parametrize("kernel", ["mega", "flat"])
def test_kernel_breakdown_bytes_and_keys(served, kernel):
    fm, cache, tok = served
    cfg, n, pos0 = fm.config, 4, 12
    st = stack_serving(fm)
    if kernel == "flat":
        fl = stack_flat(fm, st)
        kb = latency.kernel_breakdown(fm, tok, pos0, None, 1.0, n=n, flat_meta=fl,
                                      flat_cache=stack_cache_flat(cache), hbm_bytes_per_s=HBM)
        stack = fl[0]
    else:
        kb = latency.kernel_breakdown(fm, tok, pos0, stack_cache(cache), 1.0, n=n,
                                      stack_meta=st, hbm_bytes_per_s=HBM)
        stack = st[0]
    stack_bytes = sum(t.numel() * t.element_size() for t in stack.values())
    rows = sum(p + 1 for p in range(pos0, pos0 + n))
    live = cfg.num_layers * 2 * cfg.num_kv_heads * (cfg.head_dim + 4) * rows / n
    mk = kb["megakernel"]
    assert mk["bytes_per_token"] == stack_bytes + live
    assert set(kb) - {"scatter_embed_glue", "lm_head_scatter_glue"} == _port_keys(JAX_KB_KEYS)
    assert set(mk) == _port_keys(JAX_MEGA_KEYS)
    assert mk["kind"] == ("flat(+lm_head+argmax)" if kernel == "flat" else "model_fused")
    assert kb["nominal_hbm_gbps"] == HBM / 1e9
    assert mk["pct_of_nominal_hbm"] == pytest.approx(100 * mk["gbps"] * 1e9 / HBM)
    assert mk["pct_of_torch_sum"] == pytest.approx(100 * mk["gbps"] / kb["torch_sum_gbps"])
    assert mk["pct_of_step"] == pytest.approx(100 * mk["ms_per_token"] / 1e3)


def test_kernel_breakdown_declines_an_unstackable_model(tiny):
    """A model without the serving blocks: None, as JAX's."""
    jm, pm = tiny
    cache = engine.init_cache(pm.config, 1, 128, torch.int8, device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.int64)
    assert latency.kernel_breakdown(pm, tok, 3, cache, 1.0, n=2, hbm_bytes_per_s=HBM) is None
    assert jlatency.kernel_breakdown(jm, jnp.zeros((1, 1), jnp.int32), 3, None, 1.0) is None


def test_decode_throughput_whole_model_path_on_the_cpu(served, monkeypatch):
    """With the card's branch taken on the CPU, decode_loop_model and
    kernel_breakdown run on their plain versions: megakernel_path with the
    step's keys, and the kernel's bytes a token those of the stack and the
    live rows at the timed positions 32..35. Without it, the CPU times the
    per-layer loop only."""
    fm = served[0]
    plain = latency.decode_throughput(fm, prompt_len=32, decode_tokens=4,
                                      cache_dtype=torch.int8, device="cpu", hbm_bytes_per_s=HBM)
    assert "megakernel_path" not in plain and "kernels" not in plain
    monkeypatch.setattr(latency, "_on_card", lambda dev: True)
    out = latency.decode_throughput(fm, prompt_len=32, decode_tokens=4, cache_dtype=torch.int8,
                                    device="cpu", hbm_bytes_per_s=HBM)
    assert set(out["megakernel_path"]) == {"tokens_per_s_per_chip", "step_ms", "roofline_frac"}
    stack = stack_serving(fm)[0]
    cfg = fm.config
    live = cfg.num_layers * 2 * cfg.num_kv_heads * (cfg.head_dim + 4) * sum(
        p + 1 for p in range(32, 36)) / 4
    assert out["kernels"]["megakernel"]["bytes_per_token"] == sum(
        t.numel() * t.element_size() for t in stack.values()) + live
