"""Boundaries of the PyTorch port: it never imports JAX or the JAX package,
its entry points never fall back to the CPU on their own, and on CPU tensors
the kernel wrappers run their plain versions without counting a launch."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig, init_params
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models.synthetic import with_w4a8
from mi_optimize_tpu_torch.ops import (block_fused, decode_attention, dequant_matmul, mlp_fused,
                                       model_flat, model_flat_seg, model_fused, paged_attention,
                                       w4a8_matmul)
from mi_optimize_tpu_torch.serving import engine, megadecode
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, SpeculativeBatcher
from mi_optimize_tpu_torch.serving.paged import (PagedBatcher, PagedMegaBatcher,
                                                 PagedSpeculativeBatcher)
from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                      stack_cache_flat, stack_flat)
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.speculative import speculative_generate
from mi_optimize_tpu_torch.utils.planted import build_planted_llama, planted_pair
from mi_optimize_tpu_torch.datasets.tokenizer import ByteTokenizer
from mi_optimize_tpu_torch.eval.benchmark import Benchmark
from mi_optimize_tpu_torch.quant import QuantConfig, get_algo, quantize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mi_optimize_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "mi_optimize_tpu", "safetensors")
             or m.startswith(("jax.", "flax.", "mi_optimize_tpu.", "safetensors.")))
assert "mi_optimize_tpu_torch.parallel.overlap" in names, names  # parallel/ is scanned
new = {"eval.latency", "eval.lmeval", "eval.squad_metrics", "eval.lmeval_tasks",
       "eval.lmeval_gen_tasks", "eval.lmeval_more_tasks", "datasets.lmdatasets", "cli.common",
       "cli.benchmark_ppl", "cli.benchmark_ceval", "cli.benchmark_cmmlu", "cli.benchmark_lm_eval",
       "cli.benchmark_latency", "cli.quantize", "cli.quantization", "cli.quantize_eval",
       "cli.eval", "cli.inference", "cli.serve"}
assert {"mi_optimize_tpu_torch." + n for n in new} <= set(names), names
from mi_optimize_tpu_torch.eval.lmeval import expand_task_names
expand_task_names([])  # the task tables, imported for their registry
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 28  # every module of the four slices was imported
    assert bad.strip() == "[]"


PORTED_ALGOS = {"awq": "awq.AWQAlgo", "smoothquant": "smoothquant.SmoothQuantAlgo",
                "smooth": "smoothquant.SmoothQuantAlgo", "zeroquant": "zeroquant.ZeroQuantAlgo",
                "fp8": "fp8.FP8Algo", "spqr": "spqr.SpQRAlgo", "quip": "quip.QuIPAlgo",
                "awq+gptq": "combos.AWQGPTQAlgo", "smoothquant+gptq": "combos.SmoothGPTQAlgo"}


def test_top_level_exports_and_algorithms_not_ported():
    """The top-level exports, and each of the nine algorithm names beyond
    rtn and gptq gives its ported class (none is left unported)."""
    import mi_optimize_tpu_torch as pt

    assert pt.quantize is quantize and pt.Benchmark is Benchmark
    assert pt.QuantizedLinear.__module__ == "mi_optimize_tpu_torch.models.quant_linear"
    assert pt.as_precision("int4") is pt.Precision.INT4
    for name, where in PORTED_ALGOS.items():
        algo = get_algo(name, QuantConfig(algo=name))
        mod, cls = where.split(".")
        assert type(algo).__module__ == f"mi_optimize_tpu_torch.quant.{mod}"
        assert type(algo).__name__ == cls


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda cfg: engine.init_cache(cfg, 1, 128, torch.int8),
    lambda cfg: init_params(cfg),
    lambda cfg: build_quantized_llama(cfg),
    lambda cfg: build_planted_llama(cfg, np.arange(cfg.vocab_size)),
    lambda cfg: planted_pair(cfg),
    lambda cfg: quantize(Model(config=cfg, params=init_params(cfg, device="cpu")),
                         QuantConfig(algo="rtn", wbit="int4")),
    lambda cfg: Benchmark().eval_ppl(Model(config=cfg, params=init_params(cfg, device="cpu")),
                                     ByteTokenizer(), ["wikitext2"], seqlen=64, nsamples=1),
])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, call):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(LlamaConfig.tiny(hidden_size=128, intermediate_size=256, head_dim=32))


@pytest.mark.parametrize("make", [
    lambda m: ContinuousBatcher(m, n_slots=2, max_len=128, cache_dtype=torch.int8),
    lambda m: PagedMegaBatcher(m, n_slots=2, max_len=128),
    lambda m: PagedBatcher(m, n_slots=2),
    lambda m: SpeculativeBatcher(m, m, n_slots=2, max_len=128, cache_dtype=torch.int8),
    lambda m: PagedSpeculativeBatcher(m, m, n_slots=2, max_len=128),
])
def test_batcher_cache_on_cuda_raises_without_gpu(monkeypatch, make):
    """A model built with the default device has its tensors on CUDA; each
    batcher puts its cache or page pool beside them and, without a GPU,
    raises instead of moving to the CPU. No tensor can be made on CUDA here,
    so the model's embedding is a stand-in that reports the CUDA device."""
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256, head_dim=32)
    model = Model(config=cfg, params={"embed": types.SimpleNamespace(device=torch.device("cuda"))})
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        make(model)


def test_batcher_refuses_more_slots_than_the_batched_kernel_takes():
    """With the batched kernel on, more than MAX_BATCH slots raise (no quiet
    switch to the per-layer path); with it off they decode per layer."""
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256, head_dim=32)
    model = Model(config=cfg, params=init_params(cfg, device="cpu"))
    n = model_fused.MAX_BATCH + 1
    with pytest.raises(ValueError, match=f"at most {model_fused.MAX_BATCH} slots"):
        ContinuousBatcher(model, n_slots=n, max_len=128, cache_dtype=torch.int8,
                          use_megakernel=True)
    b = ContinuousBatcher(model, n_slots=n, max_len=128, cache_dtype=torch.int8,
                          use_megakernel=False)
    assert b._mega is None and b.cache[0]["k"].shape[0] == n


_COUNTERS = ((dequant_matmul, "launches"), (dequant_matmul, "launches_gemv16"),
             (dequant_matmul, "launches_mma"), (block_fused, "launches"),
             (block_fused, "launches_mega4"), (model_flat, "launches"),
             (model_fused, "launches"), (model_fused, "launches_batch"),
             (model_fused, "launches_paged"), (model_fused, "launches_chunk"),
             (model_fused, "launches_lm"), (model_flat_seg, "launches"),
             (paged_attention, "launches"), (decode_attention, "launches"),
             (mlp_fused, "launches"), (w4a8_matmul, "launches"))


def _counts():
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    model = fuse_for_serving(Model(
        config=cfg, params=build_quantized_llama(cfg, dtype=torch.float32, device="cpu")))
    assert all("mega" in b for b in model.params["layers"])
    fstack, fmeta = stack_flat(model)
    before = _counts()
    prompt = np.arange(5)[None] % cfg.vocab_size
    out = engine.generate(model, prompt, max_new_tokens=3, cache_dtype=torch.int8)
    logits, cache = engine.prefill(model.params, cfg, torch.from_numpy(prompt),
                                   engine.init_cache(cfg, 1, 128, torch.int8, device="cpu"))
    tok = torch.argmax(logits, -1)[:, None]
    toks, _ = decode_loop_flat(model.params, fstack, fmeta, cfg, tok, stack_cache_flat(cache), 5,
                               3)
    mtoks, _ = megadecode.decode_loop_model(model.params, fstack, fmeta[:9], cfg, tok,
                                            megadecode.stack_cache(cache), 5, 3)
    b = ContinuousBatcher(model, n_slots=2, max_len=128, cache_dtype=torch.int8,
                          use_megakernel=True)
    assert b._mega is not None
    res = b.run_all([prompt[0], prompt[0, :3]], max_new_tokens=3)
    assert out.shape == (1, 8) and toks.shape == mtoks.shape == (1, 3)
    assert torch.equal(toks, mtoks) and res[0] == [int(tok)] + toks[0, :2].tolist()
    # the paged batchers: paged decode, prefix-cache chunks, paged flash decode
    pm = PagedMegaBatcher(model, n_slots=2, max_len=256, prefix_cache=True)
    long = np.arange(140) % cfg.vocab_size
    want = _dense_tokens(model, long)
    assert pm.run_all([long, long], max_new_tokens=3) == {0: want, 1: want}
    assert pm.prefix_cache_stats()["hit_tokens"] == 128
    pb = PagedBatcher(model, n_slots=2, page_size=16, n_pages=8, pages_per_slot=2)
    pb.add_request(prompt[0], max_new_tokens=3)
    while any(pb.slot_req):
        pb.step()
    # the speculative paths: the multi-token flat decode, the scan-flat
    # route (flat draft, chunk verify with the fused lm rows) and both
    # speculative batchers
    stoks, _ = decode_loop_flat_seg(model.params, fstack, fmeta, cfg, tok,
                                    stack_cache_flat(cache), 5, 3, kseg=2)
    assert torch.equal(stoks[:, :3], toks)
    out2, stats = speculative_generate(model, model, prompt, max_new_tokens=4, k=2,
                                       cache_dtype=torch.int8, draft_megakernel=True)
    assert stats["scan_segments"] and stats["accept_rate"] == 1.0
    assert out2[0, 5:].tolist() == [int(tok)] + toks[0].tolist()
    sb = SpeculativeBatcher(model, model, k=2, n_slots=2, max_len=128, cache_dtype=torch.int8,
                            use_megakernel=True, use_draft_megakernel=True)
    assert sb.run_all([prompt[0]], max_new_tokens=3) == {0: out2[0, 5:8].tolist()}
    ps = PagedSpeculativeBatcher(model, model, k=2, n_slots=2, max_len=256)
    assert ps.run_all([prompt[0]], max_new_tokens=3) == {0: out2[0, 5:8].tolist()}
    assert _counts() == before


def _dense_tokens(model, prompt):
    """Three greedy tokens of `prompt` through the dense batcher."""
    b = ContinuousBatcher(model, n_slots=1, max_len=256, cache_dtype=torch.int8,
                          use_megakernel=True)
    return b.run_all([prompt], max_new_tokens=3)[0]


def test_kernel_launchers_validate_inputs_before_building():
    """The CUDA launchers check dtype and shape in Python before any pointer
    reaches native code (called here on CPU tensors, they raise before the
    build is reached)."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    model = fuse_for_serving(Model(
        config=cfg, params=build_quantized_llama(cfg, dtype=torch.float32, device="cpu")))
    blk = model.params["layers"][0]
    lin = blk["o_proj"]
    st, bt = dequant_matmul.kernel_tables(lin)
    x = torch.zeros(1, 256)
    with pytest.raises(ValueError, match="scale/bias"):
        dequant_matmul._packed_matmul_cuda(x, lin.packed, st[:1], bt, 4, 128)
    with pytest.raises(TypeError, match="int32"):
        dequant_matmul._packed_matmul_cuda(x, lin.packed.to(torch.int64), st, bt, 4, 128)

    cache = engine.init_cache(cfg, 1, 128, torch.int8, device="cpu")[0]
    cache["k"] = cache["k"][:, :, :, :64].contiguous()
    cos = sin = torch.zeros(128)
    with pytest.raises(ValueError, match="k cache"):
        block_fused._block_decode_cuda(blk, blk["mega"], x[None], cos, sin, cache, 3, cfg)

    fstack, fmeta = stack_flat(model)
    fcache = stack_cache_flat(engine.init_cache(cfg, 1, 128, torch.int8, device="cpu"))
    bad = dict(fstack, ue=fstack["ue"][:, :32].contiguous())
    with pytest.raises(ValueError, match=r"stack\[ue\]"):
        model_flat._model_decode_flat_cuda(bad, x[None], torch.zeros(256), fcache, 3, cfg, fmeta)
    # the multi-token entry point: the embedding table and the segment's rows
    emb = model.params["embed"]
    cs = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="emb"):
        model_flat.flat_launch("mi_model_decode_flat_seg", fstack, x[None], cs, cs, fcache, 3,
                               cfg, fmeta, kseg=4, emb=emb[:, :64].contiguous())
    with pytest.raises(ValueError, match="outside the cache"):
        model_flat.flat_launch("mi_model_decode_flat_seg", fstack, x[None], cs, cs, fcache, 125,
                               cfg, fmeta, kseg=4, emb=emb)


def test_whole_model_launchers_validate_inputs_before_building():
    """model_decode_mega's and model_decode_mega_batch's launchers check
    dtype, shape and the positions in Python before any pointer reaches
    native code (here on CPU tensors, so a pass would reach the build and
    fail differently); the batched wrapper refuses the modes not ported."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, dtype=torch.float32, device="cpu", symmetric=False)))
    stack, meta = megadecode.stack_serving(model)
    assert meta[5:] == (None,) * 4 and "qz" in stack
    T, L, Hkv, D = 128, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    x, cs = torch.zeros(1, 1, 256), torch.zeros(D)
    cache = megadecode.init_cache_stacked(cfg, T, device="cpu")
    mega = model_fused._model_decode_mega_cuda
    with pytest.raises(ValueError, match=r"stack\[qz\]"):
        mega(dict(stack, qz=stack["qz"][:, :1].contiguous()), x, cs, cs, cache, 3, cfg, meta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mega(stack, x.to(torch.float64), cs, cs, cache, 3, cfg, meta)
    with pytest.raises(ValueError, match="position"):
        mega(stack, x, cs, cs, cache, T, cfg, meta)
    with pytest.raises(ValueError, match=r"cache\[k\]"):
        mega(stack, x, cs, cs, dict(cache, k=cache["k"][:, :, :, :64].contiguous()), 3, cfg, meta)

    B = 3
    bcache = megadecode.stack_cache_batched(engine.init_cache(cfg, B, T, torch.int8,
                                                              device="cpu"))
    xb, cb = torch.zeros(B, 1, 256), torch.zeros(B, D)
    batch = model_fused._model_decode_mega_batch_cuda
    with pytest.raises(ValueError, match="positions"):
        batch(stack, xb, cb, cb, bcache, [0, 5, T], cfg, meta)
    with pytest.raises(ValueError, match="positions"):
        batch(stack, xb, cb, cb, bcache, [0, 5], cfg, meta)
    with pytest.raises(ValueError, match="slots"):
        batch(stack, torch.zeros(9, 1, 256), cb, cb, bcache, [0] * 9, cfg, meta)
    with pytest.raises(ValueError, match=r"cache\[v_scale\]"):
        batch(stack, xb, cb, cb, dict(bcache, v_scale=bcache["v_scale"][:, :2].contiguous()),
              [0, 5, 7], cfg, meta)
    with pytest.raises(ValueError, match=r"stack\[gu\]"):
        batch(dict(stack, gu=stack["gu"][:, :, :8].contiguous()), xb, cb, cb, bcache,
              [0, 5, 7], cfg, meta)
    # the paged (b) and chunk (c) modes: the page table, the pool and the
    # chunk's positions are checked before the build
    pool = megadecode.init_pool_batched(cfg, 5, 128, device="cpu")
    table = torch.tensor([[1, 2], [3, 4], [0, 0]])
    with pytest.raises(ValueError, match="table"):
        batch(stack, xb, cb, cb, pool, [0, 5, 7], cfg, meta, table=table.clone().fill_(5))
    with pytest.raises(ValueError, match="positions"):
        batch(stack, xb, cb, cb, pool, [0, 5, 256], cfg, meta, table=table)
    with pytest.raises(ValueError, match="multiple of 128"):
        batch(stack, xb, cb, cb, {f: v[:, :, :, :64].contiguous() for f, v in pool.items()},
              [0, 5, 7], cfg, meta, table=table)
    with pytest.raises(ValueError, match=r"cache\[k\]"):
        batch(stack, xb[:2], cb[:2], cb[:2], bcache, [3, 4], cfg, meta, chunk=2)
    mega_batch = model_fused.model_decode_mega_batch
    with pytest.raises(ValueError, match="consecutive"):
        mega_batch(stack, xb[:2], cb[:2], cb[:2], bcache, [3, 5], cfg, meta, chunk=2)
    with pytest.raises(ValueError, match="one row per slot"):
        mega_batch(stack, xb, cb, cb, pool, [0, 5, 7], cfg, meta, table=table[:2])
    # mode (e) takes a group of tp ranks, and refuses the chunk mode and the lm rows
    with pytest.raises(ValueError, match="group of 2 ranks"):
        mega_batch(stack, xb, cb, cb, bcache, [0, 5, 7], cfg, meta, tp=2)
    with pytest.raises(ValueError, match="tp = 1"):
        mega_batch(stack, xb[:2], cb[:2], cb[:2], bcache, [3, 4], cfg, meta, chunk=2, tp=2)
    # the terminal lm rows (mode d): lm and lm_meta come together, and the
    # launcher checks the lm_head's words, scales and final norm
    assert megadecode.stack_lm(model, meta) is None   # an asymmetric lm_head grid
    ue = build_quantized_llama(cfg, dtype=torch.float32, device="cpu")["lm_head"]
    lm = {"ue": ue.packed, "ues": dequant_matmul.kernel_tables(ue)[0],
          "fnorm": model.params["final_norm"]}
    lm_meta = (128, 8.0, cfg.vocab_size, 64)
    with pytest.raises(ValueError, match="lm_meta"):
        mega_batch(stack, xb, cb, cb, bcache, [0, 5, 7], cfg, meta, lm=lm)
    for bad, what in ((dict(lm, ue=lm["ue"][:, :32].contiguous()), r"lm\[ue\]"),
                      (dict(lm, ues=lm["ues"][:1].contiguous()), r"lm\[ues\]"),
                      (dict(lm, fnorm=lm["fnorm"][:8]), r"lm\[fnorm\]")):
        with pytest.raises(ValueError, match=what):
            batch(stack, xb, cb, cb, bcache, [0, 5, 7], cfg, meta, lm=bad, lm_meta=lm_meta)


@pytest.mark.parametrize("B,chunk", [(9, 1), (10, 5), (16, 8)])
def test_batched_kernel_refuses_more_than_8_rows(B, chunk):
    """model_decode_mega_batch takes at most MAX_BATCH = 8 rows (slots x
    chunk tokens), on the CPU as on the card, where the reference takes any
    number; it names the limit."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, dtype=torch.float32, device="cpu")))
    stack, meta = megadecode.stack_serving(model)
    cache = megadecode.stack_cache_batched(engine.init_cache(cfg, B // chunk, 128, torch.int8,
                                                             device="cpu"))
    cs = torch.zeros(B, cfg.head_dim)
    with pytest.raises(ValueError, match="MAX_BATCH = 8 rows"):
        model_fused.model_decode_mega_batch(stack, torch.zeros(B, 1, 256), cs, cs, cache,
                                            list(range(B)), cfg, meta, chunk=chunk)


def test_paged_attention_validates_inputs_before_building():
    """The paged flash decode's launcher checks the contract, the shapes, the
    table and the positions in Python (here on CPU tensors, so a pass would
    reach the build and fail differently)."""
    H, Hkv, D, P, pps = 4, 2, 128, 16, 2
    q, pk = torch.zeros(2, H * D), torch.zeros(5, P, Hkv, D)
    table, kw = torch.tensor([[1, 2], [3, 4]]), dict(n_heads=H, n_kv_heads=Hkv, head_dim=D,
                                                       page_size=P)
    launch = paged_attention._paged_flash_attention_cuda
    with pytest.raises(ValueError, match="contract"):
        launch(q, pk, pk, table, [0, 3], **dict(kw, page_size=12))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(q.double(), pk, pk, table, [0, 3], **kw)
    with pytest.raises(ValueError, match="pv"):
        launch(q, pk, pk[:, :8].contiguous(), table, [0, 3], **kw)
    with pytest.raises(ValueError, match="table"):
        launch(q, pk, pk, table + 3, [0, 3], **kw)
    with pytest.raises(ValueError, match="positions"):
        launch(q, pk, pk, table, [0, pps * P], **kw)
    assert not paged_attention.paged_attention_supported(P, 64)


@pytest.mark.parametrize("w4a8", [False, True])
def test_unfused_path_on_cpu_takes_the_stock_route_and_counts_nothing(monkeypatch, w4a8):
    """An unfused model on CPU tensors: generate and compute_ppl take the
    stock path (the reference's on a CPU), even with MI_W4A8_INT=1, whose
    integer product runs its plain version; no kernel is launched."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    params = build_quantized_llama(cfg, dtype=torch.float32, device="cpu")
    model = Model(config=cfg, params=with_w4a8(params) if w4a8 else params)
    monkeypatch.setenv("MI_W4A8_INT", "1")
    before = _counts()
    prompt = np.arange(40)[None] % cfg.vocab_size
    out = engine.generate(model, prompt, max_new_tokens=3, cache_dtype=torch.int8)
    ppl = compute_ppl(model, [prompt, prompt[:, :33]])
    assert out.shape == (1, 43) and np.isfinite(ppl) and ppl > 1.0
    assert _counts() == before


def test_unfused_launchers_validate_inputs_before_building():
    """The decode attention, fused MLP and W4A8 launchers check dtype and
    shape in Python before any pointer reaches native code (called here on
    CPU tensors, they raise before the build is reached)."""
    H, Hkv, D, T = 4, 2, 128, 64
    q, kv = torch.zeros(1, H * D), torch.zeros(1, Hkv * D)
    cs = torch.zeros(1, D)
    ck, cks = torch.zeros(T, Hkv, D, dtype=torch.int8), torch.zeros(T, Hkv)
    att = decode_attention._fused_decode_attention_cuda
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)
    with pytest.raises(TypeError, match="one dtype"):
        att(q, kv.to(torch.bfloat16), kv, cs, cs, ck, ck, cks, cks, 3, **kw)
    with pytest.raises(ValueError, match="position"):
        att(q, kv, kv, cs, cs, ck, ck, cks, cks, T, **kw)
    with pytest.raises(ValueError, match="cache_v"):
        att(q, kv, kv, cs, cs, ck, ck[:, :, :64].contiguous(), cks, cks, 3, **kw)
    with pytest.raises(ValueError, match="contract"):
        att(q, kv, kv, cs, cs, ck, ck, cks, cks, 3, n_heads=3, n_kv_heads=2, head_dim=D,
            max_len=T)

    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    blk = build_quantized_llama(cfg, dtype=torch.float32, device="cpu")["layers"][0]
    tabs = [t for n in ("gate_proj", "up_proj", "down_proj")
            for t in (blk[n].packed, *dequant_matmul.zero_tables(blk[n]))]
    mkw = dict(bits=4, k_group=128, i_group=128, qmin=0, inter=512, hidden=256)
    x = torch.zeros(3, 256)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mlp_fused._fused_mlp_cuda(x.to(torch.float64), *tabs, **mkw)
    with pytest.raises(ValueError, match="down words"):
        mlp_fused._fused_mlp_cuda(x, *tabs[:6], tabs[6][:8].contiguous(), *tabs[7:], **mkw)
    with pytest.raises(ValueError, match="unsupported"):
        mlp_fused._fused_mlp_cuda(x, *tabs, **dict(mkw, inter=480))

    lin = blk["q_proj"]
    st, zt = dequant_matmul.zero_tables(lin)
    xi = torch.zeros(40, 256, dtype=torch.int8)
    w4 = w4a8_matmul._w4a8_matmul_int_cuda
    with pytest.raises(ValueError, match="multiples"):
        w4(xi, lin.packed, st, zt, bits=4, groupsize=16, qmin=0)
    with pytest.raises(TypeError, match="int8"):
        w4(xi.to(torch.int32), lin.packed, st, zt, bits=4, groupsize=128, qmin=0)
    with pytest.raises(ValueError, match="scales"):
        w4(xi, lin.packed, st[:1], zt, bits=4, groupsize=128, qmin=0)
