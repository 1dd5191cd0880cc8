"""Boundaries of the PyTorch port: it never imports JAX or the JAX package,
its entry points never fall back to the CPU on their own, and on CPU tensors
the three kernel wrappers run their plain versions without counting a
launch."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig, init_params
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
from mi_optimize_tpu_torch.ops import block_fused, dequant_matmul, model_flat
from mi_optimize_tpu_torch.serving import engine
from mi_optimize_tpu_torch.serving.flatdecode import decode_loop_flat, stack_cache_flat, stack_flat
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mi_optimize_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "mi_optimize_tpu") or m.startswith(("jax.", "flax.", "mi_optimize_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15  # every module of the slice was imported
    assert bad.strip() == "[]"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda cfg: engine.init_cache(cfg, 1, 128, torch.int8),
    lambda cfg: init_params(cfg),
    lambda cfg: build_quantized_llama(cfg),
])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, call):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(LlamaConfig.tiny(hidden_size=128, intermediate_size=256, head_dim=32))


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    model = fuse_for_serving(Model(
        config=cfg, params=build_quantized_llama(cfg, dtype=torch.float32, device="cpu")))
    assert all("mega" in b for b in model.params["layers"])
    fstack, fmeta = stack_flat(model)
    for m in (dequant_matmul, block_fused, model_flat):
        m.launches = 0
    prompt = np.arange(5)[None] % cfg.vocab_size
    out = engine.generate(model, prompt, max_new_tokens=3, cache_dtype=torch.int8)
    logits, cache = engine.prefill(model.params, cfg, torch.from_numpy(prompt),
                                   engine.init_cache(cfg, 1, 128, torch.int8, device="cpu"))
    toks, _ = decode_loop_flat(model.params, fstack, fmeta, cfg,
                               torch.argmax(logits, -1)[:, None], stack_cache_flat(cache), 5, 3)
    assert out.shape == (1, 8) and toks.shape == (1, 3)
    assert (dequant_matmul.launches, block_fused.launches, model_flat.launches) == (0, 0, 0)


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
