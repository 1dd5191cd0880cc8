"""Latency / throughput benchmark: forward percentiles, decode tokens/s
against the HBM roofline, and the whole-model decode kernel timed alone.

Port of mi_optimize_tpu/eval/latency.py (the reference toolbox's
benchmark_latency.py: warmup 10 + 30 timed iterations, the mean and the
p10/25/50/75/90 percentiles), with decode tokens/s and the roofline
fraction from the packed weights' bytes (decode reads every weight once a
token: speed of light = weight bytes / HBM rate).

Times are walls of the host clock around calls that end in a
`torch.cuda.synchronize()` on the card; `kernel_breakdown` times the
kernel's launches with CUDA events. The HBM rate comes from
`HBM_BYTES_PER_S`, keyed on the device's name, or from the caller
(`hbm_bytes_per_s`); a device the table does not know, with no rate given,
raises. `kernel_breakdown` also reports the kernel against `torch.sum` over
a buffer of the bytes it reads, timed in the same call: the streaming rate
a library read reaches on this device.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import llama
from ..models.model import Model
from ..models.quant_linear import QuantizedLinear
from ..serving import decode_loop, init_cache, prefill

# HBM bandwidth (bytes/s) by torch.cuda.get_device_name: the data sheet's
# figure, the one the kernels' bounds use
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_rate(dev: torch.device, hbm_bytes_per_s: Optional[float] = None) -> float:
    """The caller's rate, else the table's for the device's name."""
    if hbm_bytes_per_s is not None:
        return float(hbm_bytes_per_s)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM rate known for device {name!r}; pass hbm_bytes_per_s")
    return HBM_BYTES_PER_S[name]


def _on_card(dev: torch.device) -> bool:
    """Whether decode_throughput times the whole-model path: on the card,
    as the reference does off the CPU."""
    return dev.type == "cuda"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn, dev: torch.device) -> float:
    """Seconds of fn() on the host clock, the device's work included."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _percentiles(times):
    t = np.asarray(times) * 1000.0
    return {
        "avg_ms": float(t.mean()),
        **{f"p{p}_ms": float(np.percentile(t, p)) for p in (10, 25, 50, 75, 90)},
    }


@torch.no_grad()
def forward_latency(model: Model, batch=1, seqlen=128, warmup=10, iters=30, fused=True,
                    device=None) -> Dict:
    """Full-forward latency of `batch` x `seqlen` seeded tokens on `device`
    ("cuda" unless the caller asks for the CPU)."""
    model = model.on(device)
    dev = model.params["embed"].device
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.config.vocab_size, (batch, seqlen)), device=dev)
    fwd = lambda: llama.forward(model.params, model.config, ids, fused=fused)
    for _ in range(warmup):
        fwd()
    times = [_wall(fwd, dev) for _ in range(iters)]
    return {"batch": batch, "seqlen": seqlen, **_percentiles(times)}


def _tensors(node):
    """The weight tensors of a params tree: JAX's pytree leaves (each
    linear's weight, words, scales, zeros, bias, smoothing, activation
    qparams and permutation; every other tensor). A block's "mega" entry
    holds views of its linears' kernel tables, which are not weights."""
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, QuantizedLinear):
        for f in ("weight", "packed", "w_scale", "w_zero", "bias", "smooth_factor", "a_scale",
                  "a_zero", "perm"):
            if getattr(node, f) is not None:
                yield getattr(node, f)
    elif isinstance(node, dict):
        for k, v in node.items():
            if k != "mega":
                yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)


def model_weight_bytes(model: Model) -> int:
    """Bytes of weight data the decode step must stream from HBM."""
    return sum(t.numel() * t.element_size() for t in _tensors(model.params))


@torch.no_grad()
def decode_throughput(model: Model, batch=1, prompt_len=128, decode_tokens=64, warmup=8,
                      fused=True, cache_dtype=torch.bfloat16, device=None,
                      hbm_bytes_per_s: Optional[float] = None) -> Dict:
    """Decode tokens/s on one device and the roofline fraction. The timed
    loop is engine.decode_loop (per layer: with an int8 cache, the fused
    model's per-layer decode kernel). With `fused`, batch 1 and the int8
    cache on a CUDA device, `megakernel_path` times the whole-model loop
    (megadecode.decode_loop_model) from the same state, and `kernels` its
    kernel alone (`kernel_breakdown`)."""
    model = model.on(device)
    cfg, params = model.config, model.params
    dev = params["embed"].device
    bw = hbm_rate(dev, hbm_bytes_per_s)
    total = prompt_len + decode_tokens + warmup + 1
    if total % 128 and total + (-total) % 128 <= cfg.max_seq_len:
        total += (-total) % 128   # the per-layer decode kernel's cache length, as generate's
    cache = init_cache(cfg, batch, total, cache_dtype, device=dev)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                            (batch, prompt_len)), device=dev)
    logits, cache = prefill(params, cfg, ids, cache, fused)
    tok = torch.argmax(logits, -1)[:, None]
    loop = lambda: decode_loop(params, cfg, tok, cache, prompt_len, decode_tokens, fused)
    loop()
    step_s = _wall(loop, dev) / decode_tokens

    wbytes = model_weight_bytes(model)
    sol_step_s = wbytes / bw  # speed of light: one full weight read per token
    out = {
        "tokens_per_s_per_chip": batch / step_s,
        "step_ms": step_s * 1e3,
        "weight_bytes": wbytes,
        "sol_step_ms": sol_step_s * 1e3,
        "roofline_frac": sol_step_s / step_s,
    }
    if fused and _on_card(dev) and batch == 1 and cache_dtype == torch.int8:
        from ..serving.megadecode import decode_loop_model, stack_cache, stack_serving

        st = stack_serving(model)
        if st is not None:
            stack, meta = st
            scache = stack_cache(cache)
            mega = lambda: decode_loop_model(params, stack, meta, cfg, tok, scache, prompt_len,
                                             decode_tokens)
            mega()
            mega_step_s = _wall(mega, dev) / decode_tokens
            out["megakernel_path"] = {
                "tokens_per_s_per_chip": 1.0 / mega_step_s,
                "step_ms": mega_step_s * 1e3,
                "roofline_frac": sol_step_s / mega_step_s,
            }
            kb = kernel_breakdown(model, tok, prompt_len, scache, mega_step_s, n=decode_tokens,
                                  stack_meta=st, hbm_bytes_per_s=bw)
            if kb is not None:
                out["kernels"] = kb
    return out


def _events_s(fn, dev: torch.device, reps: int = 1) -> float:
    """Seconds of one fn() on the device: CUDA events around `reps` calls
    (the host clock on the CPU), after one untimed call."""
    fn()
    if dev.type != "cuda":
        return _wall(lambda: [fn() for _ in range(reps)], dev) / reps
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / reps


def torch_sum_rate(nbytes: int, dev: torch.device, reps: int = 5) -> float:
    """Bytes/s of torch.sum over a float32 buffer of `nbytes` bytes."""
    buf = torch.zeros(-(-nbytes // 4), dtype=torch.float32, device=dev)
    s = _events_s(lambda: buf.sum(), dev, reps)
    del buf
    return nbytes / s


def kv_live_bytes(cfg, positions) -> int:
    """The int8 k/v rows and their f32 scales a whole-model decode kernel
    moves over all layers for tokens at these positions: the history rows
    t < pos it reads and the new row it writes."""
    return cfg.num_layers * 2 * sum(int(p) + 1 for p in positions) * cfg.num_kv_heads * (
        cfg.head_dim + 4)


@torch.no_grad()
def kernel_breakdown(model: Model, tok, pos0, cache_list, full_step_s, n=32, stack_meta=None,
                     flat_meta=None, flat_cache=None,
                     hbm_bytes_per_s: Optional[float] = None) -> Optional[Dict]:
    """The whole-model decode kernel timed alone over n tokens (positions
    pos0..pos0+n-1, the embedding of `tok` as every step's input, no cache
    scatter): its ms a token, bytes a token (the stack it reads and the live
    k/v rows, `kv_live_bytes`, averaged over the n positions), GB/s, and its
    share of the HBM rate, of torch.sum's rate over as many bytes and of the
    full step (`full_step_s`). Returns None when the model does not meet the
    whole-model kernels' contract.

    stack_meta: a (stack, meta) of megadecode.stack_serving, times B4
    (`model_decode_mega`) on the stacked cache `cache_list` (or a per-layer
    list, stacked here). flat_meta/flat_cache: a flatdecode.stack_flat
    result and its merged cache, times B3 (`model_decode_flat`, lm_head and
    argmax inside the kernel)."""
    from ..serving.megadecode import stack_cache, stack_serving

    cfg, params = model.config, model.params
    dev = params["embed"].device
    bw = hbm_rate(dev, hbm_bytes_per_s)
    lm = params.get("lm_head")
    lm_bytes = (sum(t.numel() * t.element_size() for t in (lm.packed, lm.w_scale, lm.w_zero)
                    if t is not None)
                if isinstance(lm, QuantizedLinear) and lm.packed is not None else 0)
    x0 = llama.embed(params, tok)
    positions = list(range(int(pos0), int(pos0) + n))
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev))
    cos, sin = cos.reshape(n, -1)[:, -cfg.head_dim:], sin.reshape(n, -1)[:, -cfg.head_dim:]

    if flat_meta is not None:
        from ..ops.model_flat import model_decode_flat

        stack, meta = flat_meta
        cossin = torch.cat([cos, sin], dim=1)

        def alone():
            for i, p in enumerate(positions):
                model_decode_flat(stack, x0, cossin[i], flat_cache, p, cfg, meta)
    else:
        from ..ops.model_fused import model_decode_mega

        st = stack_meta if stack_meta is not None else stack_serving(model)
        if st is None:
            return None
        stack, meta = st
        scache = stack_cache(cache_list) if isinstance(cache_list, list) else cache_list

        def alone():
            x = x0
            for i, p in enumerate(positions):
                x = model_decode_mega(stack, x, cos[i], sin[i], scache, p, cfg, meta)[0]

    mega_s = _events_s(alone, dev) / n
    stack_bytes = sum(t.numel() * t.element_size() for t in stack.values())
    mega_bytes = stack_bytes + kv_live_bytes(cfg, positions) / n
    rate = mega_bytes / mega_s
    sum_rate = torch_sum_rate(int(mega_bytes), dev)
    glue_s = max(full_step_s - mega_s, 0.0)
    out = {
        "nominal_hbm_gbps": bw / 1e9,
        "torch_sum_gbps": sum_rate / 1e9,
        "megakernel": {
            "kind": "flat(+lm_head+argmax)" if flat_meta is not None else "model_fused",
            "ms_per_token": mega_s * 1e3,
            "bytes_per_token": mega_bytes,
            "gbps": rate / 1e9,
            "pct_of_nominal_hbm": 100 * rate / bw,
            "pct_of_torch_sum": 100 * rate / sum_rate,
            "pct_of_step": 100 * mega_s / full_step_s,
        },
    }
    if flat_meta is not None:
        # the lm_head is inside the kernel (its bytes are in the stack); the
        # rest of a step is the cache-row scatter and the embedding gather
        out["scatter_embed_glue"] = {"ms_per_token": glue_s * 1e3}
    else:
        out["lm_head_scatter_glue"] = {
            "ms_per_token": glue_s * 1e3,
            "bytes_per_token": lm_bytes,
            "gbps_if_io_bound": lm_bytes / glue_s / 1e9 if glue_s > 0 else None,
        }
    return out
