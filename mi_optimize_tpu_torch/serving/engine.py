"""Serving path: KV-cached prefill, single-token decode, sampling, generate.

Port of mi_optimize_tpu/serving/engine.py (prefill, the chunk prefills of
speculative verify, decode, sampling). PyTorch runs eagerly, so the
reference's jit-compiled prefill / decode-step functions are plain functions
and its on-device scan is a Python loop. Caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.model import Model


def _cache_len(cache) -> int:
    c0 = cache[0]
    return (c0["k"] if isinstance(c0, dict) else c0[0]).shape[1]


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """KV cache, one entry per layer. dtype torch.int8 selects the quantized
    cache (int8 values + per-(token, head) f32 scales); a float dtype gives
    the plain (k, v) cache."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        return [
            {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
             "v": torch.zeros(shape, dtype=torch.int8, device=dev),
             "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
             "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev)}
            for _ in range(cfg.num_layers)
        ]
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.num_layers)]


@torch.no_grad()
def prefill(params, cfg, input_ids, cache, fused=True):
    """Process the prompt; returns (last-token logits [B,V], filled cache)."""
    B, S = input_ids.shape
    max_len = _cache_len(cache)
    x = llama.embed(params, input_ids)
    dev = x.device
    cos, sin = llama.rope_tables(cfg, torch.arange(S, device=dev))
    mask = torch.arange(max_len, device=dev)[None, :] <= torch.arange(S, device=dev)[:, None]
    new_cache = []
    for blk, kv in zip(params["layers"], cache):
        x, kv, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=kv,
                                     cache_index=0, fused=fused)
        new_cache.append(kv)
    x = llama.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused)[:, 0], new_cache


@torch.no_grad()
def prefill_chunk(params, cfg, input_ids, cache, pos0: int, fused=True):
    """Process a chunk of C tokens at positions pos0..pos0+C-1 against the
    cached context before pos0; returns (logits [B,C,V], cache). Unlike
    `prefill` it scores every chunk position: the speculative-decoding
    verify step."""
    B, C = input_ids.shape
    max_len = _cache_len(cache)
    x = llama.embed(params, input_ids)
    dev = x.device
    positions = int(pos0) + torch.arange(C, device=dev)
    cos, sin = llama.rope_tables(cfg, positions)
    mask = torch.arange(max_len, device=dev)[None, :] <= positions[:, None]       # [C, T]
    new_cache = []
    for blk, kv in zip(params["layers"], cache):
        x, kv, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=kv,
                                     cache_index=int(pos0), fused=fused)
        new_cache.append(kv)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused), new_cache


@torch.no_grad()
def prefill_chunk_batched(params, cfg, input_ids, cache, positions, fused=True):
    """B-slot chunk ingest or verify: input_ids [B, C], slot b's chunk at
    positions[b]..positions[b]+C-1 against its own cached prefix. Returns
    (logits [B, C, V], cache)."""
    B, C = input_ids.shape
    max_len = _cache_len(cache)
    x = llama.embed(params, input_ids)
    dev = x.device
    pos = torch.as_tensor(positions).reshape(-1).to(dev, torch.long)
    posm = pos[:, None] + torch.arange(C, device=dev)[None, :]                    # [B, C]
    cos, sin = llama.rope_tables(cfg, posm)                                       # [B, C, rd]
    mask = torch.arange(max_len, device=dev)[None, None, None, :] <= posm[:, None, :, None]
    new_cache = []
    for blk, kv in zip(params["layers"], cache):
        x, kv, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=kv,
                                     cache_index=pos, fused=fused)
        new_cache.append(kv)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused), new_cache


@torch.no_grad()
def decode_step(params, cfg, token, cache, pos: int, fused=True):
    """One autoregressive step. token [B,1], pos int; returns (logits, cache)."""
    pos = int(pos)
    max_len = _cache_len(cache)
    x = llama.embed(params, token)
    dev = x.device
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    mask = (torch.arange(max_len, device=dev)[None, :] <= pos)[None, :]
    new_cache = []
    for blk, kv in zip(params["layers"], cache):
        x, kv, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=kv,
                                     cache_index=pos, fused=fused)
        new_cache.append(kv)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused)[:, 0], new_cache


@torch.no_grad()
def decode_loop(params, cfg, token, cache, pos0: int, n: int, fused=True):
    """Greedy-decode `n` tokens. token [B,1] -> (tokens [B,n], cache)."""
    toks = []
    tok = token
    for i in range(n):
        logits, cache = decode_step(params, cfg, tok, cache, int(pos0) + i, fused)
        tok = torch.argmax(logits, dim=-1).to(token.dtype)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache


def _filter_logits(logits, temperature, top_p=1.0, top_k=0):
    """Temperature-scaled logits with the top-k / top-p truncation applied
    (dropped entries at -inf), as the reference's `_sample` masks them."""
    logits = logits.to(torch.float32) / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # exclusive cumulative mass: keep every token whose predecessors'
        # mass is < top_p; always keep the most likely token
        cum = torch.cumsum(probs, dim=-1) - probs
        keep = cum < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def _sample(logits, temperature, generator=None, top_p=1.0, top_k=0):
    """Greedy (temperature 0) or temperature sampling with optional nucleus
    (top_p) / top_k truncation."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits, temperature, top_p, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: Model,
    input_ids,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    eos_token_id: Optional[int] = None,
    max_len: Optional[int] = None,
    seed: int = 0,
    fused: bool = True,
    cache_dtype=torch.float32,
    top_p: float = 1.0,
    top_k: int = 0,
) -> np.ndarray:
    """Greedy/temperature/top-p/top-k generation on the device of the model's
    tensors; returns [B, prompt+new] as numpy."""
    cfg, params = model.config, model.params
    dev = params["embed"].device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev)
    B, S = ids.shape
    total = max_len or min(cfg.max_seq_len, S + max_new_tokens)
    if total % 128 and total + (-total) % 128 <= cfg.max_seq_len:
        # a multiple of 128 engages the one-launch decode kernel (block_fused)
        total += (-total) % 128
    cache = init_cache(cfg, B, total, cache_dtype, device=dev)
    logits, cache = prefill(params, cfg, ids, cache, fused)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [ids]
    for i in range(max_new_tokens):
        tok = _sample(logits, temperature, gen, top_p, top_k)
        out.append(tok[:, None].to(ids.dtype))
        if eos_token_id is not None and bool((tok == eos_token_id).all()):
            break
        logits, cache = decode_step(params, cfg, tok[:, None], cache, S + i, fused)
    return torch.cat(out, dim=1).cpu().numpy()
