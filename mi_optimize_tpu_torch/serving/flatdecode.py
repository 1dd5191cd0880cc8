"""Serving glue for the flat whole-model decode kernel (ops/model_flat.py):
single-stream greedy decode with the lm_head and argmax inside the kernel.

Port of mi_optimize_tpu/serving/flatdecode.py:

    model = fuse_for_serving(model)
    fl = stack_flat(model)                    # None -> use engine.decode_loop
    logits, cache = prefill(...)              # per-layer int8 cache
    decode_loop_flat(..., stack_cache_flat(cache), ...)   # one launch per token
    decode_loop_flat_seg(..., kseg=k)         # one launch per k tokens

Where `stack_flat` returns None (asymmetric grids, an unpacked lm_head)
callers decode as the reference's bench does: through
`megadecode.decode_loop_model` (one model_fused launch per token, the
lm_head outside it) when `megadecode.stack_serving` takes the model, else
through `engine.decode_loop` (the per-layer block_fused kernel).
"""
from __future__ import annotations

import torch

from ..models import llama
from ..models.model import Model


def stack_flat(model: Model, st=None):
    """(stack, meta) for the flat kernel, or None. `st` may pass a
    precomputed megadecode.stack_serving result."""
    from ..ops.model_flat import stack_flat_params
    from .megadecode import stack_serving

    if st is None:
        st = stack_serving(model)
    if st is None:
        return None
    return stack_flat_params(model, st[0], st[1])


def stack_cache_flat(cache_list):
    """Per-layer engine cache (batch=1, int8) -> merged flat layout
    {"kv": [L,T,2,Hkv,D] int8, "kv_scale": [L,T,2,Hkv] f32}."""
    k = torch.stack([c["k"][0] for c in cache_list])
    v = torch.stack([c["v"][0] for c in cache_list])
    ks = torch.stack([c["k_scale"][0] for c in cache_list])
    vs = torch.stack([c["v_scale"][0] for c in cache_list])
    return {"kv": torch.stack([k, v], dim=2), "kv_scale": torch.stack([ks, vs], dim=2)}


def _flat_step(params, stack, meta, cfg, tok, cache, pos: int):
    """One token: (next token [1] int32, logits [1,V], cache). The new k/v
    rows are scattered into the cache in place."""
    from ..ops.model_flat import model_decode_flat

    x = llama.embed(params, tok)                                   # [1, 1, h]
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=x.device))
    cossin = torch.cat([cos.reshape(-1)[-cfg.head_dim:], sin.reshape(-1)[-cfg.head_dim:]])
    tok2, logits, kvrows, kvsc = model_decode_flat(stack, x, cossin, cache, pos, cfg, meta)
    cache["kv"][:, pos] = kvrows
    cache["kv_scale"][:, pos] = kvsc[:, :, 0]
    return tok2, logits, cache


@torch.no_grad()
def decode_loop_flat(params, stack, meta, cfg, token, cache, pos0: int, n: int):
    """Greedy-decode n tokens, one kernel launch per token (lm_head and
    argmax included). token [1,1] -> (tokens [1,n], cache)."""
    toks = []
    tok = token
    for i in range(n):
        nt, _, cache = _flat_step(params, stack, meta, cfg, tok, cache, int(pos0) + i)
        tok = nt.to(token.dtype).reshape(1, 1)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache


def _flat_seg_step(params, stack, meta, cfg, tok, cache, pos: int, kseg: int):
    """kseg greedy tokens in ONE launch (ops/model_flat_seg.py): the kernel
    reads the next token's embedding row itself, and the segment's kseg
    cache rows are written after it with one indexed write per field.
    Returns (tokens [kseg] int32, cache)."""
    from ..ops.model_flat_seg import model_decode_flat_seg

    x = llama.embed(params, tok)                                   # [1, 1, h]
    cos, sin = llama.rope_tables(cfg, int(pos) + torch.arange(kseg, device=x.device))
    toks, kvrows, kvsc = model_decode_flat_seg(stack, params["embed"], x,
                                               torch.cat([cos, sin], dim=-1), cache, pos, cfg,
                                               meta, kseg)
    cache["kv"][:, pos:pos + kseg] = kvrows.transpose(0, 1)
    cache["kv_scale"][:, pos:pos + kseg] = kvsc.transpose(0, 1)
    return toks, cache


@torch.no_grad()
def decode_loop_flat_seg(params, stack, meta, cfg, token, cache, pos0: int, n: int, kseg: int = 8):
    """Greedy-decode n tokens with ceil(n/kseg) multi-token launches. token
    [1,1] -> (tokens [1, ceil(n/kseg)*kseg], cache): the last segment's
    surplus tokens are decoded too and extend the same greedy sequence; the
    caller keeps the first n."""
    toks = []
    tok = token
    for s in range(-(-n // kseg)):
        seg, cache = _flat_seg_step(params, stack, meta, cfg, tok, cache, int(pos0) + s * kseg,
                                    kseg)
        tok = seg[kseg - 1].to(token.dtype).reshape(1, 1)
        toks.append(seg.to(token.dtype))
    return torch.cat(toks)[None], cache
