"""Multi-token flat decode: kseg greedy tokens of the whole model (every
layer, the final rmsnorm, the packed lm_head and a first-index argmax each)
in ONE launch, for a small draft model whose per-token launches and glue
cost more than its weights.

Kernel: csrc/model_flat.cu (`model_flat_seg_kernel`, entry
`mi_model_decode_flat_seg`), which replaces the TPU kernel
mi_optimize_tpu/ops/model_flat_seg.py::_kernel_flat_seg
(model_decode_flat_seg).

What bounds it on an H100: kseg times the flat kernel's bytes (the packed
model plus the lm_head, read once per token: token t + 1's first layer
needs token t's argmax, so the tokens share no weight read), 5.32 ms at
Llama-2-7B int4 g128 for kseg = 5. With 4-bit words the kernel runs the
one-token flat kernel's tensor-core layer loop (csrc/flat_model.cuh,
`flat4_model` with the segment policy) once for each token: the same GEMV
phases, plan (`model_flat.flat_plans`), partials and rounding points as
`model_decode_flat`, so that a segment costs what kseg of its launches do,
less the launches and the host glue between them; each later token's first
ring stages go out as soon as its input is known. Every block reduces the
blocks' argmax pairs itself and reads the winner's embedding row directly,
so that one barrier passes a token on. Token t attends to the cache rows
before pos0 and then to the segment's rows 0..t-1, which other blocks of
the launch wrote into its output rows: those rows and scales are loaded
through L2, never L1. The caller writes all kseg rows into the cache after
the launch. 2- and 8-bit words keep the CUDA-core
decoder_layer.

Tokens come back as flat int32 ids [kseg], not the reference's [kseg, 8,
128] lane tiles. On CPU tensors the wrapper runs the plain version,
`model_decode_flat_seg_ref`; on CUDA tensors it launches the kernel, and a
refused launch raises.
"""
from __future__ import annotations

import torch

from .model_flat import flat_launch, model_decode_flat_ref

launches = 0  # kernel launches; chip_smoke.py resets and reads it


def model_decode_flat_seg_ref(stack, emb, x, cossin, cache, pos0: int, cfg, meta, kseg: int):
    """Plain PyTorch version of the kernel (same signature and outputs as
    `model_decode_flat_seg`): kseg steps of `model_decode_flat_ref`, each
    reading the cache rows before pos0 and the segment's earlier rows from a
    working copy of the cache."""
    T = cache["kv"].shape[1]
    if not (0 <= pos0 and pos0 + kseg <= T):
        raise ValueError(f"positions {pos0}..{pos0 + kseg - 1} outside the cache of {T} rows")
    work = {f: cache[f][:, :pos0 + kseg].clone() for f in ("kv", "kv_scale")}
    toks, rows, scales = [], [], []
    for t in range(kseg):
        tok, _, kv, sc = model_decode_flat_ref(stack, x, cossin[t], work, pos0 + t, cfg, meta)
        work["kv"][:, pos0 + t] = kv
        work["kv_scale"][:, pos0 + t] = sc[:, :, 0]
        toks.append(tok)
        rows.append(kv)
        scales.append(sc[:, :, 0])
        x = emb[tok.to(torch.long)].reshape(x.shape)
    return torch.cat(toks), torch.stack(rows), torch.stack(scales)


def model_decode_flat_seg(stack, emb, x, cossin, cache, pos0: int, cfg, meta, kseg: int):
    """kseg greedy tokens, one launch: x [1,1,h] (the first token's embedding
    row), emb [V, h] (the embedding table, x's dtype), cossin [kseg, 2D] (the
    rope rows of positions pos0..pos0+kseg-1), cache the merged flat cache
    {"kv": [L,T,2,Hkv,D] int8, "kv_scale": [L,T,2,Hkv] f32} holding rows <
    pos0, stack/meta from `serving.flatdecode.stack_flat`. Returns (tokens
    [kseg] int32, kvrows [kseg, L, 2, Hkv, D] int8, kvscales [kseg, L, 2,
    Hkv] f32) for the caller to scatter at pos0..pos0+kseg-1. The kernel on
    GPU tensors, the plain version on CPU tensors."""
    cossin = cossin.reshape(kseg, 2 * cfg.head_dim)
    if not x.is_cuda:
        return model_decode_flat_seg_ref(stack, emb, x, cossin, cache, int(pos0), cfg, meta,
                                         kseg)
    return _model_decode_flat_seg_cuda(stack, emb, x, cossin, cache, int(pos0), cfg, meta, kseg)


def _model_decode_flat_seg_cuda(stack, emb, x, cossin, cache, pos0: int, cfg, meta, kseg: int):
    global launches
    D = cfg.head_dim
    toks, _, kvrows, kvsc = flat_launch("mi_model_decode_flat_seg", stack, x, cossin[:, :D],
                                        cossin[:, D:], cache, pos0, cfg, meta, kseg=kseg, emb=emb)
    launches += 1
    return toks, kvrows, kvsc
