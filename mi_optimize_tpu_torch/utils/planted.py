"""Planted-structure quantized models: greedy decoding follows a fixed token
map whose logit margins dwarf quantization and bf16 noise.

Port of mi_optimize_tpu/utils/planted.py (`planted_map`, `build_planted_llama`,
`planted_pair`). Random weights give near-tie argmaxes that flip between
serving paths and a draft/target accept rate of about 1/V; a planted model
makes every path (dense, flat, paged, prefix cache, speculative verify) emit
the same greedy chain m(t), m(m(t)), ..., and a draft built with a fraction
of its map redirected agrees at a controlled rate.

Construction: the embedding rows are random gaussians; every o_proj and
down_proj is exactly zero (a zero group quantizes to a finite scale and
codes that dequantize to exactly 0), so the residual stream carries
embed[t] through all layers; the packed lm_head is W = scatter(m)^T * embed,
so logits_j = embed[t] . W[j] peaks at j = m(t). qkv and gate/up stay
random: their weights are streamed at full cost, as a real checkpoint's.

The map comes from numpy, so the greedy chain is the reference's whatever
the weights; the weights are made on the device from explicit
torch.Generators (they are not the reference's numbers).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.model import Model
from ..models.synthetic import quantized_linear


def planted_map(vocab: int, seed: int = 0, disagree_frac: float = 0.0,
                disagree_seed: int = 1) -> np.ndarray:
    """Token map m [V] int32: a permutation σ, with `disagree_frac` of the
    entries redirected to random tokens (host-side, deterministic)."""
    rng = np.random.default_rng(seed)
    m = rng.permutation(vocab).astype(np.int32)
    if disagree_frac > 0:
        rng2 = np.random.default_rng(disagree_seed)
        n = int(disagree_frac * vocab)
        idx = rng2.choice(vocab, n, replace=False)
        m[idx] = rng2.integers(0, vocab, n)
    return m


def build_planted_llama(cfg, m: np.ndarray, bits: int = 4, groupsize: int = 128,
                        dtype=torch.bfloat16, embed_seed: int = 0, noise_seed: int = 7,
                        device=None):
    """Params of a packed int-quantized Llama whose greedy next token is m[t]
    for every context ending in token t, built on `device` (default CUDA)
    one linear at a time; the same shapes and weight traffic as
    models.synthetic.build_quantized_llama."""
    dev = resolve_device(device)
    h, V = cfg.hidden_size, cfg.vocab_size
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    embed = torch.randn(V, h, generator=torch.Generator(device=dev).manual_seed(embed_seed),
                        device=dev) * 0.02
    # W[j] = sum over t with m(t) = j of embed[t]; rows no t maps to stay zero
    w_lm = torch.zeros(V, h, device=dev).index_add_(
        0, torch.as_tensor(m, dtype=torch.long, device=dev), embed)
    gen = torch.Generator(device=dev).manual_seed(noise_seed)

    def rand(out_f, in_f):
        w = torch.randn(out_f, in_f, generator=gen, device=dev) * (in_f ** -0.5)
        return quantized_linear(w, bits, groupsize)

    def zero(out_f, in_f):
        return quantized_linear(torch.zeros(out_f, in_f, device=dev), bits, groupsize)

    layers = [{
        "input_norm": torch.ones(h, dtype=dtype, device=dev),
        "post_norm": torch.ones(h, dtype=dtype, device=dev),
        "q_proj": rand(q_dim, h),
        "k_proj": rand(kv_dim, h),
        "v_proj": rand(kv_dim, h),
        "o_proj": zero(h, q_dim),                 # the residual stays embed[t] exactly
        "gate_proj": rand(cfg.intermediate_size, h),
        "up_proj": rand(cfg.intermediate_size, h),
        "down_proj": zero(h, cfg.intermediate_size),
    } for _ in range(cfg.num_layers)]
    lm_head = quantized_linear(w_lm, bits, groupsize)
    del w_lm
    return {
        "embed": embed.to(dtype),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=torch.float32 if dtype == torch.float32 else dtype,
                                 device=dev),
        "lm_head": lm_head,
    }


def planted_pair(cfg, draft_layers: int = 2, bits: int = 4, draft_bits: int = 4,
                 groupsize: int = 128, disagree_frac: float = 0.0, dtype=torch.bfloat16,
                 device=None):
    """(target Model, draft Model, m_target, m_draft): the same embedding and
    map family; the draft has `draft_layers` layers and `disagree_frac` of its
    map entries redirected, so it agrees with the target along the greedy
    chain at a rate of about 1 - disagree_frac."""
    m_t = planted_map(cfg.vocab_size)
    m_d = planted_map(cfg.vocab_size, disagree_frac=disagree_frac)
    dcfg = dataclasses.replace(cfg, num_layers=draft_layers)
    target = Model(config=cfg, params=build_planted_llama(cfg, m_t, bits, groupsize, dtype,
                                                          device=device), family="llama")
    draft = Model(config=dcfg, params=build_planted_llama(dcfg, m_d, draft_bits, groupsize, dtype,
                                                          device=device), family="llama")
    return target, draft, m_t, m_d
