"""Synthetic packed Llama weights built on the device from a seed.

Port of `build_quantized_llama_on_device` in the reference's bench.py: every
linear is a random normal matrix scaled by in_features**-0.5, fake-quantized
per-group (symmetric by default, or asymmetric: a zero per group, as GPTQ's
default 'affine' grid), mapped to its integer grid and packed words-major,
all on `device`. One linear is quantized and packed at a time, so the peak memory
stays near the packed model plus one float32 weight matrix.

`with_w4a8` gives a model's decoder linears the W4A8 activation spec
(dynamic symmetric signed per-token int8), as smoothquant+gptq at wbit 4,
abit 8 produces.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import packing, qparams
from ..core.device import resolve_device
from ..core.qparams import qrange
from .llama import LlamaConfig
from .quant_linear import QuantizedLinear, QuantSpec


def quantized_linear(w, bits: int, groupsize: int, symmetric: bool = True) -> QuantizedLinear:
    """The float weight w [out, in] fake-quantized per group, mapped to its
    integer grid and packed words-major, on w's device."""
    spec = QuantSpec(wbit=bits, w_qtype="per_group", w_groupsize=groupsize,
                     w_symmetric=symmetric, w_packed=True)
    fake, scale, zero = qparams.quantize_dequantize(w, bits, "per_group", groupsize, symmetric)
    ints = qparams.quantize_to_int(fake, scale, zero, bits, "per_group", groupsize)
    del fake
    return QuantizedLinear(spec=spec, out_features=w.shape[0], in_features=w.shape[1],
                           packed=packing.pack_weight_device(ints, bits, qrange(bits, True)),
                           w_scale=scale, w_zero=zero)


def build_quantized_llama(cfg: LlamaConfig, bits: int = 4, groupsize: int = 128,
                          dtype=torch.bfloat16, seed: int = 0, device=None,
                          symmetric: bool = True):
    """Params dict of a packed int`bits` per-group Llama with random weights.
    symmetric=False quantizes every linear on an asymmetric grid, so its
    zero varies by group."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lin(out_f, in_f):
        w = torch.randn(out_f, in_f, generator=gen, device=dev) * (in_f ** -0.5)
        return quantized_linear(w, bits, groupsize, symmetric)

    h, q_dim = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_norm": torch.ones(h, dtype=dtype, device=dev),
            "post_norm": torch.ones(h, dtype=dtype, device=dev),
            "q_proj": lin(q_dim, h),
            "k_proj": lin(kv_dim, h),
            "v_proj": lin(kv_dim, h),
            "o_proj": lin(h, q_dim),
            "gate_proj": lin(cfg.intermediate_size, h),
            "up_proj": lin(cfg.intermediate_size, h),
            "down_proj": lin(h, cfg.intermediate_size),
        })
    embed = (torch.randn(cfg.vocab_size, h, generator=gen, device=dev) * 0.02).to(dtype)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones(h, dtype=dtype, device=dev),
        "lm_head": lin(cfg.vocab_size, h),
    }


def w4a8_spec(spec: QuantSpec) -> QuantSpec:
    """spec with dynamic symmetric signed per-token int8 activations."""
    return dataclasses.replace(spec, abit=8, a_qtype="per_token", a_dynamic=True,
                               a_symmetric=True, a_unsigned=False)


def with_w4a8(params):
    """A params dict whose decoder linears carry `w4a8_spec`; the lm_head
    keeps its weight-only spec, as calibrated models keep it. The tensors are
    shared with `params`."""
    layers = [{k: v.replace(spec=w4a8_spec(v.spec)) if isinstance(v, QuantizedLinear) else v
               for k, v in blk.items()} for blk in params["layers"]]
    return dict(params, layers=layers)
