"""ZeroQuant: per-group absmax weights plus per-token dynamic activations.

Port of mi_optimize_tpu/quant/zeroquant.py: calibration-free; weights
absmax symmetric signed per group of `w_groupsize` (128 when unset),
activations per-token absmax at forward time; both on the symmetric signed
grid (scale = absmax / (2^(b-1) - 1), zero 0). On the card its packed 8-bit
linears take dequant_matmul's CUDA-core kernels.
"""
from __future__ import annotations

import torch

from ..core import qparams
from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, register_algo
from .common import build_quantized_linear
from .smoothquant import dynamic_act_spec


@register_algo("zeroquant")
class ZeroQuantAlgo(BaseAlgo):
    stats = ()

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        groupsize = cfg.w_groupsize if cfg.w_groupsize > 0 else 128
        out = lin
        if cfg.quantize_weights:
            fake_w, scale, zero = qparams.quantize_dequantize(
                lin.weight.to(torch.float32), cfg.wbit.bits, "per_group", groupsize,
                symmetric=True, unsigned=False)
            out = build_quantized_linear(lin, cfg, fake_w, scale, zero, w_qtype="per_group",
                                         w_groupsize=groupsize)
        return out.replace(spec=dynamic_act_spec(out.spec, cfg, "per_token"))
