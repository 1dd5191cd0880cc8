"""RTN (round-to-nearest) weight quantization plus static/dynamic activation quant.

Port of mi_optimize_tpu/quant/rtn.py: weight fake-quant through the
granularity engine of core/qparams, per-tensor static activation qparams
from the calibration min/max, dynamic per-forward otherwise. Weight-only
dynamic configs need no calibration data.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import qparams
from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, register_algo
from .common import build_quantized_linear, static_act_params


@register_algo("rtn")
class RTNAlgo(BaseAlgo):
    stats = ()

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        if not cfg.quantize_weights:
            a_scale, a_zero = static_act_params(cfg, stats)
            spec = dataclasses.replace(
                lin.spec,
                abit=cfg.abit.bits if cfg.quantize_acts else None,
                a_qtype=cfg.a_qtype,
                a_groupsize=cfg.a_groupsize,
                a_symmetric=not cfg.a_has_zero,
                a_unsigned=cfg.a_unsign,
                a_dynamic=cfg.quantization_type == "dynamic",
            )
            return lin.replace(spec=spec, a_scale=a_scale, a_zero=a_zero)

        fake_w, scale, zero = qparams.quantize_dequantize(
            lin.weight.to(torch.float32),
            cfg.wbit.bits,
            cfg.w_qtype,
            cfg.w_groupsize,
            symmetric=not cfg.w_has_zero,
            unsigned=cfg.w_unsign,
        )
        a_scale, a_zero = static_act_params(cfg, stats)
        return build_quantized_linear(lin, cfg, fake_w, scale, zero, a_scale=a_scale,
                                      a_zero=a_zero)
