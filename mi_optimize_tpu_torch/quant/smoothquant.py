"""SmoothQuant: activation-outlier migration by per-channel smoothing.

Port of mi_optimize_tpu/quant/smoothquant.py:
  * act scale  = per-in-feature max |x| over the calibration set (the
                 absmax reducer);
  * smooth     = (act^alpha / colmax|W|^(1-alpha)).clamp(1e-5);
  * weight     = absmax symmetric signed fake-quant of W·smooth per group,
                 channel or tensor (scale = absmax / (2^(b-1) - 1), zero 0);
  * runtime    = x / smooth, then dynamic per-token or per-tensor absmax
                 activation quant; optional output quant.

Packing follows the config's `w_unsign` like every algorithm's, as the
reference does: with its default (True) the signed grid is stored in the
unsigned range and the negative codes clamp to 0.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import qparams
from ..models.quant_linear import QuantizedLinear
from .awq_impl import _pow
from .base import BaseAlgo, register_algo
from .common import build_quantized_linear


def smooth_scales(w: torch.Tensor, act_absmax: torch.Tensor, alpha: float) -> torch.Tensor:
    """s_j = act_absmax_j^alpha / max_i|W_ij|^(1-alpha), clamped at 1e-5."""
    w_colmax = torch.clamp(w.abs().amax(dim=0), min=1e-5)
    s = _pow(act_absmax, alpha) / _pow(w_colmax, 1.0 - alpha)
    return torch.clamp(s, min=1e-5)


def absmax_fake_quant_weight(w, bits, qtype, groupsize):
    """Symmetric signed absmax fake-quant: (dq, scales, zeros)."""
    return qparams.quantize_dequantize(w, bits, qtype, groupsize, symmetric=True, unsigned=False)


def dynamic_act_spec(spec, cfg, a_qtype):
    """The spec with the dynamic absmax (symmetric signed) activation grid."""
    return dataclasses.replace(spec, abit=cfg.abit.bits if cfg.quantize_acts else None,
                               a_qtype=a_qtype, a_symmetric=True, a_unsigned=False,
                               a_dynamic=True)


@register_algo("smoothquant")
@register_algo("smooth")
class SmoothQuantAlgo(BaseAlgo):
    stats = ("absmax",)

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        w = lin.weight.to(torch.float32)
        smooth = None
        if cfg.quantize_acts:
            smooth = smooth_scales(w, stats["absmax"].to(w.device), cfg.alpha)
            w = w * smooth
        if cfg.quantize_weights:
            fake_w, scale, zero = absmax_fake_quant_weight(w, cfg.wbit.bits, cfg.w_qtype,
                                                           cfg.w_groupsize)
            out = build_quantized_linear(lin, cfg, fake_w, scale, zero, smooth_factor=smooth)
        else:
            out = lin.replace(weight=w, smooth_factor=smooth)
        spec = dataclasses.replace(dynamic_act_spec(out.spec, cfg, cfg.a_qtype),
                                   quant_out=cfg.quant_out)
        return out.replace(spec=spec)
