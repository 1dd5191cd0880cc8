"""Composed pipelines: AWQ+GPTQ and SmoothQuant+GPTQ.

Port of mi_optimize_tpu/quant/combos.py. Both algorithms' stats come from
the SAME calibration forwards, so GPTQ's Hessian is accumulated on the
*unsmoothed* inputs, as in the reference (the smoothed linear sees x / s,
whose Hessian would be diag(1/s) H diag(1/s)); the first algorithm's smooth
factor is folded into the weights, GPTQ quantizes the smoothed weights, and
the runtime divides the activations by the smooth factor (and, for
SmoothQuant+GPTQ, quantizes them as SmoothQuant does). AWQ+GPTQ is the
reference's single-smoothing pipeline: smooth, clip, GPTQ.
"""
from __future__ import annotations

import torch

from ..models.quant_linear import QuantizedLinear
from .awq_impl import awq_smooth_clip
from .base import BaseAlgo, finalize_hessian, register_algo
from .common import build_quantized_linear
from .gptq import gptq_quantize_matrix
from .smoothquant import dynamic_act_spec, smooth_scales


def _gptq_on(cfg, lin, W_smoothed, stats, smooth):
    """GPTQ of the smoothed weights against the Hessian of the unsmoothed
    inputs; the linear keeps `smooth`."""
    H = finalize_hessian(stats)
    groupsize = cfg.w_groupsize
    symmetric = cfg.w_qscheme == "symmetric"
    Q, scales, zeros, perm = gptq_quantize_matrix(
        W_smoothed, H, bits=cfg.wbit.bits, blocksize=min(cfg.blocksize, lin.in_features),
        groupsize=groupsize, actorder=cfg.actorder, symmetric=symmetric, percdamp=cfg.percdamp)
    del H
    w_qtype = "per_group" if groupsize > 0 else "per_channel"
    kw = dict(w_qtype=w_qtype, w_symmetric=symmetric, smooth_factor=smooth)
    if groupsize > 0 and cfg.actorder and cfg.pack:
        out = build_quantized_linear(lin, cfg, Q[:, perm], scales, zeros, **kw)
        if out.packed is not None:
            return out.replace(perm=perm)
    return build_quantized_linear(lin, cfg, Q, scales, zeros,
                                  pack_ok=groupsize <= 0 or not cfg.actorder, **kw)


@register_algo("awq+gptq")
class AWQGPTQAlgo(BaseAlgo):
    stats = ("inputs", "absmean", "xtx")

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        if not self.cfg.quantize_weights:
            return lin
        smooth, Qc, _ = awq_smooth_clip(self.cfg, lin, stats)
        return _gptq_on(self.cfg, lin, Qc, stats, smooth)


@register_algo("smoothquant+gptq")
class SmoothGPTQAlgo(BaseAlgo):
    stats = ("absmax", "xtx")

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        if not cfg.quantize_weights:
            return lin
        w = lin.weight.to(torch.float32)
        smooth = smooth_scales(w, stats["absmax"].to(w.device), cfg.alpha)
        out = _gptq_on(cfg, lin, w * smooth[None, :], stats, smooth)
        if cfg.quantize_acts:
            out = out.replace(spec=dynamic_act_spec(out.spec, cfg, cfg.a_qtype))
        return out
