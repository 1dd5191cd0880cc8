"""Shared helpers for building quantized `QuantizedLinear`s.

Port of mi_optimize_tpu/quant/common.py. Packing reconstructs the integer
grid from the fake-quantized weights (round(fake_w / scale + zero)) and packs
it words-major on the weights' own device for bit-widths that divide 32 (on
the host for the others, such as int3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core import packing, qparams
from ..core.qparams import qrange
from ..models.quant_linear import QuantizedLinear, QuantSpec
from .config import QuantConfig


def make_weight_spec(cfg: QuantConfig, packed: bool) -> QuantSpec:
    return QuantSpec(
        wbit=cfg.wbit.bits if cfg.quantize_weights else None,
        abit=cfg.abit.bits if cfg.quantize_acts else None,
        w_qtype=cfg.w_qtype,
        a_qtype=cfg.a_qtype,
        w_groupsize=cfg.w_groupsize,
        a_groupsize=cfg.a_groupsize,
        w_symmetric=not cfg.w_has_zero,
        a_symmetric=not cfg.a_has_zero,
        w_unsigned=cfg.w_unsign,
        a_unsigned=cfg.a_unsign,
        a_dynamic=cfg.quantization_type == "dynamic",
        w_packed=packed,
    )


def build_quantized_linear(
    lin: QuantizedLinear,
    cfg: QuantConfig,
    fake_w: torch.Tensor,
    w_scale: torch.Tensor,
    w_zero: torch.Tensor,
    *,
    w_qtype: Optional[str] = None,
    w_groupsize: Optional[int] = None,
    w_symmetric: Optional[bool] = None,
    smooth_factor: Optional[torch.Tensor] = None,
    a_scale=None,
    a_zero=None,
    pack_ok: bool = True,
) -> QuantizedLinear:
    """The quantized linear: packed ints when cfg.pack (and pack_ok), else
    the fake-quantized weights in the linear's own dtype.

    `w_symmetric` overrides cfg.w_has_zero for algorithms whose grid
    symmetry comes from elsewhere (GPTQ's w_qscheme): the serving routes key
    on spec.w_symmetric."""
    spec = make_weight_spec(cfg, packed=cfg.pack and pack_ok)
    over = {k: v for k, v in (("w_qtype", w_qtype), ("w_groupsize", w_groupsize),
                              ("w_symmetric", w_symmetric)) if v is not None}
    if over:
        spec = dataclasses.replace(spec, **over)
    if smooth_factor is not None:
        smooth_factor = smooth_factor.to(torch.float32)

    if spec.w_packed and spec.wbit is not None:
        rng = qrange(spec.wbit, spec.w_unsigned)
        ints = qparams.quantize_to_int(
            fake_w, w_scale, w_zero, spec.wbit, spec.w_qtype, spec.w_groupsize, spec.w_unsigned)
        if 32 % spec.wbit == 0:
            packed = packing.pack_weight_device(ints, spec.wbit, rng)
        else:
            packed = packing.pack_weight(ints, spec.wbit, rng).to(fake_w.device)
        weight = None
    else:
        packed = None
        weight = fake_w.to(lin.weight.dtype if lin.weight is not None else torch.float32)

    return QuantizedLinear(
        spec=spec,
        out_features=lin.out_features,
        in_features=lin.in_features,
        weight=weight,
        packed=packed,
        w_scale=w_scale.to(torch.float32),
        w_zero=w_zero.to(torch.float32),
        bias=lin.bias,
        smooth_factor=smooth_factor,
        a_scale=a_scale,
        a_zero=a_zero,
    )


def static_act_params(cfg: QuantConfig, stats: Dict[str, Any]):
    """Per-tensor static activation qparams from the calibration min/max
    (the reference toolbox's RTN activation branch, from streamed min/max
    stats instead of concatenated inputs: the same result per tensor)."""
    if not (cfg.quantize_acts and cfg.quantization_type == "static"):
        return None, None
    if cfg.a_qtype != "per_tensor":
        return None, None  # only per_tensor supports static
    rng = qrange(cfg.abit.bits, cfg.a_unsign)
    return qparams.find_qparams(stats["min"], stats["max"], rng, symmetric=not cfg.a_has_zero)
