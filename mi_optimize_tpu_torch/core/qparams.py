"""Quantization numerics: qparam search, quantize / dequantize, fake-quant.

Port of mi_optimize_tpu/core/qparams.py. Same granularities (per_tensor,
per_channel, per_group, per_dimension, per_token), the same symmetric and
asymmetric formulas, and round-half-to-even rounding (`torch.round`, like
`jnp.round`), so integer grids match the reference bit for bit.

PyTorch divides two tensors with a correctly rounded IEEE quotient on both the
CPU and the GPU. A Python number as the divisor is another matter on the GPU:
there PyTorch multiplies by its f32 reciprocal, which can be one ulp off the
quotient (1/127 is not exact). `exact_div` hands the divisor over as a 0-dim
tensor on x's device, which gives the reference's `exact_div` (the true
quotient) everywhere; `find_qparams` and the W4A8 activation grid use it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

GRANULARITIES = ("per_tensor", "per_channel", "per_group", "per_dimension", "per_token")

_EPS = 1e-12


def exact_div(x: torch.Tensor, y) -> torch.Tensor:
    """The correctly rounded quotient x / y, also for a Python-number y on
    the GPU."""
    if not isinstance(y, torch.Tensor):
        y = torch.full((), y, dtype=x.dtype, device=x.device)
    return x / y


def div_round(x: torch.Tensor, y) -> torch.Tensor:
    """round-half-to-even of the correctly-rounded f32 quotient x/y."""
    return torch.round(x / y)


class QRange(NamedTuple):
    qmin: int
    qmax: int
    bits: int
    unsigned: bool


def qrange(bits: int, unsigned: bool = True) -> QRange:
    if unsigned:
        return QRange(0, (1 << bits) - 1, bits, True)
    return QRange(-(1 << (bits - 1)), (1 << (bits - 1)) - 1, bits, False)


def find_qparams(x_min, x_max, rng: QRange, symmetric: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) from min/max statistics, in float32.

    `symmetric` is the reference's `has_zero=False`."""
    x_min = torch.as_tensor(x_min, dtype=torch.float32)
    x_max = torch.as_tensor(x_max, dtype=torch.float32)
    if symmetric:
        max_abs = torch.maximum(x_max.abs(), x_min.abs())
        scale = torch.clamp(exact_div(max_abs, float((rng.qmax - rng.qmin) // 2)), min=_EPS)
        zp_val = 0 if rng.qmin < 0 else (1 << (rng.bits - 1))
        zero = torch.full_like(scale, float(zp_val))
    else:
        scale = torch.clamp(exact_div(x_max - x_min, float(rng.qmax - rng.qmin)), min=_EPS)
        zero = rng.qmin - div_round(x_min, scale)
    return scale, zero


def quantize(x, scale, zero, rng: QRange) -> torch.Tensor:
    """Real-valued x -> integer grid (kept in float for downstream math)."""
    q = div_round(x.to(torch.float32), scale) + zero
    return torch.clamp(q, rng.qmin, rng.qmax)


def dequantize(q, scale, zero) -> torch.Tensor:
    return scale * (q.to(torch.float32) - zero)


def _minmax_rows(x2d):
    return x2d.amin(dim=1, keepdim=True), x2d.amax(dim=1, keepdim=True)


def quantize_dequantize(
    x: torch.Tensor,
    bits: int,
    qtype: str = "per_tensor",
    groupsize: int = -1,
    symmetric: bool = True,
    unsigned: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fake-quantize `x`; returns (dq in x's dtype, scales, zeros)."""
    orig_shape = x.shape
    rng = qrange(bits, unsigned)
    xf = x.to(torch.float32)

    if qtype == "per_tensor":
        scale, zero = find_qparams(xf.min(), xf.max(), rng, symmetric)
        dq = dequantize(quantize(xf, scale, zero, rng), scale, zero)
    elif qtype in ("per_channel", "per_token"):
        x2 = xf.reshape(-1, orig_shape[-1])
        mn, mx = _minmax_rows(x2)
        scale, zero = find_qparams(mn, mx, rng, symmetric)
        dq = dequantize(quantize(x2, scale, zero, rng), scale, zero).reshape(orig_shape)
    elif qtype == "per_group":
        if groupsize <= 0:
            raise ValueError(f"per_group requires groupsize>0, got {groupsize}")
        if orig_shape[-1] % groupsize != 0:
            raise ValueError(f"last dim {orig_shape[-1]} not divisible by groupsize {groupsize}")
        xg = xf.reshape(-1, groupsize)
        mn, mx = _minmax_rows(xg)
        scale, zero = find_qparams(mn, mx, rng, symmetric)
        dq = dequantize(quantize(xg, scale, zero, rng), scale, zero).reshape(orig_shape)
        ngroups = orig_shape[-1] // groupsize
        scale = scale.reshape(*orig_shape[:-1], ngroups)
        zero = zero.reshape(*orig_shape[:-1], ngroups)
    elif qtype == "per_dimension":
        x2 = xf.reshape(-1, orig_shape[-1])
        mn = x2.amin(dim=0, keepdim=True)
        mx = x2.amax(dim=0, keepdim=True)
        scale, zero = find_qparams(mn, mx, rng, symmetric)
        dq = dequantize(quantize(x2, scale, zero, rng), scale, zero).reshape(orig_shape)
    else:
        raise ValueError(f"unsupported qtype {qtype!r}; one of {GRANULARITIES}")

    return dq.to(x.dtype), scale, zero


def quantize_to_int(
    x: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    bits: int,
    qtype: str,
    groupsize: int = -1,
    unsigned: bool = True,
) -> torch.Tensor:
    """Map real weights onto the integer grid of existing qparams (for
    packing). Returns int32 in [qmin, qmax]."""
    rng = qrange(bits, unsigned)
    orig_shape = x.shape
    xf = x.to(torch.float32)
    if qtype == "per_group" and groupsize > 0:
        xg = xf.reshape(-1, groupsize)
        q = quantize(xg, scale.reshape(-1, 1), zero.reshape(-1, 1), rng)
        return q.reshape(orig_shape).to(torch.int32)
    if qtype in ("per_channel", "per_token"):
        x2 = xf.reshape(-1, orig_shape[-1])
        q = quantize(x2, scale.reshape(-1, 1), zero.reshape(-1, 1), rng)
        return q.reshape(orig_shape).to(torch.int32)
    q = quantize(xf, scale.reshape(()), zero.reshape(()), rng)
    return q.to(torch.int32)
