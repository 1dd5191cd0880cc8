"""FP8 (software-emulated E4M3 / E5M2) weight and activation quantization.

Port of mi_optimize_tpu/quant/fp8.py:
  * E4M3: bound 240 (2^7·1.875), |v| <= 2^-10 flushed to 0, exponent floor
    -6, 3-bit mantissa (round to 1/8);
  * E5M2: bound 57344 (2^15·1.75), flush at 2^-17, exponent floor -14,
    2-bit mantissa (round to 1/4);
  * weights: a scale per output row, S = bound / absmax(row) (E4M3) or
    absmax(row) / bound (E5M2, the reference's own convention);
  * activations: a per-tensor scale from max(x) (not absmax, as the
    reference), computed at forward time.

The exponent E = floor(log2|v|) is read exactly from `torch.frexp` (the same
E as the reference's log2 on every bf16 bit pattern at the tested scales),
and 2^E is built from its bits, an exact power of two on any device. The
reference's `jnp.exp2` on the CPU is not exact at some integer arguments
(exp2(15) = 32767.984; ±13, 15 and below -14), which moves its E5M2 grid off
the E5M2 value set there; E4M3's exponents (-6..7) are exact on both. So the
port's grid is the fp8 value set, and `pack=True` stores the weights as
native float8 (`torch.float8_e4m3fn` / `float8_e5m2`): grid · S casts
exactly, and dequantization divides it by S again.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.qparams import exact_div
from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, register_algo

E4M3_BOUND = 240.0      # 2^7 * 1.875
E5M2_BOUND = 57344.0    # 2^15 * 1.75

_FORMATS = {  # bound, flush, exponent floor, mantissa steps
    "e4m3": (E4M3_BOUND, 2.0 ** -10, -6, 8.0),
    "e5m2": (E5M2_BOUND, 2.0 ** -17, -14, 4.0),
}


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integral int32 e in the normal float32 range, from its bits."""
    return ((e + 127) << 23).view(torch.float32)


def _fp8_grid(ab: torch.Tensor, fmt: str) -> torch.Tensor:
    """Round |values| (already scaled into the fp8 range) onto the fp8 grid."""
    if fmt not in _FORMATS:
        raise ValueError(f"fp8 format must be e4m3|e5m2, got {fmt}")
    top, flush, emin, mant = _FORMATS[fmt]
    ab = torch.clamp(ab, max=top)
    ab = torch.where(ab <= flush, torch.zeros_like(ab), ab)
    safe = torch.where(ab > 0, ab, torch.ones_like(ab))
    E = torch.where(ab < 2.0 ** emin, torch.full_like(safe, emin, dtype=torch.int32),
                    torch.frexp(safe)[1] - 1)
    M = torch.round(ab * _pow2(-E) * mant) / mant
    return M * _pow2(E)


def fp8_quantize_value(x: torch.Tensor, scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """Fake-quantize x with pre-scaling S: round_fp8(|x|·S)·sign / S, in x's dtype."""
    xf = x.to(torch.float32)
    q = _fp8_grid(xf.abs() * scale, fmt) * torch.sign(xf) / scale
    # nan, inf and zero inputs stay as they are, as in the reference
    keep = torch.isnan(xf) | torch.isinf(xf) | (xf == 0.0)
    return torch.where(keep, xf, q).to(x.dtype)


def _row_scale(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    """The pre-scaling S from an absmax (or max): bound / amax for E4M3,
    amax / bound for E5M2, correctly rounded on any device."""
    if fmt == "e4m3":
        return exact_div(torch.full_like(amax, E4M3_BOUND), amax)
    return exact_div(amax, E5M2_BOUND)


def fp8_fake_quant(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Dynamic per-tensor activation fake-quant (runs in the forward)."""
    amax = x.to(torch.float32).max()  # the reference takes max, not absmax
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    return fp8_quantize_value(x, _row_scale(amax, fmt), fmt)


@register_algo("fp8")
class FP8Algo(BaseAlgo):
    stats = ()

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        fmt = cfg.fp8_format.lower()
        w = lin.weight.to(torch.float32)
        absmax = torch.clamp(w.abs().amax(dim=-1, keepdim=True), min=1e-12)
        scale = _row_scale(absmax, fmt)
        fake_w = fp8_quantize_value(w, scale, fmt)
        spec = dataclasses.replace(lin.spec, wbit=8, abit=8 if cfg.quantize_acts else None,
                                   fp8_format=fmt, w_packed=False, a_dynamic=True)
        if cfg.pack:
            # native float8: the grid is the fp8 value set, so fake_w·S casts exactly
            f8 = torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2
            return lin.replace(weight=(fake_w * scale).to(f8), spec=spec, w_scale=scale,
                               w_zero=torch.zeros_like(scale))
        return lin.replace(weight=fake_w.to(lin.weight.dtype), spec=spec, w_scale=scale,
                           w_zero=torch.zeros_like(scale))
