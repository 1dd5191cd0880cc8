"""W8A8 matmul: int8 activations times int8 weights with an exact int32 product.

Port of mi_optimize_tpu/ops/int8_matmul.py, which runs an XLA int8
dot_general (no Pallas kernel):

    y = (x_int8 @ w_int8^T) · s_x ⊗ s_w

The activations take the dynamic symmetric absmax grid (s_x = amax / 127, a
correctly rounded quotient, x_int8 = round(x / s_x) half to even), the
weights are the packed 8-bit words with the zero point taken off (q - zero,
integral on a symmetric grid), so the int32 sums are exact and only the
scales round: acc.f32 · s_x · s_w, in that order.

Routing (`supports_native_int8`, read by `quant_linear_apply`): packed 8-bit
symmetric weights per channel or per tensor, dynamic symmetric signed 8-bit
activations per token or per tensor, no fp8 and no output quantization:
SmoothQuant's and per-channel ZeroQuant's serving configuration.

On CUDA tensors the int32 product is `torch._int_mm` (cuBLASLt's int8 GEMM;
PyTorch has no other int8 product on the GPU). It wants more than 16 rows
(some releases) and K and N multiples of 8: the rows are padded with zeros
to a multiple of 8 and at least 24, which is exact (each row has its own
sums and the padded rows are dropped); K or N off the rule raises. On CPU
tensors `w8a8_matmul_ref` computes the same sums in float64, exact below
2^53 (|sum| <= 128 · 128 · K).
"""
from __future__ import annotations

import torch

from ..core.qparams import qrange
from .w4a8_matmul import quantize_activations

launches = 0  # torch._int_mm calls of the route; chip_smoke.py resets and reads it

_MIN_ROWS = 24  # the row padding: more than 16, a multiple of 8


def supports_native_int8(spec) -> bool:
    return (
        spec.wbit == 8
        and spec.w_symmetric
        and spec.w_qtype in ("per_channel", "per_tensor")
        and spec.abit == 8
        and spec.a_dynamic
        and spec.a_symmetric
        and not spec.a_unsigned
        and spec.a_qtype in ("per_token", "per_tensor")
        and spec.fp8_format is None
        and not spec.quant_out
    )


def weight_int8(qlin) -> torch.Tensor:
    """The signed int8 weights q - zero [out, in] of a packed 8-bit
    symmetric linear. The words-major int32 [in / 4, out] words hold code k =
    4w + j in byte j of word w (stored as q - qmin), so their little-endian
    bytes, transposed, are the stored codes: one copy and one add, where the
    generic unpack takes a shift and a mask a field."""
    s = qlin.spec
    N, K = qlin.out_features, qlin.in_features
    b = qlin.packed.contiguous().view(torch.uint8).reshape(K // 4, N, 4)
    b = b.permute(1, 0, 2).reshape(N, K).to(torch.int16)
    z = qlin.w_zero.reshape(-1, 1) if qlin.w_zero.dim() else qlin.w_zero.reshape(1, 1)
    return (b + (qrange(8, s.w_unsigned).qmin - z).to(torch.int16)).to(torch.int8)


def w8a8_matmul_ref(xi: torch.Tensor, wi8: torch.Tensor) -> torch.Tensor:
    """Plain version of `w8a8_matmul_int`: the int32 sums xi [M, K] @ wi8
    [N, K]^T, exact in float64."""
    return (xi.to(torch.float64) @ wi8.to(torch.float64).t()).to(torch.int32)


def _w8a8_matmul_int_cuda(xi: torch.Tensor, wi8: torch.Tensor) -> torch.Tensor:
    global launches
    M, K = xi.shape
    N = wi8.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm takes K and N multiples of 8: K={K} N={N}")
    if wi8.device != xi.device or xi.dtype != torch.int8 or wi8.dtype != torch.int8:
        raise ValueError("w8a8: xi and wi8 must be int8 on one device")
    Mp = max(_MIN_ROWS, -(-M // 8) * 8)
    if Mp != M:
        xi = torch.cat([xi, xi.new_zeros(Mp - M, K)])
    # [K, N] column-major: the transposed view of the [N, K] rows
    acc = torch._int_mm(xi.contiguous(), wi8.contiguous().t())
    launches += 1
    return acc[:M]


def w8a8_matmul_int(xi: torch.Tensor, wi8: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = xi [M, K] @ wi8 [N, K]^T: torch._int_mm on GPU
    tensors, the plain version on CPU tensors."""
    if xi.is_cuda:
        return _w8a8_matmul_int_cuda(xi, wi8)
    return w8a8_matmul_ref(xi, wi8)


def w8a8_matmul(x: torch.Tensor, qlin) -> torch.Tensor:
    """y[..., N] = int8(x) @ int8(W)^T rescaled; replaces the activation
    fake-quant and the matmul. In x's dtype."""
    s = qlin.spec
    lead = x.shape[:-1]
    K = x.shape[-1]
    xi, sx = quantize_activations(x.reshape(-1, K).to(torch.float32), s.a_qtype)
    acc = w8a8_matmul_int(xi, weight_int8(qlin))
    sw = qlin.w_scale.reshape(1, -1) if qlin.w_scale.numel() > 1 else qlin.w_scale.reshape(1, 1)
    y = acc.to(torch.float32) * sx * sw
    return y.reshape(*lead, qlin.out_features).to(x.dtype)
