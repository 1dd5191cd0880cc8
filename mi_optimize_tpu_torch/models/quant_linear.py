"""QuantizedLinear: the one linear abstraction every model layer goes through.

Port of mi_optimize_tpu/models/quant_linear.py. A `QuantizedLinear` holds fp
weights, fake-quantized weights, or packed int weights plus qparams, and
`quant_linear_apply` picks the compute path from its `QuantSpec`:

    x  -> x / smooth_factor          (AWQ / SmoothQuant)
       -> fake-quant activations     (static scale or dynamic per-token/tensor)
       -> x @ dequant(W)^T + bias    (packed path: ops.dequant_matmul)

Packed 8-bit symmetric per-channel or per-tensor linears with dynamic
symmetric int8 activations (SmoothQuant's W8A8) take the exact integer
product of ops.int8_matmul. With `MI_W4A8_INT=1` (read at each call), packed
int4 linears with dynamic symmetric int8 activations take the integer
product of ops.w4a8_matmul at 32 rows or more, as the reference does. FP8
linears (fp8_format) fake-quantize their activations on the fp8 grid
(quant.fp8.fp8_fake_quant).

Packed words are the int32 bit-view of the reference's uint32 words-major
[in*wbit/32, out] layout (core/packing.py).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from ..core import packing, qparams
from ..core.qparams import qrange


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization metadata for one linear layer (hashable)."""

    wbit: Optional[int] = None          # None => fp weights
    abit: Optional[int] = None          # None => fp activations
    w_qtype: str = "per_channel"
    a_qtype: str = "per_tensor"
    w_groupsize: int = -1
    a_groupsize: int = -1
    w_symmetric: bool = True
    a_symmetric: bool = True
    w_unsigned: bool = True
    a_unsigned: bool = True
    a_dynamic: bool = True
    w_packed: bool = False
    fp8_format: Optional[str] = None    # 'e4m3' | 'e5m2'
    quant_out: bool = False


@dataclasses.dataclass
class QuantizedLinear:
    """Parameters of one (possibly quantized) linear: y = x W^T + b."""

    spec: QuantSpec
    out_features: int
    in_features: int
    weight: Optional[torch.Tensor] = None        # fp or fake-quant [out, in]
    packed: Optional[torch.Tensor] = None        # int32 [in*wbit/32, out] words-major
    w_scale: Optional[torch.Tensor] = None
    w_zero: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    smooth_factor: Optional[torch.Tensor] = None  # [in]; x /= smooth at runtime
    a_scale: Optional[torch.Tensor] = None        # static activation qparams
    a_zero: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None           # GPTQ act-order in-feature order
    # the dequant kernels' f32 [ngroups, out] (scale, bias) tables, made once
    # by ops.dequant_matmul.kernel_tables; `replace` starts without them
    tables: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False,
                                                compare=False)
    # the fused MLP's and the W4A8 kernel's f32 [ngroups, out] zero - qmin
    # table, made once by ops.dequant_matmul.zero_tables (their scale table
    # is tables[0])
    ztable: Optional[torch.Tensor] = dataclasses.field(default=None, init=False, repr=False,
                                                       compare=False)
    # a rank's shard under tensor parallelism: its place in the layout and
    # its group (parallel.sharding.TPInfo), set by parallel.sharding.shard_model
    tp: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def fp(cls, weight, bias=None):
        return cls(spec=QuantSpec(), out_features=weight.shape[0],
                   in_features=weight.shape[1], weight=weight, bias=bias)

    def replace(self, **kw) -> "QuantizedLinear":
        return dataclasses.replace(self, **kw)


def group_size(q: QuantizedLinear) -> int:
    """Effective quantization group along in-features (per-channel: all of K)."""
    s = q.spec
    if s.w_qtype == "per_group" and s.w_groupsize > 0:
        return s.w_groupsize
    return q.in_features


def dequant_weight(q: QuantizedLinear) -> torch.Tensor:
    """Materialize the effective fp weight matrix [out, in] (float32 when packed)."""
    s = q.spec
    if q.packed is None:
        if s.fp8_format is not None and q.weight.dtype in (torch.float8_e4m3fn,
                                                           torch.float8_e5m2):
            return q.weight.to(torch.float32) / q.w_scale
        return q.weight
    rng = qrange(s.wbit, s.w_unsigned)
    w_int = packing.unpack_weight(q.packed, s.wbit, rng, q.in_features).to(torch.float32)
    if s.w_qtype == "per_group" and s.w_groupsize > 0:
        wg = w_int.reshape(-1, s.w_groupsize)
        w = (wg - q.w_zero.reshape(-1, 1)) * q.w_scale.reshape(-1, 1)
        w = w.reshape(q.out_features, q.in_features)
    elif s.w_qtype == "per_channel":
        w = (w_int - q.w_zero.reshape(-1, 1)) * q.w_scale.reshape(-1, 1)
    else:
        w = (w_int - q.w_zero.reshape(())) * q.w_scale.reshape(())
    if q.perm is not None:
        w = w[:, torch.argsort(q.perm)]  # back to natural in-feature order
    return w


def _quant_activations(q: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    s = q.spec
    if s.abit is None:
        return x
    if s.fp8_format is not None:
        from ..quant.fp8 import fp8_fake_quant  # local import: quant imports this module
        return fp8_fake_quant(x, s.fp8_format)
    if s.a_dynamic:
        dq, _, _ = qparams.quantize_dequantize(
            x, s.abit, s.a_qtype, s.a_groupsize, s.a_symmetric, s.a_unsigned)
        return dq
    rng = qrange(s.abit, s.a_unsigned)
    qx = qparams.quantize(x, q.a_scale, q.a_zero, rng)
    return qparams.dequantize(qx, q.a_scale, q.a_zero).to(x.dtype)


def quant_linear_apply(q: QuantizedLinear, x: torch.Tensor, *, fused: bool = True) -> torch.Tensor:
    """y = act_quant(x / smooth) @ W_eff^T + b, in x's dtype.

    `fused=True` sends packed int2/int4/int8 weights through
    ops.dequant_matmul (the CUDA kernel on GPU tensors); otherwise the weight
    is dequantized and multiplied in float32. A tensor-parallel shard
    (`q.tp`) goes through parallel.sharding.tp_apply, which takes the
    collectives its kind needs around `local_apply`."""
    if q.tp is not None:
        from ..parallel.sharding import tp_apply  # local import: parallel imports this module
        return tp_apply(q, x, fused)
    return local_apply(q, x, fused)


def local_apply(q: QuantizedLinear, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """`quant_linear_apply` on q's own tensors, whatever its `tp`."""
    in_dtype = x.dtype
    if q.smooth_factor is not None:
        x = x / q.smooth_factor.to(x.dtype)

    s = q.spec
    if q.perm is not None and q.packed is not None and fused:
        x = torch.index_select(x, -1, q.perm.to(torch.long))
    if q.packed is not None and fused:
        from ..ops.int8_matmul import supports_native_int8, w8a8_matmul
        if supports_native_int8(s):
            # W8A8: the integers stay integer through an exact int32 product
            y = w8a8_matmul(x, q)
            if q.bias is not None:
                y = y + q.bias
            return y.to(in_dtype)
        from ..ops.w4a8_matmul import supports_w4a8, w4a8_matmul
        if (supports_w4a8(s) and math.prod(x.shape[:-1]) >= 32
                and os.environ.get("MI_W4A8_INT") == "1"):
            # the W4A8 integer product, opt-in as in the reference (ops/w4a8_matmul.py)
            y = w4a8_matmul(x, q)
            if q.bias is not None:
                y = y + q.bias
            return y.to(in_dtype)

    x = _quant_activations(q, x)
    if q.packed is not None and fused and s.wbit in (2, 4, 8):
        from ..ops.dequant_matmul import dequant_matmul
        y = dequant_matmul(x, q)
    else:
        w = dequant_weight(q)
        if q.packed is None:
            w = w.to(x.dtype)
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32).t())
    if q.bias is not None:
        y = y + q.bias
    if s.quant_out and s.abit is not None:
        dq, _, _ = qparams.quantize_dequantize(
            y, s.abit, s.a_qtype, s.a_groupsize, s.a_symmetric, s.a_unsigned)
        y = dq
    return y.to(in_dtype)
