"""Fused dequantize + matmul for packed int2/int4/int8 weights (W4A16 / W8A16).

Kernel: csrc/dequant_matmul.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/dequant_matmul.py::_kernel (reached through
`_packed_matmul_local` -> `packed_matmul` -> `dequant_matmul`).

    y[M, N] = x[M, K] @ dequant(packed)^T,  dequant(q) = q*s + b,
    b = -(zero - qmin)*s  per (group, output column)

What bounds it on an H100: at decode (M <= 8) every packed word is used M
times, far below the ~295 operations per byte where the card stops being
memory bound, so the time is the bytes of the packed words and scales over
the memory rate. The GEMV-style kernel therefore gives each lane one output
column (neighbouring lanes read neighbouring words of a words-major row, so
the loads coalesce), splits K over the warps of a block, and never writes the
dequantized weight anywhere. At prefill (M = 128) the work is 2*M*N*K
operations on CUDA cores; the tiled kernel dequantizes a [32, 64] weight tile
into shared memory once per block and reuses it for a 64-row x tile. Tensor
cores (mma / wgmma) are later work.

On CPU tensors the wrapper runs `dequant_matmul_ref`, which follows the
reference path that M selects: the grouped rescale over centered codes for
small M, and dequantize-to-x's-dtype-then-dot otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.packing import unpack_words
from ..core.qparams import qrange
from ..models.quant_linear import group_size

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _group_table(qlin, t, minus=0.0):
    """qlin's per-group table t (scales or zeros) minus `minus`, as f32
    [ngroups, N], contiguous."""
    ng = qlin.in_features // group_size(qlin)
    t = t.reshape(-1, ng).t().to(torch.float32).expand(ng, qlin.out_features)
    return (t - minus).contiguous()


def _zero_table(qlin):
    """zero - qmin: the zero on the stored codes."""
    s = qlin.spec
    return _group_table(qlin, qlin.w_zero, float(qrange(s.wbit, s.w_unsigned).qmin))


def kernel_tables(qlin):
    """The kernel layout of qlin's scales/zeros: (scale, dequant bias), f32
    [ngroups, N]. Made at the first call and kept on qlin (`qlin.tables`);
    `serving.optimize.fuse_for_serving` makes them for every packed linear."""
    if qlin.tables is None:
        st = _group_table(qlin, qlin.w_scale)
        qlin.tables = (st, (-_zero_table(qlin) * st).contiguous())
    return qlin.tables


def zero_tables(qlin):
    """qlin's scales and zeros as the fused MLP and W4A8 kernels take them,
    (scale, zero - qmin), f32 [ngroups, N]: the weight is (q - z) * s on the
    stored codes q. The scale is `kernel_tables`' own; the zero table is made
    at the first call and kept on qlin (`qlin.ztable`)."""
    if qlin.ztable is None:
        qlin.ztable = _zero_table(qlin)
    return kernel_tables(qlin)[0], qlin.ztable


def f32_table(t):
    """A [ngroups, N] scale or zero table as contiguous f32; a cached table
    passes through uncopied."""
    return t.to(torch.float32).contiguous()


def qdot_ref(x32, packed, scale_t, bias_t, bits: int, group: int):
    """Grouped-rescale dequant dot, f32 [M,K] -> f32 [M,N], as the reference's
    `block_fused._qdot`: one dot per group on the centered codes
    q - 2^(bits-1), then y = sum_g s*d + (b + 2^(bits-1)*s) * sum(x_g)."""
    M, K = x32.shape
    N = packed.shape[1]
    ng = K // group
    off = 1 << (bits - 1)
    c = (unpack_words(packed, bits) - off).to(torch.float32).reshape(ng, group, N)
    xg = x32.reshape(M, ng, group)
    d = torch.einsum("mgk,gkn->mgn", xg, c)
    xs = xg.sum(dim=-1, keepdim=True)                    # [M, ng, 1]
    return (d * scale_t + (bias_t + off * scale_t) * xs).sum(dim=1)


def _grouped(M: int, bits: int, group: int) -> bool:
    """Whether the reference kernel takes its grouped-rescale path: its row
    tile (the largest of 256..8 dividing M padded to 8) is at most 16 rows
    and a group spans whole words."""
    mp = M + (-M) % 8
    tm = next(c for c in (256, 128, 64, 32, 16, 8) if mp % c == 0)
    return tm <= 16 and group % (32 // bits) == 0


def dequant_matmul_ref(x, packed, scale_t, bias_t, bits: int, group: int):
    """Plain PyTorch version: x [M,K] -> y [M,N] in x's dtype."""
    M, K = x.shape
    N = packed.shape[1]
    if _grouped(M, bits, group):
        y = qdot_ref(x.to(torch.float32), packed, scale_t, bias_t, bits, group)
    else:
        wd = (unpack_words(packed, bits).to(torch.float32).reshape(K // group, group, N)
              * scale_t[:, None] + bias_t[:, None]).reshape(K, N)
        y = torch.matmul(x.to(torch.float32), wd.to(x.dtype).to(torch.float32))
    return y.to(x.dtype)


def _packed_matmul_cuda(x, packed, scale_t, bias_t, bits: int, group: int):
    global launches
    from . import _build

    M, K = x.shape
    N = packed.shape[1]
    vpw = 32 // bits
    if x.dtype not in _DTYPES:
        raise TypeError(f"dequant_matmul kernel takes float32 or bfloat16, not {x.dtype}")
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, not {packed.dtype}")
    if bits not in (2, 4, 8) or K % group or group % vpw or packed.shape[0] * vpw != K:
        raise ValueError(f"unsupported packed shape: K={K} bits={bits} group={group} "
                         f"words={tuple(packed.shape)}")
    if scale_t.shape != (K // group, N) or bias_t.shape != (K // group, N):
        raise ValueError(f"scale/bias tables must be [{K // group}, {N}], not "
                         f"{tuple(scale_t.shape)} / {tuple(bias_t.shape)}")
    for t in (packed, scale_t, bias_t):
        if t.device != x.device:
            raise ValueError("dequant_matmul operands must share x's device")
    x = x.contiguous()
    packed = packed.contiguous()
    scale_t = scale_t.to(torch.float32).contiguous()
    bias_t = bias_t.to(torch.float32).contiguous()
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    fn = _build.load("dequant_matmul").mi_dequant_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), packed.data_ptr(), scale_t.data_ptr(), bias_t.data_ptr(),
             y.data_ptr(), M, N, K, bits, group, _DTYPES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "dequant_matmul")
    launches += 1
    return y


def packed_matmul(x, packed, scale_t, bias_t, bits: int, group: int):
    """y = x @ dequant(packed) for a 2-D x: the CUDA kernel on GPU tensors,
    the plain version on CPU tensors."""
    if x.is_cuda:
        return _packed_matmul_cuda(x, packed, scale_t, bias_t, bits, group)
    return dequant_matmul_ref(x, packed, scale_t, bias_t, bits, group)


def dequant_matmul(x: torch.Tensor, qlin) -> torch.Tensor:
    """y = x @ dequant(qlin)^T for a packed QuantizedLinear; any batch dims."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    st, bt = kernel_tables(qlin)
    y = packed_matmul(x.reshape(-1, K), qlin.packed, st, bt, qlin.spec.wbit, group_size(qlin))
    return y.reshape(*lead, qlin.out_features)
