"""W4A8 matmul: int4 weights times int8 activations with an exact integer
inner product.

Kernel: csrc/w4a8_matmul.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/w4a8_matmul.py::_kernel (w4a8_matmul_int, reached
through `w4a8_matmul` from `models.quant_linear.quant_linear_apply`).

    y[m, n] = sx[m] * sum_g s[g, n] * sum_{k in g} xq[m, k] * (q[k, n] - z[g, n])

The activations are quantized on the same dynamic absmax int8 grid as the
fake-quant route (`sx = amax / 127`, round half to even, correctly rounded
quotients), the zeros are integral, so each group's product is computed
exactly in int32 and only the scales are applied in f32: the same product
the fake-quant reference computes, without its float rounding inside a
group. Routing (the reference's opt-in, read at call time): packed int4
linears with dynamic symmetric signed int8 per-token or per-tensor
activation quantization, with `MI_W4A8_INT=1` and at least 32 flattened rows.

What bounds it on an H100: 2*M*N*K int8 operations against the bytes of the
words, x and the tables; at M = 128 the bytes weigh the most, at M = 2048
the operations. The kernel runs on the int8 tensor cores (mma.m16n8k32,
int32 accumulators a group long) over a cp.async ring, with the words turned
into int8 codes q - z once a block; `fill_tile` picks the largest of its
tiles ([128, 64], [64, 64], [64, 32]) whose blocks fill the card.

On CPU tensors `w4a8_matmul_int` runs the plain version, which computes
each group's sum exactly in float64 (PyTorch has no int32 matmul on the GPU
but torch._int_mm, and an f32 sum is exact only below 2^24) and adds the
scaled group sums in order in f32; the kernel gives the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.packing import unpack_words
from ..core.qparams import div_round, exact_div
from .block_fused import _check_cuda
from .dequant_matmul import aligned16, f32_table, fill_tile, zero_tables

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_TK = 32                              # the mma's k step: K and the group must be multiples
TILES = ((128, 64), (64, 64), (64, 32))  # csrc/w4a8_matmul.cu's tiles [BM, BN]


def supports_w4a8(spec) -> bool:
    return (
        spec.wbit == 4
        and spec.abit == 8
        and spec.a_dynamic
        and spec.a_symmetric
        and not spec.a_unsigned
        and spec.a_qtype in ("per_token", "per_tensor")
        and spec.fp8_format is None
        and not spec.quant_out
        and spec.w_qtype in ("per_group", "per_channel")
    )


def w4a8_matmul_int_ref(xi, packed_t, scales_t, zeros_t, *, bits, groupsize, qmin):
    """Plain PyTorch version of `w4a8_matmul_int`: the same arguments and
    result (bit for bit)."""
    M, K = xi.shape
    N = packed_t.shape[1]
    g = groupsize if groupsize > 0 else K
    ng = K // g
    z = f32_table(zeros_t - qmin if qmin else zeros_t).to(torch.float64)
    w = unpack_words(packed_t, bits).to(torch.float64).reshape(ng, g, N) - z[:, None, :]
    parts = torch.einsum("mgk,gkn->gmn", xi.to(torch.float64).reshape(M, ng, g), w)
    s = scales_t.to(torch.float32)
    acc = torch.zeros(M, N, dtype=torch.float32, device=xi.device)
    for gi in range(ng):
        acc = acc + parts[gi].to(torch.float32) * s[gi]
    return acc


def _w4a8_matmul_int_cuda(xi, packed_t, scales_t, zeros_t, *, bits, groupsize, qmin):
    global launches
    from . import _build

    dev = xi.device
    M, K = xi.shape
    N = packed_t.shape[1]
    g = groupsize if groupsize > 0 else K
    if bits != 4 or K % _TK or g % _TK or K % g:
        raise ValueError(f"w4a8 kernel takes 4-bit words with K and the group multiples of "
                         f"{_TK}: K={K} group={g} bits={bits}")
    xi = aligned16(xi.contiguous())
    _check_cuda("xi", xi, dev, torch.int8)
    _check_cuda("packed", packed_t, dev, torch.int32, (K // 8, N))
    packed_t = aligned16(packed_t)
    s, z = f32_table(scales_t), f32_table(zeros_t - qmin if qmin else zeros_t)
    _check_cuda("scales", s, dev, shape=(K // g, N))
    _check_cuda("zeros", z, dev, shape=(K // g, N))
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    fn = _build.load("w4a8_matmul").mi_w4a8_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    _build.check(fn(xi.data_ptr(), packed_t.data_ptr(), s.data_ptr(), z.data_ptr(),
                    out.data_ptr(), M, N, K, g, fill_tile(M, N, TILES), _build.stream_ptr(dev)),
                 "w4a8_matmul")
    launches += 1
    return out


def w4a8_matmul_int(xi, packed_t, scales_t, zeros_t, *, bits, groupsize, qmin):
    """acc [M, N] f32, before the activation scale, from int8 xi [M, K] and
    packed int4 words [K*bits/32, N]; scales_t/zeros_t [ngroups, N]
    (groupsize <= 0: one group of all K); `qmin` folds the storage bias into
    the zero table. The kernel on GPU tensors, the plain version on CPU
    tensors."""
    kw = dict(bits=bits, groupsize=groupsize, qmin=qmin)
    if xi.is_cuda:
        return _w4a8_matmul_int_cuda(xi, packed_t, scales_t, zeros_t, **kw)
    return w4a8_matmul_int_ref(xi, packed_t, scales_t, zeros_t, **kw)


def quantize_activations(x2, a_qtype):
    """(int8 codes, f32 scales [M, 1] or [1, 1]) of x2 [M, K] f32 on the
    dynamic absmax grid."""
    if a_qtype == "per_token":
        amax = torch.clamp(x2.abs().amax(dim=-1, keepdim=True), min=1e-12)
    else:
        amax = torch.clamp(x2.abs().amax(), min=1e-12).reshape(1, 1)
    sx = exact_div(amax, 127.0)
    return torch.clamp(div_round(x2, sx), -128, 127).to(torch.int8), sx


def w4a8_matmul(x: torch.Tensor, qlin) -> torch.Tensor:
    """y = int8(x) @ dequant(int4 W)^T with the integer product; any leading
    dims; in x's dtype."""
    s = qlin.spec
    lead = x.shape[:-1]
    K = x.shape[-1]
    xi, sx = quantize_activations(x.reshape(-1, K).to(torch.float32), s.a_qtype)
    g = s.w_groupsize if (s.w_qtype == "per_group" and s.w_groupsize > 0) else -1
    st, zt = zero_tables(qlin)
    acc = w4a8_matmul_int(xi, qlin.packed, st, zt, bits=s.wbit, groupsize=g, qmin=0)
    return (acc * sx).reshape(*lead, qlin.out_features).to(x.dtype)
