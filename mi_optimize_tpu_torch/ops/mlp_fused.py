"""Fused quantized SwiGLU MLP: the gate and up dequant-matmuls, SiLU * up and
the down dequant-matmul in one launch; the [M, I] activation never reaches
device memory.

Kernel: csrc/mlp_fused.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/mlp_fused.py::_kernel (fused_mlp, reached through
`mlp_apply_fused` from `models.llama._mlp_tail`). The SwiGLU MLP is
associative over intermediate features,

    y = sum_j down[I_j, :] . ( silu(x . gate[:, I_j]) * (x . up[:, I_j]) ),

so the kernel walks intermediate tiles and sums their contributions, in f32
as the reference does: weights dequantized as (q - (zero - qmin)) * scale,
gate, up and the down sum in f32, the output rounded to x's dtype.

What bounds it on an H100: at decode (M = 1) the bytes of the packed gate,
up and down words with their scales and zeros (76 MB a layer for
Llama-2-7B); at prefill and perplexity (M >= 128) the 2*M*I*(2K + N)
operations. Blocks run in no order, so the tiles' contributions land in
partial sums of their own and a fixed-order reduction follows inside the
same (cooperative) launch: no atomics, the same bits on every run. The
partial scratch is bounded (`_splits`).

`mlp_supported` is the reference's routing predicate, copied as it is,
including its 128-wide intermediate tile; the CUDA kernel's own tile (64)
divides it. On CPU tensors `fused_mlp` runs the plain version `fused_mlp_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.packing import unpack_words
from .block_fused import _check_cuda
from .dequant_matmul import f32_table, zero_tables

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_TI = 128            # the reference kernel's intermediate tile (its routing predicate)
_KERNEL_TI = 64      # csrc/mlp_fused.cu's intermediate tile
_KERNEL_TK = 32      # ... its k chunk (K must be a multiple)
_GEMV_MAXM = 8       # ... rows of its GEMV kernel
_TM = 64             # ... rows of a tiled kernel's work item
_ITEMS = 264         # work items the split count aims at (2 blocks on each of 132 SMs)
_SCRATCH = 1 << 28   # the most bytes of partial sums a launch may take

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mlp_supported(gate, up, down, hidden, inter) -> bool:
    """Whether the fused path applies to this (gate, up, down) triple."""
    for lin in (gate, up, down):
        if lin.packed is None or lin.bias is not None or lin.smooth_factor is not None:
            return False
        s = lin.spec
        if s.wbit not in (2, 4, 8) or s.abit is not None:
            return False
        if s.w_qtype not in ("per_group", "per_channel"):
            return False
    if gate.spec != up.spec or gate.spec.wbit != down.spec.wbit:
        return False
    if inter % _TI:
        return False
    gk = gate.spec.w_groupsize if gate.spec.w_qtype == "per_group" else hidden
    ik = down.spec.w_groupsize if down.spec.w_qtype == "per_group" else inter
    if hidden % gk or ik > _TI or _TI % ik:
        return False  # down groups must tile within _TI
    return gate.spec.w_unsigned == up.spec.w_unsigned == down.spec.w_unsigned


def _dequant(packed, scales_t, zeros_t, bits, group, rows):
    """(q - z) * s, f32 [rows, cols], zeros_t already minus qmin."""
    q = unpack_words(packed, bits).to(torch.float32)
    cols = q.shape[1]
    ng = rows // group
    return ((q.reshape(ng, group, cols) - zeros_t[:, None, :]) * scales_t[:, None, :]).reshape(
        rows, cols)


def fused_mlp_ref(x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t,
                  d_packed, d_scales_t, d_zeros_t, *, bits, k_group, i_group, qmin, inter,
                  hidden):
    """Plain PyTorch version of `fused_mlp`: the same arguments and result."""
    K = x.shape[1]
    x32 = x.to(torch.float32)
    w = lambda words, s, z, group, rows: _dequant(
        words, f32_table(s), f32_table(z - qmin if qmin else z), bits, group, rows)
    gate = x32 @ w(g_packed, g_scales_t, g_zeros_t, k_group, K)
    up = x32 @ w(u_packed, u_scales_t, u_zeros_t, k_group, K)
    act = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
    return (act @ w(d_packed, d_scales_t, d_zeros_t, i_group, inter)).to(x.dtype)


def _splits(M: int, N: int, inter: int) -> int:
    """Partial sums a launch writes: one a kernel tile at M <= 8; above, the
    intermediate tiles are cut into splits, enough for about _ITEMS work
    items with at most _SCRATCH bytes of partials. A function of the shapes
    alone, so the result's bits do not depend on the card."""
    tiles = inter // _KERNEL_TI
    if M <= _GEMV_MAXM:
        return tiles
    rows = -(-M // _TM)
    return max(1, min(tiles, -(-_ITEMS // rows), _SCRATCH // (M * N * 4)))


class _MlpArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "gw", "gs", "gz", "uw", "us", "uz", "dw",
                                                "ds", "dz", "part", "y")] + [
        (n, ctypes.c_int) for n in ("M", "K", "I", "N", "gk", "ik", "S")]


def _fused_mlp_cuda(x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t,
                    d_packed, d_scales_t, d_zeros_t, *, bits, k_group, i_group, qmin, inter,
                    hidden):
    global launches
    from . import _build

    dev = x.device
    M, K = x.shape
    vpw = 32 // bits if bits in (2, 4, 8) else 0
    if x.dtype not in _DTYPES:
        raise TypeError(f"mlp_fused kernel takes float32 or bfloat16 x, not {x.dtype}")
    if (not vpw or inter % _KERNEL_TI or K % _KERNEL_TK or k_group % vpw or i_group % vpw
            or K % k_group or inter % i_group):
        raise ValueError(f"unsupported fused MLP: K={K} I={inter} bits={bits} groups "
                         f"{k_group}/{i_group}")
    x = x.contiguous()
    _check_cuda("x", x, dev)
    tabs = []
    for name, (w, s, z), rows, cols, g in (
            ("gate", (g_packed, g_scales_t, g_zeros_t), K, inter, k_group),
            ("up", (u_packed, u_scales_t, u_zeros_t), K, inter, k_group),
            ("down", (d_packed, d_scales_t, d_zeros_t), inter, hidden, i_group)):
        _check_cuda(f"{name} words", w, dev, torch.int32, (rows // vpw, cols))
        s, z = f32_table(s), f32_table(z - qmin if qmin else z)
        _check_cuda(f"{name} scales", s, dev, shape=(rows // g, cols))
        _check_cuda(f"{name} zeros", z, dev, shape=(rows // g, cols))
        tabs += [w, s, z]
    S = _splits(M, hidden, inter)
    part = torch.empty(S, M, hidden, dtype=torch.float32, device=dev)
    y = torch.empty(M, hidden, dtype=x.dtype, device=dev)
    args = _MlpArgs(x.data_ptr(), *(t.data_ptr() for t in tabs), part.data_ptr(), y.data_ptr(),
                    M, K, inter, hidden, k_group, i_group, S)
    fn = _build.load("mlp_fused").mi_mlp_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_MlpArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.byref(args), bits, _DTYPES[x.dtype], _build.stream_ptr(dev)),
                 "mlp_fused")
    launches += 1
    return y


def fused_mlp(x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t, d_packed,
              d_scales_t, d_zeros_t, *, bits, k_group, i_group, qmin, inter, hidden):
    """x [M, K] -> y [M, hidden] in x's dtype.

    gate/up words [K*b/32, I] with scales/zeros [K/k_group, I]; down words
    [I*b/32, hidden] with scales/zeros [I/i_group, hidden] (kernel layout,
    [groups, out]; zeros as stored, `qmin` is folded in here). The kernel on
    GPU tensors, the plain version on CPU tensors."""
    kw = dict(bits=bits, k_group=k_group, i_group=i_group, qmin=qmin, inter=inter, hidden=hidden)
    args = (x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t, d_packed,
            d_scales_t, d_zeros_t)
    if x.is_cuda:
        return _fused_mlp_cuda(*args, **kw)
    return fused_mlp_ref(*args, **kw)


def mlp_apply_fused(x, gate, up, down, cfg):
    """Run the fused MLP for a supported triple (the caller checked
    `mlp_supported`); any leading dims. The scale and zero tables are the
    linears' cached `zero_tables` (qmin already folded in)."""
    hidden = cfg.hidden_size
    inter = cfg.intermediate_size
    s = gate.spec
    gk = s.w_groupsize if s.w_qtype == "per_group" else hidden
    ik = down.spec.w_groupsize if down.spec.w_qtype == "per_group" else inter
    (gs, gz), (us, uz), (ds, dz) = (zero_tables(lin) for lin in (gate, up, down))
    lead = x.shape[:-1]
    y = fused_mlp(x.reshape(-1, hidden), gate.packed, gs, gz, up.packed, us, uz, down.packed,
                  ds, dz, bits=s.wbit, k_group=gk, i_group=ik, qmin=0, inter=inter,
                  hidden=hidden)
    return y.reshape(*lead, hidden)
