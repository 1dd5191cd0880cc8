"""Fused dequantize + matmul for packed int2/int4/int8 weights (W4A16 / W8A16).

Kernel: csrc/dequant_matmul.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/dequant_matmul.py::_kernel (reached through
`_packed_matmul_local` -> `packed_matmul` -> `dequant_matmul`).

    y[M, N] = x[M, K] @ dequant(packed)^T,  dequant(q) = q*s + b,
    b = -(zero - qmin)*s  per (group, output column)

`route` picks one of its kernels for each call:
  * "gemv16" (bf16 x, 4-bit words, M <= 16, group % 32 == 0): decode, the
    lm_head in generate, the unfused model's linears. Bound by the bytes of
    the packed words: every word is used M times, far below the ~295
    operations a byte where the card stops being memory bound. The
    reference's grouped rescale over centered codes on the tensor cores,
    K split at group boundaries over enough blocks to fill the card, the
    splits added in a fixed order (`gemv_splits`).
  * "mma" (bf16 x, 4-bit words, any other M): prefill (M = 128) and PPL
    (M = 2048). Bound by 2*M*N*K operations at M = 2048. Tensor cores on
    weight tiles dequantized once a block to bf16 (`mma_plan` picks the
    tile and how K is split).
  * "cuda_core" (f32 x, or 2- and 8-bit words): CUDA-core kernels, a
    GEMV at M <= 8 and a tiled kernel above. The f32 inputs stay off the
    tensor cores: TF32 would not hold f32 results to the plain version.

On CPU tensors the wrapper runs `dequant_matmul_ref`, which follows the
reference path that M selects: the grouped rescale over centered codes for
small M, and dequantize-to-x's-dtype-then-dot otherwise (an f32 matmul of
the rounded weights, on the card a CUDA-core product too).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.packing import unpack_words
from ..core.qparams import qrange
from ..models.quant_linear import group_size

# kernel launches by route; chip_smoke.py resets and reads them
launches = 0          # "cuda_core" (f32 x, 2- and 8-bit words)
launches_gemv16 = 0   # "gemv16"
launches_mma = 0      # "mma"

COUNTERS = {"cuda_core": "launches", "gemv16": "launches_gemv16", "mma": "launches_mma"}

SMS = 132                     # an H100 SXM's SMs: what the tile and split choices fill
GEMV_MAX_M = 16               # rows of the gemv16 kernel (its two mma row tiles)
GEMV_COLS = 256               # columns a gemv16 block (4 warps of 64)
GEMV_BLOCKS_PER_SM = 4        # gemv16 blocks to aim for: 16 warps an SM
GEMV_SCRATCH = 64 << 20       # bytes of f32 split partials a gemv16 call may use
MMA_TILES = ((64, 128), (128, 128))  # the mma kernel's tiles [BM, BN]: M <= 64, else
MMA_STEP = 64                 # k a stage of the mma kernel (splits are whole steps)
MMA_SCRATCH = 64 << 20        # bytes of f32 split partials an mma call may use

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


def route(M: int, dtype, bits: int, group: int) -> str:
    """The kernel a call takes on the card: "gemv16" or "mma" for bf16 x
    with 4-bit words (by M and the group), else "cuda_core"."""
    if dtype == torch.bfloat16 and bits == 4:
        return "gemv16" if M <= GEMV_MAX_M and group % 32 == 0 else "mma"
    return "cuda_core"


def gemv_splits(M: int, N: int, K: int, group: int) -> int:
    """How many splits of K the gemv16 kernel takes: enough blocks to fill
    the card, at most one split a group (split s covers groups [s*ng/S,
    (s+1)*ng/S)), and at most GEMV_SCRATCH bytes of f32 partials."""
    ng = K // group
    cols = -(-N // GEMV_COLS)
    want = -(-GEMV_BLOCKS_PER_SM * SMS // cols)
    return max(1, min(ng, want, GEMV_SCRATCH // (4 * M * N)))


def mma_plan(M: int, N: int, K: int):
    """(tile [BM, BN], splits of K) of the mma kernel: the [64, 128] tile up
    to 64 rows, else [128, 128]; where the tiles give fewer blocks than SMs,
    K split into enough whole MMA_STEP steps for two blocks an SM (split s
    covers steps [s*steps/S, (s+1)*steps/S)), within MMA_SCRATCH bytes of
    f32 partials."""
    tile = MMA_TILES[0] if M <= 64 else MMA_TILES[1]
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    if tiles >= SMS:
        return tile, 1
    steps = -(-K // MMA_STEP)
    return tile, max(1, min(steps, -(-2 * SMS // tiles), MMA_SCRATCH // (4 * M * N)))


def fill_tile(M: int, N: int, tiles) -> int:
    """Index of the first (largest) of `tiles` [BM, BN] that gives at least
    two blocks an SM, else of the last."""
    for i, (bm, bn) in enumerate(tiles[:-1]):
        if -(-M // bm) * -(-N // bn) >= 2 * SMS:
            return i
    return len(tiles) - 1


def aligned16(t):
    """t, copied if its data does not start on 16 bytes (the kernels load
    16 bytes a lane)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_counters = {}


def _gemv_counters(dev, n: int):
    """Zeroed int32 arrivals counters of the gemv16 kernel's column blocks on
    dev (the kernel leaves them zero), kept for the next call."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        c = _counters[dev] = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
    return c


def _packed_matmul_cuda(x, packed, scale_t, bias_t, bits: int, group: int, kernel=None):
    """The card's product through `kernel` (a `route` name; by default the
    route of the call's shape)."""
    global launches, launches_gemv16, launches_mma
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
    kernel = kernel or route(M, x.dtype, bits, group)
    if (kernel != "cuda_core" and (x.dtype, bits) != (torch.bfloat16, 4)
            or kernel == "gemv16" and (M > GEMV_MAX_M or group % 32)):
        raise ValueError(f"the {kernel} kernel does not take M={M} {x.dtype} {bits}-bit "
                         f"group {group}")
    x = aligned16(x.contiguous())
    packed = aligned16(packed.contiguous())
    scale_t = aligned16(scale_t.to(torch.float32).contiguous())
    bias_t = aligned16(bias_t.to(torch.float32).contiguous())
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    lib = _build.load("dequant_matmul")
    ptrs = [t.data_ptr() for t in (x, packed, scale_t, bias_t, y)]
    stream = _build.stream_ptr(x.device)
    if kernel == "gemv16":
        splits = gemv_splits(M, N, K, group)
        part = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device) if splits > 1
                else y)
        cnt = _gemv_counters(x.device, -(-N // GEMV_COLS))
        fn = lib.mi_dequant_matmul_gemv16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        err = fn(*ptrs, part.data_ptr(), cnt.data_ptr(), M, N, K, group, splits, stream)
        launches_gemv16 += 1  # one launch counted, the last-block sum is inside it
    elif kernel == "mma":
        tile, splits = mma_plan(M, N, K)
        part = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device) if splits > 1
                else y)
        fn = lib.mi_dequant_matmul_mma
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        err = fn(*ptrs, part.data_ptr(), M, N, K, group, int(tile == MMA_TILES[1]), splits,
                 stream)
        launches_mma += 1  # one launch counted, with its split sum
    else:
        fn = lib.mi_dequant_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        err = fn(*ptrs, M, N, K, bits, group, _DTYPES[x.dtype], stream)
        launches += 1
    _build.check(err, f"dequant_matmul ({kernel})")
    return y


def packed_matmul(x, packed, scale_t, bias_t, bits: int, group: int, kernel=None):
    """y = x @ dequant(packed) for a 2-D x: the CUDA kernel on GPU tensors,
    the plain version on CPU tensors. `kernel` (a `route` name) launches
    another kernel than the call's route, to time one against the other."""
    if x.is_cuda:
        return _packed_matmul_cuda(x, packed, scale_t, bias_t, bits, group, kernel)
    return dequant_matmul_ref(x, packed, scale_t, bias_t, bits, group)


def dequant_matmul(x: torch.Tensor, qlin) -> torch.Tensor:
    """y = x @ dequant(qlin)^T for a packed QuantizedLinear; any batch dims."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    st, bt = kernel_tables(qlin)
    y = packed_matmul(x.reshape(-1, K), qlin.packed, st, bt, qlin.spec.wbit, group_size(qlin))
    return y.reshape(*lead, qlin.out_features)
