"""Fused quantized SwiGLU MLP: y = down . (silu(x . gate) * (x . up)) over
packed gate, up and down weights.

Kernel: csrc/mlp_fused.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/mlp_fused.py::_kernel (fused_mlp, reached through
`mlp_apply_fused` from `models.llama._mlp_tail`). The math is the
reference's, in f32: weights (q - (zero - qmin)) * scale, gate and up in
f32, act = silu(gate) * up, the down sum in f32, the output rounded to x's
dtype.

`route` picks the kernel of a call on the card:
  * "gemv" (bf16 x, 4-bit words, groups of whole k32, M <= 8): decode. One
    cooperative launch: P1 gate and up on the tensor cores, a warp holding
    the same columns of both, act = silu(g) * u in f32 from the split that
    finishes a column block; a grid barrier; P2 down over act as two bf16
    planes. Bound by the bytes of the words and tables (76 MB a layer at
    Llama-2-7B). `gemv_plans` cuts each phase into (column block, K split)
    items over the grid.
  * "mma" (the same inputs, M > 8): prefill and perplexity. Two launches on
    one stream: P1 gate/up on the tensor cores with SiLU * up in its
    epilogue, act written as two bf16 planes [2, M, I]; P2 down over them,
    I split only as far as `mma_plan` needs to fill the card, the splits
    added in split order by each tile's last block. Bound by
    2*M*I*(2K + N) operations at M = 2048.
  * "cuda_core" (f32 x, 2- and 8-bit words, other groups): the first port's
    CUDA-core kernels, one cooperative launch whose partial sums are added
    in a fixed order after a grid barrier (`_splits` bounds them).
act is the one departure from the reference's "act never in device
memory": [M, I] f32 at M <= 8, two bf16 planes above (90 MB at M = 2048).
The tensor-core routes compute the reference's grouped rescale on the
centered codes (`dequant_matmul.qdot_ref`), y = sum_g s*D[g] + (b + 8s) *
xsum[g], with the bias tables b = -(zero - qmin) * s; only the order of the
f32 sums differs from the plain version (and act's second plane leaves it
within 2^-17). Every route gives the same bits on every launch. `launches`
counts one a call, and `launches_<route>` the calls of each route.

`mlp_supported` is the reference's routing predicate, copied as it is,
including its 128-wide intermediate tile. On CPU tensors `fused_mlp` runs the
plain version `fused_mlp_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.packing import unpack_words
from .block_fused import _check_cuda
from .coop_plan import COOP_PER_SM, H100_SMS, best_plan, sm_count
from .dequant_matmul import aligned16, f32_table, kernel_tables, zero_tables

# kernel launches, one a call; chip_smoke.py resets and reads them
launches = 0              # every route
launches_gemv = 0         # "gemv"
launches_mma = 0          # "mma"
launches_cuda_core = 0    # "cuda_core"

COUNTERS = {"gemv": "launches_gemv", "mma": "launches_mma", "cuda_core": "launches_cuda_core"}

_TI = 128            # the reference kernel's intermediate tile (its routing predicate)
_KERNEL_TI = 64      # csrc/mlp_fused.cu's intermediate tile
_KERNEL_TK = 32      # ... its k chunk (K must be a multiple)
_GEMV_MAXM = 8       # ... rows of its GEMV kernel
_TM = 64             # ... rows of a tiled kernel's work item
_ITEMS = 264         # work items the split count aims at (2 blocks on each of 132 SMs)
_SCRATCH = 1 << 28   # the most bytes of partial sums a launch may take
MMA_GROUP = 32       # the tensor-core routes take groups of whole k32 (two mma steps)
GEMV_COLS = 512      # "gemv": virtual columns an item (8 warps of 64)
MMA_BN = 128         # "mma": output columns a tile
MMA_BIG_M = 128      # "mma": [128, 128] tiles above this many rows, [64, 128] up to it
MMA_TILES = {False: (64, 2), True: (128, 1)}  # "mma": big -> (rows a tile, P2 blocks an SM)
MMA_SCRATCH = 64 << 20  # bytes of P2's f32 split partials a call may use

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mlp_supported(gate, up, down, hidden, inter) -> bool:
    """Whether the fused path applies to this (gate, up, down) triple."""
    for lin in (gate, up, down):
        if lin.packed is None or lin.bias is not None or lin.smooth_factor is not None:
            return False
        if lin.perm is not None:
            return False  # GPTQ act-order: the kernels read x in natural order
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


def route(M: int, dtype, bits: int, k_group: int, i_group: int) -> str:
    """The kernel a call takes on the card: "gemv" (M <= 8) or "mma" for bf16
    x with 4-bit words in groups of whole k16 steps, else "cuda_core"."""
    if dtype == torch.bfloat16 and bits == 4 and not (k_group % MMA_GROUP or
                                                      i_group % MMA_GROUP):
        return "gemv" if M <= _GEMV_MAXM else "mma"
    return "cuda_core"


def _split_plan(tiles: int, ng: int, blocks: int, scratch_floats: int) -> int:
    """Splits of K (at whole groups) for `tiles` output tiles over `ng`
    groups, searched by `coop_plan.best_plan`: among the plans that fill
    `blocks` blocks, the least waves x groups of the largest split, then the
    fewest splits, within MMA_SCRATCH bytes of partials (`scratch_floats` a
    split)."""
    def rank(ws, splits, most, waves, idle):
        if ws != 1 or splits > 1 and 4 * splits * scratch_floats > MMA_SCRATCH:
            return None
        return waves * most, splits

    return best_plan(tiles, ng, blocks, rank)[1]


@functools.lru_cache(maxsize=None)
def gemv_plans(M: int, K: int, inter: int, hidden: int, k_group: int, i_group: int,
               blocks: int = COOP_PER_SM * H100_SMS) -> tuple:
    """The "gemv" route's K splits (P1, P2): items are blocks of GEMV_COLS
    virtual columns (P1: 2 * inter, a warp's 64 being 32 gate columns and the
    same 32 up columns; P2: hidden) x splits, over the cooperative grid."""
    nv1, nv2 = 2 * inter, hidden
    return (_split_plan(-(-nv1 // GEMV_COLS), K // k_group, blocks, M * nv1),
            _split_plan(-(-nv2 // GEMV_COLS), inter // i_group, blocks, M * nv2))


def gemv_scratch(M: int, inter: int, hidden: int, splits: tuple) -> tuple:
    """(f32 partials, counters) of the "gemv" route's plan: P2 reuses P1's
    after the grid barrier."""
    part, cnt = 0, 0
    for nv, s in zip((2 * inter, hidden), splits):
        if s > 1:
            part, cnt = max(part, s * M * nv), max(cnt, -(-nv // GEMV_COLS))
    return part, cnt


@functools.lru_cache(maxsize=None)
def mma_plan(M: int, hidden: int, inter: int, i_group: int, sms: int = H100_SMS) -> tuple:
    """(big, P2's splits of I) of the "mma" route: [128, 128] tiles (16
    warps, one block an SM) above MMA_BIG_M rows, else [64, 128] (8 warps,
    two blocks an SM); the splits by `_split_plan` over P2's tiles."""
    big = M > MMA_BIG_M
    rows, per_sm = MMA_TILES[big]
    tiles = -(-M // rows) * -(-hidden // MMA_BN)
    return big, _split_plan(tiles, inter // i_group, per_sm * sms, M * hidden)


_counters = {}


def _zeroed_counters(dev, n: int):
    """Zeroed int32 arrival counters on dev (the kernels leave them zero),
    kept for the next call."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        c = _counters[dev] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return c


class _MlpArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "gw", "gs", "gz", "uw", "us", "uz", "dw",
                                                "ds", "dz", "part", "y")] + [
        (n, ctypes.c_int) for n in ("M", "K", "I", "N", "gk", "ik", "S")]


class _MlpMmaArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("x", "gw", "gs", "gb", "uw", "us", "ub", "dw",
                                                "ds", "db", "act", "part", "counters", "y")] + [
        ("n_part", ctypes.c_long), ("n_counters", ctypes.c_int)] + [
        (n, ctypes.c_int) for n in ("M", "K", "I", "N", "gk", "ik")] + [
        ("splits1", ctypes.c_int), ("splits2", ctypes.c_int), ("big", ctypes.c_int)]


def _checked_tables(x, words, vpw, biases, *, bits, k_group, i_group, qmin, inter, hidden):
    """[words, scales, zeros or biases] of gate, up and down, checked against
    the shapes: the zeros (qmin folded in) where `biases` is None, else the
    three bias tables given."""
    dev, K = x.device, x.shape[1]
    tabs = []
    for i, (name, (w, s, z), rows, cols, g) in enumerate((
            ("gate", words[0:3], K, inter, k_group), ("up", words[3:6], K, inter, k_group),
            ("down", words[6:9], inter, hidden, i_group))):
        _check_cuda(f"{name} words", w, dev, torch.int32, (rows // vpw, cols))
        s = f32_table(s)
        t = f32_table(z - qmin if qmin else z) if biases is None else f32_table(biases[i])
        _check_cuda(f"{name} scales", s, dev, shape=(rows // g, cols))
        _check_cuda(f"{name} {'zeros' if biases is None else 'biases'}", t, dev,
                    shape=(rows // g, cols))
        tabs += [aligned16(w), aligned16(s), aligned16(t)]
    return tabs


def _fused_mlp_cuda(x, *words, bits, k_group, i_group, qmin, inter, hidden, biases=None,
                    kernel=None):
    global launches, launches_gemv, launches_mma, launches_cuda_core
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
    x = aligned16(x.contiguous())
    _check_cuda("x", x, dev)
    kw = dict(bits=bits, k_group=k_group, i_group=i_group, qmin=qmin, inter=inter, hidden=hidden)
    y = torch.empty(M, hidden, dtype=x.dtype, device=dev)
    r = route(M, x.dtype, bits, k_group, i_group)
    if kernel not in (None, r, "cuda_core"):
        raise ValueError(f"the {kernel} kernels do not take M={M} {x.dtype} {bits}-bit groups "
                         f"{k_group}/{i_group}")
    r = kernel or r
    if r == "cuda_core":
        tabs = _checked_tables(x, words, vpw, None, **kw)
        S = _splits(M, hidden, inter)
        part = torch.empty(S, M, hidden, dtype=torch.float32, device=dev)
        args = _MlpArgs(x.data_ptr(), *(t.data_ptr() for t in tabs), part.data_ptr(),
                        y.data_ptr(), M, K, inter, hidden, k_group, i_group, S)
        fn = _build.load("mlp_fused").mi_mlp_fused
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_MlpArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(ctypes.byref(args), bits, _DTYPES[x.dtype], _build.stream_ptr(dev))
    else:
        if biases is None:  # -(z - qmin) * s, as dequant_matmul.kernel_tables caches them
            biases = [-f32_table(z - qmin if qmin else z) * f32_table(sc)
                      for sc, z in (words[1:3], words[4:6], words[7:9])]
        tabs = _checked_tables(x, words, vpw, biases, **kw)
        if r == "gemv":
            splits = gemv_plans(M, K, inter, hidden, k_group, i_group,
                                COOP_PER_SM * sm_count(dev))
            n_part, n_cnt = gemv_scratch(M, inter, hidden, splits)
            act = torch.empty(M, inter, dtype=torch.float32, device=dev)
            big = False
        else:
            big, S = mma_plan(M, hidden, inter, i_group, sm_count(dev))
            splits = (1, S)
            n_part = S * M * hidden if S > 1 else 0
            n_cnt = -(-M // MMA_TILES[big][0]) * -(-hidden // MMA_BN) if S > 1 else 0
            act = torch.empty(2, M, inter, dtype=torch.bfloat16, device=dev)
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
        cnt = _zeroed_counters(dev, n_cnt)
        args = _MlpMmaArgs(x.data_ptr(), *(t.data_ptr() for t in tabs), act.data_ptr(),
                           part.data_ptr(), cnt.data_ptr(), y.data_ptr(), n_part, cnt.numel(),
                           M, K, inter, hidden, k_group, i_group, *splits, int(big))
        fn = _build.load("mlp_fused").mi_mlp_fused_mma
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_MlpMmaArgs), ctypes.c_void_p]
        err = fn(ctypes.byref(args), _build.stream_ptr(dev))
    _build.check(err, f"mlp_fused ({r})")
    launches += 1  # one a call: the "mma" route's two launches are one call
    globals()[COUNTERS[r]] += 1
    return y


def fused_mlp(x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t, d_packed,
              d_scales_t, d_zeros_t, *, bits, k_group, i_group, qmin, inter, hidden,
              biases=None, kernel=None):
    """x [M, K] -> y [M, hidden] in x's dtype.

    gate/up words [K*b/32, I] with scales/zeros [K/k_group, I]; down words
    [I*b/32, hidden] with scales/zeros [I/i_group, hidden] (kernel layout,
    [groups, out]; zeros as stored, `qmin` is folded in here). `biases`, the
    three bias tables -(zero - qmin) * scale in the same layout, spare the
    tensor-core routes making them from the zeros at each call. The kernel
    on GPU tensors, the plain version on CPU tensors. `kernel` (a `route`
    name) launches another kernel than the call's route, to time one against
    the other: "cuda_core" takes any inputs."""
    kw = dict(bits=bits, k_group=k_group, i_group=i_group, qmin=qmin, inter=inter, hidden=hidden)
    args = (x, g_packed, g_scales_t, g_zeros_t, u_packed, u_scales_t, u_zeros_t, d_packed,
            d_scales_t, d_zeros_t)
    if x.is_cuda:
        return _fused_mlp_cuda(*args, **kw, biases=biases, kernel=kernel)
    return fused_mlp_ref(*args, **kw)


def mlp_apply_fused(x, gate, up, down, cfg):
    """Run the fused MLP for a supported triple (the caller checked
    `mlp_supported`); any leading dims. The tables are the linears' cached
    `zero_tables` (qmin already folded in) and `kernel_tables`' biases."""
    hidden = cfg.hidden_size
    inter = cfg.intermediate_size
    s = gate.spec
    gk = s.w_groupsize if s.w_qtype == "per_group" else hidden
    ik = down.spec.w_groupsize if down.spec.w_qtype == "per_group" else inter
    (gs, gz), (us, uz), (ds, dz) = (zero_tables(lin) for lin in (gate, up, down))
    lead = x.shape[:-1]
    y = fused_mlp(x.reshape(-1, hidden), gate.packed, gs, gz, up.packed, us, uz, down.packed,
                  ds, dz, bits=s.wbit, k_group=gk, i_group=ik, qmin=0, inter=inter,
                  hidden=hidden, biases=tuple(kernel_tables(lin)[1] for lin in (gate, up, down)))
    return y.reshape(*lead, hidden)
