"""The row-parallel dequant matmul with its ring reduce overlapped.

Port of mi_optimize_tpu/parallel/overlap.py. The output columns are cut
into one chunk a rank; each rank walks the chunks in ring order,

    step s (rank d):   c = (d + 1 + s) % D
        partial_c = x_local @ dequant(packed_local[:, c·NC:(c+1)·NC])
        if s > 0:      partial_c += the partial received from rank d + 1
        if s < D - 1:  send partial_c to rank d - 1

so that after D steps rank d holds the fully reduced chunk d (a
reduce-scatter); the optional ring all-gather then gives every rank the
whole [M, N] output.

Kernel: csrc/overlap.cu (`ring_chunk`), which replaces the TPU kernel
mi_optimize_tpu/parallel/overlap.py::_ring_kernel: one launch computes a
column window of a step's chunk in f32 and adds the received partial in its
epilogue. `ring_route` picks the kernel: bf16 x with 4-bit words and groups
of whole k32 (every served window) take the tensor cores with the grouped
rescale (s * sum(x * (q - 8)) + (8 - zq) * s * sum(x) a group, in f32): a
split-K GEMV over the whole card up to GEMV_MAX_M rows ("gemv", its K splits
from `gemv_plan`), the tiled product above ("mma", its tile and splits from
`mma_plan`); f32 x and 2/8-bit words take the first port's CUDA-core tiles
("cuda_core"), the dequant as `_dequant_chunk` writes it, (q - (zero -
qmin)) * s. The TPU kernel sends with remote DMAs from inside the kernel;
here the ring's transfers are torch.distributed isend/irecv (NCCL between
cards, on its own stream) posted right after each window's launch. Each
chunk goes in PARTS windows, so that one window's transfer runs while the
next window computes: every transfer but the last of a step hides behind a
launch (a step's first window waits for the right neighbour's first
window, sent while that neighbour computed its second). On a CPU tensor
`ring_chunk` runs its plain version, `ring_chunk_ref`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..ops.coop_plan import H100_SMS, sm_count
from .collectives import ring_start, ring_wait, size_of, rank_of

# ring_chunk kernel launches (every route), and by route; chip_smoke.py
# resets and reads them
launches = 0
launches_gemv = 0
launches_mma = 0
launches_cuda_core = 0

GEMV_MAX_M = 16   # rows the "gemv" route takes at most (csrc/overlap.cu RG_MAXM)
GEMV_WARPS = 4    # warps a ring_gemv block, each a share of the split's groups (RG_WARPS)
GEMV_COLS = 64    # output columns a ring_gemv block (RG_COLS)
MMA_BIG_M = 128   # the "mma" route's [128, 128] tile above this many rows, [64, 128] up to it
MMA_BN = 128      # output columns of an "mma" tile
MMA_SPLITS = 8    # K splits of an "mma" tile at the most: its last block adds them

PARTS = 2  # column windows a chunk: the transfer of one overlaps the next's launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ring_chunk_ref(x, packed, scale_t, zq_t, add, bits: int, group: int, col0: int, nc: int):
    """Plain version of the kernel: add + x @ W[:, col0:col0+nc] in f32, W =
    (q - zq) * s of the words-major packed [K/vpw, N] with f32 [K/g, N]
    tables (zq = zero - qmin); add is f32 [M, nc] or None."""
    from ..core.packing import unpack_words

    K = x.shape[1]
    q = unpack_words(packed[:, col0:col0 + nc], bits).to(torch.float32)
    s, z = scale_t[:, col0:col0 + nc], zq_t[:, col0:col0 + nc]
    w = ((q.reshape(K // group, group, nc) - z[:, None]) * s[:, None]).reshape(K, nc)
    y = torch.matmul(x.to(torch.float32), w)
    return y if add is None else add + y


def _tensor_cores(dtype, bits: int, group: int, nc: int) -> bool:
    """Whether the tensor-core kernels take the window: bf16 x, 4-bit words,
    groups of whole k32, whole 8 columns."""
    return dtype == torch.bfloat16 and bits == 4 and group % 32 == 0 and nc % 8 == 0


def ring_route(M: int, dtype, bits: int, group: int, nc: int) -> str:
    """The kernel `ring_chunk` takes on the card: where the tensor cores take
    the window (`_tensor_cores`), "gemv" (the split-K GEMV, ring_gemv_kernel)
    up to GEMV_MAX_M rows and "mma" (the tiled product, ring_mma_kernel)
    above them; else "cuda_core" (the first port's f32 tiles,
    ring_chunk_kernel)."""
    if _tensor_cores(dtype, bits, group, nc):
        return "gemv" if M <= GEMV_MAX_M else "mma"
    return "cuda_core"


def gemv_plan(nc: int, K: int, group: int) -> int:
    """The "gemv" route's K splits, from the shapes alone: items are blocks
    of GEMV_COLS columns x a split of whole groups, and a split gives each of
    the block's GEMV_WARPS warps one group where K holds enough (Llama-2-7B
    at D = 2: o_proj's 16 groups in 4 splits, 64 blocks; down_proj's 43 in
    11, 176 blocks)."""
    ng = K // group
    return max(1, -(-ng // GEMV_WARPS))


def mma_plan(M: int, nc: int, K: int, group: int, sms: int = H100_SMS) -> tuple:
    """(big, splits) of the "mma" route, from the shapes alone: the [128,
    128] tile (one block an SM) above MMA_BIG_M rows, else [64, 128] (two an
    SM); K split at whole groups only as far as the tiles need to fill the
    card, at most MMA_SPLITS ways (M = 2048, nc = 1024: 128 tiles, one
    split; M = 128: 16 tiles, 8 splits)."""
    big = M > MMA_BIG_M
    rows, per_sm = (128, 1) if big else (64, 2)
    tiles = -(-M // rows) * -(-nc // MMA_BN)
    return big, max(1, min(K // group, MMA_SPLITS, per_sm * sms // tiles))


_workspaces = {}
_ws_lock = threading.Lock()


def _workspace(dev, stream, n_part: int, n_counters: int):
    """(f32 partials of at least n_part floats, at least n_counters int32
    arrival counters, zero) for launches on `dev` and `stream`, kept for the
    next call and grown only when a call needs more (the kernels leave the
    counters zero)."""
    key = (str(dev), stream)
    with _ws_lock:
        part, cnt = _workspaces.get(key, (None, None))
        if part is None or part.numel() < n_part:
            part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
        if cnt is None or cnt.numel() < n_counters:
            cnt = torch.zeros(max(n_counters, 1), dtype=torch.int32, device=dev)
        _workspaces[key] = (part, cnt)
        return part, cnt


def ring_chunk(x, packed, scale_t, zq_t, add, bits: int, group: int, col0: int, nc: int,
               route: str = None):
    """One window of a ring step: f32 [M, nc] = add + x @ W[:, col0:col0+nc]
    (`ring_chunk_ref`). The kernel on GPU tensors (x f32 or bf16 [M, K],
    packed int32, tables f32, add f32 or None), `ring_route`'s unless
    `route` names one ("cuda_core" takes any inputs, "mma" every window the
    tensor cores take, "gemv" those up to GEMV_MAX_M rows); the plain
    version on CPU tensors."""
    if not x.is_cuda:
        return ring_chunk_ref(x, packed, scale_t, zq_t, add, bits, group, col0, nc)
    global launches, launches_gemv, launches_mma, launches_cuda_core
    from ..ops import _build
    from ..ops.block_fused import _check_cuda

    M, K = x.shape
    N = packed.shape[1]
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"ring_chunk takes float32 or bfloat16 x, not {x.dtype}")
    if bits not in (2, 4, 8) or K % group or group % (32 // bits):
        raise ValueError(f"ring_chunk: K={K} does not cut into groups of {group} of "
                         f"{bits}-bit words")
    if not (0 <= col0 and nc >= 1 and col0 + nc <= N):
        raise ValueError(f"columns [{col0}, {col0 + nc}) outside the {N} of the words")
    route = route or ring_route(M, x.dtype, bits, group, nc)
    tc = _tensor_cores(x.dtype, bits, group, nc)
    if not (route == "cuda_core" or tc and (route == "mma" or route == "gemv" and
                                             M <= GEMV_MAX_M)):
        raise ValueError(f"the {route!r} route does not take {x.dtype} x, {bits}-bit words in "
                         f"groups of {group}, {M} rows and {nc} columns")
    x = x.contiguous()
    _check_cuda("packed", packed, dev, torch.int32, (K * bits // 32, N))
    _check_cuda("scale_t", scale_t, dev, torch.float32, (K // group, N))
    _check_cuda("zq_t", zq_t, dev, torch.float32, (K // group, N))
    if add is not None:
        _check_cuda("add", add, dev, torch.float32, (M, nc))
    y = torch.empty(M, nc, dtype=torch.float32, device=dev)
    p = lambda t: None if t is None else t.data_ptr()
    ptrs = (p(x), p(packed), p(scale_t), p(zq_t), p(add), p(y))
    lib = _build.load("overlap")
    stream = _build.stream_ptr(dev)
    if route == "cuda_core":
        fn = lib.mi_ring_chunk
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = ptrs + (M, N, K, bits, group, col0, nc, _DTYPES[x.dtype])
    else:
        if route == "gemv":
            splits = gemv_plan(nc, K, group)
            n_counters, extra = -(-nc // GEMV_COLS), ()
            fn = lib.mi_ring_chunk_gemv
        else:
            big, splits = mma_plan(M, nc, K, group, sm_count(dev))
            n_counters = -(-M // (128 if big else 64)) * -(-nc // MMA_BN)
            extra = (int(big),)
            fn = lib.mi_ring_chunk_mma
        part, cnt = _workspace(dev, getattr(stream, "value", stream),
                               splits * M * nc if splits > 1 else 0, n_counters)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * (6 + len(extra) + 1) + [
            ctypes.c_void_p]
        args = ptrs + (p(part), p(cnt), M, N, K, group, col0, nc) + extra + (splits,)
    fn.restype = ctypes.c_int
    _build.check(fn(*args, stream), "ring_chunk")
    launches += 1
    if route == "gemv":
        launches_gemv += 1
    elif route == "mma":
        launches_mma += 1
    else:
        launches_cuda_core += 1
    return y


def ring_ok(N: int, K: int, D: int, bits: int, groupsize: int) -> bool:
    """Whether the shapes ring-shard as the reference requires: N into D
    chunks of whole 128 columns, K into D slices of whole words and groups."""
    if D > 1 and N % (D * 128):
        return False
    k_local = K // D
    return not (K % D or k_local % (32 // bits) or (groupsize > 0 and k_local % groupsize))


def ring_matmul(x_local, packed_local, scale_t, zq_t, grp, *, bits: int, group: int,
                gather: bool = True, parts: int = PARTS):
    """The ring over `grp` on this rank's shard: x_local [M, K/D], packed
    [K/D/vpw, N], f32 tables [K/D/group, N] (zq = zero - qmin; per-channel:
    one row). Returns f32 [M, N] (gather) or this rank's reduced chunk [M,
    N/D]."""
    D, me = size_of(grp), rank_of(grp)
    M = x_local.shape[0]
    N = packed_local.shape[1]
    nc = N // D
    parts = parts if nc % (parts * 128) == 0 else 1
    w = nc // parts
    recv = torch.empty(D - 1, parts, M, w, dtype=torch.float32, device=x_local.device)
    handles = [None] * parts
    reduced = []
    for s in range(D):
        c = (me + 1 + s) % D
        for j in range(parts):
            add = ring_wait(handles[j]) if s > 0 else None
            out = ring_chunk(x_local, packed_local, scale_t, zq_t, add, bits, group,
                             c * nc + j * w, w)
            if s < D - 1:
                handles[j] = ring_start(out, recv[s, j], grp)
            else:
                reduced.append(out)
    mine = torch.cat(reduced, dim=1) if parts > 1 else reduced[0]
    if not gather:
        return mine
    y = torch.empty(M, N, dtype=torch.float32, device=x_local.device)
    y[:, me * nc:(me + 1) * nc] = mine
    block = mine
    for t in range(D - 1):  # ring all-gather: pass each reduced chunk leftwards
        got = ring_wait(ring_start(block, torch.empty_like(block), grp))
        idx = (me + 1 + t) % D
        y[:, idx * nc:(idx + 1) * nc] = got
        block = got
    return y


def overlapped_row_parallel_dequant_matmul(x_local, packed_local, scales_local, zeros_local,
                                           group, *, bits: int, groupsize: int, qmin: int,
                                           gather: bool = True):
    """y[M, N] = x[M, K] @ dequant(packed)^T with K sharded over `group` (a
    torch.distributed group or a parallel.collectives.LocalGroup rank) and
    the ring reduce, and the optional all-gather, overlapped with the chunk
    products. Each rank passes its own shard: x_local [M, K/D], packed_local
    words-major [K/D * bits / 32, N], scales_local / zeros_local [K/D/g, N]
    (per-channel, groupsize <= 0: [1, N], the same on every rank). Returns f32
    [M, N] on every rank, or with gather=False this rank's reduced column
    chunk [M, N/D] (the reduce-scatter form). One rank (D = 1) takes the
    local packed matmul (ops.dequant_matmul.packed_matmul) and returns x's
    dtype, as the reference. Raises ValueError on shapes the ring cannot
    cut, as the reference."""
    D = size_of(group)
    M, k_local = x_local.shape
    N = packed_local.shape[1]
    K = k_local * D
    if D > 1 and N % (D * 128):
        raise ValueError(f"N={N} must split into {D} lane-aligned chunks")
    if not ring_ok(N, K, D, bits, groupsize):
        raise ValueError(f"K={K} does not ring-shard over {D} devices on whole "
                         f"words/groups (groupsize={groupsize})")
    g = groupsize if groupsize > 0 else k_local
    scale_t = scales_local.to(torch.float32).expand(k_local // g, N).contiguous()
    zq_t = (zeros_local.to(torch.float32) - float(qmin)).expand(k_local // g, N).contiguous()
    if D == 1:
        from ..ops.dequant_matmul import packed_matmul

        return packed_matmul(x_local, packed_local, scale_t, (-zq_t * scale_t).contiguous(),
                             bits, g)
    return ring_matmul(x_local, packed_local, scale_t, zq_t, group, bits=bits, group=g,
                       gather=gather)
