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
column window of a step's chunk in f32, the dequant as `_dequant_chunk`
writes it, (q - (zero - qmin)) * s, and adds the received partial in its
epilogue. The TPU kernel sends with remote DMAs from inside the kernel;
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

import torch

from .collectives import ring_start, ring_wait, size_of, rank_of

launches = 0  # ring_chunk kernel launches; chip_smoke.py resets and reads it

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


def ring_chunk(x, packed, scale_t, zq_t, add, bits: int, group: int, col0: int, nc: int):
    """One window of a ring step: f32 [M, nc] = add + x @ W[:, col0:col0+nc]
    (`ring_chunk_ref`). The kernel on GPU tensors (x f32 or bf16 [M, K],
    packed int32, tables f32, add f32 or None), the plain version on CPU
    tensors."""
    if not x.is_cuda:
        return ring_chunk_ref(x, packed, scale_t, zq_t, add, bits, group, col0, nc)
    global launches
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
    x = x.contiguous()
    _check_cuda("packed", packed, dev, torch.int32, (K * bits // 32, N))
    _check_cuda("scale_t", scale_t, dev, torch.float32, (K // group, N))
    _check_cuda("zq_t", zq_t, dev, torch.float32, (K // group, N))
    if add is not None:
        _check_cuda("add", add, dev, torch.float32, (M, nc))
    y = torch.empty(M, nc, dtype=torch.float32, device=dev)
    fn = _build.load("overlap").mi_ring_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), packed.data_ptr(), scale_t.data_ptr(), zq_t.data_ptr(),
             None if add is None else add.data_ptr(), y.data_ptr(), M, N, K, bits, group, col0,
             nc, _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check(err, "ring_chunk")
    launches += 1
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
