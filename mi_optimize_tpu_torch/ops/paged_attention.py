"""Paged flash decode: attention of one new token a slot over a float page
pool, read through the page table.

Kernel: csrc/paged_attention.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/paged_attention.py::_kernel (paged_flash_attention).
Slot b's row t lives on page table[b, t // P] at offset t % P; rows
t <= positions[b] are attended (the new row is already written). Only the
live pages j <= positions[b] // P are read, as the reference's live-page
clamp does.

What bounds it on an H100: the live k/v rows, read once (for Llama-2-7B one
layer at 1085 live rows over 4 slots, 35.6 MB of f32 pool), over the memory
rate, 3.35 TB/s. The kernel splits each slot's live rows across the card
(flash decoding): a work item is (slot, kv head, up to 8 of its q heads, a
chunk of `chunk_pages` pages), so one slot at a long position runs on the
whole card; an item reads its kv head's rows once for every q head it holds
(the GQA group); it streams them as slabs of `slab_rows` rows through a ring
of shared-memory stages by 16-byte cp.async, several slabs in flight; and it
keeps an online softmax in f32. The last item of a (slot, kv head) to finish
merges the chunks' partials in chunk order, so every launch gives the same
bits. `split_plan` sets the split from the shapes alone: the positions stay
on the card, and the grid holds every chunk of the table, the items past a
slot's live rows exiting at once. The partials and the arrival counters are
a workspace cached per device and shape (`_workspace`; the kernel leaves the
counters at 0), so launches that share it run on one stream, as the port's
do.

On CPU tensors the wrapper runs the plain version,
`paged_flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from .block_fused import _check_cuda

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_supported(page_size: int, head_dim: int) -> bool:
    return page_size % 8 == 0 and head_dim == 128


def paged_flash_attention_ref(q, pk, pv, table, positions, *, n_heads, n_kv_heads, head_dim,
                              page_size):
    """Plain PyTorch version: gather each slot's live pages, then masked GQA
    softmax attention in float32. Same signature and output as
    `paged_flash_attention`."""
    B = q.shape[0]
    reps = n_heads // n_kv_heads
    tbl = torch.as_tensor(table).to(q.device, torch.long)
    pos = [int(p) for p in torch.as_tensor(positions).reshape(-1).tolist()]
    out = []
    for b in range(B):
        n = pos[b] + 1
        pages = tbl[b, :-(-n // page_size)]
        k = pk[pages].reshape(-1, n_kv_heads, head_dim)[:n].to(torch.float32)
        v = pv[pages].reshape(-1, n_kv_heads, head_dim)[:n].to(torch.float32)
        qh = q[b].to(torch.float32).reshape(n_kv_heads, reps, head_dim)
        s = torch.einsum("grd,tgd->grt", qh, k) / float(head_dim) ** 0.5
        out.append(torch.einsum("grt,tgd->grd", torch.softmax(s, -1), v).reshape(-1))
    return torch.stack(out).to(q.dtype)


class _PagedArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "pk", "pv", "table", "pos", "out", "part",
                                               "count")] + [
        (n, ctypes.c_int) for n in ("batch", "n_heads", "n_kv_heads", "head_dim", "page_size",
                                    "pps", "chunk_pages", "n_chunks", "slab_rows", "n_sub")]


CHUNK_ROWS = 64   # rows of a work item's chunk (whole pages)
GROUP_MAX = 8     # q heads an item holds


def split_plan(n_heads, n_kv_heads, page_size, pps, chunk_pages=None):
    """The kernel's split, from the shapes alone: (chunk_pages, n_chunks,
    slab_rows, n_sub). A chunk is `chunk_pages` whole pages (CHUNK_ROWS rows
    by default), `n_chunks` cover the table's pps pages; a slab, the unit of
    the shared-memory ring, is the largest multiple of 8 rows, at most 32,
    that divides the page; a kv head's q heads go to `n_sub` items of at
    most GROUP_MAX heads."""
    cp = chunk_pages or max(1, CHUNK_ROWS // page_size)
    cp = min(cp, pps)
    sr = next(r for r in (32, 24, 16, 8) if page_size % r == 0)
    return cp, -(-pps // cp), sr, -(-(n_heads // n_kv_heads) // GROUP_MAX)


_workspaces = {}


def _workspace(dev, batch, n_heads, n_kv_heads, n_chunks, n_sub, head_dim):
    """(partials, counters) for a launch of these shapes on `dev`: f32
    [B*H, n_chunks, D] acc then [B*H, n_chunks, 2] (m, l), and int32 arrival
    counters [B, Hkv, n_sub], zeroed once (the kernel's last item of each
    resets its own). Cached per device and shape."""
    key = (str(dev), batch, n_heads, n_kv_heads, n_chunks, n_sub, head_dim)
    ws = _workspaces.get(key)
    if ws is None:
        rows = batch * n_heads * n_chunks
        ws = _workspaces[key] = (
            torch.empty(rows * (head_dim + 2), dtype=torch.float32, device=dev),
            torch.zeros(batch * n_kv_heads * n_sub, dtype=torch.int32, device=dev))
    return ws


def check_table(table, positions, n_slots, n_pages, page_size):
    """Host check of a page table [n_slots, pps] (every entry a page of the
    pool) and of the positions [n_slots] (each inside its slot's pps *
    page_size rows). Returns both as CPU int32 tensors."""
    tbl = torch.as_tensor(table).to("cpu", torch.int64)
    pos = torch.as_tensor(positions).reshape(-1).to("cpu", torch.int64)
    if (tbl.ndim != 2 or tbl.shape[0] != n_slots
            or bool(((tbl < 0) | (tbl >= n_pages)).any())):
        raise ValueError(f"table must be [{n_slots}, pages a slot] of pages inside the pool of "
                         f"{n_pages}")
    cap = tbl.shape[1] * page_size
    if pos.numel() != n_slots or bool(((pos < 0) | (pos >= cap)).any()):
        raise ValueError(f"positions {pos.tolist()} must be {n_slots} rows inside the slots' "
                         f"{cap} rows")
    return tbl.to(torch.int32), pos.to(torch.int32)


def _paged_flash_attention_cuda(q, pk, pv, table, positions, *, n_heads, n_kv_heads, head_dim,
                                page_size):
    global launches
    from . import _build

    dev = q.device
    if q.dtype not in _DTYPES or pk.dtype not in _DTYPES:
        raise TypeError(f"paged_flash_attention kernel takes float32 or bfloat16 q and pool, "
                        f"not {q.dtype} / {pk.dtype}")
    if not paged_attention_supported(page_size, head_dim) or n_heads % n_kv_heads:
        raise ValueError(f"page size {page_size}, head_dim {head_dim}, {n_heads} heads over "
                         f"{n_kv_heads}: outside the kernel's contract")
    B = q.shape[0]
    n_pages = pk.shape[0]
    _check_cuda("q", q, dev, shape=(B, n_heads * head_dim))
    for name, t in (("pk", pk), ("pv", pv)):
        _check_cuda(name, t, dev, pk.dtype, (n_pages, page_size, n_kv_heads, head_dim))
    if isinstance(table, torch.Tensor) and table.is_cuda:
        # already on the card: the caller checked them on the host (check_table)
        # and copied them once for all its launches
        tbl, pos = table, positions
        _check_cuda("table", tbl, dev, torch.int32, (B, tbl.shape[-1]))
        _check_cuda("positions", pos, dev, torch.int32, (B,))
    else:
        tbl, pos = (t.to(dev) for t in check_table(table, positions, B, n_pages, page_size))
    pps = tbl.shape[1]
    cp, n_chunks, sr, n_sub = split_plan(n_heads, n_kv_heads, page_size, pps)
    part, count = _workspace(dev, B, n_heads, n_kv_heads, n_chunks, n_sub, head_dim)
    out = torch.empty_like(q)
    p = lambda t: t.data_ptr()
    args = _PagedArgs(p(q), p(pk), p(pv), p(tbl), p(pos), p(out), p(part), p(count), B, n_heads,
                      n_kv_heads, head_dim, page_size, pps, cp, n_chunks, sr, n_sub)
    fn = _build.load("paged_attention").mi_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_PagedArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.byref(args), _DTYPES[q.dtype], _DTYPES[pk.dtype],
                    _build.stream_ptr(dev)), "paged_flash_attention")
    launches += 1
    return out


def paged_flash_attention(q, pk, pv, table, positions, *, n_heads, n_kv_heads, head_dim,
                          page_size):
    """q [B, H*D]; pk/pv [n_pages, P, Hkv, D]; table [B, pps] int32;
    positions [B] (row positions[b] must already be written). Returns the
    attention output [B, H*D] in q's dtype. The kernel on GPU tensors, the
    plain version on CPU tensors. The kernel checks a host table and
    positions itself; int32 ones already on the card are taken as they are,
    checked by the caller with `check_table` (a step calls this once a
    layer and copies them once)."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, page_size=page_size)
    if q.is_cuda:
        return _paged_flash_attention_cuda(q, pk, pv, table, positions, **kw)
    return paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
