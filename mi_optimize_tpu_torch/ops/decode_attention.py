"""Decode attention of one token over the int8 KV cache: RoPE, the new k/v
row quantized and appended in place, and masked GQA softmax attention.

Kernel: csrc/decode_attention.cu, which replaces the TPU kernel
mi_optimize_tpu/ops/decode_attention.py::_kernel (fused_decode_attention).
`models.llama.block_apply` takes it for a single-token, batch-1 step with a
scalar position, an int8 dict cache and full split-half rotary, where no
block megakernel applies, as the reference does on a TPU.

What bounds it on an H100: the live history (rows t <= pos of the int8 cache
and its scales), read once, over the memory rate, 3.35 TB/s (for Llama-2-7B
one layer at pos 2047, 17.3 MB). The kernel splits the live rows across the
card (flash decoding): a work item is (chunk of `chunk_rows` rows, kv head,
up to 8 of its q heads), so one layer at a long position runs on the whole
card; an item reads its kv head's rows once for every q head it holds (the
GQA group); it streams them as slabs of SLAB_ROWS rows (codes and scales)
through a ring of shared-memory stages by cp.async, several slabs in flight;
and it keeps an online softmax in f32 (at head_dim 128, a quarter of a warp
a row). The last item of a (kv head, sub-group) to finish merges the
chunks' partials in chunk order, so every launch gives the same bits.
`split_plan` sets the split from the shapes and `pos`, a host int: the grid
holds exactly the live chunks. The partials and the arrival counters are a
workspace cached per device and shape (`_workspace`, sized for the most
chunks any position below `max_len` fills; the kernel leaves the counters
at 0), so launches that share it run on one stream, as the port's do. The
new row is made where it is attended: the items of the chunk that
holds row `pos` rope and quantize their kv head's new row, the sub-group-0
item writes it into the cache, and each takes it, as its own codes and
scale, as its chunk's last row; no item reads row `pos` from memory.

The new row's codes and scales are bit-equal between the kernel and the
plain version `fused_decode_attention_ref`, and equal to the reference's on
the CPU: the same IEEE operations in the order XLA's CPU backend runs the
reference kernel (RoPE as fma(x, cos, rot*sin), the scale amax * f32(1/127),
see `models.llama.KV_RCP`, the codes as correctly rounded quotients); the attention
output agrees to f32 rounding (the sums run in another order). On CPU
tensors the wrapper runs the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.llama import KV_RCP
from .block_fused import _check_cuda

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_supported(head_dim: int) -> bool:
    """The kernel's own contract on the head width (a lane reads 4 codes at a
    time and holds at most 8 of a row)."""
    return head_dim % 4 == 0 and 4 <= head_dim <= 256


def _rope_rows(x, cos, sin):
    """x [H, D] f32; cos/sin [D] f32 split-half tables. x*cos + rot*sin as
    the reference's kernel computes it on XLA's CPU backend and this kernel
    does: rot*sin rounded, then one fused multiply-add, fma(x, cos, rot*sin)
    (emulated in float64, where x*cos is exact)."""
    half = x.shape[-1] // 2
    rs = torch.cat([-x[:, half:], x[:, :half]], dim=-1) * sin
    return (x.to(torch.float64) * cos.to(torch.float64) + rs.to(torch.float64)).to(torch.float32)


def _quantize_rows(x):
    """Per-head int8 codes and scales of a new row x [H, D] f32."""
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    s = amax * KV_RCP
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s[:, 0]


def fused_decode_attention_ref(q, k, v, cos, sin, cache_k, cache_v, k_scale, v_scale, pos, *,
                               n_heads, n_kv_heads, head_dim, max_len):
    """Plain PyTorch version, the same signature and results as
    `fused_decode_attention`: the cache is written in place at row `pos` and
    returned."""
    pos = int(pos)
    D = head_dim
    cos = cos.reshape(-1)[-D:].to(torch.float32)
    sin = sin.reshape(-1)[-D:].to(torch.float32)
    qr = _rope_rows(q.reshape(n_heads, D).to(torch.float32), cos, sin)
    kr = _rope_rows(k.reshape(n_kv_heads, D).to(torch.float32), cos, sin)
    kq, ks = _quantize_rows(kr)
    vq, vs = _quantize_rows(v.reshape(n_kv_heads, D).to(torch.float32))
    cache_k[pos] = kq
    cache_v[pos] = vq
    k_scale[pos] = ks
    v_scale[pos] = vs
    n = pos + 1  # rows past pos are masked to exactly 0 weight in the reference
    k_all = cache_k[:n].to(torch.float32) * k_scale[:n, :, None]
    v_all = cache_v[:n].to(torch.float32) * v_scale[:n, :, None]
    reps = n_heads // n_kv_heads
    qg = qr.reshape(n_kv_heads, reps, D)
    s = torch.einsum("grd,tgd->grt", qg, k_all) * (1.0 / float(D) ** 0.5)
    out = torch.einsum("grt,tgd->grd", torch.softmax(s, dim=-1), v_all)
    return out.reshape(1, n_heads * D), cache_k, cache_v, k_scale, v_scale


class _DecodeAttnArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "k", "v", "cos", "sin", "ck", "cv", "ks",
                                                "vs", "out", "part", "count")] + [
        (n, ctypes.c_int) for n in ("n_heads", "n_kv_heads", "head_dim", "max_len", "pos",
                                    "chunk_rows", "n_chunks", "group")]


SLAB_ROWS = 32    # rows of a slab, the unit of the kernel's shared-memory ring (its SR)
CHUNK_MIN = SLAB_ROWS  # rows of a work item's chunk at the least: one slab
LIVE_CHUNKS = 16  # chunks the live rows are cut into at the most
GROUP_MAX = 8     # q heads an item holds (half as many above head_dim 128)


def split_plan(n_heads, n_kv_heads, head_dim, max_len, pos, chunk_rows=None):
    """The kernel's split, from the shapes and the position alone:
    (chunk_rows, n_live, n_chunks, group, n_sub). A chunk is the smallest
    power of two of rows, CHUNK_MIN at the least, that cuts rows 0..pos into
    at most LIVE_CHUNKS chunks (Llama-2-7B at position 200: 32 rows, 7
    chunks; at 2047: 128 rows, 16 chunks), unless `chunk_rows` (a multiple
    of SLAB_ROWS) fixes it; the grid holds the `n_live` chunks that rows
    0..pos fill, and the workspace `n_chunks`, the most that any position
    below `max_len` fills. A kv head's q heads go to `n_sub` items of
    `group` heads, GROUP_MAX at the most (half as many above head_dim 128,
    where a lane holds twice the values); the kernel takes `group` and
    finds `n_sub` from it."""
    if chunk_rows:
        cr, n_chunks = chunk_rows, -(-max_len // chunk_rows)
    else:
        cr = max(CHUNK_MIN, 1 << (-(-(pos + 1) // LIVE_CHUNKS) - 1).bit_length())
        n_chunks = min(LIVE_CHUNKS, -(-max_len // CHUNK_MIN))
    reps = n_heads // n_kv_heads
    group = min(reps, GROUP_MAX if head_dim <= 128 else GROUP_MAX // 2)
    return cr, pos // cr + 1, n_chunks, group, -(-reps // group)


_workspaces = {}


def _workspace(dev, n_heads, n_kv_heads, n_chunks, n_sub, head_dim):
    """(partials, counters) for a launch of these shapes on `dev`: f32
    [H, n_chunks, D] acc then [H, n_chunks, 2] (m, l), and int32 arrival
    counters [Hkv, n_sub], zeroed once (the kernel's last item of each
    resets its own). Cached per device and shape."""
    key = (str(dev), n_heads, n_kv_heads, n_chunks, n_sub, head_dim)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = (
            torch.empty(n_heads * n_chunks * (head_dim + 2), dtype=torch.float32, device=dev),
            torch.zeros(n_kv_heads * n_sub, dtype=torch.int32, device=dev))
    return ws


def _fused_decode_attention_cuda(q, k, v, cos, sin, cache_k, cache_v, k_scale, v_scale, pos, *,
                                 n_heads, n_kv_heads, head_dim, max_len):
    global launches
    from . import _build

    dev = q.device
    D = head_dim
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                        f"not {q.dtype} / {k.dtype} / {v.dtype}")
    if not decode_attention_supported(D) or n_heads % n_kv_heads:
        raise ValueError(f"head_dim {D}, {n_heads} heads over {n_kv_heads}: outside the "
                         f"kernel's contract")
    pos = int(pos)
    if not 0 <= pos < max_len:
        raise ValueError(f"position {pos} outside the cache's {max_len} rows")
    q, k, v = (t.reshape(1, -1).contiguous() for t in (q, k, v))
    _check_cuda("q", q, dev, shape=(1, n_heads * D))
    _check_cuda("k", k, dev, shape=(1, n_kv_heads * D))
    _check_cuda("v", v, dev, shape=(1, n_kv_heads * D))
    cos = cos.reshape(-1)[-D:].to(torch.float32).contiguous()
    sin = sin.reshape(-1)[-D:].to(torch.float32).contiguous()
    _check_cuda("cos", cos, dev)
    _check_cuda("sin", sin, dev)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_cuda(name, t, dev, torch.int8, (max_len, n_kv_heads, D))
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_cuda(name, t, dev, torch.float32, (max_len, n_kv_heads))
    cr, _, n_chunks, group, n_sub = split_plan(n_heads, n_kv_heads, D, max_len, pos)
    part, count = _workspace(dev, n_heads, n_kv_heads, n_chunks, n_sub, D)
    out = torch.empty(1, n_heads * D, dtype=torch.float32, device=dev)
    p = lambda t: t.data_ptr()
    args = _DecodeAttnArgs(p(q), p(k), p(v), p(cos), p(sin), p(cache_k), p(cache_v),
                           p(k_scale), p(v_scale), p(out), p(part), p(count), n_heads, n_kv_heads,
                           D, max_len, pos, cr, n_chunks, group)
    fn = _build.load("decode_attention").mi_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_DecodeAttnArgs), ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.byref(args), _DTYPES[q.dtype], _build.stream_ptr(dev)),
                 "decode_attention")
    launches += 1
    return out, cache_k, cache_v, k_scale, v_scale


def fused_decode_attention(q, k, v, cos, sin, cache_k, cache_v, k_scale, v_scale, pos, *,
                           n_heads, n_kv_heads, head_dim, max_len):
    """q [1, Hq*D], k/v [1, Hkv*D]; cos/sin the position's [D] split-half
    tables; cache_k/v int8 [T, Hkv, D] and k/v_scale f32 [T, Hkv] (T =
    max_len), written in place at row `pos`. Returns (out [1, Hq*D] f32,
    cache_k, cache_v, k_scale, v_scale). The kernel on GPU tensors, the
    plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim, max_len=max_len)
    if q.is_cuda:
        return _fused_decode_attention_cuda(q, k, v, cos, sin, cache_k, cache_v, k_scale,
                                            v_scale, pos, **kw)
    return fused_decode_attention_ref(q, k, v, cos, sin, cache_k, cache_v, k_scale, v_scale,
                                      pos, **kw)
