"""Decode block megakernel: one decoder layer for one token in ONE launch.

It computes rmsnorm, the QKV dequant dot, RoPE, the new int8 k/v row and its
scales, attention over the int8 cache (live prefix only, seeded with the new
row), o_proj plus residual, rmsnorm, SwiGLU over gate/up/down, plus residual,
and replaces the TPU kernel mi_optimize_tpu/ops/block_fused.py::_kernel
(block_decode_mega). `block_route` picks its kernel on the card:

  * "mega4" (4-bit words, float32 or bfloat16: every served block): the
    whole-model kernel's tensor-core layer loop (csrc/model_mega4.cu over
    csrc/flat_model.cuh and csrc/flat_gemv.cuh, ops/model_fused.py's
    "mega4" route) at one layer, on a one-layer view of the block
    (`mega4_view`: its words, tables and norms as [1, ...] views, the
    per-layer cache [1, T, Hkv, D] as it is). Each GEMV is cut by
    `model_flat.flat_plan` to fill the card; a symmetric grid takes its
    bias from one zero constant, an asymmetric grid streams its tables.
    Under `block_decode_mega` the kernel writes the new k/v rows and
    scales into the cache itself, so that consecutive layers' launches
    follow each other with no copy between them.
  * "cuda_core" (2- and 8-bit words): csrc/block_fused.cu's
    block_decode_kernel (with csrc/decode_common.cuh), the five phases of
    one cooperative launch on the CUDA cores.

What bounds it on an H100: the layer's packed weights and scales, read once
(about 108 MB at Llama-2-7B width, int4 g128; 6 MB more for an asymmetric
grid's bias tables), over the memory rate. Both kernels are one cooperative
launch whose phases are separated by grid barriers, so nothing but the
packed words and a few f32 vectors that stay in L2 crosses device memory,
and a layer costs one launch instead of a dozen.

The reference's TPU layout tricks (the planar nibble permutation, the one-hot
scale selection, 8-row padding) do not come along: the kernels read the
natural words-major packed matrices and f32 [ngroups, N] scale and bias
tables (`prepare_block`). On CPU tensors the wrapper runs the plain version,
`block_decode_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict

import torch

from ..models.llama import quantize_kv
from ..models.quant_linear import group_size
from .dequant_matmul import kernel_tables, qdot_ref

launches = 0        # block_decode_mega launches, either route; chip_smoke.py resets and reads it
launches_mega4 = 0  # ... of them on the "mega4" route (csrc/model_mega4.cu at one layer)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LINEARS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def _lin_ok(lin, cfg) -> bool:
    if lin is None or lin.packed is None:
        return False
    if lin.bias is not None or lin.smooth_factor is not None:
        return False
    if lin.a_scale is not None or lin.perm is not None:
        return False
    s = lin.spec
    if s.wbit not in (2, 4, 8) or s.abit is not None:
        return False
    if s.w_qtype not in ("per_group", "per_channel"):
        return False
    g = group_size(lin)
    return g % (32 // s.wbit) == 0 and lin.in_features % g == 0


def block_mega_supported(blk: Dict[str, Any], cfg) -> bool:
    """Whether the one-launch decode kernel applies to this block."""
    if "qkv_proj" not in blk or "gateup_proj" not in blk:
        return False
    lins = [blk[n] for n in _LINEARS]
    if not all(_lin_ok(l, cfg) for l in lins):
        return False
    if len({l.spec.wbit for l in lins}) != 1:
        return False
    if cfg.rotary_dim not in (-1, cfg.head_dim) or cfg.rope_interleaved:
        return False
    # one warp lane per 32 head dims, one thread per dim in the RoPE step
    return cfg.head_dim % 32 == 0 and cfg.head_dim <= 256


def prepare_block(blk: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The four fused linears' kernel-layout f32 [ngroups, N] scale (`*s`)
    and dequant-bias (`*b`) tables: the tensors each linear keeps
    (`kernel_tables`), not copies."""
    out = {}
    for key, name in (("q", "qkv_proj"), ("o", "o_proj"), ("gu", "gateup_proj"),
                      ("d", "down_proj")):
        out[key + "s"], out[key + "b"] = kernel_tables(blk[name])
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _rope_rows(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[:, half:], x[:, :half]], dim=-1) * sin


def attend_ref(q, kq, ks, vq, vs, k_hist, ks_hist, v_hist, vs_hist, pos, n_kv_heads):
    """Attention of q [H, D] over the int8 history rows t < pos plus the new
    (dequantized) row. Returns f32 [H*D]."""
    H, D = q.shape
    reps = H // n_kv_heads
    kd = kq.to(torch.float32) * ks[:, None]
    vd = vq.to(torch.float32) * vs[:, None]
    k_all = torch.cat([k_hist[:pos].to(torch.float32) * ks_hist[:pos, :, None], kd[None]], 0)
    v_all = torch.cat([v_hist[:pos].to(torch.float32) * vs_hist[:pos, :, None], vd[None]], 0)
    qh = q.reshape(n_kv_heads, reps, D)
    scores = torch.einsum("grd,tgd->grt", qh, k_all) * (1.0 / float(D) ** 0.5)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("grt,tgd->grd", p, v_all).reshape(H * D)


def norm_row(xf, w, eps, dtype):
    """rms_norm over the last axis with the model-dtype rounding points of the
    decode kernels: ((x*rstd).to(dtype) * w.to(dtype)).to(f32)."""
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return ((xf * rstd).to(dtype) * w.to(dtype)).to(torch.float32)


def layer_rows_ref(x32, dtype, lin, tabs, n1, n2, cos, sin, hists, positions, cfg,
                   pre: bool = False):
    """One decoder layer for B tokens, one per slot, on the plain path.
    x32: f32 [B, h] residual rows. lin: packed words (qkv, o, gu, d); tabs:
    (scale, bias) per linear; cos/sin: [B, D]; hists[b]: slot b's
    (k, k_scale, v, v_scale) history [T, Hkv(, D)], or a function of this
    layer's new rows (kq, ks, vq, vs) that returns that list (a chunk's rows
    also attend to the rows before them); positions[b]: its
    position. Returns (x_out f32 [B, h], krows [B, Hkv, D] int8, ks [B, Hkv],
    vrows, vs), and with `pre` also the k and v values the int8 rows round
    (`quantize_kv`'s x / scale, f32 [B, Hkv, D])."""
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qdim, kvdim, inter = H * D, Hkv * D, cfg.intermediate_size
    bits, groups = lin["bits"], lin["groups"]
    B = x32.shape[0]

    def dot(rows, name):
        s, b = tabs[name]
        return qdot_ref(rows, lin[name], s, b, bits, groups[name])

    h = norm_row(x32, n1, cfg.rms_eps, dtype)
    qkv = dot(h, "qkv")
    k = torch.stack([_rope_rows(qkv[b, qdim:qdim + kvdim].reshape(Hkv, D), cos[b], sin[b])
                     for b in range(B)])
    v = qkv[:, qdim + kvdim:].reshape(B, Hkv, D)
    kq, ks = quantize_kv(k[:, None])
    vq, vs = quantize_kv(v[:, None])
    kq, ks, vq, vs = kq[:, 0], ks[:, 0], vq[:, 0], vs[:, 0]
    if callable(hists):
        hists = hists(kq, ks, vq, vs)
    attn = torch.stack([
        attend_ref(_rope_rows(qkv[b, :qdim].reshape(H, D), cos[b], sin[b]), kq[b], ks[b],
                   vq[b], vs[b], *hists[b], positions[b], Hkv)
        for b in range(B)])
    xmid = x32 + dot(attn, "o")
    h2 = norm_row(xmid, n2, cfg.rms_eps, dtype)
    gu = dot(h2, "gu")
    g, u = gu[:, :inter], gu[:, inter:]
    act = g * (1.0 / (1.0 + torch.exp(-g))) * u
    out = (xmid + dot(act, "d"), kq, ks, vq, vs)
    return out + (k / ks[..., None], v / vs[..., None]) if pre else out


def layer_ref(x32, dtype, lin, tabs, n1, n2, cos, sin, hist, pos, cfg, pre: bool = False):
    """One decoder layer for one token on the plain path (`layer_rows_ref`
    at B = 1). x32: f32 [h]; hist: (k, k_scale, v, v_scale) history
    [T, Hkv(, D)]. Returns (x_out f32 [h], krow, ks, vrow, vs), and with
    `pre` the k and v values before rounding."""
    out = layer_rows_ref(x32[None], dtype, lin, tabs, n1, n2, cos[None], sin[None], [hist],
                         [pos], cfg, pre)
    return tuple(t[0] for t in out)


def _block_lin(blk, mega):
    lin = {"qkv": blk["qkv_proj"].packed, "o": blk["o_proj"].packed,
           "gu": blk["gateup_proj"].packed, "d": blk["down_proj"].packed,
           "bits": blk["qkv_proj"].spec.wbit,
           "groups": {k: group_size(blk[n]) for k, n in
                      (("qkv", "qkv_proj"), ("o", "o_proj"), ("gu", "gateup_proj"),
                       ("d", "down_proj"))}}
    tabs = {k: (mega[k + "s"], mega[k + "b"]) for k in ("q", "o", "gu", "d")}
    tabs["qkv"] = tabs.pop("q")
    return lin, tabs


def block_decode_ref(blk, mega, x, cos, sin, cache, pos: int, cfg, pre: bool = False):
    """Plain PyTorch version of the kernel. x [1,1,h] -> (x_out [1,h] in x's
    dtype, krow [Hkv,D] int8, vrow, ks [Hkv] f32, vs), and with `pre` also
    the k and v values the rows round (x / scale, f32 [Hkv, D])."""
    lin, tabs = _block_lin(blk, mega)
    hist = (cache["k"][0], cache["k_scale"][0], cache["v"][0], cache["v_scale"][0])
    xo, kq, ks, vq, vs, *kv = layer_ref(
        x.reshape(-1).to(torch.float32), x.dtype, lin, tabs, blk["input_norm"],
        blk["post_norm"], cos.to(torch.float32), sin.to(torch.float32), hist, pos, cfg, pre)
    return (xo.to(x.dtype)[None], kq, vq, ks, vs, *kv)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class _BlockArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "n1", "n2", "qkv", "qs", "qb", "o", "os", "ob", "gu", "gus", "gub",
        "dn", "ds", "db", "cos", "sin", "ck", "cv", "cks", "cvs",
        "x_out", "krow", "vrow", "ks", "vs", "scratch")] + [
        (n, ctypes.c_int) for n in (
            "hidden", "n_heads", "n_kv_heads", "head_dim", "inter", "pos",
            "g_qkv", "g_o", "g_gu", "g_d")] + [("eps", ctypes.c_float)]


def _check_cuda(name, t, dev, dtype=None, shape=None):
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, not {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, not {tuple(t.shape)}")


def block_route(bits: int, dtype) -> str:
    """The kernel `block_decode_mega` takes on the card: "mega4" (the
    whole-model kernel's tensor-core layer loop at one layer,
    csrc/model_mega4.cu) for 4-bit words in float32 or bfloat16;
    "cuda_core" (block_decode_kernel on the CUDA cores, csrc/block_fused.cu)
    for 2- and 8-bit words, which csrc/flat_gemv.cuh does not unpack."""
    return "mega4" if bits == 4 and dtype in _DTYPES else "cuda_core"


@dataclasses.dataclass
class Mega4View:
    """A block as a one-layer stack in `serving.megadecode.stack_serving`'s
    layout, and what its "mega4" launches take that no launch changes."""
    stack: Dict[str, torch.Tensor]  # [1, ...] views of the block's words, tables and norms
    meta: tuple                     # (bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d)
    cfg: Any                        # the model's config at one layer
    prep: Any                       # ops/model_fused.MegaLaunch


def mega4_view(blk, mega, cfg, dt) -> Mega4View:
    """The block's one-layer view for the "mega4" route in model dtype dt,
    made at its first launch in dt and kept in mega["mega4"][dt]: the
    block's packed words, `mega`'s scale tables and its norms as [1, ...]
    views, nothing copied (a norm held in another dtype than dt is
    converted here, once); meta as `stack_serving` makes it for this one
    layer: a linear whose zero is one constant (a symmetric grid,
    `megadecode._zconst`) takes -zc*s in the kernel and passes no bias
    table, the others pass `mega`'s; and the launch's fixed fields with
    the plan, `model_flat.flat_plans` without the lm_head for the card's
    SMs."""
    views = mega.setdefault("mega4", {})
    if dt in views:
        return views[dt]
    if not block_mega_supported(blk, cfg):
        raise ValueError("block does not meet the decode kernel's contract")
    from ..serving.megadecode import _zconst
    from .model_fused import _STACKED, mega_prepare

    lins = [blk[n] for n in _LINEARS]
    zcs = tuple(_zconst([blk], n) for n in _LINEARS)
    meta = (lins[0].spec.wbit,) + tuple(group_size(l) for l in lins) + zcs
    stack = {"n1": blk["input_norm"].to(dt).reshape(1, -1),
             "n2": blk["post_norm"].to(dt).reshape(1, -1)}
    for (wk, sk, zk, _), key, lin, zc in zip(_STACKED, ("q", "o", "gu", "d"), lins, zcs):
        stack[wk] = lin.packed[None]
        stack[sk] = mega[key + "s"][None]
        if zc is None:
            stack[zk] = mega[key + "b"][None]
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    views[dt] = Mega4View(stack, meta, cfg1,
                          mega_prepare(stack, cfg1, meta, lins[0].packed.device, dt))
    return views[dt]


def _block_decode_cuda(blk, mega, x, cos, sin, cache, pos: int, cfg, in_place=False):
    """The kernel `block_route` picks. in_place: the "mega4" kernel writes
    the new rows and scales into the cache at pos itself (its attention
    reads only the history rows t < pos), and the rows returned are views
    of the cache."""
    global launches, launches_mega4
    from . import _build

    dev, dt = x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"block_decode_mega kernel takes float32 or bfloat16, not {dt}")
    B, T = cache["k"].shape[:2]
    if B != 1:
        raise ValueError(f"the decode kernel takes a batch-1 cache, not batch {B}")
    if not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache of {T} rows")
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qdim, kvdim, inter = H * D, Hkv * D, cfg.intermediate_size
    xr = x.reshape(h).contiguous()
    cos = cos.to(torch.float32).contiguous()
    sin = sin.to(torch.float32).contiguous()
    for name, t, n in (("cos", cos, D), ("sin", sin, D)):
        _check_cuda(name, t, dev, shape=(n,))
    for name, f, want, shape in (
            ("k cache", "k", torch.int8, (1, T, Hkv, D)),
            ("v cache", "v", torch.int8, (1, T, Hkv, D)),
            ("k scales", "k_scale", torch.float32, (1, T, Hkv)),
            ("v scales", "v_scale", torch.float32, (1, T, Hkv))):
        _check_cuda(name, cache[f], dev, want, shape)
    if block_route(blk["qkv_proj"].spec.wbit, dt) == "mega4":
        # the batch-1 cache [1, T, Hkv, D] is the one-layer stacked cache
        from .model_fused import mega_launch

        rows = (tuple(cache[f][:, pos] for f in ("k", "v", "k_scale", "v_scale"))
                if in_place else None)
        x_out, krow, vrow, ks, vs = mega_launch(mega4_view(blk, mega, cfg, dt).prep, xr, cos,
                                                sin, cache, pos, rows)
        launches_mega4 += 1
        launches += 1
        return x_out[None], krow[0], vrow[0], ks[0], vs[0]

    if not block_mega_supported(blk, cfg):
        raise ValueError("block does not meet the decode kernel's contract")
    n1 = blk["input_norm"].to(dt).contiguous()
    n2 = blk["post_norm"].to(dt).contiguous()
    for name, t in (("input norm", n1), ("post norm", n2)):
        _check_cuda(name, t, dev, shape=(h,))
    lins = [blk[n] for n in _LINEARS]
    vpw = 32 // lins[0].spec.wbit
    for l, n_out, k_in in zip(lins, (qdim + 2 * kvdim, h, 2 * inter, h), (h, qdim, h, inter)):
        _check_cuda("packed weight", l.packed, dev, torch.int32, (k_in // vpw, n_out))
    for key, l in zip(("q", "o", "gu", "d"), lins):
        shape = (l.in_features // group_size(l), l.out_features)
        _check_cuda(f"mega[{key}s]", mega[key + "s"], dev, torch.float32, shape)
        _check_cuda(f"mega[{key}b]", mega[key + "b"], dev, torch.float32, shape)

    x_out = torch.empty(h, dtype=dt, device=dev)
    krow = torch.empty(Hkv, D, dtype=torch.int8, device=dev)
    vrow = torch.empty_like(krow)
    ks = torch.empty(Hkv, dtype=torch.float32, device=dev)
    vs = torch.empty_like(ks)
    scratch = torch.empty(h + qdim + 2 * kvdim + qdim + h + inter, dtype=torch.float32,
                          device=dev)
    p = lambda t: t.data_ptr()
    args = _BlockArgs(
        p(xr), p(n1), p(n2),
        p(lins[0].packed), p(mega["qs"]), p(mega["qb"]),
        p(lins[1].packed), p(mega["os"]), p(mega["ob"]),
        p(lins[2].packed), p(mega["gus"]), p(mega["gub"]),
        p(lins[3].packed), p(mega["ds"]), p(mega["db"]),
        p(cos), p(sin), p(cache["k"]), p(cache["v"]), p(cache["k_scale"]), p(cache["v_scale"]),
        p(x_out), p(krow), p(vrow), p(ks), p(vs), p(scratch),
        h, H, Hkv, D, inter, pos, *(group_size(l) for l in lins), cfg.rms_eps)
    fn = _build.load("block_fused").mi_block_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_BlockArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(ctypes.byref(args), lins[0].spec.wbit, _DTYPES[dt], _build.stream_ptr(dev))
    _build.check(err, "block_decode_mega")
    launches += 1
    return x_out[None], krow, vrow, ks, vs


def block_decode_rows(blk, mega, x, cos, sin, cache, pos: int, cfg):
    """(x_out [1,h], krow, vrow, ks, vs): the kernel `block_route` picks on
    GPU tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return _block_decode_cuda(blk, mega, x, cos, sin, cache, pos, cfg)
    return block_decode_ref(blk, mega, x, cos, sin, cache, pos, cfg)


def block_decode_mega(blk, mega, x, cos, sin, cache, pos: int, cfg):
    """One decoder block, one launch. x [1,1,h] -> (x_out like x, cache).

    The cache is read by the kernel; the new int8 row and scales are
    written into it in place at `pos`: on the "mega4" route by the kernel
    itself, else scattered after it."""
    if x.is_cuda and block_route(blk["qkv_proj"].spec.wbit, x.dtype) == "mega4":
        x_out = _block_decode_cuda(blk, mega, x, cos, sin, cache, pos, cfg, in_place=True)[0]
        return x_out.reshape(x.shape), cache
    x_out, krow, vrow, ks, vs = block_decode_rows(blk, mega, x, cos, sin, cache, pos, cfg)
    cache["k"][0, pos] = krow
    cache["v"][0, pos] = vrow
    cache["k_scale"][0, pos] = ks
    cache["v_scale"][0, pos] = vs
    return x_out.reshape(x.shape), cache
