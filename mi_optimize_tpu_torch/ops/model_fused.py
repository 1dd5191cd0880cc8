"""Whole-model decode without the lm_head: every decoder layer in ONE launch,
for one token (`model_decode_mega`) or for B rows at their own positions
(`model_decode_mega_batch`: the continuous-batching step, its paged and
chunk modes).

Kernels: csrc/model_fused.cu (with csrc/decode_common.cuh) and, for the
one-token kernel with 4-bit words, csrc/model_mega4.cu (with
csrc/flat_gemv.cuh), which replace the TPU kernels
mi_optimize_tpu/ops/model_fused.py::_kernel (model_decode_mega) and
::_kernel_b in its modes (a) batched decode, (b)
paged (a page table picks each history row's pool page), (c) chunk (C
consecutive tokens a slot with an intra-chunk causal pass) and (d) terminal
lm rows (every row's final rmsnorm, packed lm_head logits and first-index
argmax after the last layer), alone or combined (model_decode_mega_batch).
The tensor-parallel mode (e) of _kernel_b is not ported: the batched
wrapper raises NotImplementedError for it.

What bounds them on an H100: the stacked packed weights (about 3.4 GB at
Llama-2-7B, int4 g128) read once per step over the memory rate, plus every
slot's live KV history. The one-token kernel keeps the residual in f32
across all layers. With 4-bit words (`mega_route`: "mega4") it runs the
flat decode kernel's tensor-core layer loop without the lm_head
(csrc/model_mega4.cu: each GEMV cut by `model_flat.flat_plan` to fill the
card, an asymmetric grid's bias tables streamed beside the scales); with
2- and 8-bit words ("cuda_core") the layers of the per-layer decode kernel
back to back. The batched kernel reads each packed word once per step for all B
rows, so a step costs about one weight read however many rows it decodes.
With 4-bit words its GEMVs run on the tensor cores (csrc/batch_gemv.cuh:
the reference's grouped rescale, the rows as an n8 mma operand in exact
bf16 planes), each cut into (column tile x K split) items by `gemv_plan`
so that one wave fills the card; with 2- and 8-bit words a lane keeps B
accumulators on the CUDA cores. Paging changes only the history rows'
addresses, so the paged step moves the dense step's bytes. The lm rows add
the lm_head's words and scales.

Grids: a linear whose zero is one constant across the model computes its
bias -zc*s in-kernel; otherwise `serving.megadecode.stack_serving` stacks
its f32 bias table ("qz", "oz", "guz", "dz") and the kernel streams it.

On CPU tensors the wrappers run the plain versions, `model_decode_mega_ref`
and `model_decode_mega_batch_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Optional

import torch

from .block_fused import _check_cuda, layer_rows_ref, norm_row
from .coop_plan import COOP_PER_SM, H100_SMS, best_plan, sm_count
from .dequant_matmul import qdot_ref
from .model_flat import _FlatArgs, flat_plans, flat_scratch

launches = 0        # model_decode_mega launches, either route; chip_smoke.py resets and reads it
launches_mega4 = 0  # ... of them on the "mega4" route (csrc/model_mega4.cu)
launches_batch = 0  # model_decode_mega_batch launches in mode (a), dense one-token rows
launches_paged = 0  # ... in mode (b) with one token a slot (paged decode)
launches_chunk = 0  # ... in mode (c), dense or paged (C > 1 tokens a slot)
launches_lm = 0     # ... with the terminal lm rows, mode (d) (also counted in its mode above)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 8  # rows (slots x chunk tokens): the batched kernel keeps one accumulator a row
_MAX_BLOCKS = 1024  # cap on the cooperative grid (the lm rows' per-block argmax slots)
# The 4-bit GEMV's geometry (csrc/batch_gemv.cuh): k a staged window holds,
# m16 tiles a warp strip, output columns a strip (NC = 2: half gate, half
# up), warps a block, f32 partials of a strip, GEMVs a plan (qkv, o,
# gate/up, down, lm_head). The plan and the scratch sizes below follow
# them; the kernel's dispatch counts each plan's tiles and partials with its
# own (bg_tiles, bg_part_floats) and refuses a scratch they do not fit.
GEMV_KC, GEMV_TILES, GEMV_WARPS, GEMV_PHASES = 1024, 2, 8, 5
GEMV_STRIP, GEMV_PART = 16 * GEMV_TILES, 32 * 4 * GEMV_TILES
# The plan's cost model, in word rows a warp streams (32 columns x 4 bytes
# each): an item's fixed cost (its barriers within the block, partials and
# counter), a split's partials read back; a staged window costs a word row
# for each of its word rows (on the H100 staging a window took about as long
# a block as streaming as many word rows: PERF.md).
GEMV_ITEM_ROWS, GEMV_SPLIT_ROWS = 32, 0.5
# (stack key of the words, of the scale table, of the bias table, meta index of the group)
_STACKED = (("qkv", "qs", "qz", 1), ("o", "os", "oz", 2), ("gu", "gus", "guz", 3),
            ("d", "ds", "dz", 4))


def _layer(stack, meta, l):
    """(lin, tabs) of layer l for `layer_rows_ref`: the packed words and the
    (scale, bias) tables, the bias from the stacked table where the zero is
    not constant, else -zc*scale."""
    bits = meta[0]
    lin = {"bits": bits, "groups": {}}
    tabs = {}
    for (wk, sk, zk, gi), zc in zip(_STACKED, meta[5:]):
        lin[wk] = stack[wk][l]
        lin["groups"][wk] = meta[gi]
        s = stack[sk][l]
        tabs[wk] = (s, stack[zk][l] if zc is None else s * (-zc))
    return lin, tabs


def model_decode_mega_ref(stack, x, cos, sin, cache, pos: int, cfg, meta, pre: bool = False):
    """Plain PyTorch version of the one-token kernel (same signature and
    outputs as `model_decode_mega`); with `pre` also the k and v values
    each layer's int8 rows round (x / scale, f32 [L, Hkv, D])."""
    D = cfg.head_dim
    xo, *rows = model_decode_mega_batch_ref(
        stack, x.reshape(1, 1, -1), cos.reshape(1, D), sin.reshape(1, D),
        {f: cache[f][:, None].transpose(2, 3) for f in ("k", "v", "k_scale", "v_scale")},
        [pos], cfg, meta, pre=pre)
    return (xo.reshape(x.shape),) + tuple(r[:, 0] for r in rows)


def _history(cache, l, s, table, n):
    """The first n history rows of slot s in layer l as (k, k_scale, v,
    v_scale) [n, Hkv(, D)]: from the head-transposed cache [L, S, Hkv, T(, D)],
    or with a page table from the pool [L, n_pages, Hkv, P(, D)], row t on
    page table[s, t // P] at offset t % P (only the pages the rows use are
    gathered)."""
    out = []
    for f in ("k", "k_scale", "v", "v_scale"):
        c = cache[f][l]
        if table is None:
            out.append(c[s].transpose(0, 1)[:n])
        else:
            pages = table[s, :-(-n // c.shape[2])].to(device=c.device, dtype=torch.long)
            out.append(c[pages].transpose(1, 2).flatten(0, 1)[:n])
    return tuple(out)


def model_decode_mega_batch_ref(stack, x, cos, sin, cache, positions, cfg, meta, table=None,
                                chunk: int = 1, lm=None, lm_meta=None, pre: bool = False):
    """Plain PyTorch version of the batched kernel (same signature and
    outputs as `model_decode_mega_batch`, modes (a)-(d)).

    Row r = s*C + i is token i of slot s's chunk (C = chunk; C = 1: one token
    a slot). It attends to its slot's history rows t < prefix = positions[s*C]
    (gathered through `table` when paged), then to the quantized new rows
    0..i-1 of its own chunk, then to its own row: position prefix + i. With
    `lm`, every row's f32 residual after the last layer goes through the
    final rmsnorm (the model-dtype rounding points) and the packed lm_head,
    and the first index of each row's maximum is its token. With `pre` the
    outputs gain, after the new rows' scales, the k and v values the rows
    round (x / scale, f32 [L, B, Hkv, D])."""
    B, h, D, L = x.shape[0], cfg.hidden_size, cfg.head_dim, cfg.num_layers
    C = chunk
    pos = [int(p) for p in torch.as_tensor(positions).reshape(-1).tolist()]
    prefix = [pos[s * C] for s in range(B // C)]
    cos = cos.reshape(B, D).to(torch.float32)
    sin = sin.reshape(B, D).to(torch.float32)
    xr = x.reshape(B, h).to(torch.float32)
    tbl = None if table is None else torch.as_tensor(table)
    rows = []
    for l in range(L):
        lin, tabs = _layer(stack, meta, l)
        base = [_history(cache, l, s, tbl, p) for s, p in enumerate(prefix)]

        def hists(kq, ks, vq, vs, base=base):
            # row r's history: its slot's cache rows, then the chunk rows before r
            out = []
            for r in range(B):
                c0 = r - r % C
                out.append(tuple(torch.cat([hist, new[c0:r]]) for hist, new in
                                 zip(base[r // C], (kq, ks, vq, vs))))
            return out

        xr, kq, ks, vq, vs, *kv = layer_rows_ref(
            xr, x.dtype, lin, tabs, stack["n1"][l], stack["n2"][l], cos, sin, hists,
            [prefix[r // C] + r % C for r in range(B)], cfg, pre)
        rows.append((kq, vq, ks, vs, *kv))
    out = (xr.to(x.dtype).reshape(B, 1, h),) + tuple(torch.stack(r) for r in zip(*rows))
    if lm is None:
        return out
    g_ue, zc_ue = lm_meta[:2]
    hh = norm_row(xr, lm["fnorm"], cfg.rms_eps, x.dtype)
    logits = qdot_ref(hh, lm["ue"], lm["ues"], lm["ues"] * (-zc_ue), meta[0], g_ue)
    return out + (logits, torch.argmax(logits, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_WEIGHTS = ["x", "n1", "n2", "qkv", "qs", "qb", "o", "os", "ob", "gu", "gus", "gub",
            "dn", "ds", "db", "cos", "sin"]
_OUTS = ["ck", "cv", "cks", "cvs", "x_out", "krow", "vrow", "ks", "vs", "scratch"]
_GROUPS = ["g_qkv", "g_o", "g_gu", "g_d"]
_ZCS = [(n, ctypes.c_float) for n in ("zc_qkv", "zc_o", "zc_gu", "zc_d", "eps")]


class _MegaArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _WEIGHTS + _OUTS] + [
        (n, ctypes.c_int) for n in ["n_layers", "hidden", "n_heads", "n_kv_heads", "head_dim",
                                    "inter", "max_len", "pos"] + _GROUPS] + _ZCS


_MEGA_FIELDS = {n for n, _ in _MegaArgs._fields_}
_FLAT_FIELDS = {n for n, _ in _FlatArgs._fields_}


class _BatchArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _WEIGHTS + ["pos"] + _OUTS] + [
        (n, ctypes.c_int) for n in ["batch", "n_layers", "hidden", "n_heads", "n_kv_heads",
                                    "head_dim", "inter", "max_len"] + _GROUPS] + _ZCS + [
        ("table", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("chunk", "page_size", "pps", "n_pages")] + [
        (n, ctypes.c_void_p) for n in ("ue", "ues", "fnorm", "logits", "tokens", "part_val",
                                       "part_idx")] + [
        (n, ctypes.c_int) for n in ("vocab", "g_ue", "max_blocks")] + [("zc_ue", ctypes.c_float),
        ("plan_ws", ctypes.c_int * GEMV_PHASES), ("plan_splits", ctypes.c_int * GEMV_PHASES),
        ("part", ctypes.c_void_p), ("counters", ctypes.c_void_p), ("n_counters", ctypes.c_int),
        ("n_part", ctypes.c_int), ("ssq", ctypes.c_void_p)]


def _check_stack(stack, cfg, meta, dev, dt):
    """Validate the stacked weights; returns (n1, n2, pointers of the words,
    scale and bias tables per linear, ints, floats) for the argument block."""
    bits = meta[0]
    if bits not in (2, 4, 8):
        raise ValueError(f"the decode kernels take 2/4/8-bit words, not {bits}")
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, inter = cfg.num_layers, cfg.intermediate_size
    if D % 32 or D > 256:
        raise ValueError(f"head_dim {D} outside the decode kernel's contract")
    qdim, kvdim, vpw = H * D, Hkv * D, 32 // bits
    n1 = stack["n1"].to(dt).contiguous()
    n2 = stack["n2"].to(dt).contiguous()
    _check_cuda("stack[n1]", n1, dev, shape=(L, h))
    _check_cuda("stack[n2]", n2, dev, shape=(L, h))
    ptrs = []
    for (wk, sk, zk, gi), zc, k_in, n_out in zip(
            _STACKED, meta[5:], (h, qdim, h, inter), (qdim + 2 * kvdim, h, 2 * inter, h)):
        g = meta[gi]
        if k_in % g or g % vpw:
            raise ValueError(f"group {g} does not fit stack[{wk}]'s {k_in} inputs")
        _check_cuda(f"stack[{wk}]", stack[wk], dev, torch.int32, (L, k_in // vpw, n_out))
        _check_cuda(f"stack[{sk}]", stack[sk], dev, torch.float32, (L, k_in // g, n_out))
        if zc is None:
            _check_cuda(f"stack[{zk}]", stack[zk], dev, torch.float32, (L, k_in // g, n_out))
        ptrs += [stack[wk].data_ptr(), stack[sk].data_ptr(),
                 None if zc is not None else stack[zk].data_ptr()]
    zcs = [0.0 if zc is None else float(zc) for zc in meta[5:]]
    return n1, n2, ptrs, list(meta[1:5]), zcs + [cfg.rms_eps]


def _call(name, args, argtype, bits, dt, dev, lib="model_fused"):
    from . import _build

    fn = getattr(_build.load(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(argtype), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.byref(args), bits, _DTYPES[dt], _build.stream_ptr(dev)), name)


class _Mega4Args(ctypes.Structure):
    """csrc/model_mega4.cu's Mega4Args: the flat kernel's argument block
    (its words, scales, norms, shapes and plan; no lm_head, no merged cache)
    for the layer loop both kernels run, then MegaArgs for the rest."""
    _fields_ = [("f", _FlatArgs), ("m", _MegaArgs)]


def mega_route(meta) -> str:
    """The kernel `model_decode_mega` takes on the card: "mega4" (the
    tensor-core layer loop, csrc/model_mega4.cu) for 4-bit words, every case
    a 4-bit stack can hold; "cuda_core" (mega_kernel on the CUDA cores,
    csrc/model_fused.cu) for 2- and 8-bit words, which csrc/flat_gemv.cuh
    does not unpack."""
    return "mega4" if meta[0] == 4 else "cuda_core"


@dataclasses.dataclass
class MegaLaunch:
    """What a one-token whole-model launch on a stack takes that no launch
    changes (`mega_prepare`), for `mega_launch`: the argument block with the
    stack's pointers, shapes, groups and zero constants (`_MegaArgs`; on
    the "mega4" route `_Mega4Args`, with the plan), the plan's f32
    partials, and the tensors whose pointers it holds."""
    cfg: Any
    meta: tuple
    dtype: torch.dtype
    args: ctypes.Structure
    plans: Optional[list]  # the "mega4" route's plan (flat_plans without the lm_head)
    n_part: int
    keep: tuple


# the fields of the argument block that each launch sets
_PER_LAUNCH = ("x", "cos", "sin", "ck", "cv", "cks", "cvs", "x_out", "krow", "vrow", "ks", "vs",
               "scratch", "max_len", "pos")


def mega_prepare(stack, cfg, meta, dev, dt) -> MegaLaunch:
    """Check the stack and fill every field of a one-token launch that no
    launch changes, on the route `mega_route` picks (on "mega4" the plan
    for the card's SMs)."""
    if dt not in _DTYPES:
        raise TypeError(f"model_decode_mega kernel takes float32 or bfloat16, not {dt}")
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n1, n2, ptrs, groups, floats = _check_stack(stack, cfg, meta, dev, dt)
    args = _MegaArgs(n1=n1.data_ptr(), n2=n2.data_ptr(), **dict(zip(_WEIGHTS[3:15], ptrs)),
                     **dict(zip(_GROUPS + [n for n, _ in _ZCS], groups + floats)),
                     n_layers=cfg.num_layers, hidden=h, n_heads=H, n_kv_heads=Hkv, head_dim=D,
                     inter=cfg.intermediate_size)
    plans, n_part = None, 0
    if mega_route(meta) == "mega4":  # the flat kernel's plan without the lm_head
        plans = flat_plans(cfg, meta, sm_count(dev), lm=False)
        n_part, kc = flat_scratch(plans)
        f = _FlatArgs(**{n: getattr(args, n) for n, _ in _FlatArgs._fields_
                         if n in _MEGA_FIELDS})  # the fields both blocks name alike
        f.plan_ws[:4] = [pl[3] for pl in plans]
        f.plan_splits[:4] = [pl[4] for pl in plans]
        f.plan_kc, f.n_part = kc, n_part
        args = _Mega4Args(f, args)
    return MegaLaunch(cfg, meta, dt, args, plans, n_part, (n1, n2))


def mega_launch(prep: MegaLaunch, x, cos, sin, cache, pos: int, rows=None):
    """One launch of a prepared stack on checked inputs (x [h] in
    prep.dtype, cos/sin f32 [D], the split cache [L, T, Hkv, D] and its
    scales [L, T, Hkv], all contiguous on the stack's device; 0 <= pos < T).
    Returns (x_out [h], krows [L, Hkv, D] int8, vrows, ksr [L, Hkv] f32,
    vsr), written into `rows` where given (contiguous tensors of those
    shapes); counts nothing."""
    cfg, dev, dt = prep.cfg, x.device, prep.dtype
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, inter = cfg.num_layers, cfg.intermediate_size
    x_out = torch.empty(h, dtype=dt, device=dev)
    if rows is None:
        kv = torch.empty(2, L, Hkv, D, dtype=torch.int8, device=dev)
        sc = torch.empty(2, L, Hkv, dtype=torch.float32, device=dev)
        rows = (kv[0], kv[1], sc[0], sc[1])
    n_scratch = -(-(2 * h + 2 * H * D + 2 * Hkv * D + inter) // 64) * 64
    work = torch.empty(n_scratch + prep.n_part, dtype=torch.float32,
                       device=dev)  # scratch, then the plan's partials 256-byte aligned
    p = lambda t: t.data_ptr()
    vals = (p(x), p(cos), p(sin), p(cache["k"]), p(cache["v"]), p(cache["k_scale"]),
            p(cache["v_scale"]), p(x_out), *map(p, rows), p(work), cache["k"].shape[1], pos)
    args = type(prep.args).from_buffer_copy(prep.args)
    mega4 = prep.plans is not None
    for n, v in zip(_PER_LAUNCH, vals):
        setattr(args.m if mega4 else args, n, v)
        if mega4 and n in _FLAT_FIELDS:
            setattr(args.f, n, v)
    if mega4:
        args.f.part = p(work) + 4 * n_scratch
        _call("mi_model_decode_mega4", args, _Mega4Args, prep.meta[0], dt, dev, "model_mega4")
    else:
        _call("mi_model_decode_mega", args, _MegaArgs, prep.meta[0], dt, dev)
    return (x_out, *rows)


def _model_decode_mega_cuda(stack, x, cos, sin, cache, pos: int, cfg, meta):
    global launches, launches_mega4
    dev, dt = x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"model_decode_mega kernel takes float32 or bfloat16, not {dt}")
    h, Hkv, D, L = cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    T = cache["k"].shape[1]
    if not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache of {T} rows")
    for f, want, shape in (("k", torch.int8, (L, T, Hkv, D)), ("v", torch.int8, (L, T, Hkv, D)),
                           ("k_scale", torch.float32, (L, T, Hkv)),
                           ("v_scale", torch.float32, (L, T, Hkv))):
        _check_cuda(f"cache[{f}]", cache[f], dev, want, shape)
    xr = x.reshape(h).contiguous()
    cos = cos.reshape(-1).to(torch.float32).contiguous()
    sin = sin.reshape(-1).to(torch.float32).contiguous()
    _check_cuda("cos", cos, dev, shape=(D,))
    _check_cuda("sin", sin, dev, shape=(D,))
    prep = mega_prepare(stack, cfg, meta, dev, dt)
    x_out, krows, vrows, ksr, vsr = mega_launch(prep, xr, cos, sin, cache, pos)
    launches_mega4 += prep.plans is not None
    launches += 1
    return x_out.reshape(x.shape), krows, vrows, ksr, vsr


def model_decode_mega(stack, x, cos, sin, cache, pos: int, cfg, meta):
    """All decoder layers for one token, one launch. x [1,1,h] -> (x_out
    [1,1,h] in x's dtype, krows [L,Hkv,D] int8, vrows, ksr [L,Hkv] f32, vsr).
    The kernel `mega_route` picks on GPU tensors, the plain version on CPU
    tensors.

    cos/sin: [D] for the token's position. cache: stacked
    {"k"/"v": [L,T,Hkv,D] int8, "k_scale"/"v_scale": [L,T,Hkv] f32}; the
    caller scatters the rows into it at `pos`. meta: (bits, g_qkv, g_o, g_gu,
    g_d, zc_qkv, zc_o, zc_gu, zc_d) from `serving.megadecode.stack_serving`."""
    if x.is_cuda:
        return _model_decode_mega_cuda(stack, x, cos, sin, cache, int(pos), cfg, meta)
    return model_decode_mega_ref(stack, x, cos, sin, cache, int(pos), cfg, meta)


def _check_lm(lm, lm_meta, cfg, meta, dev, dt):
    """Validate the terminal lm rows' arrays (mode d); returns (fnorm in the
    model dtype, g_ue, zc_ue, vocab)."""
    g_ue, zc_ue, vocab = lm_meta[:3]
    h, vpw = cfg.hidden_size, 32 // meta[0]
    if h % g_ue or g_ue % vpw:
        raise ValueError(f"lm_head group {g_ue} does not fit {h} inputs of {vpw} values a word")
    fnorm = lm["fnorm"].reshape(-1).to(dt).contiguous()
    _check_cuda("lm[ue]", lm["ue"], dev, torch.int32, (h // vpw, vocab))
    _check_cuda("lm[ues]", lm["ues"], dev, torch.float32, (h // g_ue, vocab))
    _check_cuda("lm[fnorm]", fnorm, dev, shape=(h,))
    return fnorm, g_ue, float(zc_ue), vocab


@functools.lru_cache(maxsize=None)
def gemv_plan(ncols: int, K: int, g: int, nc: int = 1, blocks: int = COOP_PER_SM * H100_SMS):
    """The work plan of one 4-bit GEMV of the batched kernel: (ws, splits),
    searched by `coop_plan.best_plan`.

    Output columns (gate columns when nc = 2, each with its up column) go
    in strips of 32 // nc a warp. The block's 8 // ws warps of a strip
    split an item's groups again, so an item then fits one staged window
    (GEMV_KC). Among the plans that fill the grid it takes the least time
    of the slowest warp, counted in word rows streamed: waves times (its
    share of an item, GEMV_ITEM_ROWS, and the item's staged window), plus
    GEMV_SPLIT_ROWS a split for the last block's read of the partials;
    then the fewest waves, idle blocks and partials. Every mode of a step
    (dense, paged, with or without the lm rows) takes the same plan and
    gives the same bits."""
    wpg = g // 8

    def rank(ws, splits, most, waves, idle):
        ks = GEMV_WARPS // ws
        if ks > 1 and most * g > GEMV_KC:
            return None
        # a warp's word rows, an item's fixed cost, its staged window
        cost = waves * (-(-most // ks) * wpg + GEMV_ITEM_ROWS + min(most * g, GEMV_KC) // 8)
        if splits > 1:
            cost += GEMV_SPLIT_ROWS * splits
        return cost, waves, idle, splits * ws if splits > 1 else 0

    return best_plan(-(-ncols // (GEMV_STRIP // nc)), K // g, blocks, rank)


def gemv_scratch(plans) -> tuple:
    """(f32 partials, counters) the plans [(ncols, nc, ws, splits)] need:
    splits x tiles x ws strips of GEMV_PART floats for the largest GEMV
    that splits K, and one counter a tile of the GEMV with the most tiles
    (the wrapper also gives each counter 8 f32 row sums of squares)."""
    part, tiles = 0, 1
    for ncols, nc, ws, splits in plans:
        nt = -(-ncols // (ws * GEMV_STRIP // nc))
        tiles = max(tiles, nt)
        if splits > 1:
            part = max(part, splits * nt * ws * GEMV_PART)
    return part, tiles


def batch_plans(cfg, meta, lm_meta=None, sms: int = H100_SMS):
    """The batched kernel's 4-bit work plan: [(ncols, nc, ws, splits)] for
    qkv, o, gate/up, down and the lm_head (the lm rows' entry is (0, 1, 1,
    1) without them)."""
    h, I = cfg.hidden_size, cfg.intermediate_size
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    blocks = COOP_PER_SM * sms
    shapes = [(qdim + 2 * kvdim, h, meta[1], 1), (h, qdim, meta[2], 1), (I, h, meta[3], 2),
              (h, I, meta[4], 1)]
    plans = [(n, nc) + gemv_plan(n, K, g, nc, blocks) for n, K, g, nc in shapes]
    if lm_meta is None:
        return plans + [(0, 1, 1, 1)]
    g_ue, _, vocab = lm_meta[:3]
    return plans + [(vocab, 1) + gemv_plan(vocab, h, g_ue, 1, blocks)]


def _model_decode_mega_batch_cuda(stack, x, cos, sin, cache, positions, cfg, meta, table=None,
                                  chunk: int = 1, lm=None, lm_meta=None):
    global launches_batch, launches_paged, launches_chunk, launches_lm
    dev, dt = x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"model_decode_mega_batch kernel takes float32 or bfloat16, not {dt}")
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, inter = cfg.num_layers, cfg.intermediate_size
    B = x.shape[0]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the batched kernel takes 1 to {MAX_BATCH} rows (slots x chunk "
                         f"tokens), not {B}")
    n1, n2, ptrs, groups, floats = _check_stack(stack, cfg, meta, dev, dt)
    n_slots = B // chunk
    if table is None:
        T = cap = cache["k"].shape[3]
        kv_shape, tbl, P, pps, n_pages = (L, n_slots, Hkv, T, D), None, 0, 0, 0
    else:
        n_pages, P = cache["k"].shape[1], cache["k"].shape[3]
        if P % 128:
            raise ValueError(f"pages of {P} rows: the paged mode takes a multiple of 128")
        tbl = torch.as_tensor(table).to("cpu", torch.int64)
        pps = tbl.shape[-1]
        if tuple(tbl.shape) != (n_slots, pps) or bool(((tbl < 0) | (tbl >= n_pages)).any()):
            raise ValueError(f"table must be [{n_slots}, pages a slot] of pages inside the pool "
                             f"of {n_pages}, not {tbl.tolist()}")
        tbl = tbl.to(dev, torch.int32)
        T, cap, kv_shape = P, pps * P, (L, n_pages, Hkv, P, D)
    for f, want, shape in (("k", torch.int8, kv_shape), ("v", torch.int8, kv_shape),
                           ("k_scale", torch.float32, kv_shape[:4]),
                           ("v_scale", torch.float32, kv_shape[:4])):
        _check_cuda(f"cache[{f}]", cache[f], dev, want, shape)
    pos = torch.as_tensor(positions).reshape(-1).to("cpu", torch.int64)
    if pos.numel() != B or bool(((pos < 0) | (pos >= cap)).any()):
        raise ValueError(f"positions {pos.tolist()} must be {B} rows inside the slots' "
                         f"{cap} rows")
    pos = pos.to(dev, torch.int32)
    xr = x.reshape(B, h).contiguous()
    cos = cos.reshape(B, -1).to(torch.float32).contiguous()
    sin = sin.reshape(B, -1).to(torch.float32).contiguous()
    _check_cuda("cos", cos, dev, shape=(B, D))
    _check_cuda("sin", sin, dev, shape=(B, D))

    x_out = torch.empty(B, h, dtype=dt, device=dev)
    krows = torch.empty(L, B, Hkv, D, dtype=torch.int8, device=dev)
    vrows = torch.empty_like(krows)
    ksr = torch.empty(L, B, Hkv, dtype=torch.float32, device=dev)
    vsr = torch.empty_like(ksr)
    scratch = torch.empty(B * (2 * h + 2 * H * D + 2 * Hkv * D + inter), dtype=torch.float32,
                          device=dev)
    p = lambda t: t.data_ptr()
    lm_ptrs, lm_ints, zc_ue = [None] * 7, [0, 0], 0.0
    if lm is not None:
        fnorm, g_ue, zc_ue, vocab = _check_lm(lm, lm_meta, cfg, meta, dev, dt)
        logits = torch.empty(B, vocab, dtype=torch.float32, device=dev)
        tokens = torch.empty(B, dtype=torch.int32, device=dev)
        part_val = torch.empty(_MAX_BLOCKS * MAX_BATCH, dtype=torch.float32, device=dev)
        part_idx = torch.empty(_MAX_BLOCKS * MAX_BATCH, dtype=torch.int32, device=dev)
        lm_ptrs = [p(lm["ue"]), p(lm["ues"]), p(fnorm), p(logits), p(tokens), p(part_val),
                   p(part_idx)]
        lm_ints = [vocab, g_ue]
    plan_ws, plan_splits = [1] * GEMV_PHASES, [1] * GEMV_PHASES
    part, counters, n_part = None, None, 0
    if meta[0] == 4:  # the tensor-core GEMV's plan, partials, tile counters, row squares
        plans = batch_plans(cfg, meta, lm_meta if lm is not None else None, sm_count(dev))
        plan_ws, plan_splits = [pl[2] for pl in plans], [pl[3] for pl in plans]
        n_part, n_counters = gemv_scratch(plans)
        part = torch.empty(n_counters * 8 + n_part, dtype=torch.float32, device=dev)
        counters = torch.empty(n_counters, dtype=torch.int32, device=dev)
    args = _BatchArgs(p(xr), p(n1), p(n2), *ptrs, p(cos), p(sin), p(pos),
                      p(cache["k"]), p(cache["v"]), p(cache["k_scale"]), p(cache["v_scale"]),
                      p(x_out), p(krows), p(vrows), p(ksr), p(vsr), p(scratch),
                      B, L, h, H, Hkv, D, inter, T, *groups, *floats,
                      None if tbl is None else p(tbl), chunk, P, pps, n_pages,
                      *lm_ptrs, *lm_ints, _MAX_BLOCKS, zc_ue,
                      (ctypes.c_int * GEMV_PHASES)(*plan_ws),
                      (ctypes.c_int * GEMV_PHASES)(*plan_splits),
                      None if part is None else p(part) + 4 * 8 * counters.numel(),
                      None if counters is None else p(counters),
                      0 if counters is None else counters.numel(), n_part,
                      None if part is None else p(part))
    _call("mi_model_decode_mega_batch", args, _BatchArgs, meta[0], dt, dev)
    if chunk > 1:
        launches_chunk += 1
    elif tbl is not None:
        launches_paged += 1
    else:
        launches_batch += 1
    out = (x_out.reshape(B, 1, h), krows, vrows, ksr, vsr)
    if lm is None:
        return out
    launches_lm += 1
    return out + (logits, tokens)


def model_decode_mega_batch(stack, x, cos, sin, cache, positions, cfg, meta, *, table=None,
                            chunk: int = 1, tp: int = 1, lm=None, lm_meta=None):
    """Whole-model decode of B rows, one launch: x [B,1,h], positions [B] ->
    (x_out [B,1,h] in x's dtype, krows [L,B,Hkv,D] int8, vrows, ksr [L,B,Hkv]
    f32, vsr), and with `lm` also (logits [B,V] f32, tokens [B] int32). The
    kernel on GPU tensors, the plain version on CPU tensors.
    At most MAX_BATCH rows (the reference takes any B; its callers stay at 8
    rows or fewer).

    cos/sin: [B, D], one row per row's position. cache: the head-transposed
    stacked cache of `serving.megadecode.stack_cache_batched`
    {"k"/"v": [L,S,Hkv,T,D] int8, "k_scale"/"v_scale": [L,S,Hkv,T] f32}, one
    slot s per row (S = B) or per chunk (S = B / chunk). The caller scatters
    each row's new k/v row at its position.

    chunk=C > 1, mode (c): the rows are S slots of C consecutive tokens,
    positions[s*C + i] = positions[s*C] + i; row s*C + i attends to its
    slot's history t < positions[s*C] and to the chunk's rows before it.
    table [S, pps] int32, mode (b): `cache` is the shared page pool of
    `serving.megadecode.init_pool_batched` {"k"/"v": [L,n_pages,Hkv,P,D]
    int8, "k_scale"/"v_scale": [L,n_pages,Hkv,P] f32}, P a multiple of 128;
    slot s's history row t lives on page table[s, t // P] at offset t % P.
    lm, mode (d), with any mode above: {"ue": [h/vpw, V] int32 words, "ues":
    [h/g_ue, V] f32 scales, "fnorm": [h] final norm} and lm_meta = (g_ue,
    zc_ue, vocab, tv) from `serving.megadecode.stack_lm` (a symmetric lm_head
    grid: the bias is -zc_ue*s; tv is the reference's TPU tile, unused).
    `tp` > 1 (mode e) raises NotImplementedError."""
    if tp != 1:
        raise NotImplementedError(
            "model_decode_mega_batch mode (e) tp>1 is not ported yet (ROADMAP.md B5)")
    if (lm is None) != (lm_meta is None):
        raise ValueError("lm and lm_meta come together (serving.megadecode.stack_lm)")
    B = x.shape[0]
    if B > MAX_BATCH:
        raise ValueError(f"the batched kernel takes at most MAX_BATCH = {MAX_BATCH} rows "
                         f"(slots x chunk tokens), not {B}")
    if chunk < 1 or B % chunk:
        raise ValueError(f"chunk {chunk} does not divide the {B} rows")
    if table is not None and len(table) != B // chunk:
        raise ValueError(f"the page table needs one row per slot ({B // chunk}), not "
                         f"{len(table)}")
    if chunk > 1:
        pos = torch.as_tensor(positions).reshape(-1, chunk).to("cpu", torch.int64)
        if bool((pos != pos[:, :1] + torch.arange(chunk)).any()):
            raise ValueError(f"a chunk's positions must be consecutive: {pos.tolist()}")
    if x.is_cuda:
        return _model_decode_mega_batch_cuda(stack, x, cos, sin, cache, positions, cfg, meta,
                                             table, chunk, lm, lm_meta)
    lm_kw = {} if lm is None else dict(lm=lm, lm_meta=lm_meta)
    return model_decode_mega_batch_ref(stack, x, cos, sin, cache, positions, cfg, meta, table,
                                       chunk, **lm_kw)
