"""Flat whole-model decode: every layer, the final rmsnorm, the packed
lm_head and a first-index argmax for one token in ONE launch.

Kernel: csrc/model_flat.cu (with csrc/decode_common.cuh), which replaces the
TPU kernel mi_optimize_tpu/ops/model_flat.py::_kernel_flat
(model_decode_flat).

What bounds it on an H100: the whole packed model plus the lm_head, read
once per token (about 3.5 GB at Llama-2-7B, int4 g128) over the memory rate.
The kernel is one cooperative launch that runs the layers back to back,
keeping the residual in f32 across all of them, with grid barriers in place
of launches; the logits and the argmax follow after one more barrier.
Symmetric grids only: the dequant bias is -zc*s from one constant per
linear, so no bias table is streamed. With 4-bit words the GEMVs run on the
tensor cores (csrc/flat_gemv.cuh: the reference's grouped rescale, the row
as exact bf16 planes of an n8 mma operand), each cut into (column tile x K
split) items by `flat_plan` so that every phase fills the card, the splits'
partials added in split order by the phase that reads them; 2- and 8-bit
words keep decode_common.cuh's CUDA-core dot.

Layout: the port's `serving.megadecode.stack_serving` stacks the natural
words-major per-layer arrays into [L, KW, N] with f32 scales [L, K/g, N];
the reference's TPU tiling of the intermediate axis is not copied. On CPU
tensors the wrapper runs the plain version, `model_decode_flat_ref`.
`flat_launch` checks the inputs and launches either entry point of
model_flat.cu (with 4-bit words both take the same plan, partials and
window); ops/model_flat_seg.py launches the multi-token one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..models.quant_linear import group_size
from .block_fused import _check_cuda, layer_ref, norm_row
from .coop_plan import COOP_PER_SM, H100_SMS, best_plan, sm_count
from .dequant_matmul import kernel_tables, qdot_ref

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 1024  # cap on the cooperative grid (per-block argmax slots)
# The 4-bit GEMV's geometry (csrc/flat_gemv.cuh): output columns a warp
# strip, warps a block, word rows a chunk, the largest staged window (k),
# GEMVs a plan (qkv, o_proj, gate/up, down_proj, lm_head). The plan and the
# scratch sizes below follow them; the kernel's launch checks the plan
# against the scratch it is given (check_plan). FLAT_SPLITS: the most K
# splits a plan takes to keep a wider tile (every block reads each split's
# partials back after the barrier).
FLAT_STRIP, FLAT_WARPS, FLAT_CHUNK_ROWS, FLAT_KC_MAX, FLAT_GEMVS = 32, 8, 8, 8192, 5
FLAT_SPLITS = 8


def stack_flat_params(model, base_stack, base_meta):
    """Extend a `stack_serving` stack with the lm_head, or None.

    Requires every linear (lm_head included) on a symmetric grid (one
    constant zero per stack, so the bias is computed in-kernel) and a packed
    lm_head. Returns (stack, meta) with meta = base meta + (g_ue, zc_ue, vocab)."""
    from ..core.qparams import qrange

    bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d = base_meta
    if None in (zc_qkv, zc_o, zc_gu, zc_d):
        return None
    lm = model.params.get("lm_head")
    cfg = model.config
    if lm is None or getattr(lm, "packed", None) is None:
        return None
    s = lm.spec
    if s.wbit != bits or s.abit is not None or lm.bias is not None \
            or lm.smooth_factor is not None or lm.perm is not None:
        return None
    if s.w_qtype not in ("per_group", "per_channel"):
        return None
    g_ue = group_size(lm)
    if g_ue % (32 // bits) or cfg.hidden_size % g_ue:
        return None
    z = lm.w_zero.reshape(-1)
    if not bool(torch.all(z == z[0])):
        return None
    zc_ue = float(z[0]) - float(qrange(s.wbit, s.w_unsigned).qmin)
    ues, _ = kernel_tables(lm)
    stack = dict(base_stack)
    stack.update({"ue": lm.packed, "ues": ues,
                  "fnorm": model.params["final_norm"].reshape(-1)})
    return stack, tuple(base_meta) + (g_ue, zc_ue, lm.out_features)


def model_decode_flat_ref(stack, x, cossin, cache, pos: int, cfg, meta):
    """Plain PyTorch version of the kernel (same signature and outputs as
    `model_decode_flat`)."""
    (bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d, g_ue, zc_ue, vocab) = meta
    D, L = cfg.head_dim, cfg.num_layers
    cos = cossin.reshape(-1)[:D].to(torch.float32)
    sin = cossin.reshape(-1)[D:].to(torch.float32)
    dt = x.dtype
    xr = x.reshape(-1).to(torch.float32)
    groups = {"qkv": g_qkv, "o": g_o, "gu": g_gu, "d": g_d}
    zcs = {"qkv": zc_qkv, "o": zc_o, "gu": zc_gu, "d": zc_d}
    skey = {"qkv": "qs", "o": "os", "gu": "gus", "d": "ds"}
    wkey = {"qkv": "qkv", "o": "o", "gu": "gu", "d": "d"}
    kvrows, kvsc = [], []
    for l in range(L):
        lin = {k: stack[wkey[k]][l] for k in groups}
        lin.update(bits=bits, groups=groups)
        tabs = {}
        for k in groups:
            sc = stack[skey[k]][l]
            tabs[k] = (sc, sc * (-zcs[k]))
        kv, ks = cache["kv"][l], cache["kv_scale"][l]
        hist = (kv[:, 0], ks[:, 0], kv[:, 1], ks[:, 1])
        xr, kq, ksc, vq, vsc = layer_ref(xr, dt, lin, tabs, stack["n1"][l], stack["n2"][l],
                                         cos, sin, hist, pos, cfg)
        kvrows.append(torch.stack([kq, vq]))
        kvsc.append(torch.stack([ksc, vsc])[:, None])
    hh = norm_row(xr, stack["fnorm"], cfg.rms_eps, dt)
    logits = qdot_ref(hh[None], stack["ue"], stack["ues"], stack["ues"] * (-zc_ue), bits, g_ue)
    tok = torch.argmax(logits[0]).reshape(1).to(torch.int32)
    return tok, logits, torch.stack(kvrows), torch.stack(kvsc)


class _FlatArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "n1", "n2", "qkv", "qs", "o", "os", "gu", "gus", "dn", "ds",
        "ue", "ues", "fnorm", "cos", "sin", "kv", "kvs",
        "token", "logits", "kvrow", "kvsc", "scratch", "part_idx", "emb")] + [
        (n, ctypes.c_int) for n in (
            "n_layers", "hidden", "n_heads", "n_kv_heads", "head_dim", "inter", "vocab",
            "max_len", "pos", "g_qkv", "g_o", "g_gu", "g_d", "g_ue", "max_blocks", "kseg")] + [
        (n, ctypes.c_float) for n in ("zc_qkv", "zc_o", "zc_gu", "zc_d", "zc_ue", "eps")] + [
        ("plan_ws", ctypes.c_int * FLAT_GEMVS), ("plan_splits", ctypes.c_int * FLAT_GEMVS),
        ("plan_kc", ctypes.c_int), ("n_part", ctypes.c_int), ("part", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def flat_plan(ncols: int, K: int, g: int, blocks: int = COOP_PER_SM * H100_SMS,
              split: bool = True):
    """The work plan of one 4-bit GEMV of the flat kernel: (ws, splits),
    searched by `coop_plan.best_plan`.

    Output columns go in strips of 32 a warp; the 8 // ws warps of a strip
    split an item's chunks (8 word rows of one group) again, in order. With
    split=False the GEMV takes no K split (the lm_head, whose argmax needs
    whole logits). Among the plans that fill the grid it takes the fewest
    waves (each costs every block an item's fixed work and a staged
    window), then the fewest chunks a warp streams, then at most
    FLAT_SPLITS splits, then the widest tile (a block streams a longer run
    of each word row), then the fewest idle blocks and splits."""
    cpg = -(-(g // 8) // FLAT_CHUNK_ROWS)

    def rank(ws, splits, most, waves, idle):
        return (waves, -(-most * cpg // (FLAT_WARPS // ws)), splits > FLAT_SPLITS, -ws, idle,
                splits)

    return best_plan(-(-ncols // FLAT_STRIP), K // g, blocks, rank, split)


def flat_plans(cfg, meta, sms: int = H100_SMS, lm: bool = True):
    """The 4-bit flat kernel's plan: [(ncols, K, g, ws, splits)] for qkv,
    o_proj, gate/up (gate and up columns side by side), down_proj and, with
    lm, the lm_head (lm=False: the whole-model kernel without it,
    ops/model_fused.py's "mega4" route)."""
    h, I = cfg.hidden_size, cfg.intermediate_size
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    blocks = COOP_PER_SM * sms
    shapes = [(qdim + 2 * kvdim, h, meta[1], True), (h, qdim, meta[2], True),
              (2 * I, h, meta[3], True), (h, I, meta[4], True)]
    if lm:
        shapes.append((meta[11], h, meta[9], False))
    return [(n, K, g) + flat_plan(n, K, g, blocks, split) for n, K, g, split in shapes]


def flat_scratch(plans) -> tuple:
    """(f32 partials, staged window k) the plans need: splits x columns for
    qkv, o_proj, gate/up and down_proj (the lm_head takes no split), and the
    largest split's k rounded up to 64, at most FLAT_KC_MAX (a longer split
    is staged a window at a time)."""
    n_part = sum(ncols * splits for ncols, _, _, _, splits in plans[:4])
    kc = max(-(-(K // g) // splits) * g for _, K, g, _, splits in plans)
    return n_part, min(FLAT_KC_MAX, -(-kc // 64) * 64)


def flat_launch(entry, stack, x, cos, sin, cache, pos: int, cfg, meta, kseg=1, emb=None,
                lib=None):
    """Check the inputs of the flat kernels (model_flat.cu), launch `entry`
    for kseg tokens from position pos (cos/sin [kseg, D]) and return (tokens
    [kseg] int32, logits [V] f32 of the last token, kvrows [kseg, L, 2, Hkv,
    D] int8, kvscales [kseg, L, 2, Hkv] f32). With 4-bit words either entry
    gets the tensor-core GEMV's plan (`flat_plans`), its partials and its
    staged window (`flat_scratch`). `lib`:
    another build of model_flat.cu to launch (scripts/torch_flat_phases.py's
    timed copy). A refused launch raises (`_build.check`)."""
    from . import _build

    (bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d, g_ue, zc_ue, vocab) = meta
    dev, dt = x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the flat kernels take float32 or bfloat16, not {dt}")
    h, H, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, inter = cfg.num_layers, cfg.intermediate_size
    qdim, kvdim = H * D, Hkv * D
    if D % 32 or D > 256:
        raise ValueError(f"head_dim {D} outside the decode kernel's contract")
    T = cache["kv"].shape[1]
    if not (0 <= pos and pos + kseg <= T):
        raise ValueError(f"positions {pos}..{pos + kseg - 1} outside the cache of {T} rows")
    xr = x.reshape(h).contiguous()
    n1 = stack["n1"].to(dt).contiguous()
    n2 = stack["n2"].to(dt).contiguous()
    fnorm = stack["fnorm"].to(dt).contiguous()
    cos = cos.reshape(kseg, D).to(torch.float32).contiguous()
    sin = sin.reshape(kseg, D).to(torch.float32).contiguous()
    vpw = 32 // bits
    nqkv = qdim + 2 * kvdim
    for k, sk, k_in, n_out, g in (("qkv", "qs", h, nqkv, g_qkv), ("o", "os", qdim, h, g_o),
                                  ("gu", "gus", h, 2 * inter, g_gu), ("d", "ds", inter, h, g_d)):
        _check_cuda(f"stack[{k}]", stack[k], dev, torch.int32, (L, k_in // vpw, n_out))
        _check_cuda(f"stack[{sk}]", stack[sk], dev, torch.float32, (L, k_in // g, n_out))
    _check_cuda("stack[ue]", stack["ue"], dev, torch.int32, (h // vpw, vocab))
    _check_cuda("stack[ues]", stack["ues"], dev, torch.float32, (h // g_ue, vocab))
    for name, t, shape in (("n1", n1, (L, h)), ("n2", n2, (L, h)), ("final norm", fnorm, (h,)),
                           ("cos", cos, (kseg, D)), ("sin", sin, (kseg, D))):
        _check_cuda(name, t, dev, shape=shape)
    if emb is not None:
        _check_cuda("emb", emb, dev, dt, (vocab, h))
    elif entry == "mi_model_decode_flat_seg":
        raise ValueError("the multi-token kernel reads each later token's row from emb")
    _check_cuda("kv cache", cache["kv"], dev, torch.int8, (L, T, 2, Hkv, D))
    _check_cuda("kv scales", cache["kv_scale"], dev, torch.float32, (L, T, 2, Hkv))

    token = torch.empty(kseg, dtype=torch.int32, device=dev)
    logits = torch.empty(vocab, dtype=torch.float32, device=dev)
    kvrows = torch.empty(kseg, L, 2, Hkv, D, dtype=torch.int8, device=dev)
    kvsc = torch.empty(kseg, L, 2, Hkv, dtype=torch.float32, device=dev)
    scratch = torch.empty(h + qdim + 2 * kvdim + qdim + h + inter + _MAX_BLOCKS,
                          dtype=torch.float32, device=dev)
    part_idx = torch.empty(_MAX_BLOCKS, dtype=torch.int32, device=dev)
    plan_ws, plan_splits, kc, n_part, part = [0] * FLAT_GEMVS, [0] * FLAT_GEMVS, 0, 0, None
    if bits == 4:  # the tensor-core GEMV's plan, partials
        plans = flat_plans(cfg, meta, sm_count(dev))
        plan_ws, plan_splits = [pl[3] for pl in plans], [pl[4] for pl in plans]
        n_part, kc = flat_scratch(plans)
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    p = lambda t: t.data_ptr()
    args = _FlatArgs(
        p(xr), p(n1), p(n2), p(stack["qkv"]), p(stack["qs"]), p(stack["o"]), p(stack["os"]),
        p(stack["gu"]), p(stack["gus"]), p(stack["d"]), p(stack["ds"]),
        p(stack["ue"]), p(stack["ues"]), p(fnorm), p(cos), p(sin),
        p(cache["kv"]), p(cache["kv_scale"]),
        p(token), p(logits), p(kvrows), p(kvsc), p(scratch), p(part_idx),
        None if emb is None else p(emb),
        L, h, H, Hkv, D, inter, vocab, T, pos, g_qkv, g_o, g_gu, g_d, g_ue, _MAX_BLOCKS, kseg,
        zc_qkv, zc_o, zc_gu, zc_d, zc_ue, cfg.rms_eps,
        (ctypes.c_int * FLAT_GEMVS)(*plan_ws), (ctypes.c_int * FLAT_GEMVS)(*plan_splits), kc,
        n_part, None if part is None else p(part))
    _call(entry, args, bits, dt, dev, lib)
    return token, logits, kvrows, kvsc


def _call(entry, args, bits, dt, dev, lib=None):
    from . import _build

    fn = getattr(lib or _build.load("model_flat"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_FlatArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ctypes.byref(args), bits, _DTYPES[dt], _build.stream_ptr(dev)), entry)


def _model_decode_flat_cuda(stack, x, cossin, cache, pos: int, cfg, meta):
    global launches
    D = cfg.head_dim
    cs = cossin.reshape(-1)
    token, logits, kvrows, kvsc = flat_launch("mi_model_decode_flat", stack, x, cs[:D], cs[D:],
                                              cache, pos, cfg, meta)
    launches += 1
    return token, logits[None], kvrows[0], kvsc[0][:, :, None]


def model_decode_flat(stack, x, cossin, cache, pos: int, cfg, meta):
    """One decoded token, one launch: x [1,1,h] (embedding row) ->
    (token [1] int32, logits [1, V] f32, kvrows [L,2,Hkv,D] int8,
    kvscales [L,2,1,Hkv] f32). The kernel on GPU tensors, the plain version
    on CPU tensors.

    cache: {"kv": [L,T,2,Hkv,D] int8, "kv_scale": [L,T,2,Hkv] f32}. The
    caller scatters the rows into it."""
    if x.is_cuda:
        return _model_decode_flat_cuda(stack, x, cossin, cache, pos, cfg, meta)
    return model_decode_flat_ref(stack, x, cossin, cache, pos, cfg, meta)
