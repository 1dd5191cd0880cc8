"""Model-level decode: the whole decoder stack as ONE kernel per step.

Port of mi_optimize_tpu/serving/megadecode.py: `_grp`, `_zconst`,
`stack_serving`, the single-stream loop (`init_cache_stacked`,
`stack_cache`, `_model_step`, `decode_loop_model`), the batched step of
continuous batching (`default_lm`, `stack_cache_batched`,
`unstack_cache_batched`, `_scatter_rows_batched`, `model_step_batch`), the
paged steps over a shared page pool (`init_pool_batched`,
`_scatter_rows_paged`, `scatter_prefill_pages`, `model_step_batch_paged`),
the chunk steps (`_scatter_chunk_rows_batched`, `model_step_chunk`,
`model_step_chunk_batch`, `model_step_chunk_batch_paged`; the reference's
one-slot `_scatter_chunk_rows` is the batched scatter with one prefix) and
the batched kernel's fused terminal lm rows (`stack_lm`; `lm=`/`lm_meta=` of
the batch and chunk steps) and the tensor-parallel steps (`_lin_out_slices`,
`_lin_in_slice`, `stack_serving_tp`, `model_step_batch_tp`,
`model_step_batch_paged_tp`: the batched kernel's mode (e), one rank's
shard a call, its collectives over an explicit group).

A chunk step takes any number of slots and rows, where one batched launch
takes at most ops.model_fused.MAX_BATCH = 8 rows: the slots go in waves of
max(1, 8 // C) and a chunk longer than 8 rows in consecutive sub-chunks,
each launched after the previous one's rows are written (a row attends to
the earlier rows' int8 k/v either way; only the order of the sums changes).
A wave over a subset of a dense cache's slots reads that cache as a page
pool of one T-row page a slot (page s = slot s).

    model = fuse_for_serving(model)
    stack, meta = stack_serving(model)          # None -> engine.decode_loop
    logits, cache = prefill(...)                # per-layer int8 cache
    decode_loop_model(..., stack_cache(cache), ...)   # one launch per token

The stacked layout is the port's own: the natural words-major per-layer
packed arrays [L, KW, N] and their f32 scale tables [L, K/g, N], plus the f32
bias tables [L, K/g, N] of every linear whose zero is not one constant
across the model. The TPU kernel's zero padding of the intermediate axis is
a VMEM tiling detail and is not copied. The blocks then read their words and
tables through views of the stack.

Caches are updated in place (the reference returns fresh functional arrays);
the functions still return the cache they wrote.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.qparams import qrange
from ..models import llama
from ..models.model import Model
from ..models.quant_linear import group_size as _grp
from ..ops.block_fused import prepare_block
from ..ops.dequant_matmul import kernel_tables

_LINEARS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
# (linear, stack key of its words, of its scale table, of its bias table)
_STACKED = (("qkv_proj", "qkv", "qs", "qz"), ("o_proj", "o", "os", "oz"),
            ("gateup_proj", "gu", "gus", "guz"), ("down_proj", "d", "ds", "dz"))
_FIELDS = ("k", "v", "k_scale", "v_scale")


def _zconst(layers, name):
    """Constant (zero - qmin) shared by `name` across ALL layers, else None."""
    z = torch.cat([b[name].w_zero.reshape(-1).to(torch.float32) for b in layers])
    if not bool(torch.all(z == z[0])):
        return None
    lin = layers[0][name]
    return float(z[0]) - float(qrange(lin.spec.wbit, lin.spec.w_unsigned).qmin)


def refuse_shard(params, what: str) -> None:
    """The one check that keeps a tensor-parallel shard (parallel.shard_model)
    off the tp = 1 whole-model kernels: they would run a rank's heads and MLP
    columns as a whole model, with no sum of the o_proj and down_proj
    partials over the group, and return wrong tokens without an error.
    Raises ValueError naming `what`. stack_serving declines a shard by the
    same test; the loops that are handed a shard's stack raise here."""
    from ..parallel.sharding import tp_group

    if tp_group(params) is not None:
        raise ValueError(
            f"{what} runs a tp = 1 whole-model kernel and this model is a tensor-parallel "
            "shard: serve it through ContinuousBatcher or PagedMegaBatcher (the batched "
            "kernel's mode (e)) or the per-layer route")


def stack_serving(model: Model, tp: bool = False):
    """(stack dict, meta tuple) for the whole-model kernels, or None.

    meta = (bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d); a zc is
    None where that linear's zero is not one constant across the model, and
    then its bias tables are stacked too ("qz", "oz", "guz", "dz"). A
    symmetric model stacks no bias table. The model's blocks are rebound to
    views of the stack (same values); a second call returns the same words
    and tables, not a copy. A tensor-parallel shard is declined unless the
    caller asks with `tp`: only the batched kernel's mode (e) serves a
    shard's stack (ContinuousBatcher, PagedMegaBatcher)."""
    layers = model.params["layers"]
    if not layers or any("mega" not in b for b in layers):
        return None
    if not tp:
        from ..parallel.sharding import tp_group

        if tp_group(model) is not None:
            return None

    def key(b):
        return ((b["qkv_proj"].spec.wbit, b["qkv_proj"].spec.w_unsigned)
                + tuple(_grp(b[n]) for n in _LINEARS))

    k0 = key(layers[0])
    if any(key(b) != k0 for b in layers[1:]):
        return None

    def stk(fn):
        ts = [fn(b) for b in layers]
        base = ts[0]._base
        # a model stacked before already reads these through views of one
        # stack: reuse it, so that stacking twice keeps one copy on the card
        if (base is not None and base.shape == (len(ts),) + ts[0].shape
                and all(t._base is base and t.data_ptr() == base[l].data_ptr()
                        for l, t in enumerate(ts))):
            return base
        return torch.stack(ts)

    zcs = tuple(_zconst(layers, n) for n in _LINEARS)
    stack = {"n1": stk(lambda b: b["input_norm"].reshape(-1)),
             "n2": stk(lambda b: b["post_norm"].reshape(-1))}
    for (name, wk, sk, zk), zc in zip(_STACKED, zcs):
        stack[wk] = stk(lambda b: b[name].packed)
        stack[sk] = stk(lambda b: kernel_tables(b[name])[0])
        if zc is None:
            stack[zk] = stk(lambda b: kernel_tables(b[name])[1])
    _share(model, stack)
    return stack, (k0[0],) + k0[2:] + zcs


def _share(model: Model, stack) -> None:
    """Rebind every block's packed words and kernel tables to views of the
    stack, so the card keeps one copy of them, not two."""
    for l, b in enumerate(model.params["layers"]):
        for name, wk, sk, zk in _STACKED:
            lin = b[name]
            lin.packed = stack[wk][l]
            lin.tables = (stack[sk][l], stack[zk][l] if zk in stack else lin.tables[1])
        b["mega"] = prepare_block(b, model.config)


def _pick_tv(vocab: int, cap: int) -> int:
    """Largest 128-aligned divisor of the vocab <= cap, else 0: the
    reference's lm_head tile (ops/model_flat.py::_pick_tv without its MI_TV
    override). The port's kernel does not tile by it; stack_lm keeps it as
    the reference's acceptance test and in lm_meta."""
    best = 0
    for c in range(128, cap + 1, 128):
        if vocab % c == 0:
            best = c
    return best


def stack_lm(model: Model, meta, cap: int = 1280):
    """(lm dict, lm_meta) for the batched kernel's terminal lm rows (mode
    d), or None: the flat kernel's lm contract (a packed lm_head on
    `meta`'s bits, a symmetric grid: one zero for the whole matrix, a group
    a multiple of the values a word dividing the hidden size), plus the
    reference's checks that the hidden size is a multiple of 512 and that
    the vocab has a 128-aligned divisor <= cap (`_pick_tv`; the reference's
    default cap of 1280 is a TPU tile ceiling).

    lm = {"ue": packed words [h/vpw, V], "ues": f32 scales [h/g, V],
    "fnorm": final norm [h]}; lm_meta = (g_ue, zc_ue, vocab, tv)."""
    bits = meta[0]
    lin = model.params.get("lm_head")
    cfg = model.config
    if lin is None or getattr(lin, "packed", None) is None:
        return None
    s = lin.spec
    if s.wbit != bits or s.abit is not None or lin.bias is not None \
            or lin.smooth_factor is not None or lin.perm is not None:
        return None
    if s.w_qtype not in ("per_group", "per_channel"):
        return None
    g_ue = _grp(lin)
    if g_ue % (32 // bits) or cfg.hidden_size % g_ue or cfg.hidden_size % 512:
        return None
    tv = _pick_tv(lin.out_features, cap)
    if not tv:
        return None
    z = lin.w_zero.reshape(-1)
    if not bool(torch.all(z == z[0])):
        return None
    zc_ue = float(z[0]) - float(qrange(s.wbit, s.w_unsigned).qmin)
    lm = {"ue": lin.packed, "ues": kernel_tables(lin)[0],
          "fnorm": model.params["final_norm"].reshape(-1)}
    return lm, (g_ue, zc_ue, lin.out_features, tv)


# ---------------------------------------------------------------------------
# single stream: one model_decode_mega launch per token
# ---------------------------------------------------------------------------

def init_cache_stacked(cfg, max_len: int, device=None):
    """Stacked int8 KV cache: [L, T, Hkv, D] values + [L, T, Hkv] scales."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev)}


def stack_cache(cache_list):
    """Per-layer cache list (engine.init_cache dtype=int8, batch=1) -> stacked."""
    return {f: torch.stack([c[f][0] for c in cache_list]) for f in _FIELDS}


def _model_step(params, stack, meta, cfg, tok, cache, pos: int):
    """One token: (logits [1, V], cache). The new rows are written into the
    cache in place at `pos`; the lm_head runs outside the kernel."""
    from ..ops.model_fused import model_decode_mega

    x = llama.embed(params, tok)                                   # [1, 1, h]
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=x.device))
    x, krows, vrows, ksr, vsr = model_decode_mega(
        stack, x, cos.reshape(-1)[-cfg.head_dim:], sin.reshape(-1)[-cfg.head_dim:],
        cache, pos, cfg, meta)
    for f, new in zip(_FIELDS, (krows, vrows, ksr, vsr)):
        cache[f][:, pos] = new
    h = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, h)[:, 0], cache


@torch.no_grad()
def decode_loop_model(params, stack, meta, cfg, token, cache, pos0: int, n: int):
    """Greedy-decode n tokens, ONE whole-model launch per token.
    token [1,1] -> (tokens [1,n], cache)."""
    refuse_shard(params, "decode_loop_model")
    toks = []
    tok = token
    for i in range(n):
        logits, cache = _model_step(params, stack, meta, cfg, tok, cache, int(pos0) + i)
        tok = torch.argmax(logits, -1).to(token.dtype)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache


# ---------------------------------------------------------------------------
# batched (B-slot) decode: the continuous-batching fast path
# ---------------------------------------------------------------------------

def default_lm(model: Model, meta):
    """The batchers' default for the fused terminal lm rows (mode (d)): off,
    as the reference's default, so the batched step's lm_head runs after the
    kernel through dequant_matmul with M = B. The reference's MI_FUSED_LM=1
    switch is not ported; a caller that wants the rows passes `stack_lm`'s
    result. Returns (lm, lm_meta)."""
    return None, None


def stack_cache_batched(cache_list):
    """Per-layer multi-slot cache (engine.init_cache dtype=int8, batch=B) ->
    HEAD-TRANSPOSED stacked dict for the batched kernel:
    k/v [L, B, Hkv, T, D], scales [L, B, Hkv, T]."""
    return {f: torch.stack([c[f] for c in cache_list]).transpose(2, 3).contiguous()
            for f in _FIELDS}


def unstack_cache_batched(cache, n_layers):
    """Inverse of stack_cache_batched (back to the per-layer engine layout)."""
    return [{f: cache[f][l].transpose(1, 2).contiguous() for f in _FIELDS}
            for l in range(n_layers)]


def _scatter(cache, rows, at1, at3):
    """Row r of each new field (krows, vrows, ksr, vsr: [L, R, Hkv(, D)])
    into cache[f][:, at1[r], :, at3[r]], in place: one indexed write a field.
    Advanced indices on axes 1 and 3 put the row axis first."""
    for f, new in zip(_FIELDS, rows):
        cache[f][:, at1, :, at3] = new.transpose(0, 1)
    return cache


def _host(a):
    return torch.as_tensor(a).to("cpu", torch.int64)


def _scatter_rows_batched(cache, krows, vrows, ksr, vsr, positions):
    """Write each slot's new rows at its own position, in place (one indexed
    write per field). Positions must lie inside the cache: unlike the
    reference's dynamic_update_slice, an out-of-range position raises
    instead of being clamped to the last row."""
    dev = krows.device
    b = torch.arange(krows.shape[1], device=dev)
    return _scatter(cache, (krows, vrows, ksr, vsr), b, _host(positions).reshape(-1).to(dev))


@torch.no_grad()
def model_step_batch(params, stack, meta, cfg, tokens, cache, positions, lm=None,
                     lm_meta=None):
    """One B-slot decode step: tokens [B,1], positions [B] (host ints, one
    per slot) -> (logits [B,V], cache). ONE launch for the whole decoder
    stack: the weights stream once for all B slots. With `lm` (stack_lm) the
    logits come from the kernel's terminal lm rows."""
    refuse_shard(params, "the batched whole-model step (tp = 1)")
    logits, cache = _step_rows(params, stack, meta, cfg, tokens, cache, positions, lm=lm,
                               lm_meta=lm_meta)
    return logits[:, 0], cache


def _step_rows(params, stack, meta, cfg, tokens, cache, positions, chunk=1, table=None,
               lm=None, lm_meta=None, scatter=None, group=None):
    """The whole-model launch for tokens [S, C] at positions [S*C] (C = chunk
    tokens a slot), the new rows scattered in place (`scatter`, default the
    dense one-row-a-slot scatter), then the lm_head, or with `lm` the
    kernel's own logits: (logits [S, C, V], cache)."""
    from ..ops.model_fused import model_decode_mega_batch

    S, C = tokens.shape
    h = cfg.hidden_size
    x = llama.embed(params, tokens).reshape(S * C, 1, h)
    pos = _host(positions).reshape(-1)
    cos, sin = llama.rope_tables(cfg, pos.to(x.device)[:, None])
    outs = model_decode_mega_batch(
        stack, x, cos.reshape(S * C, -1)[:, -cfg.head_dim:],
        sin.reshape(S * C, -1)[:, -cfg.head_dim:], cache, pos, cfg, meta, table=table,
        chunk=C, lm=lm, lm_meta=lm_meta, **_tp_kw(group))
    scatter = scatter or _scatter_rows_batched
    cache = scatter(cache, *outs[1:5], pos)
    if lm is not None:
        return outs[5].reshape(S, C, -1), cache
    hh = llama.rms_norm(outs[0].reshape(S, C, h), params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, hh), cache


def _tp_kw(group):
    if group is None:
        return {}
    from ..parallel.collectives import size_of

    return {"tp": size_of(group), "group": group}


# ---------------------------------------------------------------------------
# paged: one KV page pool shared by every slot through a page table
# ---------------------------------------------------------------------------

def init_pool_batched(cfg, n_pages: int, page_size: int, device=None):
    """Shared KV page POOL for the paged batched kernel: `n_pages` pages of
    `page_size` tokens, shared by every layer of every slot through a
    per-slot page table. Page 0 is the scratch page: never allocated, it
    absorbs dead slots' reads and writes. Layout: stack_cache_batched's with
    the page axis in place of the (slot, block) axes: k/v [L, n_pages, Hkv,
    P, D] int8 (zeros), scales [L, n_pages, Hkv, P] f32 (ones)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, n_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.ones(shape[:4], dtype=torch.float32, device=dev),
            "v_scale": torch.ones(shape[:4], dtype=torch.float32, device=dev)}


def _scatter_rows_paged(pool, krows, vrows, ksr, vsr, table, positions):
    """Write each row's new k/v row into its (page, offset) in place: page =
    table[b, pos // P], offset = pos % P. A retired slot (position 0, zero
    table row) and a chunk's pad rows past the allocated pages (table entry
    0) write into the scratch page 0, as in the reference."""
    P = pool["k"].shape[3]
    pos = _host(positions).reshape(-1)
    pg = _host(table)[torch.arange(pos.numel()), pos // P]
    dev = krows.device
    return _scatter(pool, (krows, vrows, ksr, vsr), pg.to(dev), (pos % P).to(dev))


@torch.no_grad()
def model_step_batch_paged(params, stack, meta, cfg, tokens, pool, table, positions, lm=None,
                           lm_meta=None):
    """model_step_batch over a shared KV page pool: tokens [B,1], table
    [B, pps], positions [B] -> (logits [B,V], pool). The same one-launch
    weight stream; the kernel reads history through the page table and the
    new rows scatter into (page, offset)."""
    logits, pool = _step_rows(
        params, stack, meta, cfg, tokens, pool, positions, table=table, lm=lm, lm_meta=lm_meta,
        scatter=lambda c, *r: _scatter_rows_paged(c, *r[:4], table, r[4]))
    return logits[:, 0], pool


@torch.no_grad()
def scatter_prefill_pages(pool, kvs, pages, valid, cfg):
    """Scatter one prefilled request's per-layer int8 KV slabs into its pages,
    in place. kvs: engine.init_cache/prefill output (batch 1, int8, T a
    multiple of the page size); pages [npg] pool pages; valid [npg] bool
    (invalid entries are redirected to the scratch page 0). Returns the
    pool."""
    P = pool["k"].shape[3]
    dev = pool["k"].device
    pg = torch.where(torch.as_tensor(valid, device=dev),
                     torch.as_tensor(pages, device=dev).to(torch.long), 0)
    for f in _FIELDS:
        a = torch.stack([c[f][0] for c in kvs]).transpose(1, 2)      # [L, Hkv, T(, D)]
        L, Hkv, T = a.shape[:3]
        # [L, Hkv, T(, D)] -> [L, npg, Hkv, P(, D)]
        pool[f][:, pg] = a.reshape(L, Hkv, T // P, P, *a.shape[3:]).transpose(1, 2)
    return pool


# ---------------------------------------------------------------------------
# chunk: C consecutive tokens a slot in one launch (spec-dec verify, suffix
# prefill)
# ---------------------------------------------------------------------------

def _scatter_chunk_rows_batched(cache, krows, vrows, ksr, vsr, prefixes, C):
    """Write each slot's C consecutive rows at its own prefix, in place.
    krows/vrows [L, B*C, Hkv, D] (slot-major rows), prefixes [B]. The rows
    must lie inside the cache (the reference's dynamic_update_slice would
    clamp them)."""
    pre = _host(prefixes).reshape(-1)
    at = (pre[:, None] + torch.arange(C)).reshape(-1)
    T = cache["k"].shape[3]
    if bool((at >= T).any()):
        raise ValueError(f"chunk rows {at.tolist()} outside the cache of {T}")
    dev = krows.device
    return _scatter(cache, (krows, vrows, ksr, vsr),
                    torch.arange(pre.numel()).repeat_interleave(C).to(dev), at.to(dev))


def _chunk_waves(n_slots: int, C: int):
    """(slot indices, first token, tokens) of the launches that cover
    n_slots chunks of C tokens at most MAX_BATCH rows each: waves of
    max(1, MAX_BATCH // C) slots; a chunk above MAX_BATCH tokens in
    consecutive sub-chunks of at most MAX_BATCH, in order."""
    from ..ops.model_fused import MAX_BATCH

    G = max(1, MAX_BATCH // C)
    for s0 in range(0, n_slots, G):
        for off in range(0, C, MAX_BATCH):
            yield list(range(s0, min(s0 + G, n_slots))), off, min(MAX_BATCH, C - off)


@torch.no_grad()
def model_step_chunk(params, stack, meta, cfg, tokens, cache, prefix, lm=None, lm_meta=None):
    """Whole-model CHUNK step: score C consecutive tokens of ONE sequence
    (positions prefix..prefix+C-1) with the intra-chunk causal attention in
    the kernel: one launch up to 8 tokens, else consecutive sub-chunks.
    tokens [1, C]; cache: the 1-slot batched stacked layout [L,1,Hkv,T,D].
    Returns (logits [C, V], cache with the C rows written); with `lm`
    (stack_lm) the logits come from the kernel's terminal lm rows. This is
    the speculative-decoding verify step."""
    logits, cache = model_step_chunk_batch(params, stack, meta, cfg, tokens, cache,
                                           [int(prefix)], lm=lm, lm_meta=lm_meta)
    return logits[0], cache


@torch.no_grad()
def model_step_chunk_batch(params, stack, meta, cfg, tokens, cache, prefixes, lm=None,
                           lm_meta=None):
    """B-slot chunk step: tokens [B, C], slot b's chunk at positions
    prefixes[b]..prefixes[b]+C-1 against its own cache slot; ONE whole-model
    launch up to 8 rows, else waves (the module's docstring). Returns (logits
    [B, C, V], cache with all B*C rows written)."""
    from ..ops.model_fused import MAX_BATCH

    B, C = tokens.shape
    pre = _host(prefixes).reshape(-1)
    if B * C > MAX_BATCH:
        # the dense slot cache as a pool of one T-row page a slot: a wave
        # reads its slots' rows through a table of their slot numbers
        return model_step_chunk_batch_paged(params, stack, meta, cfg, tokens, cache,
                                            torch.arange(B)[:, None], pre, lm=lm,
                                            lm_meta=lm_meta)
    return _step_rows(params, stack, meta, cfg, tokens, cache,
                      pre[:, None] + torch.arange(C), chunk=C, lm=lm, lm_meta=lm_meta,
                      scatter=lambda c, *r: _scatter_chunk_rows_batched(c, *r[:4], pre, C))


@torch.no_grad()
def model_step_chunk_batch_paged(params, stack, meta, cfg, tokens, pool, table, prefixes,
                                 lm=None, lm_meta=None):
    """model_step_chunk_batch over the shared page pool: tokens [B, C], table
    [B, pps]; each slot's C rows scatter into (page, offset) through its table
    row (the scheduler must have pages through position prefix+C-1; rows
    past them land in the scratch page 0). Launches of at most 8 rows in
    waves (the module's docstring). Returns (logits [B, C, V], pool)."""
    B, C = tokens.shape
    tbl = _host(table)
    pre = _host(prefixes).reshape(-1)
    logits = None
    for slots, off, c in _chunk_waves(B, C):
        rows_table = tbl[slots].repeat_interleave(c, 0)
        lg, pool = _step_rows(params, stack, meta, cfg, tokens[slots, off:off + c], pool,
                              pre[slots, None] + off + torch.arange(c), chunk=c,
                              table=tbl[slots], lm=lm, lm_meta=lm_meta,
                              scatter=lambda p, *r: _scatter_rows_paged(p, *r[:4], rows_table,
                                                                        r[4]))
        if logits is None:
            logits = lg.new_empty(B, C, lg.shape[-1])
        logits[slots, off:off + c] = lg
    return logits, pool


# ---------------------------------------------------------------------------
# tensor parallel: a rank's shard of the stack, and the steps of mode (e)
# ---------------------------------------------------------------------------
#
# Megatron head and intermediate parallelism of the batched kernel: the q/kv
# heads and the MLP columns shard over the group, the residual stays whole on
# every rank, and the o_proj and down_proj partials are summed over the group
# between the kernel's half-layer launches (the reference exchanges them
# inside its one launch, over remote DMAs between chips).


def _lin_out_slices(lin, spans):
    """The out-feature spans of a linear (packed columns, scale and zero rows)."""
    from ..parallel.sharding import cut_cols

    return cut_cols(lin, spans)


def _lin_in_slice(lin, a, b):
    """The in-features [a, b) of a linear (packed word rows, scale and zero
    groups; per-channel ones whole)."""
    from ..parallel.sharding import cut_rows

    return cut_rows(lin, a, b)


def _tp_blocks(model: Model, ntp: int, rank: int, zeros_only: bool = False):
    """Rank `rank`'s shard of every fused block (with zeros_only, of the
    linears' zeros only: what the meta reads)."""
    from ..parallel.sharding import shard_block

    cfg = model.config
    out = []
    for blk in model.params["layers"]:
        if zeros_only:
            blk = {n: (blk[n].replace(packed=None, weight=None, bias=None, perm=None,
                                      smooth_factor=None) if n in _LINEARS else blk[n])
                   for n in _LINEARS + ("input_norm", "post_norm")}
        nb = shard_block(blk, cfg, rank, ntp)
        for n in _LINEARS:
            nb[n].tp = None
        out.append(nb)
    return out


def stack_serving_tp(model: Model, ntp: int, rank: int):
    """(rank `rank`'s stack, meta, its config) for the batched kernel's
    mode (e) over `ntp` ranks, or None where the reference declines: a model
    without the fused serving blocks, heads, kv heads or MLP columns that do
    not split over ntp, a rank's MLP columns that do not cut on down_proj's
    groups, a rank's q or MLP features that do not fill whole words, or
    ranks whose metas differ (a zero constant over one rank's cut that is not
    over another's). The rank's stack equals its cut of the reference's
    shard-major stack; its blocks are the stack's views, as stack_serving's."""
    from ..parallel.sharding import rank_config

    cfg = model.config
    layers = model.params["layers"]
    if not layers or "qkv_proj" not in layers[0]:
        return None
    if cfg.num_heads % ntp or cfg.num_kv_heads % ntp or cfg.intermediate_size % ntp:
        return None
    bits = layers[0]["qkv_proj"].spec.wbit
    qdl, il = cfg.num_heads * cfg.head_dim // ntp, cfg.intermediate_size // ntp
    if il % max(_grp(layers[0]["down_proj"]), 1) or (qdl * bits) % 32 or (il * bits) % 32:
        return None
    cfg_l = rank_config(cfg, ntp)
    try:
        metas = []
        for s in range(ntp):
            shard = _tp_blocks(model, ntp, s, zeros_only=True)
            metas.append(tuple(_zconst(shard, n) for n in _LINEARS))
    except ValueError:  # a cut off whole words or groups
        return None
    if any(m != metas[0] for m in metas[1:]):
        return None
    blocks = _tp_blocks(model, ntp, rank)
    for b in blocks:
        b["mega"] = prepare_block(b, cfg_l)
    st = stack_serving(Model(config=cfg_l, params={
        "layers": blocks, "embed": model.params["embed"],
        "final_norm": model.params["final_norm"]}, family=model.family))
    return None if st is None else (st[0], st[1], cfg_l)


@torch.no_grad()
def model_step_batch_tp(params, stack, meta, cfg, tokens, cache, positions, group):
    """One B-slot decode step of this rank, tensor-parallel over `group`
    (model_step_batch with the kernel's mode (e)): `stack` is the rank's
    (`stack_serving_tp`, or stack_serving(..., tp=True) of a
    parallel.shard_model model),
    `cache` its kv heads [L, B, Hkv/tp, T, D]. Returns (logits [B, V],
    cache), the logits the same on every rank; the rank's new rows are
    scattered into its cache in place."""
    logits, cache = _step_rows(params, stack, meta, cfg, tokens, cache, positions, group=group)
    return logits[:, 0], cache


@torch.no_grad()
def model_step_batch_paged_tp(params, stack, meta, cfg, tokens, pool, table, positions, group):
    """model_step_batch_tp over the rank's head shard of the page pool
    [L, n_pages, Hkv/tp, P, D]; the table is every rank's. Returns
    (logits [B, V], pool)."""
    logits, pool = _step_rows(
        params, stack, meta, cfg, tokens, pool, positions, table=table, group=group,
        scatter=lambda c, *r: _scatter_rows_paged(c, *r[:4], table, r[4]))
    return logits[:, 0], pool
