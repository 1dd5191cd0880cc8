"""Paged KV cache: slots share one page pool through per-slot page tables.

Port of mi_optimize_tpu/serving/paged.py: `_topk_packed`, `_copy_pool_page`,
`init_paged_cache`, `paged_decode_step`, `PagedMegaBatcher`,
`PagedSpeculativeBatcher` and `PagedRequest` / `PagedBatcher`.

The slot scheduler of batching.py reserves max_len rows of cache a slot;
paging lifts that: K/V live in fixed-size pages drawn from one pool, a
per-slot page table maps positions to pages, and the host-side scheduler
owns the free list. Memory scales with the tokens in flight, not with
n_slots x max_len.

  write:  page = table[slot, pos // P]; pages[page, pos % P] = kv
  read:   through the table, inside the kernels

Three batchers:
  * `PagedMegaBatcher`: each step is ONE launch of the batched whole-model
    kernel reading the int8 pool through the table (ops/model_fused.py mode
    (b)); batchers wider than 8 slots step in waves of 8; with
    prefix_cache=True full prompt pages are shared between requests and a
    hit's suffix runs through the paged chunk mode ((b) + (c)).
  * `PagedSpeculativeBatcher`: speculative rounds over the pool: the draft
    on the batched kernel over its own dense cache, the verify of every
    slot's k+1 tokens on the paged chunk mode, in waves.
  * `PagedBatcher`: the per-layer step over an f32 pool, attention through
    the paged flash-decode kernel (ops/paged_attention.py) where it applies.

The pools are updated in place (the reference's functional pools are
donated); the table, free list, refcounts and prefix-cache maps are host
numpy state, as in the reference, and decide which tokens are emitted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.model import Model
from ..models.quant_linear import quant_linear_apply
from .batching import _accept_round, _prefill_kv


def _topk_packed(logits, k):
    """[2, B, k] f32 numpy: per-row top-k values and bitcast token ids in one
    array, so the sampling step's device-to-host pull is a single copy."""
    v, i = torch.topk(logits.to(torch.float32), k, dim=-1)
    return torch.stack([v, i.to(torch.int32).view(torch.float32)]).cpu().numpy()


def _copy_pool_page(pool, src, dst):
    """Copy one pool page's content (all layers and fields) in place: the
    private tail page of a parallel-sampling fork when the prompt ends
    mid-page."""
    for f in pool:
        pool[f][:, dst] = pool[f][:, src]
    return pool


def init_paged_cache(cfg, n_pages: int, page_size: int, n_slots: int, pages_per_slot: int,
                     dtype=torch.float32, device=None):
    """Per-layer paged KV storage [(pk, pv) of [n_pages, P, Hkv, D]] plus one
    shared int32 page table [n_slots, pages_per_slot] (on the CPU: the
    scheduler owns it)."""
    dev = resolve_device(device)
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    layers = [(torch.zeros(shape, dtype=dtype, device=dev),
               torch.zeros(shape, dtype=dtype, device=dev)) for _ in range(cfg.num_layers)]
    return layers, torch.zeros((n_slots, pages_per_slot), dtype=torch.int32)


@torch.no_grad()
def paged_decode_step(params, cfg, tokens, layers, table, positions, page_size, fused=True):
    """tokens [B,1], table [B, pps], positions [B] -> (logits [B,V], layers).

    Per layer: write this step's k/v into (page, offset) in place, then
    attend through the page table: the paged flash-decode kernel where
    `paged_attention_supported`, else a gather of each slot's pages into its
    logical [T, Hkv, D] view and the stock attention."""
    from ..ops.paged_attention import (check_table, paged_attention_supported,
                                       paged_flash_attention)

    B = tokens.shape[0]
    x = llama.embed(params, tokens)
    dev = x.device
    # checked on the host and copied to the card once for every layer's launch
    tbl, pos32 = (t.to(dev) for t in check_table(table, positions, B, layers[0][0].shape[0],
                                                 page_size))
    pos = pos32.to(torch.long)
    T = tbl.shape[1] * page_size
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_dim, kv_dim = H * D, Hkv * D
    cos, sin = llama.rope_tables(cfg, pos[:, None])
    mask = (torch.arange(T, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    page_idx = tbl[torch.arange(B, device=dev), pos // page_size].to(torch.long)
    offset = pos % page_size
    kernel = fused and paged_attention_supported(page_size, D)

    for blk, (pk, pv) in zip(params["layers"], layers):
        # attention must see the whole paged history, so the block is inlined
        # here (block_apply's cache path takes a contiguous per-slot buffer)
        h = llama.rms_norm(x, blk["input_norm"], cfg.rms_eps)
        if "qkv_proj" in blk:
            qkv = quant_linear_apply(blk["qkv_proj"], h, fused=fused)
            q, k, v = qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim], qkv[..., q_dim + kv_dim:]
        else:
            q = quant_linear_apply(blk["q_proj"], h, fused=fused)
            k = quant_linear_apply(blk["k_proj"], h, fused=fused)
            v = quant_linear_apply(blk["v_proj"], h, fused=fused)
        q = llama.apply_rope(q.reshape(B, 1, H, D), cos, sin, cfg)
        k = llama.apply_rope(k.reshape(B, 1, Hkv, D), cos, sin, cfg)
        v = v.reshape(B, 1, Hkv, D)
        pk[page_idx, offset] = k[:, 0].to(pk.dtype)
        pv[page_idx, offset] = v[:, 0].to(pv.dtype)
        if kernel:
            attn = paged_flash_attention(q.reshape(B, -1), pk, pv, tbl, pos32, n_heads=H,
                                         n_kv_heads=Hkv, head_dim=D, page_size=page_size)
            attn = attn.reshape(B, 1, q_dim).to(x.dtype)
        else:
            k_all = pk[tbl.to(torch.long)].reshape(B, T, Hkv, D)
            v_all = pv[tbl.to(torch.long)].reshape(B, T, Hkv, D)
            attn = llama.attention(q, k_all.to(q.dtype), v_all.to(q.dtype), mask, cfg)
            attn = attn.reshape(B, 1, q_dim)
        x = x + quant_linear_apply(blk["o_proj"], attn, fused=fused)
        x = llama._mlp_tail(blk, x, cfg, {}, False, fused)

    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused)[:, 0], layers


def _f32(t) -> np.ndarray:
    return t.to(torch.float32).cpu().numpy()


class PagedMegaBatcher:
    """Continuous batching over a shared KV page POOL with the batched
    whole-model decode kernel: page-pool memory (memory scales with tokens in
    flight, pages recycle across requests) with the one-launch-per-step
    batched path. The kernel reads the history THROUGH the page table, so a
    step moves the dense batched step's bytes.

    The pool lives on the device of the model's tensors. Page size = a
    multiple of 128 tokens. Page 0 is scratch: retired slots point at it and
    their writes land there. Allocation is host-side (free list); a slot
    allocates lazily as its position crosses a page boundary. `n_pages`
    sizes the pool, which may be far below n_slots * max_len / P;
    `add_request` returns None when the pool cannot cover the prompt, and
    `step` raises if lazy growth finds the pool exhausted.

    prefix_cache=True: every full prompt page is registered under a chain
    hash of all tokens through its end; a later request whose prompt starts
    with a cached chain maps those pages (refcount + 1, no prefill for them)
    and runs only its suffix, through the paged whole-model CHUNK step
    (megadecode.model_step_chunk_batch_paged) 8 tokens a launch. Pages whose
    refcount drops to zero stay resident on an LRU list and are evicted only
    under allocator pressure. The admission clamp reserves one chunk quantum
    of slot capacity for the suffix chunk's pad rows, even on a miss.

    Numerics: hit pages hold the same KV bytes (same tokens, same positions),
    so cached and uncached runs differ only in the suffix path (chunk kernel
    vs prefill): greedy-exact in float32 on the CPU; in bf16 on random
    weights a near-tie argmax may flip.

    Batchers of more than `wave_slots` (default 8) slots step in waves of
    that many rows over the shared pool, a short wave padded by repeating
    its last slot (the duplicate row rewrites the same (page, offset) with
    the same data)."""

    def __init__(self, model: Model, n_slots: int = 4, max_len: int = 512, page_size: int = 128,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 wave_slots: Optional[int] = None):
        from ..ops.model_fused import MAX_BATCH
        from .megadecode import default_lm, init_pool_batched, stack_serving

        if max_len % page_size or page_size % 128:
            raise ValueError(f"page size {page_size} must be a multiple of 128 that divides "
                             f"max_len {max_len}")
        if wave_slots is not None and not 1 <= wave_slots <= MAX_BATCH:
            raise ValueError(f"wave_slots {wave_slots}: the batched kernel takes 1 to "
                             f"{MAX_BATCH} rows a launch")
        self.device = resolve_device(model.params["embed"].device)
        st = stack_serving(model)
        if st is None:
            raise ValueError("model does not satisfy the megakernel contract")
        self.model = model
        self.cfg = model.config
        self._mega = st
        self._lm = default_lm(model, st[1])
        self._wave = wave_slots          # None -> _wave_size() default (8)
        self.page_size = page_size
        self.max_len = min(max_len, self.cfg.max_seq_len)
        self.pps = self.max_len // page_size
        if n_pages is None:
            n_pages = 1 + n_slots * self.pps
        self.n_slots = n_slots
        self.pool = init_pool_batched(self.cfg, n_pages, page_size, device=self.device)
        self.table = np.zeros((n_slots, self.pps), np.int32)
        self.free_pages = list(range(1, n_pages))
        # full prompt pages are SHARED between the n forks of a parallel-
        # sampling request: refcounted, freed at zero
        self.page_refs = np.zeros(n_pages, np.int32)
        self.positions = np.zeros(n_slots, np.int64)
        self.last_token = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional["Request"]] = [None] * n_slots
        self.slot_sample: List[Optional[dict]] = [None] * n_slots
        self._next_rid = 0
        # automatic prefix cache state (all host-side)
        self._pc = prefix_cache
        self._pc_key2page: Dict[int, int] = {}   # chain hash -> pool page
        self._pc_page2key: Dict[int, int] = {}   # inverse (registered pages)
        self._pc_lru: Dict[int, None] = {}       # refcount-0 cached pages, LRU
        self.pc_hit_tokens = 0
        self.pc_miss_tokens = 0

    def _alloc(self, n):
        if len(self.free_pages) + len(self._pc_lru) < n:
            return None
        while len(self.free_pages) < n:  # evict the coldest cached pages
            pg = next(iter(self._pc_lru))
            del self._pc_lru[pg]
            del self._pc_key2page[self._pc_page2key.pop(pg)]
            self.free_pages.append(pg)
        out = self.free_pages[:n]
        del self.free_pages[:n]
        self.page_refs[out] = 1
        return out

    def _ref_cached(self, page: int):
        """Take a reference on a prefix-cache hit page (possibly reviving it
        off the refcount-0 LRU list)."""
        if self.page_refs[page] == 0:
            self._pc_lru.pop(page, None)
        self.page_refs[page] += 1

    def _unref(self, page: int):
        """Drop one reference; at zero, registered pages go back on the LRU
        (evictable, still cached) and unregistered ones to the free list."""
        page = int(page)
        self.page_refs[page] -= 1
        if self.page_refs[page] == 0:
            if page in self._pc_page2key:
                self._pc_lru[page] = None
            else:
                self.free_pages.append(page)

    def _page_keys(self, prompt) -> List[int]:
        """Chain hash per full page: key[j] covers tokens [0, (j+1)*P), so a
        page is reusable only when its ENTIRE prefix matches."""
        P = self.page_size
        keys, h = [], 0
        arr = np.asarray(prompt, np.int64)
        for j in range(len(arr) // P):
            h = hash((h, arr[j * P:(j + 1) * P].tobytes()))
            keys.append(h)
        return keys

    def prefix_cache_stats(self) -> Dict[str, int]:
        return {"hit_tokens": self.pc_hit_tokens,
                "miss_tokens": self.pc_miss_tokens,
                "cached_pages": len(self._pc_key2page),
                "evictable_pages": len(self._pc_lru)}

    def _retire(self, slot):
        for p in self.table[slot]:
            if p != 0:
                self._unref(p)
        self.table[slot] = 0
        self.positions[slot] = 0   # a dead slot reads and writes only the scratch page 0
        self.last_token[slot] = 0
        self.slot_req[slot] = None
        self.slot_sample[slot] = None

    def _headroom(self) -> int:
        # rows past the current position a step may write
        return 1

    def _pc_chunk_quantum(self) -> int:
        """Tokens a suffix-prefill launch: 8 (the batched kernel's row limit,
        the reference's quantum); longer suffixes run several launches."""
        return 8

    def _draw(self, st, vals) -> int:
        """Index into `vals` (logits) drawn with the slot's temperature,
        top-k and top-p truncation (engine._sample's semantics) and its own
        deterministic rng."""
        x = vals.astype(np.float64) / st["temperature"]
        if st["top_k"]:
            kth = np.sort(x)[-min(st["top_k"], x.shape[0])]
            x = np.where(x < kth, -np.inf, x)
        p = np.exp(x - x.max())
        p /= p.sum()
        if st["top_p"] < 1.0:
            order = np.argsort(-p)
            keep = np.cumsum(p[order]) < st["top_p"]
            keep[0] = True             # always keep the most likely token
            mask = np.zeros(p.shape, bool)
            mask[order[keep]] = True
            p = np.where(mask, p, 0.0)
            p /= p.sum()
        return int(st["rng"].choice(p.shape[0], p=p))

    def _pick(self, slot, logits_row) -> int:
        """Per-slot next token from full logits: greedy, or a draw (forks of
        one request differ only by their draws)."""
        st = self.slot_sample[slot]
        if st is None or st["temperature"] <= 0.0:
            return int(np.argmax(logits_row))
        return self._draw(st, logits_row)

    def _pick_topk(self, slot, vals_row, idx_row) -> int:
        """_pick over the device's top-K (values, token ids), ordered by value
        and then by lower id: greedy = idx_row[0]; a draw maps back through
        idx_row."""
        st = self.slot_sample[slot]
        if st is None or st["temperature"] <= 0.0:
            return int(idx_row[0])
        return int(idx_row[self._draw(st, vals_row)])

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None, n: int = 1,
                    temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                    seed: Optional[int] = None):
        """Admit a request; returns its rid (or None if not admittable).

        n > 1: PARALLEL SAMPLING: n forks of the prompt decode independently
        (one prefill; the full prompt pages are shared, refcounted, between
        forks; only the partial tail page is copied per fork), each sampling
        with its own rng (seed + fork). Returns the list of n rids, or None
        (all-or-nothing admission)."""
        from .batching import Request
        from .engine import init_cache, prefill
        from .megadecode import model_step_chunk_batch_paged, scatter_prefill_pages

        assert n >= 1
        if n > 1 and temperature <= 0.0:
            raise ValueError("parallel sampling (n>1) needs temperature > 0 "
                             "(greedy forks would be identical)")
        slots = [i for i, r in enumerate(self.slot_req) if r is None][:n]
        if len(slots) < n:
            return None
        keep = max(self.max_len - max_new_tokens - self._headroom(), 1)
        if self._pc:
            # a suffix chunk's pad rows reach position S + q - 2; keep them
            # inside the slot's page-table row
            keep = min(keep, self.max_len - self._pc_chunk_quantum())
        prompt = np.asarray(prompt).reshape(-1)[-keep:]
        S = len(prompt)
        P = self.page_size
        npg = S // P + 1               # covers positions 0..S (the first decode row)

        # prefix-cache lookup: the longest cached chain of full pages, capped
        # so that at least the last prompt token is computed (its logits)
        keys = self._page_keys(prompt) if self._pc else []
        nhit = 0
        for k in keys:
            if k in self._pc_key2page:
                nhit += 1
            else:
                break
        nhit = min(nhit, (S - 1) // P)

        # pin the hit pages BEFORE allocating: _alloc evicts refcount-0 LRU
        # pages and could otherwise hand out the very pages about to be mapped
        hit_pages = [self._pc_key2page[keys[j]] for j in range(nhit)]
        for pg in hit_pages:
            self._ref_cached(pg)

        # the primary takes npg - nhit fresh pages; each fork adds a private tail
        pages = self._alloc(npg - nhit + (n - 1))
        if pages is None and nhit:
            # the pool cannot cover the suffix with the hit pages pinned: fall
            # back to a full miss, which may evict the would-be hit pages
            for pg in hit_pages:
                self._unref(pg)
            nhit, hit_pages = 0, []
            pages = self._alloc(npg + (n - 1))
        if pages is None:
            return None
        slot = slots[0]
        for j, pg in enumerate(hit_pages):
            self.table[slot, j] = pg
        self.table[slot, nhit:npg] = pages[:npg - nhit]
        # stats count only ADMITTED work
        self.pc_hit_tokens += nhit * P
        self.pc_miss_tokens += S - nhit * P

        params = self.model.params
        if nhit == 0:
            # batch-1 prefill at the full logical capacity, then whole-page
            # scatter of the first ceil(S/P) pages (the rest go to scratch)
            one = init_cache(self.cfg, 1, self.max_len, torch.int8, device=self.device)
            logits, one = prefill(params, self.cfg,
                                  torch.as_tensor(prompt[None, :], device=self.device), one, True)
            n_slab = -(-S // P)
            self.pool = scatter_prefill_pages(self.pool, one, self.table[slot],
                                              np.arange(self.pps) < n_slab, self.cfg)
            logits0 = _f32(logits[0])
        else:
            # suffix prefill THROUGH the page table: the paged whole-model
            # chunk step scores q tokens a launch against the hit pages. Pad
            # rows (position > S-1) land in fresh or scratch pages and are
            # overwritten (by decode or a later chunk) before they are read.
            suf = prompt[nhit * P:]
            s_len = len(suf)
            q = self._pc_chunk_quantum()
            logits0 = None
            off = 0
            while off < s_len:
                n_real = min(q, s_len - off)
                toks = np.zeros(q, prompt.dtype)
                toks[:n_real] = suf[off:off + n_real]
                logits_c, self.pool = model_step_chunk_batch_paged(
                    params, self._mega[0], self._mega[1], self.cfg,
                    torch.as_tensor(toks[None, :], device=self.device), self.pool,
                    self.table[slot:slot + 1], [nhit * P + off])
                if off + n_real == s_len:
                    logits0 = _f32(logits_c[0, n_real - 1])
                off += n_real

        # register this prompt's full pages for future hits
        if self._pc:
            for j in range(S // P):
                pg = int(self.table[slot, j])
                if keys[j] not in self._pc_key2page and pg != 0:
                    self._pc_key2page[keys[j]] = pg
                    self._pc_page2key[pg] = keys[j]

        rids = []
        for f, s in enumerate(slots):
            if f > 0:
                tail = pages[npg - nhit + f - 1]
                j0 = S // P            # the page written from S on
                shared = self.table[slot, :j0]
                self.table[s, :j0] = shared
                self.page_refs[shared] += 1
                self.table[s, j0] = tail
                if S % P:              # the tail page holds prompt rows: copy it
                    self.pool = _copy_pool_page(self.pool, int(self.table[slot, j0]), int(tail))
            req = Request(self._next_rid, prompt, max_new_tokens, eos_token_id)
            self._next_rid += 1
            self.slot_sample[s] = None if temperature <= 0.0 else {
                "temperature": temperature, "top_p": top_p, "top_k": top_k,
                "rng": np.random.default_rng(None if seed is None else seed + f),
            }
            tok = self._pick(s, logits0)
            req.tokens.append(tok)
            self.positions[s] = S
            self.last_token[s] = tok
            self.slot_req[s] = req
            rids.append(req.rid)
        return rids if n > 1 else rids[0]

    def _wave_size(self) -> int:
        """Most slots a kernel launch decodes (the batched kernel's 8 rows)."""
        return self._wave or 8

    def step(self) -> Dict[int, int]:
        from .megadecode import model_step_batch_paged

        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return {}
        P = self.page_size
        for i in active:  # lazy page growth at boundary crossings
            j = int(self.positions[i]) // P
            if self.table[i, j] == 0:
                pg = self._alloc(1)
                if pg is None:
                    raise RuntimeError("KV page pool exhausted")
                self.table[i, j] = pg[0]
        stack, meta = self._mega
        lm = self._lm[0] if self._lm is not None else None
        W = self._wave_size()
        dev = self.device
        if self.n_slots <= W:
            row_of = {i: i for i in active}
            logits, self.pool = model_step_batch_paged(
                self.model.params, stack, meta, self.cfg,
                torch.as_tensor(self.last_token[:, None], device=dev), self.pool, self.table,
                self.positions, lm=lm)
        else:
            # waves of W slots over the shared pool; a short wave pads by
            # repeating its last active slot
            parts = []
            row_of: Dict[int, int] = {}
            r0 = 0
            for o in range(0, len(active), W):
                g = active[o:o + W]
                idx = g + [g[-1]] * (W - len(g))
                lg, self.pool = model_step_batch_paged(
                    self.model.params, stack, meta, self.cfg,
                    torch.as_tensor(self.last_token[idx][:, None], device=dev), self.pool,
                    self.table[idx], self.positions[idx], lm=lm)
                parts.append(lg)
                for off, s in enumerate(idx):
                    row_of.setdefault(s, r0 + off)
                r0 += W
            logits = torch.cat(parts, 0)
        # compact pull: greedy slots need only the device argmax (the first
        # index of the maximum, as the reference's); sampling slots get the
        # device top-K with K = max(256, the largest top_k requested)
        if all(self.slot_sample[i] is None for i in active):
            toks_np = torch.argmax(logits, -1).cpu().numpy()
            pick = lambda i: int(toks_np[row_of[i]])
        else:
            want = max([256] + [int(self.slot_sample[i]["top_k"]) for i in active
                                if self.slot_sample[i] is not None])
            K = min(want, logits.shape[-1])
            packed = _topk_packed(logits, K)
            vals_np, idx_np = packed[0], packed[1].view(np.int32)
            # torch.topk leaves the order among equal values open; order the
            # candidates as the reference's top_k does: by value, then lower id
            order = np.lexsort((idx_np, -vals_np), axis=-1)
            vals_np = np.take_along_axis(vals_np, order, -1)
            idx_np = np.take_along_axis(idx_np, order, -1)
            pick = lambda i: self._pick_topk(i, vals_np[row_of[i]], idx_np[row_of[i]])
        out = {}
        for i in active:
            req = self.slot_req[i]
            tok = pick(i)
            req.tokens.append(tok)
            out[req.rid] = tok
            self.positions[i] += 1
            self.last_token[i] = tok
            hit_eos = req.eos_token_id is not None and tok == req.eos_token_id
            if len(req.tokens) >= req.max_new_tokens or hit_eos \
                    or self.positions[i] >= self.max_len - 1:
                req.done = True
                self._retire(i)
        return out

    def run_all(self, prompts, max_new_tokens=16) -> Dict[int, List[int]]:
        pending = list(prompts)
        results: Dict[int, List[int]] = {}
        reqs = []
        while pending or any(r is not None for r in self.slot_req):
            while pending:
                rid = self.add_request(pending[0], max_new_tokens)
                if rid is None:
                    break
                reqs.append([r for r in self.slot_req if r and r.rid == rid][0])
                pending.pop(0)
            if not any(r is not None for r in self.slot_req):
                if pending:  # nothing running and nothing admittable
                    raise RuntimeError("page pool too small for request")
                break
            self.step()
        for r in reqs:
            results[r.rid] = r.tokens
        return results


class PagedSpeculativeBatcher(PagedMegaBatcher):
    """Speculative decoding under page-pool memory management: each step
    drafts k tokens a slot (the batched whole-model kernel over the draft's
    dense stacked cache: the draft is the small model; the target's KV, the
    big allocation, lives in the shared pool), then verifies every slot's
    k+1-token chunk on the paged chunk mode, reading and writing the pool
    through the page table (megadecode.model_step_chunk_batch_paged).

    Greedy speculative decoding is exact, so the emitted sequences equal the
    plain paged batcher's up to the capacity boundary (slots retire 2k+1
    tokens earlier). Pages grow lazily: before a round each active slot
    takes any missing page covering its prefix..prefix+k. The verify runs in
    waves of `verify_wave_slots` (default max(1, 8 // (k+1))) over all
    n_slots, free ones included, as the reference; a short wave repeats its
    last slot (the duplicate rows rewrite the same data). The draft takes at
    most 8 slots (the batched kernel's rows). `fused_lm` as
    SpeculativeBatcher's."""

    def __init__(self, model: Model, draft: Model, k: int = 4, n_slots: int = 4,
                 max_len: int = 512, page_size: int = 128, n_pages: Optional[int] = None,
                 verify_wave_slots: Optional[int] = None, fused_lm: bool = False):
        from ..ops.model_fused import MAX_BATCH
        from .batching import verify_lm
        from .engine import init_cache
        from .megadecode import stack_cache_batched, stack_serving

        super().__init__(model, n_slots, max_len, page_size, n_pages)
        if fused_lm:
            self._lm = verify_lm(model, self._mega)
        self._verify_wave = verify_wave_slots   # None -> max(1, 8 // (k+1)) slots
        self.draft = draft
        self.k = k
        st = stack_serving(draft)
        if st is None:
            raise ValueError("draft does not satisfy the megakernel contract")
        if n_slots > MAX_BATCH:
            raise ValueError(f"the batched whole-model kernel drafts at most {MAX_BATCH} slots, "
                             f"not {n_slots}")
        self._dmega = st
        self.ddevice = resolve_device(draft.params["embed"].device)
        self.dcache = stack_cache_batched(init_cache(draft.config, n_slots, self.max_len,
                                                     torch.int8, device=self.ddevice))
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0

    def _headroom(self) -> int:
        return 2 * self.k + 2

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None):
        from .batching import _prefill_into_slot_mega

        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return None
        rid = super().add_request(prompt, max_new_tokens, eos_token_id)
        if rid is None:
            return None
        ids = torch.as_tensor(self.slot_req[slot].prompt[None, :], device=self.ddevice)
        _, self.dcache = _prefill_into_slot_mega(self.draft.params, self.draft.config, ids,
                                                 self.dcache, slot, self.max_len)
        return rid

    def step(self) -> Dict[int, List[int]]:
        """One speculative round for all active slots; returns {rid: [new
        tokens]}."""
        from .batching import draft_propose_batch
        from .megadecode import model_step_chunk_batch_paged

        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return {}
        P, k = self.page_size, self.k
        for i in active:  # lazy growth: this round writes rows pos..pos+k
            for j in range(int(self.positions[i]) // P, (int(self.positions[i]) + k) // P + 1):
                if self.table[i, j] == 0:
                    pg = self._alloc(1)
                    if pg is None:
                        raise RuntimeError("KV page pool exhausted")
                    self.table[i, j] = pg[0]
        toks = torch.as_tensor(self.last_token[:, None], device=self.ddevice)
        dstack, dmeta = self._dmega
        props, self.dcache = draft_propose_batch(self.draft.params, dstack, dmeta,
                                                 self.draft.config, toks, self.dcache,
                                                 self.positions, k)
        chunk = torch.cat([toks, props], dim=1).to(self.device)                # [B, k+1]
        stack, meta = self._mega
        B = chunk.shape[0]
        G = self._verify_wave or max(1, 8 // (k + 1))
        parts = []
        for o in range(0, B, min(G, B)):
            g = list(range(o, min(o + G, B)))
            idx = g + [g[-1]] * (G - len(g))
            lg, self.pool = model_step_chunk_batch_paged(
                self.model.params, stack, meta, self.cfg, chunk[idx], self.pool,
                self.table[idx], self.positions[idx], lm=self._lm[0], lm_meta=self._lm[1])
            parts.append(torch.argmax(lg, -1)[:len(g)])
        ver = torch.cat(parts, 0).cpu().numpy()                                # [B, k+1]
        return _accept_round(self, active, ver, props.cpu().numpy(),
                             self.max_len - self._headroom(), self._retire)


@dataclass
class PagedRequest:
    rid: int
    tokens: List[int] = field(default_factory=list)
    max_new_tokens: int = 32
    done: bool = False


class PagedBatcher:
    """Continuous batching over the shared page pool, one launch chain per
    layer a step (`paged_decode_step`); the pool (f32 by default) lives on
    the device of the model's tensors. Each request takes all the pages it
    can need when it is admitted."""

    def __init__(self, model: Model, n_slots=4, page_size=16, n_pages=64, pages_per_slot=8,
                 fused=True):
        self.model = model
        self.cfg = model.config
        self.fused = fused
        self.device = resolve_device(model.params["embed"].device)
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.layers, table = init_paged_cache(self.cfg, n_pages, page_size, n_slots,
                                              pages_per_slot, device=self.device)
        self.table = table.numpy()  # host-owned, writable
        # page 0 is a scratch page never read (slots start with real pages)
        self.free_pages = list(range(1, n_pages))
        self.positions = np.zeros(n_slots, np.int64)
        self.last_token = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional[PagedRequest]] = [None] * n_slots
        self._rid = 0

    def _alloc(self, n):
        if len(self.free_pages) < n:
            return None
        out = self.free_pages[:n]
        del self.free_pages[:n]
        return out

    def _free_slot(self, slot):
        used = [p for p in self.table[slot] if p != 0]
        self.free_pages.extend(int(p) for p in used)
        self.table[slot] = 0

    def add_request(self, prompt, max_new_tokens=16) -> Optional[int]:
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return None
        prompt = np.asarray(prompt).reshape(-1)
        total = len(prompt) + max_new_tokens
        need = -(-total // self.page_size)
        if need > self.pages_per_slot:
            raise ValueError("request exceeds pages_per_slot capacity")
        pages = self._alloc(need)
        if pages is None:
            return None
        self.table[slot, :need] = pages

        logits, kvs = _prefill_kv(self.model.params, self.cfg,
                                  torch.as_tensor(prompt[None, :], device=self.device),
                                  self.fused)
        S = len(prompt)
        # write the prompt's K/V into this slot's pages, in place
        pos = np.arange(S)
        pg = torch.as_tensor(self.table[slot][pos // self.page_size], device=self.device)
        off = torch.as_tensor(pos % self.page_size, device=self.device)
        for (pk, pv), (ck, cv) in zip(self.layers, kvs):
            pk[pg.to(torch.long), off] = ck[0].to(pk.dtype)
            pv[pg.to(torch.long), off] = cv[0].to(pv.dtype)

        req = PagedRequest(self._rid, max_new_tokens=max_new_tokens)
        self._rid += 1
        tok = int(np.argmax(_f32(logits[0])))
        req.tokens.append(tok)
        self.positions[slot] = S
        self.last_token[slot] = tok
        self.slot_req[slot] = req
        return req.rid

    def step(self) -> Dict[int, int]:
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return {}
        logits, self.layers = paged_decode_step(
            self.model.params, self.cfg,
            torch.as_tensor(self.last_token[:, None], device=self.device), self.layers,
            self.table, self.positions, self.page_size, self.fused)
        # argmax on the device: bring back [B] ids, not [B, V] logits
        toks = torch.argmax(logits, -1).cpu().numpy()
        out = {}
        for i in active:
            req = self.slot_req[i]
            tok = int(toks[i])
            req.tokens.append(tok)
            out[req.rid] = tok
            self.positions[i] += 1
            self.last_token[i] = tok
            if len(req.tokens) >= req.max_new_tokens:
                req.done = True
                self._free_slot(i)
                self.slot_req[i] = None
        return out
