"""Beam search on the paged batched whole-model kernel.

Port of mi_optimize_tpu/serving/beam.py. A beam search with a KV cache must
reorder the cache every step (child beams inherit their parent's history,
possibly many children a parent). On the page pool that is table surgery:
children share the parent's pages, refcounted, and only the page that
receives the next write (the one holding position pos + 1) is copied for
each extra child, as a parallel-sampling fork copies its tail page
(serving/paged.py).

Every decode step is ONE launch of the batched whole-model kernel for all W
beams (megadecode.model_step_batch_paged, kernel mode (b)); the device
reduces the [W, V] logits to each beam's top 2W log-softmax values and ids,
packed into one [2, W, 2W] f32 array (ids bitcast) and pulled in one
blocking copy; selection and scoring are host numpy. The top-k goes by
value, then the lower id, as the reference's lax.top_k. The
page table and free list are host numpy (int32 tables, int64 positions) and
the pool is updated in place.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.model import Model


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    m = x.max(axis=-1, keepdims=True)
    z = x - m
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def _topk_logprobs(logits: torch.Tensor, k: int) -> np.ndarray:
    """Per-row (log-softmax top-k values, token ids), computed on the device
    in lax.top_k's order (paged._topk) and packed into one f32 [2, W, k]
    numpy array (ids bitcast) for one pull. Exact for beam selection: a
    candidate of the global top 2W ranks <= 2W in its own row."""
    from .paged import _topk

    lf = logits.to(torch.float32)
    v, i = _topk(lf, k)
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    return torch.stack([v - lse, i.view(torch.float32)]).cpu().numpy()


def _norm(score: float, length: int, length_penalty: float) -> float:
    # simple normalization: score / len^alpha (alpha=0 -> raw sum)
    return score / (max(length, 1) ** length_penalty)


@torch.no_grad()
def beam_search(
    model: Model,
    prompt,
    beam_width: int = 4,
    max_new_tokens: int = 32,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    page_size: int = 128,
    max_len: Optional[int] = None,
    n_best: Optional[int] = None,
) -> List[Tuple[List[int], float]]:
    """Length-normalized beam search; returns the `n_best` (default
    beam_width) hypotheses as (new_tokens, normalized_score), best first.

    One prefill; every later step advances ALL beams in one paged batched
    launch. A finished hypothesis (eos) leaves the beam set and its slot is
    re-used by the next-best live candidate. The model must be served
    (serving.fuse_for_serving) and meet the batched kernel's contract; the
    search runs on the device of its tensors."""
    from .engine import init_cache, prefill
    from .megadecode import (default_lm, init_pool_batched, model_step_batch_paged,
                             refuse_shard, scatter_prefill_pages, stack_serving)
    from .paged import _copy_pool_page

    refuse_shard(model.params, "beam_search")
    st = stack_serving(model)
    if st is None:
        raise ValueError("model does not satisfy the megakernel contract")
    stack, meta = st
    cfg = model.config
    dev = model.params["embed"].device
    W = beam_width
    lm, lm_meta = default_lm(model, meta)

    P = page_size
    max_len = min(max_len or cfg.max_seq_len, cfg.max_seq_len)
    if max_len % P or P % 128:
        raise ValueError(f"page size {P} must be a multiple of 128 that divides "
                         f"max_len {max_len}")
    pps = max_len // P
    prompt = np.asarray(prompt).reshape(-1)[-(max_len - max_new_tokens - 1):]
    S = len(prompt)

    # page bookkeeping (PagedMegaBatcher's invariants: page 0 = scratch,
    # refcounted sharing, lazy growth at boundary crossings)
    n_pages = 1 + W * pps
    pool = init_pool_batched(cfg, n_pages, P, device=dev)
    table = np.zeros((W, pps), np.int32)
    refs = np.zeros(n_pages, np.int32)
    free = list(range(1, n_pages))

    def alloc():
        p = free.pop(0)
        refs[p] = 1
        return p

    def drop_row(w):
        for p in table[w]:
            if p != 0:
                refs[p] -= 1
                if refs[p] == 0:
                    free.append(int(p))
        table[w] = 0

    # ---- prefill beam 0, fork beams 1..W-1 (share full pages, copy tail)
    npg = S // P + 1
    for j in range(npg):
        table[0, j] = alloc()
    one = init_cache(cfg, 1, max_len, torch.int8, device=dev)
    logits0, one = prefill(model.params, cfg, torch.as_tensor(prompt[None, :], device=dev), one)
    n_slab = -(-S // P)
    pool = scatter_prefill_pages(pool, one, table[0], np.arange(pps) < n_slab, cfg)
    del one
    j0 = S // P
    for w in range(1, W):
        shared = table[0, :j0]
        table[w, :j0] = shared
        refs[shared] += 1
        table[w, j0] = alloc()
        if S % P:
            pool = _copy_pool_page(pool, int(table[0, j0]), int(table[w, j0]))

    logp0 = _log_softmax(logits0[0].to(torch.float32).cpu().numpy())
    first = np.argsort(-logp0, kind="stable")[:W]
    beams = [[int(t)] for t in first]             # new tokens per live beam
    scores = np.array([logp0[t] for t in first])  # raw logprob sums
    last = np.array([int(t) for t in first])
    positions = np.full(W, S, np.int64)
    alive = [eos_token_id is None or beams[w][-1] != eos_token_id for w in range(W)]
    finished: List[Tuple[List[int], float]] = []
    for w in range(W):
        if not alive[w]:
            finished.append((beams[w], _norm(scores[w], 1, length_penalty)))
            drop_row(w)

    while any(alive) and len(beams[0]) < max_new_tokens:
        live = [w for w in range(W) if alive[w]]
        # lazy growth: this step writes row `positions[w]` for every live beam
        for w in live:
            j = int(positions[w]) // P
            if table[w, j] == 0:
                table[w, j] = alloc()
        logits, pool = model_step_batch_paged(
            model.params, stack, meta, cfg, torch.as_tensor(last[:, None], device=dev), pool,
            table, positions, lm=lm, lm_meta=lm_meta)
        # device top-2W per beam (one compact pull); candidates from live
        # beams only; top 2W so that eos-absorbed picks still leave W live
        # continuations
        k2 = min(2 * W, cfg.vocab_size)
        packed = _topk_logprobs(logits, k2)
        lp = packed[0].astype(np.float64)
        li = packed[1].view(np.int32)
        cand = np.full((W, k2), -np.inf)
        cand[live] = scores[live, None] + lp[live]
        order = np.argsort(-cand.reshape(-1), kind="stable")[:2 * W]

        nlen = len(beams[live[0]]) + 1
        new_parent, new_tok, new_score = [], [], []
        for idx in order:
            p_, c_ = int(idx // k2), int(idx % k2)
            t_ = int(li[p_, c_])
            if eos_token_id is not None and t_ == eos_token_id:
                if len(finished) < 2 * W:
                    finished.append((beams[p_] + [t_],
                                     _norm(cand[p_, c_], nlen, length_penalty)))
                continue
            new_parent.append(p_)
            new_tok.append(t_)
            new_score.append(cand[p_, c_])
            if len(new_parent) == len(live):
                break

        # ---- reorder the page tables: children of one parent share its
        # pages; every extra child copies the page that receives the NEXT
        # write (position pos + 1), unless that write starts a fresh page
        old_table = table.copy()
        old_pos = positions.copy()
        new_rows = []
        first_child_of = {}
        for p_ in new_parent:
            row = old_table[p_].copy()
            j1 = (int(old_pos[p_]) + 1) // P
            if p_ not in first_child_of:
                first_child_of[p_] = True       # keeps the parent's row
            else:
                refs[row[row != 0]] += 1
                if j1 < pps and row[j1] != 0:   # mid-page: copy-on-write
                    src = int(row[j1])
                    dst = alloc()
                    pool = _copy_pool_page(pool, src, dst)
                    refs[src] -= 1              # row swaps src for dst
                    if refs[src] == 0:
                        free.append(src)
                    row[j1] = dst
            new_rows.append(row)
        # parents with no surviving child release their pages
        surviving = set(new_parent)
        for w in live:
            if w not in surviving:
                drop_row(w)
        # dead slots (the beam set shrank) route to the scratch page 0
        nb = [None] * W
        ns = np.full(W, -np.inf)
        nl = np.zeros(W, np.int64)
        npos = np.zeros(W, np.int64)
        table[:] = 0
        for i, (p_, t_, s_) in enumerate(zip(new_parent, new_tok, new_score)):
            nb[i] = beams[p_] + [t_]
            ns[i] = s_
            nl[i] = t_
            npos[i] = old_pos[p_] + 1
            table[i] = new_rows[i]
        beams = [b if b is not None else [] for b in nb]
        scores, last, positions = ns, nl, npos
        alive = [i < len(new_parent) for i in range(W)]
        if npos.max() >= max_len - 1:
            break

    for w in range(W):
        if alive[w]:
            finished.append((beams[w], _norm(scores[w], len(beams[w]), length_penalty)))
    finished.sort(key=lambda x: -x[1])
    return finished[:n_best or W]
