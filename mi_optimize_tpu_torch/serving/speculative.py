"""Speculative decoding: a cheap draft model proposes, the target verifies.

Port of mi_optimize_tpu/serving/speculative.py. Greedy speculative decoding
is exact: a proposal is accepted only while it equals the target's argmax
given the verified prefix, so the emitted sequence is the target's own
greedy decode. Both models keep a KV cache, prefilled once on the prompt; a
round drafts k tokens, verifies the k+1 tokens [last, p_0..p_{k-1}] with one
chunk step of the target, and keeps the accepted proposals plus the
target's token after them. Rejected rows stay in the caches past the
verified prefix, masked by position, and are overwritten later.

Routes of `speculative_generate` (the reference's, each with its kernels):
  * scan-flat (`_spec_scan_flat`): the draft on the flat kernel (k+1 steps a
    round, the last one ingesting p_{k-1}), the verify on the batched
    kernel's chunk mode with its fused lm rows (mode d) for chunks of at
    most `fused_lm_max_chunk` rows; m rounds a segment, the surplus of the
    last segment cut off; k="auto" re-picks k between segments;
  * `_spec_loop_mega_full`: the draft on the whole-model kernel, the verify
    on the chunk mode;
  * `_spec_loop_mega`: the draft on the whole-model kernel, the verify per
    layer (engine.prefill_chunk);
  * `_spec_loop`: draft and verify per layer;
  * the host loop (on_device=False), whose draft ingests p_{k-1} only when
    all k proposals were accepted.
The reference runs the first four inside one device program (a while loop
or scan segments); PyTorch runs eagerly, so here they are host loops with
the same structure, which decides the cache contents and the stats.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.model import Model
from .engine import decode_loop, decode_step, init_cache, prefill, prefill_chunk

#: adaptive-k candidate set (k="auto")
ADAPT_KSET = (2, 4, 8)
#: The reference's selection policy, copied verbatim: per-k round costs in
#: milliseconds, with the linear model of the other keys for unlisted k.
#: Only their ratios pick k. They were set on the reference's hardware and
#: are not the port's times; `speculative_generate(cost_model=...)` replaces
#: the table.
ADAPT_COST = {"round_ms": {2: 10.5, 4: 11.7, 8: 17.4},
              "verify_base_ms": 9.0, "verify_ms_per_tok": 0.3,
              "draft_ms_per_tok": 0.5}
#: the reference's gate: the fused lm rows verify chunks of at most this many rows
FUSED_LM_MAX_CHUNK = 6


def _best_k(q_hat: float, kset=ADAPT_KSET, cost=None) -> int:
    """The k maximizing expected emitted tokens per unit round cost under a
    per-token agreement q: a round with chunk k emits (1 - q^(k+1)) / (1 - q)
    tokens (truncated-geometric acceptance). Round costs come from the
    table's per-k entries when it has them, else from its linear model."""
    c = cost or ADAPT_COST
    q = min(max(q_hat, 0.0), 0.999)
    table = c.get("round_ms", {})

    def rate(k):
        e = (k + 1) if q > 0.998 else (1.0 - q ** (k + 1)) / (1.0 - q)
        ms = table.get(k, c["verify_base_ms"]
                       + (c["verify_ms_per_tok"] + c["draft_ms_per_tok"]) * (k + 1))
        return e / ms

    return max(kset, key=rate)


def _spec_while(draft_fn, verify_fn, tcache, dcache, last_tok: int, pos0: int, k: int, n: int):
    """The propose -> verify -> accept loop shared by the while-loop routes.

    draft_fn(last, dcache, pos) -> (props [k] ints, dcache with all k+1 rows
    ingested); verify_fn(chunk [1, k+1], tcache, pos) -> (ver [k+1] ints,
    tcache). Returns (the first n emitted tokens, rounds, accepted,
    proposed)."""
    out, pos, last = [], pos0, last_tok
    rounds = acc = prop = 0
    while len(out) < n:
        props, dcache = draft_fn(last, dcache, pos)
        ver, tcache = verify_fn([last] + props, tcache, pos)
        n_accept = 0
        while n_accept < k and ver[n_accept] == props[n_accept]:
            n_accept += 1
        bonus = ver[n_accept]
        out.extend(props[:n_accept] + [bonus])
        pos += n_accept + 1
        last = bonus
        rounds += 1
        acc += n_accept
        prop += k
    return out[:n], rounds, acc, prop


def _ids(dev, toks):
    return torch.as_tensor([toks], device=dev)


def _argmax_list(logits) -> list:
    return torch.argmax(logits, -1).reshape(-1).tolist()


def _mega_draft_fn(dparams, dstack, dmeta, dcfg, k: int):
    """k whole-model-kernel draft steps plus the unconditional p_{k-1} ingest."""
    from .megadecode import _model_step

    dev = dparams["embed"].device

    def draft_fn(last, dc, pos):
        props, tok = [], last
        for i in range(k):
            logits, dc = _model_step(dparams, dstack, dmeta, dcfg, _ids(dev, [tok]), dc, pos + i)
            tok = int(torch.argmax(logits, -1)[0])
            props.append(tok)
        _, dc = _model_step(dparams, dstack, dmeta, dcfg, _ids(dev, [tok]), dc, pos + k)
        return props, dc

    return draft_fn


def _chunk_verify_fn(tparams, tcfg, fused):
    """Verify per layer: engine.prefill_chunk of the k+1 tokens."""
    dev = tparams["embed"].device

    def verify_fn(chunk, tc, pos):
        vlogits, tc = prefill_chunk(tparams, tcfg, _ids(dev, chunk), tc, pos, fused)
        return _argmax_list(vlogits[0]), tc

    return verify_fn


def _spec_loop(tparams, dparams, tcfg, dcfg, tcache, dcache, last_tok, pos0, k, n, fused=True):
    """Per-layer draft (k cached decode steps plus the unconditional ingest of
    p_{k-1}) and per-layer chunk verify."""
    dev = dparams["embed"].device

    def draft_fn(last, dc, pos):
        props, dc = decode_loop(dparams, dcfg, _ids(dev, [last]), dc, pos, k, fused)
        props = props[0].tolist()
        _, dc = decode_step(dparams, dcfg, _ids(dev, [props[k - 1]]), dc, pos + k, fused)
        return props, dc

    return _spec_while(draft_fn, _chunk_verify_fn(tparams, tcfg, fused), tcache, dcache,
                       last_tok, pos0, k, n)


def _spec_loop_mega(tparams, dparams, dstack, dmeta, tcfg, dcfg, tcache, dcache, last_tok,
                    pos0, k, n, fused=True):
    """`_spec_loop` with the draft on the whole-model kernel (one launch a
    draft step); dcache is the stacked single-stream cache."""
    return _spec_while(_mega_draft_fn(dparams, dstack, dmeta, dcfg, k),
                       _chunk_verify_fn(tparams, tcfg, fused), tcache, dcache, last_tok, pos0,
                       k, n)


def _spec_loop_mega_full(tparams, dparams, tstack, dstack, tmeta, dmeta, tcfg, dcfg, tcache,
                         dcache, last_tok, pos0, k, n):
    """The draft on the whole-model kernel and the verify on the batched
    kernel's chunk mode (megadecode.model_step_chunk). tcache: the 1-slot
    batched stacked layout; dcache: the single-stream stacked one."""
    from .megadecode import model_step_chunk

    dev = tparams["embed"].device

    def verify_fn(chunk, tc, pos):
        vlogits, tc = model_step_chunk(tparams, tstack, tmeta, tcfg, _ids(dev, chunk), tc, pos)
        return _argmax_list(vlogits), tc

    return _spec_while(_mega_draft_fn(dparams, dstack, dmeta, dcfg, k), verify_fn, tcache,
                       dcache, last_tok, pos0, k, n)


def _spec_scan_flat(tparams, dparams, tstack, dstack, tmeta, dmeta, tcfg, dcfg, tcache, dcache,
                    last_tok: int, pos0: int, k: int, m: int, tlm=None, tlm_meta=None):
    """m propose -> verify -> accept rounds, the draft on the flat kernel
    (k+1 steps a round: k proposals, then the ingest of p_{k-1}, whose token
    is dropped) and the verify on the chunk mode, with the fused lm rows
    when `tlm` is given. dcache: the merged flat layout. Returns (emits
    [m][k+1], n_accept [m], last, pos, tcache, dcache): round i's accepted
    proposals and bonus are emits[i][:n_accept[i] + 1]."""
    from .flatdecode import _flat_step
    from .megadecode import model_step_chunk

    dev = tparams["embed"].device
    ddev = dparams["embed"].device
    last, pos = last_tok, pos0
    emits, n_accs = [], []
    for _ in range(m):
        tok, steps = last, []
        for i in range(k + 1):
            nt, _, dcache = _flat_step(dparams, dstack, dmeta, dcfg, _ids(ddev, [tok]), dcache,
                                       pos + i)
            tok = int(nt[0])
            steps.append(tok)
        props = steps[:k]
        vlogits, tcache = model_step_chunk(tparams, tstack, tmeta, tcfg, _ids(dev, [last] + props),
                                           tcache, pos, lm=tlm, lm_meta=tlm_meta)
        ver = _argmax_list(vlogits)
        n_accept = 0
        while n_accept < k and ver[n_accept] == props[n_accept]:
            n_accept += 1
        bonus = ver[n_accept]
        emits.append(props[:n_accept] + [bonus] + [0] * (k - n_accept))
        n_accs.append(n_accept)
        last, pos = bonus, pos + n_accept + 1
    return emits, n_accs, last, pos, tcache, dcache


@torch.no_grad()
def speculative_generate(
    target: Model,
    draft: Model,
    prompt: np.ndarray,
    max_new_tokens: int = 32,
    k=4,
    fused: bool = True,
    max_len: Optional[int] = None,
    cache_dtype=torch.float32,
    on_device: bool = True,
    draft_megakernel: Optional[bool] = None,
    verify_megakernel: Optional[bool] = None,
    cost_model: Optional[dict] = None,
    fused_lm_max_chunk: int = FUSED_LM_MAX_CHUNK,
) -> Tuple[np.ndarray, dict]:
    """Greedy speculative decode; returns (tokens [1, S+new] numpy, stats).

    stats: {'target_calls', 'draft_calls', 'accept_rate', ...}; with a good
    draft the target calls shrink toward new/(k+1). `on_device=False` runs
    the host loop (the reference's debugging route); otherwise one of the
    kernel routes of the module's docstring. draft_megakernel (None: on when
    the draft's tensors are on CUDA; the reference turns it on on a TPU
    backend): draft on the whole-model kernels when their contract holds.
    verify_megakernel (None: follow draft_megakernel): verify on the
    batched kernel's chunk mode. k="auto" (or None): the scan-flat route
    re-picks k from ADAPT_KSET between segments with `cost_model` (default
    ADAPT_COST); the other routes take k = 4. fused_lm_max_chunk: the
    scan-flat route verifies chunks of at most this many rows with the
    fused lm rows (mode d), longer ones with the lm_head after the kernel.
    Both models' tensors share one device."""
    cfg = target.config
    dev = resolve_device(target.params["embed"].device)
    seq = list(np.asarray(prompt).reshape(-1))
    n_prompt = len(seq)
    adaptive = k == "auto" or k is None
    k_max = max(ADAPT_KSET) if adaptive else k
    if adaptive:
        k = ADAPT_KSET[len(ADAPT_KSET) // 2]
    # a round may overshoot the budget by up to k, and the scan-flat route's
    # last segment by whole rounds: its position advance is bounded by
    # 2*max_new + 2k (the reference's sizing)
    total = max_len or (n_prompt + 2 * max_new_tokens + 2 * k_max + 3)

    dm = tm = None
    if on_device and draft_megakernel is not False:
        if draft_megakernel or (fused and dev.type == "cuda"):
            from .megadecode import stack_serving

            dm = stack_serving(draft)
    if dm is not None and verify_megakernel is not False:
        from .megadecode import stack_serving

        tm = stack_serving(target)
    if dm is not None:
        total = -(-total // 128) * 128  # a multiple of 128, as the reference's kernels take

    ids = torch.as_tensor(np.asarray(prompt).reshape(1, -1), device=dev)
    tcache = init_cache(cfg, 1, total, torch.int8 if tm is not None else cache_dtype, device=dev)
    dcache = init_cache(draft.config, 1, total, torch.int8 if dm is not None else cache_dtype,
                        device=dev)
    tlogits, tcache = prefill(target.params, cfg, ids, tcache, fused)
    _, dcache = prefill(draft.params, draft.config, ids, dcache, fused)
    first = int(torch.argmax(tlogits, -1)[0])

    if on_device and dm is not None:
        from .megadecode import stack_cache, stack_cache_batched

        dstack, dmeta = dm
        dfl = None
        if tm is not None:
            from .flatdecode import stack_flat

            dfl = stack_flat(draft, dm)
        if dfl is not None:
            return _scan_flat_route(target, draft, tm, dfl, tcache, dcache, seq, first,
                                    n_prompt, max_new_tokens, k, adaptive, cost_model,
                                    fused_lm_max_chunk)
        if tm is not None:
            tstack, tmeta = tm
            rest, rounds, acc, prop = _spec_loop_mega_full(
                target.params, draft.params, tstack, dstack, tmeta, dmeta, cfg, draft.config,
                stack_cache_batched(tcache), stack_cache(dcache), first, n_prompt, k,
                max_new_tokens - 1)
        else:
            rest, rounds, acc, prop = _spec_loop_mega(
                target.params, draft.params, dstack, dmeta, cfg, draft.config, tcache,
                stack_cache(dcache), first, n_prompt, k, max_new_tokens - 1, fused)
        seq = seq + ([first] + rest)[:max_new_tokens]
        stats = {"target_calls": rounds, "draft_calls": rounds * (k + 1),
                 "accept_rate": acc / max(prop, 1), "draft_megakernel": True,
                 "verify_megakernel": tm is not None}
        return np.asarray(seq)[None, :], stats

    if on_device:
        rest, rounds, acc, prop = _spec_loop(target.params, draft.params, cfg, draft.config,
                                             tcache, dcache, first, n_prompt, k,
                                             max_new_tokens - 1, fused)
        seq = seq + ([first] + rest)[:max_new_tokens]
        stats = {"target_calls": rounds, "draft_calls": rounds * (k + 1),
                 "accept_rate": acc / max(prop, 1)}
        return np.asarray(seq)[None, :], stats

    # the host loop: the draft ingests p_{k-1} only when all k are accepted
    last_tok, pos = first, n_prompt
    t_calls = d_calls = proposed_total = accepted_total = 0
    out = [last_tok]
    while len(out) < max_new_tokens:
        props_t, dcache = decode_loop(draft.params, draft.config, _ids(dev, [last_tok]), dcache,
                                      pos, k, fused)
        props = props_t[0].tolist()
        d_calls += k
        vlogits, tcache = prefill_chunk(target.params, cfg, _ids(dev, [last_tok] + props),
                                        tcache, pos, fused)
        ver = _argmax_list(vlogits[0])
        t_calls += 1
        n_accept = 0
        while n_accept < k and ver[n_accept] == props[n_accept]:
            n_accept += 1
        bonus = ver[n_accept]
        if n_accept == k:
            _, dcache = decode_step(draft.params, draft.config, _ids(dev, [props[k - 1]]),
                                    dcache, pos + k, fused)
            d_calls += 1
        out.extend(props[:n_accept] + [bonus])
        proposed_total += k
        accepted_total += n_accept
        pos += n_accept + 1
        last_tok = bonus
    seq = seq + out[:max_new_tokens]
    stats = {"target_calls": t_calls, "draft_calls": d_calls,
             "accept_rate": accepted_total / max(proposed_total, 1)}
    return np.asarray(seq)[None, :], stats


def _scan_flat_route(target, draft, tm, dfl, tcache, dcache, seq, first, n_prompt,
                     max_new_tokens, k, adaptive, cost_model, fused_lm_max_chunk):
    """The scan-flat route of speculative_generate: segments of m rounds of
    `_spec_scan_flat`, m from a fixed set {m0} and powers of two below it
    (the reference's compile-bounding shape set, kept for its cache contents
    and stats: a short final segment runs up to m - 1 surplus rounds, cut
    off here), re-dispatched while tokens are missing."""
    from .flatdecode import stack_cache_flat
    from .megadecode import stack_cache_batched, stack_lm

    cfg = target.config
    tstack, tmeta = tm
    dstack_f, dmeta_f = dfl
    tlmres = stack_lm(target, tmeta)
    tlm, tlm_meta = tlmres if tlmres is not None else (None, None)
    tcc = stack_cache_batched(tcache)
    dcc = stack_cache_flat(dcache)
    need = max_new_tokens - 1
    emitted: list = []
    last, pos = first, n_prompt
    rounds = acc_n = prop_n = 0
    m0 = max(-(-need // (k + 1)), 1)

    def _seg_len(remaining: int, kk: int) -> int:
        m_req = max(-(-remaining // (kk + 1)), 1)
        m = 1
        while m < m_req:
            m *= 2
        return min(m, m0)

    # adaptive k: a truncated-geometric estimate of the per-token agreement,
    # q_hat = accepted / (accepted + rejecting rounds); segments start at 8
    # rounds and the cap doubles (to 64) while the re-pick keeps k
    n_rej = d_calls_n = 0
    k_hist: list = []
    adapt_cap = 8
    while len(emitted) < need:
        m = _seg_len(need - len(emitted), k)
        if adaptive:
            m = min(m, adapt_cap)
        use_lm = tlm is not None and k + 1 <= fused_lm_max_chunk
        emits, naccs, last, pos, tcc, dcc = _spec_scan_flat(
            target.params, draft.params, tstack, dstack_f, tmeta, dmeta_f, cfg, draft.config,
            tcc, dcc, last, pos, k, m, tlm=tlm if use_lm else None,
            tlm_meta=tlm_meta if use_lm else None)
        for e, na in zip(emits, naccs):
            emitted.extend(e[:na + 1])
        rounds += m
        acc_n += sum(naccs)
        prop_n += m * k
        d_calls_n += m * (k + 1)
        n_rej += sum(na < k for na in naccs)
        if adaptive:
            k_hist.append(k)
            q_hat = acc_n / max(acc_n + n_rej, 1)
            k = _best_k(q_hat, cost=cost_model)
            adapt_cap = min(adapt_cap * 2, 64) if k == k_hist[-1] else 8
    seq = seq + [first] + emitted[:need]
    stats = {"target_calls": rounds, "draft_calls": d_calls_n,
             "accept_rate": acc_n / max(prop_n, 1), "draft_megakernel": True,
             "verify_megakernel": True, "scan_segments": True}
    if adaptive:
        stats["adaptive_k"] = k_hist
        stats["q_hat"] = acc_n / max(acc_n + n_rej, 1)
    return np.asarray(seq)[None, :], stats
