"""Continuous batching: a slot scheduler over a shared KV cache.

Port of mi_optimize_tpu/serving/batching.py (`decode_step_multi`,
`_prefill_kv`, `_prefill_into_slot`, `_prefill_into_slot_mega`, `Request`,
`ContinuousBatcher`, `draft_propose_batch`, `_draft_propose_multi`,
`SpeculativeBatcher`); `shard_batcher` waits for ROADMAP.md A12. The paged
batchers are in paged.py.

  * the cache holds `n_slots` independent sequences; each slot has its own
    position, so sequences of different lengths decode together;
  * one decode step for all slots: tokens [B,1] + positions [B]. On the fast
    path that is ONE whole-model launch (`megadecode.model_step_batch`,
    kernel ops/model_fused.py::model_decode_mega_batch) that reads every
    weight once for all slots; otherwise the per-layer path with per-slot
    masks and per-slot cache writes (`decode_step_multi`);
  * prefill runs per request (batch 1) and its KV slab is written into the
    slot, so a request joins between decode steps without disturbing the
    running slots, and a slot is freed as soon as its request is done;
  * `SpeculativeBatcher`: each step drafts k tokens a slot on a small model
    and verifies every slot's k+1 tokens on the target's chunk step.

Routing: the reference turns the megakernel on by default only on a TPU
backend; the port turns it on by default when the model's tensors are on
CUDA. `use_megakernel=True` on a CPU model runs the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.model import Model
from .engine import _cache_len, init_cache, prefill


@torch.no_grad()
def decode_step_multi(params, cfg, tokens, cache, positions, fused=True):
    """tokens [B,1], positions [B] (per slot) -> (logits [B,V], cache)."""
    max_len = _cache_len(cache)
    x = llama.embed(params, tokens)
    dev = x.device
    pos = torch.as_tensor(positions).reshape(-1).to(dev, torch.long)
    cos, sin = llama.rope_tables(cfg, pos[:, None])                 # [B, 1, rd]
    mask = (torch.arange(max_len, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    new_cache = []
    for blk, kv in zip(params["layers"], cache):
        x, kv, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=kv,
                                     cache_index=pos, fused=fused)
        new_cache.append(kv)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.unembed(params, cfg, x, fused=fused)[:, 0], new_cache


@torch.no_grad()
def _prefill_kv(params, cfg, input_ids, fused=True):
    """Prompt -> (last logits, per-layer f32 (k, v) slabs of exactly the
    prompt's length), on the device of input_ids. The paged batcher writes
    the slabs into its pages."""
    B, S = input_ids.shape
    cache = init_cache(cfg, B, S, torch.float32, device=input_ids.device)
    return prefill(params, cfg, input_ids, cache, fused)


@torch.no_grad()
def _prefill_into_slot(params, cfg, input_ids, cache, slot: int, fused=True):
    """Prefill a batch-1 request and write its KV slab into `slot` of the
    shared multi-slot per-layer cache (same dtype and structure: float
    (k, v) tuples or int8 dicts with scales)."""
    dev = input_ids.device
    quant = isinstance(cache[0], dict)
    one = init_cache(cfg, 1, _cache_len(cache), torch.int8 if quant else cache[0][0].dtype,
                     device=dev)
    logits, one = prefill(params, cfg, input_ids, one, fused)
    for c, p in zip(cache, one):
        for f in (c if quant else range(2)):
            c[f][slot] = p[f][0]
    return logits, cache


@torch.no_grad()
def _prefill_into_slot_mega(params, cfg, input_ids, cache, slot: int, max_len: int):
    """Prefill a request and write its KV slab into `slot` of the BATCHED
    STACKED (head-transposed) cache [L, B, Hkv, T, D] of the batched kernel."""
    one = init_cache(cfg, 1, max_len, torch.int8, device=input_ids.device)
    logits, one = prefill(params, cfg, input_ids, one, True)
    for f in ("k", "v", "k_scale", "v_scale"):
        cache[f][:, slot] = torch.stack([c[f][0] for c in one]).transpose(1, 2)
    return logits, cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] token ids
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Static-shape slot scheduler; requests join and leave between decode
    steps.

    The cache lives on the device of the model's tensors. The one-launch
    batched kernel needs an int8 cache whose length is a multiple of 128
    (otherwise the batcher decodes per layer, as the reference does) and
    takes at most ops.model_fused.MAX_BATCH slots: more slots with the
    kernel on raise ValueError; pass use_megakernel=False to decode them per
    layer."""

    def __init__(self, model: Model, n_slots: int = 4, max_len: int = 512,
                 fused: bool = True, cache_dtype=torch.float32,
                 use_megakernel: Optional[bool] = None):
        from ..ops.model_fused import MAX_BATCH

        self.model = model
        self.cfg = model.config
        self.n_slots = n_slots
        self.max_len = min(max_len, self.cfg.max_seq_len)
        self.fused = fused
        self.device = resolve_device(model.params["embed"].device)
        # batched whole-model kernel fast path: ONE launch decodes all slots,
        # reading each weight once for the whole batch
        if use_megakernel is None:
            use_megakernel = fused and self.device.type == "cuda"
        mega = use_megakernel and fused and cache_dtype == torch.int8 and self.max_len % 128 == 0
        if mega and n_slots > MAX_BATCH:
            raise ValueError(
                f"the batched whole-model kernel takes at most {MAX_BATCH} slots, not {n_slots}; "
                "pass use_megakernel=False to decode more slots per layer")
        self.cache = init_cache(self.cfg, n_slots, self.max_len, cache_dtype, device=self.device)
        self._mega = None
        self._lm = (None, None)
        if mega:
            from .megadecode import default_lm, stack_cache_batched, stack_serving

            st = stack_serving(model)
            if st is not None:
                self._mega = st
                self.cache = stack_cache_batched(self.cache)
                self._lm = default_lm(model, st[1])
        self.positions = np.zeros(n_slots, np.int64)  # next write index per slot
        self.last_token = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._next_rid = 0

    def _admission_headroom(self) -> int:
        """Cache rows a step may write past the emitted tokens (the
        speculative batcher's draft overshoot needs more)."""
        return 1

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None) -> Optional[int]:
        """Prefill into a free slot; returns the request id, or None if full."""
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return None
        # max(..., 1): a max_new_tokens >= max_len must still trim from the
        # tail, not keep the whole prompt ([-0:] is the full array)
        keep = max(self.max_len - max_new_tokens - self._admission_headroom(), 1)
        prompt = np.asarray(prompt).reshape(-1)[-keep:]
        req = Request(self._next_rid, prompt, max_new_tokens, eos_token_id)
        self._next_rid += 1

        ids = torch.as_tensor(prompt[None, :], device=self.device)
        if self._mega is not None:
            logits, self.cache = _prefill_into_slot_mega(
                self.model.params, self.cfg, ids, self.cache, slot, self.max_len)
        else:
            logits, self.cache = _prefill_into_slot(
                self.model.params, self.cfg, ids, self.cache, slot, self.fused)
        tok = int(torch.argmax(logits[0]))
        req.tokens.append(tok)
        self.positions[slot] = len(prompt)
        self.last_token[slot] = tok
        self.slot_req[slot] = req
        return req.rid

    def step(self) -> Dict[int, int]:
        """One decode step for all slots; returns {rid: new_token} of the
        active ones."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return {}
        tokens = torch.as_tensor(self.last_token[:, None], device=self.device)
        if self._mega is not None:
            from .megadecode import model_step_batch

            stack, meta = self._mega
            logits, self.cache = model_step_batch(
                self.model.params, stack, meta, self.cfg, tokens, self.cache,
                self.positions, lm=self._lm[0], lm_meta=self._lm[1])
        else:
            logits, self.cache = decode_step_multi(
                self.model.params, self.cfg, tokens, self.cache,
                torch.as_tensor(self.positions, device=self.device), self.fused)
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
            hit_eos = req.eos_token_id is not None and tok == req.eos_token_id
            if len(req.tokens) >= req.max_new_tokens or hit_eos \
                    or self.positions[i] >= self.max_len - 1:
                req.done = True
                self.slot_req[i] = None  # slot freed; a new request can join
        return out

    def run_all(self, prompts, max_new_tokens=16) -> Dict[int, List[int]]:
        """Feed prompts through the scheduler to completion."""
        pending = list(prompts)
        results: Dict[int, List[int]] = {}
        reqs: List[Request] = []
        while pending or any(r is not None for r in self.slot_req):
            while pending:
                rid = self.add_request(pending[0], max_new_tokens)
                if rid is None:
                    break
                reqs.append([r for r in self.slot_req if r and r.rid == rid][0])
                pending.pop(0)
            self.step()
            for r in reqs:
                if r.done:
                    results[r.rid] = r.tokens
        for r in reqs:
            results[r.rid] = r.tokens
        return results


@torch.no_grad()
def draft_propose_batch(params, stack, meta, cfg, tokens, cache, positions, k: int):
    """B-slot draft proposal on the batched whole-model kernel: k greedy
    steps for every slot (one weight read a step for the whole batch), then
    the unconditional ingest of each slot's k-th proposal (rows past the
    verified prefix are masked by position and overwritten later). tokens
    [B,1], positions [B] host ints -> (proposals [B, k], cache)."""
    from .megadecode import model_step_batch

    pos = np.asarray(positions, np.int64).reshape(-1)
    tok, props = tokens, []
    for i in range(k):
        logits, cache = model_step_batch(params, stack, meta, cfg, tok, cache, pos + i)
        tok = torch.argmax(logits, -1).to(tokens.dtype)[:, None]
        props.append(tok[:, 0])
    _, cache = model_step_batch(params, stack, meta, cfg, tok, cache, pos + k)
    return torch.stack(props, dim=1), cache


@torch.no_grad()
def _draft_propose_multi(params, cfg, tokens, cache, positions, k: int, fused=True):
    """The per-layer draft of `draft_propose_batch` (same contract)."""
    pos = torch.as_tensor(np.asarray(positions, np.int64).reshape(-1), device=tokens.device)
    tok, props = tokens, []
    for i in range(k):
        logits, cache = decode_step_multi(params, cfg, tok, cache, pos + i, fused)
        tok = torch.argmax(logits, -1).to(tokens.dtype)[:, None]
        props.append(tok[:, 0])
    _, cache = decode_step_multi(params, cfg, tok, cache, pos + k, fused)
    return torch.stack(props, dim=1), cache


class SpeculativeBatcher(ContinuousBatcher):
    """Continuous batching composed with speculative decoding: every step
    drafts k tokens a slot (on the batched whole-model kernel when the
    draft's contract holds), then verifies all slots' k+1-token chunks on
    the target. Each slot advances 1..k+1 tokens a step. Greedy
    speculative decoding is exact, so the emitted sequences equal the plain
    batcher's, up to the capacity boundary: a round needs 2k+2 rows of write
    headroom, so slots retire (and admission trims prompts) 2k+1 tokens
    earlier than in the plain batcher.

    The target verifies on the batched kernel's chunk mode
    (megadecode.model_step_chunk_batch) when its own batched kernel is on
    (an int8 cache, `use_megakernel`, default: tensors on CUDA), else per
    layer (engine.prefill_chunk_batched). The reference verifies all slots'
    B*(k+1) rows in one launch; the port's chunk step takes them in waves of
    max(1, 8 // (k+1)) slots of at most 8 rows (same tokens). The draft
    decodes on the batched kernel over a stacked int8 cache when
    `use_draft_megakernel` (default: tensors on CUDA) and the cache length
    is a multiple of 128; then it takes at most 8 slots. `fused_lm` (off by
    default, as the reference's batchers) verifies through the batched
    kernel's terminal lm rows (mode d, `megadecode.stack_lm`)."""

    def __init__(self, model: Model, draft: Model, k: int = 4, n_slots: int = 4,
                 max_len: int = 512, fused: bool = True, cache_dtype=torch.float32,
                 use_draft_megakernel: Optional[bool] = None,
                 use_megakernel: Optional[bool] = None, fused_lm: bool = False):
        from ..ops.model_fused import MAX_BATCH

        super().__init__(model, n_slots, max_len, fused, cache_dtype,
                         use_megakernel=use_megakernel)
        if fused_lm:
            self._lm = verify_lm(model, self._mega)
        self.draft = draft
        self.k = k
        self._dmega = None
        ddev = resolve_device(draft.params["embed"].device)
        if use_draft_megakernel is None:
            use_draft_megakernel = fused and ddev.type == "cuda"
        if use_draft_megakernel and self.max_len % 128 == 0:
            from .megadecode import stack_cache_batched, stack_serving

            st = stack_serving(draft)
            if st is not None:
                if n_slots > MAX_BATCH:
                    raise ValueError(
                        f"the batched whole-model kernel drafts at most {MAX_BATCH} slots, not "
                        f"{n_slots}; pass use_draft_megakernel=False to draft them per layer")
                self._dmega = st
                self.dcache = stack_cache_batched(
                    init_cache(draft.config, n_slots, self.max_len, torch.int8, device=ddev))
        if self._dmega is None:
            self.dcache = init_cache(draft.config, n_slots, self.max_len, cache_dtype,
                                     device=ddev)
        # accept-rate telemetry
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0

    def _admission_headroom(self) -> int:
        # a round writes up to pos + 2k rows (the draft's ingest overshoot)
        return 2 * self.k + 2

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None):
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return None
        rid = super().add_request(prompt, max_new_tokens, eos_token_id)
        if rid is None:
            return None
        ids = torch.as_tensor(self.slot_req[slot].prompt[None, :],
                              device=self.draft.params["embed"].device)
        if self._dmega is not None:
            _, self.dcache = _prefill_into_slot_mega(self.draft.params, self.draft.config, ids,
                                                     self.dcache, slot, self.max_len)
        else:
            _, self.dcache = _prefill_into_slot(self.draft.params, self.draft.config, ids,
                                                self.dcache, slot, self.fused)
        return rid

    def step(self) -> Dict[int, List[int]]:
        """One speculative round for all slots; returns {rid: [new tokens]}
        of the active ones."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return {}
        k = self.k
        # free slots ride along at their stale positions; the clamp keeps
        # their draft overshoot (pos..pos+2k) inside the cache. Live slots
        # retire with this headroom, so the clamp never moves them.
        pos = np.minimum(self.positions, self.max_len - 2 * k - 2)
        ddev = self.draft.params["embed"].device
        toks = torch.as_tensor(self.last_token[:, None], device=ddev)
        if self._dmega is not None:
            dstack, dmeta = self._dmega
            props, self.dcache = draft_propose_batch(self.draft.params, dstack, dmeta,
                                                     self.draft.config, toks, self.dcache, pos, k)
        else:
            props, self.dcache = _draft_propose_multi(self.draft.params, self.draft.config, toks,
                                                      self.dcache, pos, k, self.fused)
        chunk = torch.cat([toks, props], dim=1).to(self.device)              # [B, k+1]
        if self._mega is not None:
            from .megadecode import model_step_chunk_batch

            tstack, tmeta = self._mega
            vlogits, self.cache = model_step_chunk_batch(self.model.params, tstack, tmeta,
                                                         self.cfg, chunk, self.cache, pos,
                                                         lm=self._lm[0], lm_meta=self._lm[1])
        else:
            from .engine import prefill_chunk_batched

            vlogits, self.cache = prefill_chunk_batched(self.model.params, self.cfg, chunk,
                                                        self.cache, pos, self.fused)
        ver = torch.argmax(vlogits, -1).cpu().numpy()                       # [B, k+1]
        return _accept_round(self, active, ver, props.cpu().numpy(), self.max_len - 2 * k - 2,
                             self._retire)

    def _retire(self, slot):
        self.slot_req[slot] = None


def verify_lm(model: Model, mega):
    """(lm, lm_meta) of `megadecode.stack_lm` for a speculative batcher's
    verify with `fused_lm`; mega: the target's (stack, meta) or None."""
    from .megadecode import stack_lm

    res = None if mega is None else stack_lm(model, mega[1])
    if res is None:
        raise ValueError("fused_lm needs the target on the batched whole-model kernel and an "
                         "lm_head that megadecode.stack_lm accepts")
    return res


def _accept_round(b, active, ver, props, limit: int, retire) -> Dict[int, List[int]]:
    """The accept step of a speculative batcher's round: for each active slot
    i, the proposals props[i] that match the target's tokens ver[i] up to the
    first mismatch, then the target's token after them. The request keeps
    them up to its budget and eos; its position and last token always
    advance by the verified count. A request that is done, or whose position
    reached `limit`, is retired with retire(i). Returns {rid: [kept tokens]}."""
    k = b.k
    b.rounds += 1
    out: Dict[int, List[int]] = {}
    for i in active:
        req = b.slot_req[i]
        match = ver[i, :k] == props[i]
        n_acc = k if match.all() else int(np.argmin(match))
        bonus = int(ver[i, n_acc])
        emit = [int(t) for t in props[i][:n_acc]] + [bonus]
        b.proposed += k
        b.accepted += n_acc
        kept = emit[:req.max_new_tokens - len(req.tokens)]
        if req.eos_token_id is not None and req.eos_token_id in kept:
            kept = kept[:kept.index(req.eos_token_id) + 1]
        req.tokens.extend(kept)
        out[req.rid] = kept
        b.positions[i] += n_acc + 1
        b.last_token[i] = bonus
        if (len(kept) < len(emit) or len(req.tokens) >= req.max_new_tokens
                or b.positions[i] >= limit):
            req.done = True
            retire(i)
    return out
