"""The tp = 1 whole-model kernels stay off a tensor-parallel shard.

A rank's shard (parallel.shard_model) holds its q/kv heads and MLP columns;
its o_proj and down_proj partials are summed over the group. The single-rank
whole-model kernels (B3, B4, B5 a-d) have no such sum: run on a shard's
stack they returned a shard's tokens without an error. Each serving entry
point on a shard now either takes its per-layer route, which sums over the
group, or raises ValueError naming the shard; ContinuousBatcher and
PagedMegaBatcher keep the batched kernel's mode (e).

Inputs: JAX's small Llama (2 layers, h=512, 4 heads over 2 kv heads,
D=128, g128, float32) of seed 3, fused for serving, as the target; seed 5 as
the draft; two 12-token prompts from numpy default_rng(0) and (1); 6 new
tokens; k = 3; an int8 cache of 128 rows; TP = 2 as LocalGroup threads. The
unsharded model's tokens are the reference."""
import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.parallel import LocalGroup, shard_model
from mi_optimize_tpu_torch.serving import engine, megadecode
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, SpeculativeBatcher
from mi_optimize_tpu_torch.serving.beam import beam_search
from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                      stack_cache_flat, stack_flat)
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher, PagedSpeculativeBatcher
from mi_optimize_tpu_torch.serving.speculative import speculative_generate
from tests.test_torch_model_fused import fused_pair, jax_model

NTP, N_NEW, K, T = 2, 6, 3, 128
PROMPTS = [np.random.default_rng(s).integers(0, 128, 12) for s in (0, 1)]


@pytest.fixture(scope="module")
def pair():
    """(target, draft): the port's fused models, unsharded; one intra-op
    thread while the module runs (the ranks are threads themselves)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield fused_pair(jax_model(3))[2], fused_pair(jax_model(5))[2]
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def want(pair):
    """The unsharded target's greedy tokens of each prompt."""
    target, _ = pair
    b = ContinuousBatcher(target, n_slots=2, max_len=T, cache_dtype=torch.int8,
                          use_megakernel=False)
    got = b.run_all(PROMPTS, max_new_tokens=N_NEW)
    return [got[0], got[1]]


def _on_shards(model, fn):
    """[fn(rank's shard of model, its group handle) for each rank]."""
    return LocalGroup(NTP).run(lambda g: fn(shard_model(model, g), g))


def test_the_whole_model_batchers_match_the_unsharded_model(pair, want):
    """The batched kernel's mode (e) stays on for ContinuousBatcher and
    PagedMegaBatcher on a shard, and gives the unsharded tokens."""
    target, _ = pair

    def serve(sm, g):
        b = ContinuousBatcher(sm, n_slots=2, max_len=T, cache_dtype=torch.int8,
                              use_megakernel=True)
        p = PagedMegaBatcher(sm, n_slots=2, max_len=T)
        assert b._mega is not None and b._tp is g and p._tp is g
        dense, paged = b.run_all(PROMPTS, N_NEW), p.run_all(PROMPTS, N_NEW)
        return [dense[0], dense[1]], [paged[0], paged[1]]

    for dense, paged in _on_shards(target, serve):
        assert dense == want and paged == want


@pytest.mark.parametrize("shard_draft", [False, True])
def test_speculative_batcher_on_a_shard_takes_the_per_layer_verify(pair, want, shard_draft):
    """SpeculativeBatcher(use_megakernel=True) on a shard: no stack for the
    target (its verify is the chunk mode, which has no tp > 1 mode), nor for
    a sharded draft; the tokens are the unsharded model's."""
    target, draft = pair

    def serve(sm, g):
        d = shard_model(draft, g) if shard_draft else draft
        b = SpeculativeBatcher(sm, d, k=K, n_slots=2, max_len=T, cache_dtype=torch.int8,
                               use_megakernel=True, use_draft_megakernel=True)
        assert b._mega is None and (b._dmega is None) == shard_draft
        got = b.run_all(PROMPTS, N_NEW)
        return [got[0], got[1]]

    for got in _on_shards(target, serve):
        assert got == want


@pytest.mark.parametrize("which", ["target", "draft"])
def test_paged_speculative_batcher_refuses_a_shard(pair, which):
    target, draft = pair

    def make(sm, g):
        t, d = (sm, draft) if which == "target" else (target, shard_model(draft, g))
        with pytest.raises(ValueError, match="tensor-parallel shard"):
            PagedSpeculativeBatcher(t, d, k=K, n_slots=2, max_len=T)
        return True

    assert _on_shards(target, make) == [True] * NTP


def test_single_rank_loops_refuse_a_shards_stack(pair):
    """stack_serving and stack_flat decline a shard; a shard's stack taken
    with tp=True (mode (e)'s) is refused by decode_loop_model,
    decode_loop_flat, decode_loop_flat_seg and the tp = 1 batched step;
    beam_search, which runs the tp = 1 paged step, refuses the shard."""
    target, _ = pair

    def check(sm, g):
        assert megadecode.stack_serving(sm) is None and stack_flat(sm) is None
        stack, meta = megadecode.stack_serving(sm, tp=True)
        cfg = sm.config
        ids = torch.as_tensor(PROMPTS[0][None])
        logits, cache = engine.prefill(sm.params, cfg, ids,
                                       engine.init_cache(cfg, 1, T, torch.int8, device="cpu"))
        tok = torch.argmax(logits, -1)[:, None]
        calls = {
            "decode_loop_model": lambda: megadecode.decode_loop_model(
                sm.params, stack, meta, cfg, tok, megadecode.stack_cache(cache), 12, 2),
            "the batched whole-model step": lambda: megadecode.model_step_batch(
                sm.params, stack, meta, cfg, tok, megadecode.stack_cache_batched(cache), [12]),
            "decode_loop_flat": lambda: decode_loop_flat(
                sm.params, stack, meta + (128, 0.0, cfg.vocab_size), cfg, tok,
                stack_cache_flat(cache), 12, 2),
            "decode_loop_flat_seg": lambda: decode_loop_flat_seg(
                sm.params, stack, meta + (128, 0.0, cfg.vocab_size), cfg, tok,
                stack_cache_flat(cache), 12, 2, kseg=2),
            "beam_search": lambda: beam_search(sm, PROMPTS[0], beam_width=2,
                                                       max_new_tokens=2, max_len=T),
        }
        for what, call in calls.items():
            with pytest.raises(ValueError, match=f"{what}.*tensor-parallel shard"):
                call()
        return True

    assert _on_shards(target, check) == [True] * NTP


@pytest.mark.parametrize("shard_draft", [False, True])
def test_speculative_generate_on_a_sharded_target(pair, want, shard_draft):
    """speculative_generate with the draft on the whole-model kernels: a
    sharded target is not stacked (its verify goes per layer), a sharded
    draft is not stacked either; the tokens are the unsharded model's."""
    target, draft = pair

    def run(sm, g):
        d = shard_model(draft, g) if shard_draft else draft
        out = []
        for p in PROMPTS:
            toks, stats = speculative_generate(sm, d, p, max_new_tokens=N_NEW, k=K,
                                               max_len=T, cache_dtype=torch.int8,
                                               draft_megakernel=True)
            assert not stats.get("scan_segments")
            out.append(toks[0, len(p):].tolist())
        return out

    for got in _on_shards(target, run):
        assert got == want
