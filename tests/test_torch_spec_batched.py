"""B-slot speculative decoding composed with continuous batching: the port
of tests/test_spec_batched.py against the JAX package, f32.

- engine.prefill_chunk / prefill_chunk_batched (per-slot chunk positions)
  against JAX's: logits and the written rows within 1e-5.
- The chunk step above 8 rows: the port's C = 9 verify (a sub-chunk of 8
  rows, then one row reading the first 8 back from the cache) at prefix 100
  against JAX's one-launch model_step_chunk (interpret=True): tokens equal,
  rows up to one-code tie flips on at most 0.1% of entries; logits within
  1e-4 of max|ref| of JAX's unfused path (engine.prefill_chunk on the same
  cache). JAX's one-launch kernel itself is 1.4e-3 of max|logit| off its
  unfused path on row 6 of these 9 (ROADMAP.md C), within 1e-4 on the rest.
- SpeculativeBatcher on the per-layer path (draft == target, and an int8
  RTN draft): the tokens of JAX's SpeculativeBatcher and of the port's plain
  ContinuousBatcher.
- SpeculativeBatcher on the batched kernel's plain versions, 4 slots, k=3
  (verify waves of 2 slots x 4 rows), a planted pair whose draft disagrees
  on half its map: every request's tokens are the target's planted chain
  and equal JAX's SpeculativeBatcher's, and so are the rounds, proposals and
  acceptances.
- Both speculative batchers on random weights, where the tokens and the
  accept stats depend on attention over every cache: a 2-layer target and
  its first layer as the draft, 4 slots, k=3, on the batched kernel's plain
  versions (the dense cache read as a pool in verify waves of 2 slots; the
  paged verify in waves of 2 slots, and of 3 with the short wave padded;
  with and without the fused lm rows). Tokens equal JAX's per-layer
  SpeculativeBatcher's (int8 cache) and the port's plain ContinuousBatcher's;
  rounds, proposals and acceptances equal JAX's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu.serving.batching import SpeculativeBatcher as JSpeculativeBatcher
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving import engine, megadecode
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, SpeculativeBatcher
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.paged import PagedSpeculativeBatcher
from tests.test_torch_block_fused import assert_rows_match, random_cache
from tests.test_torch_convert import port_model
from tests.test_torch_model_fused import fused_pair, jax_model
from tests.test_torch_speculative import jax_planted


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_launches(monkeypatch, with_lm=False):
    """(rows, chunk[, lm rows given]) of every batched whole-model call."""
    calls = []
    launch = model_fused.model_decode_mega_batch

    def spy(*a, **k):
        calls.append((a[1].shape[0], k.get("chunk")) + ((k.get("lm") is not None,) * with_lm))
        return launch(*a, **k)

    monkeypatch.setattr(model_fused, "model_decode_mega_batch", spy)
    return calls


def _run_batcher(b, prompts, n_new):
    reqs = []
    for p in prompts:
        rid = b.add_request(p, max_new_tokens=n_new)
        reqs.append([r for r in b.slot_req if r and r.rid == rid][0])
    for _ in range(40):
        b.step()
        if all(s is None for s in b.slot_req):
            break
    return [r.tokens for r in reqs]


def test_prefill_chunks_match_jax():
    jm = JModel.tiny_llama()
    pm = port_model(jm)
    cfg = jm.config
    rng = np.random.default_rng(5)
    B, C, T = 2, 3, 64
    positions = np.array([6, 11])
    prompts = [rng.integers(0, 256, (1, int(p))) for p in positions]
    chunks = rng.integers(0, 256, (B, C))
    jcache = jengine.init_cache(cfg, B, T, jnp.float32)
    cache = engine.init_cache(pm.config, B, T, torch.float32, device="cpu")
    for b in range(B):
        _, one = jengine.prefill(jm.params, cfg, jnp.asarray(prompts[b]),
                                 jengine.init_cache(cfg, 1, T, jnp.float32), False)
        jcache = [tuple(c[i].at[b].set(o[i][0]) for i in range(2)) for c, o in zip(jcache, one)]
        _, pone = engine.prefill(pm.params, pm.config, torch.from_numpy(prompts[b]),
                                 engine.init_cache(pm.config, 1, T, torch.float32, device="cpu"),
                                 False)
        for c, o in zip(cache, pone):
            for i in range(2):
                c[i][b] = o[i][0]
    jl, jc2 = jengine.prefill_chunk_batched(jm.params, cfg, jnp.asarray(chunks), jcache,
                                            jnp.asarray(positions), False)
    one = [tuple(t[:1].clone() for t in c) for c in cache]
    logits, c2 = engine.prefill_chunk_batched(pm.params, pm.config, torch.from_numpy(chunks),
                                              cache, positions, False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for b in range(B):
        sl = slice(int(positions[b]), int(positions[b]) + C)
        np.testing.assert_allclose(c2[0][0][b, sl].numpy(), np.asarray(jc2[0][0][b, sl]),
                                   rtol=1e-5, atol=1e-5)
    # slot 0 alone through prefill_chunk at a scalar position
    jl0, _ = jengine.prefill_chunk(jm.params, cfg, jnp.asarray(chunks[:1]),
                                   [tuple(t[:1] for t in c) for c in jcache],
                                   jnp.asarray(int(positions[0])), False)
    l0, _ = engine.prefill_chunk(pm.params, pm.config, torch.from_numpy(chunks[:1]), one,
                                 int(positions[0]), False)
    np.testing.assert_allclose(l0.numpy(), np.asarray(jl0), rtol=1e-5, atol=1e-5)


def test_chunk_of_9_rows_matches_jax_one_launch(monkeypatch):
    jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(31))
    cfg = pf.config
    T, prefix, C = 256, 100, 9
    base = random_cache((cfg.num_layers, 1, cfg.num_kv_heads, T, cfg.head_dim), 31)
    tokens = np.random.default_rng(31).integers(0, cfg.vocab_size, (1, C))
    jbase = {f: jnp.asarray(v) for f, v in base.items()}
    jl, jc = jmegadecode.model_step_chunk(jf.params, jstack, jmeta, jf.config,
                                          jnp.asarray(tokens), jbase, jnp.asarray(prefix),
                                          interpret=True)
    unfused, _ = jengine.prefill_chunk(jf.params, jf.config, jnp.asarray(tokens),
                                       jmegadecode.unstack_cache_batched(jbase, cfg.num_layers),
                                       jnp.asarray(prefix), False)
    calls = _record_launches(monkeypatch)
    cache = {f: torch.from_numpy(v.copy()) for f, v in base.items()}
    logits, c2 = megadecode.model_step_chunk(pf.params, stack, meta, cfg,
                                             torch.from_numpy(tokens), cache, prefix)
    assert calls == [(8, 8), (1, 1)]
    jl, unfused = np.asarray(jl), np.asarray(unfused[0])
    assert logits.shape == jl.shape == unfused.shape == (C, cfg.vocab_size)
    assert np.abs(logits.numpy() - unfused).max() <= 1e-4 * np.abs(unfused).max()
    assert torch.argmax(logits, -1).tolist() == np.argmax(jl, -1).tolist()
    sl = slice(prefix, prefix + C)
    for f in ("k", "v"):
        assert_rows_match(c2[f][:, :, :, sl].numpy(), np.asarray(jc[f])[:, :, :, sl])
        np.testing.assert_allclose(c2[f + "_scale"][:, :, :, sl].numpy(),
                                   np.asarray(jc[f + "_scale"])[:, :, :, sl], rtol=1e-5)


def test_speculative_batcher_exact_per_layer_path():
    import mi_optimize_tpu as mt
    from mi_optimize_tpu.quant.config import QuantConfig

    jm = JModel.tiny_llama()
    pm = port_model(jm)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (6,)), rng.integers(0, 256, (9,))]
    ref = _run_batcher(ContinuousBatcher(pm, n_slots=2, max_len=64, fused=False,
                                         use_megakernel=False), prompts, 6)
    jdraft = mt.quantize(jm, QuantConfig(algo="rtn", wbit="int8", w_qtype="per_channel",
                                         pack=False), calib_data=[prompts[0][None, :]])
    for jd, pd in ((jm, pm), (jdraft, port_model(jdraft))):
        b = SpeculativeBatcher(pm, pd, k=2, n_slots=2, max_len=64, fused=False,
                               use_draft_megakernel=False)
        got = _run_batcher(b, prompts, 6)
        jb = JSpeculativeBatcher(jm, jd, k=2, n_slots=2, max_len=64, fused=False,
                                 use_draft_megakernel=False)
        assert got == ref == _run_batcher(jb, prompts, 6)
        assert (b.rounds, b.proposed, b.accepted) == (jb.rounds, jb.proposed, jb.accepted)
        assert b.rounds > 0 and 0 <= b.accepted <= b.proposed


def _chain(m, t, n):
    out = []
    for _ in range(n):
        t = int(m[t])
        out.append(t)
    return out


def _prompts():
    """Six prompts of 110-135 tokens: with 16 new ones each crosses the
    128-row page boundary."""
    rng = np.random.default_rng(9)
    return [rng.integers(0, 128, (int(n),)) for n in rng.integers(110, 136, 6)]


def _jax_spec_batcher(jt, jd, prompts, n_new):
    """JAX's SpeculativeBatcher, per layer over an int8 cache, 4 slots, k=3:
    (tokens by request id, (rounds, proposed, accepted))."""
    jb = JSpeculativeBatcher(jt, jd, k=3, n_slots=4, max_len=256, fused=False,
                             cache_dtype=jnp.int8, use_draft_megakernel=False,
                             use_megakernel=False)
    jgot = jb.run_all(list(prompts), max_new_tokens=n_new)
    return ({i: [int(t) for t in v] for i, v in jgot.items()},
            (jb.rounds, jb.proposed, jb.accepted))


def test_speculative_batcher_kernels_4_slots_k3(monkeypatch):
    jt, jd, pt, pd, m_t = jax_planted(0.5)
    prompts = _prompts()
    rows = _record_launches(monkeypatch)
    b = SpeculativeBatcher(pt, pd, k=3, n_slots=4, max_len=256, fused=True,
                           cache_dtype=torch.int8, use_megakernel=True, use_draft_megakernel=True)
    assert b._mega is not None and b._dmega is not None
    got = b.run_all(list(prompts), max_new_tokens=8)
    assert [got[i] for i in range(6)] == [_chain(m_t, int(p[-1]), 8) for p in prompts]
    # verify launches of 2 slots x 4 rows; draft launches of the 4 slots
    assert (8, 4) in rows and (4, 1) in rows and max(r for r, _ in rows) <= 8
    assert (got, (b.rounds, b.proposed, b.accepted)) == _jax_spec_batcher(jt, jd, prompts, 8)
    assert 0 < b.accepted < b.proposed


N_NEW, SNAP_ROUND = 16, 3


def _drive(b, prompts, n_new, snapshot):
    """run_all's schedule (admit what fits, then one round) for the port's
    batchers and JAX's alike: (tokens by request id, snapshot(b) taken after
    round SNAP_ROUND)."""
    pending, reqs, rounds, snap = list(prompts), [], 0, None
    while pending or any(r is not None for r in b.slot_req):
        while pending:
            rid = b.add_request(pending[0], max_new_tokens=n_new)
            if rid is None:
                break
            reqs.append(next(r for r in b.slot_req if r is not None and r.rid == rid))
            pending.pop(0)
        b.step()
        rounds += 1
        if rounds == SNAP_ROUND:
            snap = snapshot(b)
    return {r.rid: [int(t) for t in r.tokens] for r in reqs}, snap


def _live_rows(b, target, draft):
    """Every live slot's rows [0, position) of the target's and the draft's
    caches, field by field, as [L, rows, Hkv(, D)] numpy; target(f, s) and
    draft(f, s) give a slot's [L, T, Hkv(, D)] rows."""
    out = {}
    for s, req in enumerate(b.slot_req):
        if req is not None:
            n = int(b.positions[s])
            for f in ("k", "v", "k_scale", "v_scale"):
                # copies: the batcher goes on writing its caches in place
                out["target", s, f] = np.array(target(f, s)[:, :n])
                out["draft", s, f] = np.array(draft(f, s)[:, :n])
    return out


def _jax_rows(b):
    return _live_rows(b, lambda f, s: np.stack([np.array(c[f][s]) for c in b.cache]),
                      lambda f, s: np.stack([np.array(c[f][s]) for c in b.dcache]))


def _port_rows(b):
    """The port's caches in JAX's per-layer layout: the stacked batched cache
    [L, B, Hkv, T(, D)], or the page pool [L, pages, Hkv, P(, D)] through the
    slot's table row."""
    def dense(c):
        return lambda f, s: c[f][:, s].transpose(1, 2)

    def pool(f, s):
        pages = torch.as_tensor(b.table[s], dtype=torch.long)
        return b.pool[f][:, pages].transpose(2, 3).flatten(1, 2)

    return _live_rows(b, pool if hasattr(b, "pool") else dense(b.cache), dense(b.dcache))


def _jax_spec_run(jt, jd, prompts):
    jb = JSpeculativeBatcher(jt, jd, k=3, n_slots=4, max_len=256, fused=False,
                             cache_dtype=jnp.int8, use_draft_megakernel=False,
                             use_megakernel=False)
    toks, rows = _drive(jb, prompts, N_NEW, _jax_rows)
    return toks, (jb.rounds, jb.proposed, jb.accepted), rows


@pytest.fixture(scope="module")
def random_spec():
    """A random-weight 2-layer target (JAX and port, fused); with two drafts
    (the target's first layer, and the target itself) JAX's speculative
    batcher's tokens, stats and live cache rows after round SNAP_ROUND; the
    port's plain ContinuousBatcher's tokens on the same prompts."""
    jt = jax_model(41)
    jd = JModel(config=dataclasses.replace(jt.config, num_layers=1),
                params={**jt.params, "layers": jt.params["layers"][:1]})
    pt, pd = fuse_for_serving(port_model(jt)), fuse_for_serving(port_model(jd))
    jt, jd = jax_fuse_for_serving(jt), jax_fuse_for_serving(jd)
    prompts = _prompts()
    plain = ContinuousBatcher(pt, n_slots=4, max_len=256, cache_dtype=torch.int8,
                              use_megakernel=True).run_all(list(prompts), max_new_tokens=N_NEW)
    return dict(target=pt, drafts={"layer0": pd, "self": pt}, prompts=prompts, plain=plain,
                jax={"layer0": _jax_spec_run(jt, jd, prompts), "self": _jax_spec_run(jt, jt, prompts)})


# name: (draft, paged, verify_wave_slots, fused_lm, the verify launches' (rows, chunk, lm)).
# The first-layer draft is mostly rejected; the target as its own draft is
# accepted throughout.
RANDOM_RUNS = {
    "dense": ("layer0", False, None, False, {(8, 4, False)}),
    "dense-lm": ("layer0", False, None, True, {(8, 4, True)}),
    "paged": ("layer0", True, None, False, {(8, 4, False)}),
    "paged-wave3-lm": ("layer0", True, 3, True, {(8, 4, True), (4, 4, True)}),
    "dense-self": ("self", False, None, False, {(8, 4, False)}),
    "paged-self": ("self", True, None, True, {(8, 4, True)}),
}


@pytest.mark.parametrize("name", list(RANDOM_RUNS))
def test_spec_batchers_random_weights_match_jax(random_spec, name, monkeypatch):
    """Tokens, stats, and after round 3 every live slot's target and draft
    cache rows (codes within one on <= 0.1% of entries, scales within 1e-5):
    a row written to the wrong slot, position or page shows there even where
    it does not flip a token."""
    draft, paged, wave, fused_lm, verify = RANDOM_RUNS[name]
    r = random_spec
    pt, pd = r["target"], r["drafts"][draft]
    jtoks, jstats, jrows = r["jax"][draft]
    rows = _record_launches(monkeypatch, with_lm=True)
    if paged:
        b = PagedSpeculativeBatcher(pt, pd, k=3, n_slots=4, max_len=256,
                                    verify_wave_slots=wave, fused_lm=fused_lm)
    else:
        b = SpeculativeBatcher(pt, pd, k=3, n_slots=4, max_len=256, fused=True,
                               cache_dtype=torch.int8, use_megakernel=True,
                               use_draft_megakernel=True, fused_lm=fused_lm)
    got, live = _drive(b, r["prompts"], N_NEW, _port_rows)
    assert got == jtoks == r["plain"]
    assert (b.rounds, b.proposed, b.accepted) == jstats
    assert 0 < b.accepted < b.proposed if draft == "layer0" else b.accepted == b.proposed
    assert live.keys() == jrows.keys() and len(live) == 4 * 2 * 4
    for key, ref in jrows.items():
        if key[2] in ("k", "v"):
            assert_rows_match(live[key], ref)
        else:
            np.testing.assert_allclose(live[key], ref, rtol=1e-5)
    assert {r for r in rows if r[1] == 4} == verify
    assert {r for r in rows if r[1] == 1} == {(4, 1, False)}      # the draft's steps


def test_fused_lm_needs_the_batched_kernel(random_spec):
    pt, pd = random_spec["target"], random_spec["drafts"]["layer0"]
    with pytest.raises(ValueError, match="fused_lm"):
        SpeculativeBatcher(pt, pd, k=3, n_slots=4, max_len=256, use_megakernel=False,
                           fused_lm=True)
