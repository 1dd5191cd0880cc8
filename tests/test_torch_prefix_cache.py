"""Automatic prefix caching on the port's PagedMegaBatcher
(serving/paged.py), the six scenarios of tests/test_prefix_cache.py, f32 on
the CPU (plain versions of the kernels).

Full prompt pages are registered under a chain hash of the whole prefix; a
later request that starts with a cached chain maps those pages (refcount +
1, no recompute) and prefills only its suffix through the paged chunk step
(megadecode.model_step_chunk_batch_paged), attending to the hit pages
through the page table. Refcount-0 cached pages stay resident on an LRU list
and are evicted only under allocator pressure. Hit pages hold the same KV
bytes, so a cache-enabled batcher emits the uncached batcher's greedy
tokens.

The page-identity scenario also runs JAX's PagedMegaBatcher(prefix_cache=
True) beside the port's (interpret mode) and compares tokens, tables,
page_refs and stats exactly."""
import numpy as np
import pytest
import torch

from mi_optimize_tpu.serving.paged import PagedMegaBatcher as JPagedMegaBatcher
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher
from tests.test_torch_model_fused import fused_pair, jax_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small CPU ops: one torch thread a test
    process keeps the suite's parallel workers from oversubscribing the
    cores (each worker's own thread pool would otherwise spin on all of
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts_with_shared_page(rng, n_tail=3):
    shared = rng.integers(0, 128, (128,))          # exactly one full page
    return [np.concatenate([shared, rng.integers(0, 128, (10 + 3 * i,))])
            for i in range(n_tail)]


def _port(seed):
    return fused_pair(jax_model(seed))[2]


def test_prefix_cache_matches_uncached_and_shares_pages(monkeypatch):
    model = _port(9)
    rng = np.random.default_rng(21)
    prompts = _prompts_with_shared_page(rng)
    ref = PagedMegaBatcher(model, n_slots=1, max_len=256, page_size=128).run_all(list(prompts), 6)
    pb = PagedMegaBatcher(model, n_slots=1, max_len=256, page_size=128, prefix_cache=True)
    chunks = []
    ref_fn = model_fused.model_decode_mega_batch_ref
    monkeypatch.setattr(model_fused, "model_decode_mega_batch_ref",
                        lambda *a: chunks.append(a[-1]) or ref_fn(*a))
    got = pb.run_all(list(prompts), 6)
    assert got == ref
    # the hits' suffixes (13 and 16 tokens) ran through the chunk mode, 8 a launch
    assert chunks.count(8) == 4
    st = pb.prefix_cache_stats()
    assert st["hit_tokens"] == 2 * 128
    assert st["miss_tokens"] == sum(len(p) for p in prompts) - 2 * 128
    assert st["cached_pages"] >= 1
    # all requests retired -> cached pages sit on the LRU list, not freed
    assert st["evictable_pages"] == st["cached_pages"]
    assert sorted(pb.free_pages + list(pb._pc_lru)) == list(range(1, len(pb.page_refs)))
    assert (pb.page_refs == 0).all()


def _state(b):
    return (b.table.tolist(), b.page_refs.tolist(), b.prefix_cache_stats(),
            sorted(b.free_pages), list(b._pc_lru))


def test_prefix_cache_page_identity_and_refcounts_match_jax():
    """The hit request's table points at the first request's page while both
    are live, the refcount tracks both; every host-side decision and token
    equals JAX's batcher's."""
    jf, _, pf, _ = fused_pair(jax_model(10))
    rng = np.random.default_rng(23)
    p1, p2 = _prompts_with_shared_page(rng, n_tail=2)
    runs = {}
    for name, cls, m in (("jax", JPagedMegaBatcher, jf), ("port", PagedMegaBatcher, pf)):
        pb = cls(m, n_slots=2, max_len=256, page_size=128, prefix_cache=True)
        r1 = pb.add_request(p1, max_new_tokens=3)
        r2 = pb.add_request(p2, max_new_tokens=3)
        admitted = _state(pb)
        reqs = [pb.slot_req[0], pb.slot_req[1]]
        assert (r1, r2) == (0, 1) and [r.rid for r in reqs] == [0, 1]
        while any(r is not None for r in pb.slot_req):
            pb.step()
        runs[name] = (admitted, [r.tokens for r in reqs], _state(pb))
    admitted, tokens, done = runs["port"]
    table, refs = admitted[0], admitted[1]
    shared = table[0][0]
    assert table[1][0] == shared and refs[shared] == 2
    assert table[1][1] != table[0][1]                  # private tails
    assert done[1] == [0] * len(done[1]) and shared in done[4]   # resident, evictable
    assert runs["port"] == runs["jax"]


def test_prefix_cache_eviction_under_pressure():
    """A pool too small to keep cold cached pages evicts them (LRU),
    deregisters them, and still serves an unrelated prompt correctly."""
    model = _port(11)
    rng = np.random.default_rng(29)
    pa, pb_prompt = _prompts_with_shared_page(rng, n_tail=2)
    other = rng.integers(0, 128, (140,))
    ref = PagedMegaBatcher(model, n_slots=1, max_len=256, page_size=128).run_all(
        [pa, pb_prompt, other], 4)
    pb = PagedMegaBatcher(model, n_slots=1, max_len=256, page_size=128, n_pages=5,
                          prefix_cache=True)
    got = pb.run_all([pa, pb_prompt, other], 4)
    assert got == ref
    st = pb.prefix_cache_stats()
    assert st["hit_tokens"] == 128                      # pb_prompt hit pa's page
    assert st["cached_pages"] <= 3


def test_prefix_cache_hit_pages_pinned_before_alloc():
    """_alloc's LRU eviction never evicts the pages the hit lookup just
    resolved: they are pinned first, and when the pool cannot cover the
    suffix with them pinned, the request falls back to a full miss."""
    model = _port(13)
    rng = np.random.default_rng(37)
    shared = rng.integers(0, 128, (128,))
    p_small = np.concatenate([shared, rng.integers(0, 128, (10,))])   # 2 pages
    p_big = np.concatenate([shared, rng.integers(0, 128, (200,))])    # 3 pages
    ref = PagedMegaBatcher(model, n_slots=1, max_len=512, page_size=128).run_all(
        [p_small, p_big], 4)
    pb = PagedMegaBatcher(model, n_slots=1, max_len=512, page_size=128, n_pages=4,
                          prefix_cache=True)
    got = pb.run_all([p_small, p_big], 4)
    assert got == ref
    assert (pb.page_refs == 0).all()
    assert sorted(pb.free_pages + list(pb._pc_lru)) == [1, 2, 3]


def test_prefix_cache_rejection_rolls_back_pins_and_stats():
    """An inadmissible request leaves refcounts, the LRU and the stats as
    they were (stats count only admitted work)."""
    model = _port(14)
    rng = np.random.default_rng(41)
    shared = rng.integers(0, 128, (128,))
    p1 = np.concatenate([shared, rng.integers(0, 128, (10,))])
    pb = PagedMegaBatcher(model, n_slots=2, max_len=512, page_size=128, n_pages=3,
                          prefix_cache=True)
    assert pb.add_request(p1, max_new_tokens=4) is not None    # uses both pages
    st0, refs0, lru0 = pb.prefix_cache_stats(), pb.page_refs.copy(), dict(pb._pc_lru)
    p2 = np.concatenate([shared, rng.integers(0, 128, (200,))])
    assert pb.add_request(p2, max_new_tokens=4) is None
    assert pb.prefix_cache_stats() == st0 and pb._pc_lru == lru0
    assert (pb.page_refs == refs0).all()


def test_prefix_cache_composes_with_parallel_sampling():
    """n > 1 forks of a cache-hit request share its hit pages (refcount ==
    forks + the first request), sample deterministically per seed, and
    release every page."""
    model = _port(12)
    rng = np.random.default_rng(31)
    p1, p2 = _prompts_with_shared_page(rng, n_tail=2)
    outs = []
    for _ in range(2):
        pb = PagedMegaBatcher(model, n_slots=3, max_len=256, page_size=128, prefix_cache=True)
        pb.add_request(p1, max_new_tokens=8)
        rids = pb.add_request(p2, max_new_tokens=8, n=2, temperature=0.8, seed=7)
        assert isinstance(rids, list) and len(rids) == 2
        shared_pg = int(pb.table[0, 0])
        assert int(pb.table[1, 0]) == shared_pg == int(pb.table[2, 0])
        assert pb.page_refs[shared_pg] == 3
        assert int(pb.table[1, 1]) != int(pb.table[2, 1])        # private tails, copied
        assert torch.equal(pb.pool["k"][:, pb.table[1, 1], :, :p2.size - 128],
                           pb.pool["k"][:, pb.table[2, 1], :, :p2.size - 128])
        reqs = list(pb.slot_req)
        while any(r is not None for r in pb.slot_req):
            pb.step()
        assert (pb.page_refs == 0).all()
        outs.append([r.tokens for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(t) == 8 for t in outs[0])
    with pytest.raises(ValueError, match="temperature"):
        pb.add_request(p2, n=2)
