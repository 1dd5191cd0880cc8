"""The port's paged and chunk serving (serving/megadecode.py paged and chunk
steps, serving/paged.py) against the JAX package, f32, on the aligned small
Llama (2 layers, h=512, 4 heads over 2 kv heads, D=128).

- model_step_batch_paged (kernel mode (b), plain version on the CPU) against
  JAX model_step_batch_paged(interpret=True), seed 7, slots at positions 9
  and 140 over a 5-page pool whose pages are a seeded permutation: logits
  within 2e-4 of max|ref| (the dequant dots sum in different orders); the
  new rows at their (page, offset) equal up to one-code tie flips on at most
  0.1% of entries, scales within 1e-6 relative. The port's paged step is
  bitwise equal to its dense step on the mirrored state.
- model_step_chunk (prefix 70 and prefix 0), model_step_chunk_batch (two
  slots at prefixes 0 and 41) and model_step_chunk_batch_paged (prefixes 126,
  across a page boundary, and 0) against JAX (mode (c), alone and with (b)):
  the same tolerances, every written row checked, nothing written past the
  chunk.
- PagedMegaBatcher against the port's ContinuousBatcher: page recycling
  through a 5-page pool (free list restored, table zero) and the wave split
  (3 slots in waves of 2): greedy tokens identical.
- PagedBatcher against JAX's PagedBatcher on both routes (page 4: gather and
  the stock attention; page 16: kernel B8): greedy tokens identical.
Each JAX reference is computed once per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu.serving.paged import PagedBatcher as JPagedBatcher
from mi_optimize_tpu_torch.ops import dequant_matmul, model_fused, paged_attention
from mi_optimize_tpu_torch.serving import engine, megadecode
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
from mi_optimize_tpu_torch.serving.paged import PagedBatcher, PagedMegaBatcher
from tests.test_torch_block_fused import assert_rows_match
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


P = 128
FIELDS = ("k", "v", "k_scale", "v_scale")


def _torch(d):
    return {f: torch.from_numpy(np.array(v)) for f, v in d.items()}


def _close(got, ref, rtol=2e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _rows_equal(got, ref):
    """k/v codes up to tie flips, scales to 1e-6 relative; [L, R, Hkv(, D)]."""
    for f in ("k", "v"):
        assert np.abs(got[f]).sum() > 0, f"{f} rows not written"
        assert_rows_match(got[f], ref[f])
        np.testing.assert_allclose(got[f + "_scale"], ref[f + "_scale"], rtol=1e-6)


def _prefilled(jf, lengths, T, rng):
    """A per-layer int8 cache (JAX prefill, one slot per length; 0 = empty)
    and each slot's greedy next token."""
    jcfg = jf.config
    cache = [{f: np.array(v) for f, v in c.items()}
             for c in jengine.init_cache(jcfg, len(lengths), T, jnp.int8)]
    last = rng.integers(0, jcfg.vocab_size, (len(lengths), 1))
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        logits, one = jengine.prefill(jf.params, jcfg, jnp.asarray(rng.integers(0, 128, (1, n))),
                                      jengine.init_cache(jcfg, 1, T, jnp.int8), False)
        last[b, 0] = int(np.argmax(np.asarray(logits[0])))
        for c, o in zip(cache, one):
            for f in c:
                c[f][b] = np.asarray(o[f][0])
    sc = jmegadecode.stack_cache_batched([{f: jnp.asarray(v) for f, v in c.items()}
                                          for c in cache])
    return {f: np.asarray(v) for f, v in sc.items()}, last


def _mirror(sc, jcfg, seed):
    """The head-transposed dense cache [L, B, Hkv, T(, D)] in a page pool
    with one scratch page: slot b's block t on page table[b, t], the pages a
    seeded permutation."""
    B, T = sc["k"].shape[1], sc["k"].shape[3]
    nt = T // P
    pool = {f: np.array(v) for f, v in jmegadecode.init_pool_batched(jcfg, 1 + B * nt, P).items()}
    table = (np.random.default_rng(seed).permutation(B * nt) + 1).reshape(B, nt).astype(np.int32)
    for b in range(B):
        for t in range(nt):
            for f in FIELDS:
                pool[f][:, table[b, t]] = sc[f][:, b, :, t * P:(t + 1) * P]
    return pool, table


def _at(cache, slot_rows):
    """Rows [L, R, Hkv(, D)] of a dense cache at (slot, position) pairs."""
    return {f: np.stack([cache[f][:, s, :, t] for s, t in slot_rows], 1) for f in FIELDS}


def _at_pages(pool, table, slot_rows):
    return {f: np.stack([pool[f][:, table[s, t // P], :, t % P] for s, t in slot_rows], 1)
            for f in FIELDS}


# ---------------------------------------------------------------------------
# model_step_batch_paged
# ---------------------------------------------------------------------------

POSITIONS = [9, 140]


@pytest.fixture(scope="module")
def paged_step():
    jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(7))
    sc, last = _prefilled(jf, POSITIONS, 2 * P, np.random.default_rng(11))
    pool, table = _mirror(sc, jf.config, seed=1)
    logits, pool2 = jmegadecode.model_step_batch_paged(
        jf.params, jstack, jmeta, jf.config, jnp.asarray(last), _jnp(pool), jnp.asarray(table),
        jnp.asarray(POSITIONS), interpret=True)
    return dict(pf=pf, stack=stack, meta=meta, sc=sc, pool=pool, table=table, last=last,
                logits=np.asarray(logits), pool2={f: np.asarray(v) for f, v in pool2.items()})


def _jnp(d):
    return {f: jnp.asarray(v) for f, v in d.items()}


def test_model_step_batch_paged_matches_jax(paged_step):
    r = paged_step
    pf = r["pf"]
    pool = _torch(r["pool"])
    before = model_fused.launches_paged
    logits, pool = megadecode.model_step_batch_paged(
        pf.params, r["stack"], r["meta"], pf.config, torch.from_numpy(r["last"]), pool,
        r["table"], POSITIONS)
    assert model_fused.launches_paged == before
    _close(logits, r["logits"])
    rows = list(enumerate(POSITIONS))
    got = _at_pages({f: v.numpy() for f, v in pool.items()}, r["table"], rows)
    _rows_equal(got, _at_pages(r["pool2"], r["table"], rows))
    for f in FIELDS:  # nothing but the two new rows changed
        diff = pool[f].numpy() != r["pool"][f]
        for s, t in rows:
            diff[:, r["table"][s, t // P], :, t % P] = False
        assert not diff.any()


def test_paged_step_bitwise_equals_dense_step(paged_step):
    """The port's paged step on the mirrored pool and its dense step on the
    dense cache: the same logits bit for bit, the same rows."""
    r = paged_step
    pf = r["pf"]
    args = (pf.params, r["stack"], r["meta"], pf.config, torch.from_numpy(r["last"]))
    ld, sc = megadecode.model_step_batch(*args, _torch(r["sc"]), POSITIONS)
    lp, pool = megadecode.model_step_batch_paged(*args, _torch(r["pool"]), r["table"], POSITIONS)
    assert torch.equal(ld, lp)
    rows = list(enumerate(POSITIONS))
    dense = _at({f: v.numpy() for f, v in sc.items()}, rows)
    paged = _at_pages({f: v.numpy() for f, v in pool.items()}, r["table"], rows)
    for f in FIELDS:
        np.testing.assert_array_equal(paged[f], dense[f])


# ---------------------------------------------------------------------------
# the chunk steps
# ---------------------------------------------------------------------------

# name: (model seed, cache length, prefix lengths, chunk length, paged)
CHUNKS = {"single": (9, 256, [70], 5, False), "single-empty": (10, 128, [0], 4, False),
          "batch": (11, 128, [0, 41], 4, False), "paged": (12, 256, [126, 0], 4, True)}


@pytest.fixture(scope="module")
def chunk_runs():
    out = {}
    for name, (seed, T, prefixes, C, paged) in CHUNKS.items():
        jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(seed))
        rng = np.random.default_rng(seed)
        sc, _ = _prefilled(jf, prefixes, T, rng)
        tokens = rng.integers(0, 128, (len(prefixes), C))
        jargs = (jf.params, jstack, jmeta, jf.config, jnp.asarray(tokens))
        table = None
        if paged:
            cache, table = _mirror(sc, jf.config, seed)
            logits, c2 = jmegadecode.model_step_chunk_batch_paged(
                *jargs, _jnp(cache), jnp.asarray(table), jnp.asarray(prefixes), interpret=True)
        elif len(prefixes) == 1:
            cache = sc
            logits, c2 = jmegadecode.model_step_chunk(*jargs, _jnp(cache),
                                                      jnp.asarray(prefixes[0]), interpret=True)
        else:
            cache = sc
            logits, c2 = jmegadecode.model_step_chunk_batch(*jargs, _jnp(cache),
                                                            jnp.asarray(prefixes), interpret=True)
        out[name] = dict(pf=pf, stack=stack, meta=meta, cache=cache, table=table,
                         tokens=tokens, prefixes=prefixes, logits=np.asarray(logits),
                         c2={f: np.asarray(v) for f, v in c2.items()})
    return out


@pytest.mark.parametrize("name", list(CHUNKS))
def test_chunk_steps_match_jax(chunk_runs, name):
    r = chunk_runs[name]
    pf, prefixes, table = r["pf"], r["prefixes"], r["table"]
    C = r["tokens"].shape[1]
    args = (pf.params, r["stack"], r["meta"], pf.config, torch.from_numpy(r["tokens"]),
            _torch(r["cache"]))
    before = model_fused.launches_chunk
    if table is not None:
        logits, c2 = megadecode.model_step_chunk_batch_paged(*args, table, prefixes)
    elif len(prefixes) == 1:
        logits, c2 = megadecode.model_step_chunk(*args, prefixes[0])
    else:
        logits, c2 = megadecode.model_step_chunk_batch(*args, prefixes)
    assert model_fused.launches_chunk == before
    _close(logits, r["logits"])
    c2 = {f: v.numpy() for f, v in c2.items()}
    rows = [(s, p + i) for s, p in enumerate(prefixes) for i in range(C)]
    if table is not None:
        _rows_equal(_at_pages(c2, table, rows), _at_pages(r["c2"], table, rows))
    else:
        _rows_equal(_at(c2, rows), _at(r["c2"], rows))
        for s, p in enumerate(prefixes):
            assert np.abs(c2["k"][:, s, :, p + C:]).sum() == 0, f"slot {s} wrote past its chunk"


def test_chunk_rows_past_the_cache_raise():
    """The reference's dynamic_update_slice would clamp such rows; the port
    refuses them."""
    _, _, pf, (stack, meta) = fused_pair(jax_model(10))
    cache = megadecode.stack_cache_batched(engine.init_cache(pf.config, 1, 128, torch.int8,
                                                             device="cpu"))
    with pytest.raises(ValueError, match="outside the cache"):
        megadecode.model_step_chunk(pf.params, stack, meta, pf.config,
                                    torch.zeros(1, 4, dtype=torch.long), cache, 126)


# ---------------------------------------------------------------------------
# PagedMegaBatcher against the port's ContinuousBatcher
# ---------------------------------------------------------------------------

def test_paged_mega_batcher_recycles_and_matches_dense():
    """4 requests x 2 pages each through a 5-page pool (2 slots): finished
    requests return their pages for the next ones (positions cross 128, so
    second pages are taken lazily mid-run), and every greedy sequence equals
    the dense ContinuousBatcher's."""
    _, _, pf, _ = fused_pair(jax_model(8))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 128, (120 + 3 * i,)) for i in range(4)]
    dense = ContinuousBatcher(pf, n_slots=2, max_len=256, cache_dtype=torch.int8,
                              use_megakernel=True)
    ref = dense.run_all(list(prompts), max_new_tokens=12)
    pb = PagedMegaBatcher(pf, n_slots=2, max_len=256, page_size=128, n_pages=6)
    assert pb.device.type == "cpu" and pb.pool["k"].shape[1] == 6
    got = pb.run_all(list(prompts), max_new_tokens=12)
    assert got == ref
    assert sorted(pb.free_pages) == list(range(1, 6))
    assert (pb.table == 0).all() and (pb.page_refs == 0).all()


def test_paged_wave_split_matches_dense(monkeypatch):
    """3 slots in waves of 2 (the last wave padded with its slot repeated),
    with retirements mid-run: the dense batcher's greedy tokens exactly."""
    _, _, pf, _ = fused_pair(jax_model(9))
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 128, (100 + 5 * i,)) for i in range(3)]
    dense = ContinuousBatcher(pf, n_slots=3, max_len=256, cache_dtype=torch.int8,
                              use_megakernel=True)
    ref = dense.run_all(list(prompts), max_new_tokens=10)
    pb = PagedMegaBatcher(pf, n_slots=3, max_len=256, page_size=128, wave_slots=2)
    calls = []
    step = megadecode.model_step_batch_paged
    monkeypatch.setattr(megadecode, "model_step_batch_paged",
                        lambda *a, **k: calls.append(a[4].shape[0]) or step(*a, **k))
    got = pb.run_all(list(prompts), max_new_tokens=10)
    assert got == ref
    assert set(calls) == {2}


# ---------------------------------------------------------------------------
# PagedBatcher against JAX's, on both attention routes
# ---------------------------------------------------------------------------

# page size: (pages a slot, pool pages); 4 -> gather route, 16 -> kernel B8
ROUTES = {4: (6, 16), 16: (2, 8)}


def _drive_paged(b, prompts):
    """Two requests, then a third that joins as soon as a slot frees."""
    rids = [b.add_request(prompts[0], max_new_tokens=3), b.add_request(prompts[1],
                                                                       max_new_tokens=5)]
    toks = {r: [s.tokens[0]] for r, s in zip(rids, b.slot_req)}
    while any(s is not None for s in b.slot_req):
        for rid, t in b.step().items():
            toks[rid].append(t)
        if len(rids) == 2 and None in b.slot_req:
            rids.append(b.add_request(prompts[2], max_new_tokens=4))
            toks[rids[2]] = [next(s for s in b.slot_req if s and s.rid == rids[2]).tokens[0]]
    return [toks[r] for r in rids], sorted(b.free_pages)


@pytest.fixture(scope="module")
def paged_batcher_runs():
    jf, _, pf, _ = fused_pair(jax_model(14))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, (n,)) for n in (7, 12, 9)]
    out = {}
    for ps, (pps, n_pages) in ROUTES.items():
        jb = JPagedBatcher(jf, n_slots=2, page_size=ps, n_pages=n_pages, pages_per_slot=pps)
        out[ps] = _drive_paged(jb, prompts)
    return pf, prompts, out


@pytest.mark.parametrize("page_size", list(ROUTES))
def test_paged_batcher_matches_jax(paged_batcher_runs, page_size, monkeypatch):
    pf, prompts, ref = paged_batcher_runs
    pps, n_pages = ROUTES[page_size]
    assert paged_attention.paged_attention_supported(page_size, 128) == (page_size == 16)
    b = PagedBatcher(pf, n_slots=2, page_size=page_size, n_pages=n_pages, pages_per_slot=pps)
    assert b.layers[0][0].dtype == torch.float32 and b.device.type == "cpu"
    before = paged_attention.launches, dequant_matmul.launches
    calls = []
    ref_fn = paged_attention.paged_flash_attention_ref
    monkeypatch.setattr(paged_attention, "paged_flash_attention_ref",
                        lambda *a, **k: calls.append(1) or ref_fn(*a, **k))
    got = _drive_paged(b, prompts)
    assert got[0] == [[int(t) for t in r] for r in ref[page_size][0]]
    assert got[1] == ref[page_size][1]
    assert (paged_attention.launches, dequant_matmul.launches) == before
    assert bool(calls) == (page_size == 16)
