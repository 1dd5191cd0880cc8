"""The port's continuous batching (serving/batching.py) and its batched
whole-model step (serving/megadecode.model_step_batch, kernel
ops/model_fused.py::model_decode_mega_batch in mode (a)) against the JAX
package, f32, on the aligned small Llama (2 layers, T = 128).

model_step_batch: B = 2 (symmetric grid) and B = 3 (asymmetric grid), with
a free slot at position 0 among them, three greedy steps from the same
prefilled cache. Logits of the first step within 2e-4 of max|ref| against
JAX model_step_batch(interpret=True); greedy tokens of all three steps equal;
each slot's rows land at its own positions (int8 codes equal up to one-code
tie flips on at most 0.1% of entries) and nothing is written past them.

ContinuousBatcher: a two-slot schedule in which a third request joins while
another is still decoding, through the one-launch step (use_megakernel=True,
asymmetric grid) and through decode_step_multi (fused=False): per-request
greedy tokens identical to the JAX batcher's. Each JAX reference is computed
once per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu.serving.batching import ContinuousBatcher as JContinuousBatcher
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import dequant_matmul, model_fused
from mi_optimize_tpu_torch.serving import batching, megadecode
from tests.test_torch_block_fused import assert_rows_match
from tests.test_torch_model_fused import fused_pair, jax_model

T = 128
STEPS = 3
# (B, grid, model seed, positions): slot 0 of B=2 and slot 1 of B=3 are free
STEP_CASES = {"B2-sym": (2, "sym", 5, [0, 19]), "B3-asym": (3, "asym", 6, [11, 0, 37])}


def _slot_cache(jf, positions, seed):
    """A B-slot per-layer int8 cache (numpy) whose slot b holds the JAX
    prefill of a random prompt of positions[b] tokens (none at 0), and each
    slot's last token."""
    jcfg = jf.config
    rng = np.random.default_rng(seed)
    B = len(positions)
    cache = [{f: np.array(v) for f, v in c.items()}
             for c in jengine.init_cache(jcfg, B, T, jnp.int8)]
    last = rng.integers(0, jcfg.vocab_size, (B, 1))
    for b, p in enumerate(positions):
        if p == 0:
            continue
        prompt = rng.integers(0, jcfg.vocab_size, (1, p))
        logits, one = jengine.prefill(jf.params, jcfg, jnp.asarray(prompt),
                                      jengine.init_cache(jcfg, 1, T, jnp.int8), False)
        last[b, 0] = int(np.argmax(np.asarray(logits[0])))
        for c, o in zip(cache, one):
            for f in c:
                c[f][b] = np.asarray(o[f][0])
    return cache, last


@pytest.fixture(scope="module")
def step_runs():
    out = {}
    for name, (B, grid, seed, positions) in STEP_CASES.items():
        jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(seed, grid == "asym"))
        cache, last = _slot_cache(jf, positions, seed)
        sc = jmegadecode.stack_cache_batched([{f: jnp.asarray(v) for f, v in c.items()}
                                              for c in cache])
        pos, cur, logits0, toks = jnp.asarray(positions), jnp.asarray(last), None, []
        for _ in range(STEPS):
            logits, sc = jmegadecode.model_step_batch(jf.params, jstack, jmeta, jf.config, cur,
                                                      sc, pos, interpret=True)
            logits0 = np.asarray(logits) if logits0 is None else logits0
            cur = jnp.argmax(logits, -1).astype(cur.dtype)[:, None]
            toks.append(np.asarray(cur[:, 0]))
            pos = pos + 1
        out[name] = dict(pf=pf, stack=stack, meta=meta, cache=cache, last=last,
                         positions=positions, logits0=logits0, toks=np.stack(toks, 1),
                         cache_out={f: np.asarray(v) for f, v in sc.items()})
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_model_step_batch_matches_jax(step_runs, case):
    r = step_runs[case]
    pf, B = r["pf"], len(r["positions"])
    cfg = pf.config
    sc = megadecode.stack_cache_batched(
        [{f: torch.from_numpy(v.copy()) for f, v in c.items()} for c in r["cache"]])
    pos = np.array(r["positions"])
    cur = torch.from_numpy(r["last"].copy())
    before = model_fused.launches_batch
    toks = []
    for i in range(STEPS):
        logits, sc = megadecode.model_step_batch(pf.params, r["stack"], r["meta"], cfg, cur,
                                                 sc, pos)
        if i == 0:
            ref = r["logits0"]
            assert logits.shape == ref.shape == (B, cfg.vocab_size)
            assert np.abs(logits.numpy() - ref).max() <= 2e-4 * np.abs(ref).max()
        cur = torch.argmax(logits, -1)[:, None]
        toks.append(cur[:, 0].numpy())
        pos = pos + 1
    assert model_fused.launches_batch == before
    np.testing.assert_array_equal(np.stack(toks, 1), r["toks"])
    for b, p in enumerate(r["positions"]):
        for f in ("k", "v"):
            got = sc[f][:, b, :, p:p + STEPS].numpy()
            assert np.abs(got).sum() > 0, f"slot {b}: rows not written"
            assert_rows_match(got, r["cache_out"][f][:, b, :, p:p + STEPS])
            assert int(sc[f][:, b, :, p + STEPS:].abs().sum()) == 0, f"slot {b} wrote past"
            np.testing.assert_allclose(sc[f + "_scale"][:, b, :, p:p + STEPS].numpy(),
                                       r["cache_out"][f + "_scale"][:, b, :, p:p + STEPS],
                                       rtol=1e-6)


def _drive(b, prompts):
    """Two requests, then a third that joins as soon as a slot frees while
    the other request still decodes. Returns each request's tokens."""
    reqs = [b.add_request(prompts[0], max_new_tokens=3), b.add_request(prompts[1],
                                                                       max_new_tokens=6)]
    by_rid = {r.rid: r for r in b.slot_req}
    joined = None
    for _ in range(20):
        b.step()
        if joined is None and None in b.slot_req:
            assert any(r is not None for r in b.slot_req), "the join must be mid-flight"
            joined = b.add_request(prompts[2], max_new_tokens=4)
            by_rid[joined] = [r for r in b.slot_req if r and r.rid == joined][0]
        if all(s is None for s in b.slot_req):
            break
    return [by_rid[r].tokens for r in reqs + [joined]]


BATCHERS = {"megakernel-asym": (7, True, dict(fused=True, use_megakernel=True)),
            "per-layer-sym": (8, False, dict(fused=False))}


@pytest.fixture(scope="module")
def batcher_runs():
    out = {}
    for name, (seed, asym, kw) in BATCHERS.items():
        jm = jax_model(seed, asym)
        jf, _, pf, _ = fused_pair(jm)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, 128, (n,)) for n in (9, 14, 6)]
        jb = JContinuousBatcher(jf, n_slots=2, max_len=T, cache_dtype=jnp.int8, **kw)
        assert (jb._mega is not None) == kw.get("use_megakernel", False)
        out[name] = dict(pf=pf, prompts=prompts, kw=kw, ref=_drive(jb, prompts))
    return out


@pytest.mark.parametrize("name", list(BATCHERS))
def test_continuous_batcher_matches_jax(batcher_runs, name):
    r = batcher_runs[name]
    b = batching.ContinuousBatcher(r["pf"], n_slots=2, max_len=T, cache_dtype=torch.int8,
                                   **r["kw"])
    assert (b._mega is not None) == r["kw"].get("use_megakernel", False)
    before = model_fused.launches_batch, dequant_matmul.launches
    got = _drive(b, r["prompts"])
    assert [len(t) for t in got] == [3, 6, 4]
    assert got == [[int(t) for t in ref] for ref in r["ref"]]
    assert (model_fused.launches_batch, dequant_matmul.launches) == before


def test_megakernel_defaults_off_on_cpu_and_run_all():
    """On a CPU model the batcher defaults to the per-layer step (the
    megakernel default is keyed on CUDA); run_all serves more prompts than
    slots and gives every request its tokens."""
    _, _, pf, _ = fused_pair(jax_model(9))
    b = batching.ContinuousBatcher(pf, n_slots=2, max_len=T, cache_dtype=torch.int8)
    assert b._mega is None and b.device.type == "cpu"
    rng = np.random.default_rng(1)
    res = b.run_all([rng.integers(0, 128, (n,)) for n in (5, 7, 3)], max_new_tokens=3)
    assert sorted(res) == [0, 1, 2] and all(len(t) == 3 for t in res.values())


def test_upd_per_slot_positions_and_clamp():
    """llama._upd with a position vector writes row b at idx[b]; a start
    past T - S is clamped into the buffer, as dynamic_update_slice does."""
    buf = torch.zeros(3, 8, 2)
    new = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 2) + 1
    llama._upd(buf, new, torch.tensor([0, 5, 9]))
    assert torch.equal(buf[0, 0:2], new[0]) and torch.equal(buf[1, 5:7], new[1])
    assert torch.equal(buf[2, 6:8], new[2])                          # 9 -> clamped to 6
    assert int((buf != 0).sum()) == new.numel()
    llama._upd(buf, new[:, :1], 20)
    assert torch.equal(buf[:, 7], new[:, 0])
