"""The batched kernel's terminal lm rows, mode (d) of ops/model_fused.py
(plain version on the CPU), against the JAX kernel
(mi_optimize_tpu/ops/model_fused.py::model_decode_mega_batch with lm=,
interpret=True), f32, on the aligned small Llama (2 layers, h=512, V=128).

Cases: dense one-token rows (B=2 at positions 0 and 19), a dense chunk (C=3,
one slot at prefix 40) and a paged chunk (two slots of C=3 at prefixes 126,
across a page boundary, and 5). Logits within 1e-4 of max|ref| (the dequant
dots sum in other orders), tokens equal; the five base outputs as the
modes without lm rows are held (x_out within 2e-4, rows up to one-code tie
flips on at most 0.1% of entries). `stack_lm` takes and refuses models as
JAX's does, and the chunk step's logits with the fused rows agree with
those of the lm_head after the kernel. Each JAX reference is computed once
per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.ops.model_fused import model_decode_mega_batch as jax_mega_batch
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving import megadecode
from tests.test_torch_block_fused import assert_rows_match, random_cache
from tests.test_torch_model_fused import fused_pair, jax_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process (the plain versions run many small
    CPU ops; the suite's workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = 128
# name: (model seed, slot prefixes, chunk, paged)
CASES = {"dense-B2": (21, [0, 19], 1, False), "chunk-C3": (22, [40], 3, False),
         "paged-chunk-C3": (23, [126, 5], 3, True)}


def _inputs(jcfg, prefixes, C, paged, seed):
    """(x [B,1,h], positions [B], cache or pool, table) as numpy."""
    rng = np.random.default_rng(seed)
    L, Hkv, D, S = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim, len(prefixes)
    positions = np.array([p + i for p in prefixes for i in range(C)])
    x = rng.standard_normal((S * C, 1, jcfg.hidden_size)).astype(np.float32)
    if not paged:
        return x, positions, random_cache((L, S, Hkv, P, D), seed), None
    n_pages = 1 + 2 * S
    table = (rng.permutation(n_pages - 1) + 1)[:2 * S].reshape(S, 2).astype(np.int32)
    return x, positions, random_cache((L, n_pages, Hkv, P, D), seed), table


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (seed, prefixes, C, paged) in CASES.items():
        jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(seed))
        jlm, jlm_meta = jmegadecode.stack_lm(jf, jmeta)
        x, positions, cache, table = _inputs(jf.config, prefixes, C, paged, seed)
        jcos, jsin = jllama.rope_tables(jf.config, jnp.asarray(positions)[:, None])
        D = jf.config.head_dim
        B = len(positions)
        outs = jax_mega_batch(
            jstack, jnp.asarray(x), jcos.reshape(B, -1)[:, -D:], jsin.reshape(B, -1)[:, -D:],
            {f: jnp.asarray(v) for f, v in cache.items()}, jnp.asarray(positions), jf.config,
            jmeta, interpret=True, table=None if table is None else jnp.asarray(table),
            chunk=C, lm=jlm, lm_meta=jlm_meta)
        out[name] = dict(pf=pf, stack=stack, meta=meta, jlm_meta=jlm_meta, x=x,
                         positions=positions, cache=cache, table=table, C=C,
                         ref=[np.asarray(o) for o in outs])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_lm_rows_match_jax(runs, name):
    r = runs[name]
    pf, C = r["pf"], r["C"]
    cfg = pf.config
    lm, lm_meta = megadecode.stack_lm(pf, r["meta"])
    assert lm_meta == r["jlm_meta"]
    B = len(r["positions"])
    cos, sin = llama.rope_tables(cfg, torch.as_tensor(r["positions"])[:, None])
    before = model_fused.launches_lm
    outs = model_fused.model_decode_mega_batch(
        r["stack"], torch.from_numpy(r["x"]), cos.reshape(B, -1), sin.reshape(B, -1),
        {f: torch.from_numpy(v) for f, v in r["cache"].items()}, r["positions"], cfg, r["meta"],
        table=None if r["table"] is None else torch.from_numpy(r["table"]), chunk=C, lm=lm,
        lm_meta=lm_meta)
    assert model_fused.launches_lm == before and len(outs) == 7
    jx, jk, jv, jks, jvs, jlogits, jtok = r["ref"]
    scale = np.abs(jx).max()
    assert np.abs(outs[0].numpy() - jx).max() <= 2e-4 * scale
    assert_rows_match(outs[1].numpy(), jk)
    assert_rows_match(outs[2].numpy(), jv)
    np.testing.assert_allclose(outs[3].numpy(), jks, rtol=1e-6)
    logits, tokens = outs[5], outs[6]
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    assert np.abs(logits.numpy() - jlogits).max() <= 1e-4 * np.abs(jlogits).max()
    assert tokens.dtype == torch.int32 and tokens.tolist() == jtok.tolist()
    assert tokens.tolist() == torch.argmax(logits, -1).tolist()


def test_stack_lm_contract_matches_jax():
    """Accepted with JAX's meta; refused where JAX refuses: an asymmetric
    lm_head grid, no packed words, and a vocab without a 128-aligned
    divisor under the tile cap."""
    jf, (_, jmeta), pf, (_, meta) = fused_pair(jax_model(24))
    assert megadecode.stack_lm(pf, meta)[1] == jmegadecode.stack_lm(jf, jmeta)[1]
    assert megadecode.stack_lm(pf, meta, cap=64) is None
    assert jmegadecode.stack_lm(jf, jmeta, cap=64) is None
    lm = pf.params["lm_head"]
    z = lm.w_zero.clone()
    z.view(-1)[0] += 1.0
    pf.params["lm_head"] = lm.replace(w_zero=z)
    assert megadecode.stack_lm(pf, meta) is None
    pf.params["lm_head"] = lm.replace(packed=None)
    assert megadecode.stack_lm(pf, meta) is None
    jlm = jf.params["lm_head"]
    jf.params["lm_head"] = jlm.replace(w_zero=jnp.asarray(jlm.w_zero).at[0, 0].add(1.0))
    assert jmegadecode.stack_lm(jf, jmeta) is None


def test_chunk_step_lm_rows_match_lm_head_after_the_kernel():
    """model_step_chunk with the fused rows and without: the same logits up
    to the sum order, the same tokens, the same cache rows."""
    _, _, pf, (stack, meta) = fused_pair(jax_model(25))
    cfg = pf.config
    lm, lm_meta = megadecode.stack_lm(pf, meta)
    base = random_cache((cfg.num_layers, 1, cfg.num_kv_heads, 2 * P, cfg.head_dim), 25)
    tokens = torch.tensor([[3, 77, 12, 90, 41]])
    got = {}
    for fused in (False, True):
        cache = {f: torch.from_numpy(v.copy()) for f, v in base.items()}
        got[fused] = megadecode.model_step_chunk(pf.params, stack, meta, cfg, tokens, cache, 61,
                                                 *((lm, lm_meta) if fused else ()))
    (l0, c0), (l1, c1) = got[False], got[True]
    assert l1.shape == l0.shape == (5, cfg.vocab_size)
    assert (l1 - l0).abs().max() <= 1e-4 * l0.abs().max()
    assert torch.equal(torch.argmax(l1, -1), torch.argmax(l0, -1))
    for f in c0:
        assert torch.equal(c0[f], c1[f])
