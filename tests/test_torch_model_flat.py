"""Plain version of the port's model_decode_flat against the JAX kernel
(ops/model_flat.py, interpret=True), f32, on the aligned small Llama.

Token: equal. Logits: rtol = atol = 2e-4, as the reference's own flat test.
New int8 rows: equal up to rare one-code tie flips; scales rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.ops.model_flat import model_decode_flat as jax_model_decode_flat
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu.serving.flatdecode import stack_flat as jax_stack_flat
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import dequant_matmul, model_flat
from mi_optimize_tpu_torch.serving.flatdecode import stack_flat
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_torch_block_fused import assert_rows_match, random_cache
from tests.test_torch_convert import small_models


def _merged_cache(cfg, T, seed):
    c = random_cache((cfg.num_layers, T, cfg.num_kv_heads, cfg.head_dim), seed)
    return {"kv": np.stack([c["k"], c["v"]], axis=2),
            "kv_scale": np.stack([c["k_scale"], c["v_scale"]], axis=2)}


@pytest.mark.parametrize("T,pos", [(256, 130)])
def test_plain_matches_jax_kernel(T, pos):
    jm, pm = small_models(seed=7)
    jf, pf = jax_fuse_for_serving(jm), fuse_for_serving(pm)
    jstack, jmeta = jax_stack_flat(jf)
    stack, meta = stack_flat(pf)
    assert meta == jmeta
    jcfg, cfg = jm.config, pm.config
    cache = _merged_cache(cfg, T, seed=pos)
    tok = np.array([[11]])

    jx = jllama.embed(jf.params, jnp.asarray(tok))
    jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray([pos]))
    jtok, jlogits, jrows, jsc = jax_model_decode_flat(
        jstack, jx, jnp.concatenate([jcos.reshape(-1), jsin.reshape(-1)]),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos), jcfg, jmeta,
        interpret=True)

    x = llama.embed(pf.params, torch.from_numpy(tok))
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    before = model_flat.launches
    ttok, logits, rows, sc = model_flat.model_decode_flat(
        stack, x, torch.cat([cos.reshape(-1), sin.reshape(-1)]),
        {k: torch.from_numpy(v) for k, v in cache.items()}, pos, cfg, meta)
    assert model_flat.launches == before

    assert int(ttok[0]) == int(np.asarray(jtok)[0, 0])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    assert rows.shape == jrows.shape and sc.shape == jsc.shape
    assert_rows_match(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-5)


def test_token_is_first_index_argmax():
    _, pm = small_models(seed=8)
    pf = fuse_for_serving(pm)
    stack, meta = stack_flat(pf)
    cfg = pm.config
    cache = {k: torch.from_numpy(v) for k, v in _merged_cache(cfg, 128, seed=3).items()}
    x = llama.embed(pf.params, torch.tensor([[5]]))
    cos, sin = llama.rope_tables(cfg, torch.tensor([40]))
    cossin = torch.cat([cos.reshape(-1), sin.reshape(-1)])
    tok, logits, _, _ = model_flat.model_decode_flat(stack, x, cossin, cache, 40, cfg, meta)
    assert tok.dtype == torch.int32 and tok.shape == (1,)
    assert int(tok[0]) == int(torch.argmax(logits[0]))


def test_stack_shares_weights_and_tables_with_the_blocks():
    """Kernel tables are made once per linear at fuse time; after stacking,
    every block reads its words and scales through views of the stack."""
    _, pm = small_models(seed=10)
    pf = fuse_for_serving(pm)
    lm = pf.params["lm_head"]
    assert lm.tables is not None
    assert dequant_matmul.kernel_tables(lm) is lm.tables
    stack, _ = stack_flat(pf)
    assert stack["ues"] is lm.tables[0]
    for l, blk in enumerate(pf.params["layers"]):
        for name, wk, sk, mk in (("qkv_proj", "qkv", "qs", "q"), ("o_proj", "o", "os", "o"),
                                 ("gateup_proj", "gu", "gus", "gu"), ("down_proj", "d", "ds", "d")):
            lin = blk[name]
            assert lin.packed.data_ptr() == stack[wk][l].data_ptr()
            assert lin.tables[0].data_ptr() == stack[sk][l].data_ptr()
            assert blk["mega"][mk + "s"] is lin.tables[0]
            assert blk["mega"][mk + "b"] is lin.tables[1]


def test_contract_rejects_asymmetric_and_unpacked_lm_head():
    jm, pm = small_models(seed=9)
    pf = fuse_for_serving(pm)
    assert stack_flat(pf) is not None
    lm = pf.params["lm_head"]
    z = lm.w_zero.clone()
    z.view(-1)[0] += 1.0
    pf.params["lm_head"] = lm.replace(w_zero=z)
    assert stack_flat(pf) is None
    pf.params["lm_head"] = lm.replace(packed=None)
    assert stack_flat(pf) is None
    # the reference agrees on the asymmetric case
    jf = jax_fuse_for_serving(jm)
    jlm = jf.params["lm_head"]
    jf.params["lm_head"] = jlm.replace(w_zero=jnp.asarray(jlm.w_zero).at[0, 0].add(1.0))
    assert jax_stack_flat(jf) is None
