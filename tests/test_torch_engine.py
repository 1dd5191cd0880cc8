"""The port's serving slice as a whole against the JAX package, f32, on the
aligned small Llama: greedy generate with the int8 cache, prefill logits,
the flat whole-model decode loop, the model forward and loss, and the
sampler's top-k / top-p masks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu.serving.flatdecode import decode_loop_flat as jax_decode_loop_flat
from mi_optimize_tpu.serving.flatdecode import stack_cache_flat as jax_stack_cache_flat
from mi_optimize_tpu.serving.flatdecode import stack_flat as jax_stack_flat
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.ops import block_fused, dequant_matmul, model_flat
from mi_optimize_tpu_torch.serving import engine
from mi_optimize_tpu_torch.serving.flatdecode import decode_loop_flat, stack_cache_flat, stack_flat
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_torch_convert import port_model, small_models


@pytest.fixture(scope="module")
def models():
    jm, pm = small_models(seed=5)
    return jm, jax_fuse_for_serving(jm), fuse_for_serving(pm)


def _prompt(n, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def test_generate_greedy_matches_jax(models):
    """Port generate (fused: block_fused decode, int8 cache) against JAX
    generate on its unfused path, 5 new tokens."""
    jm, _, pf = models
    prompt = _prompt(12, seed=23)
    ref = jengine.generate(jm, prompt, max_new_tokens=5, fused=False, cache_dtype=jnp.int8)
    before = block_fused.launches, dequant_matmul.launches
    got = engine.generate(pf, prompt, max_new_tokens=5, fused=True, cache_dtype=torch.int8)
    assert got.shape == (1, 17)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (block_fused.launches, dequant_matmul.launches) == before


def test_prefill_logits_match_jax(models):
    """Logits to 2e-4 through the float cache. With the int8 cache the
    written codes agree up to rare one-code tie flips (the qkv sums differ in
    order, so an amax and a quotient can move by an ulp across a .5 tie); one
    flipped code moves an attention input by a whole quantization step, so
    the int8 case is held on the first layer's cache, which no earlier flip
    can reach."""
    _, jf, pf = models
    cfg, jcfg = pf.config, jf.config
    prompt = _prompt(19, seed=7)
    for jdt, dt in ((jnp.float32, torch.float32), (jnp.int8, torch.int8)):
        jlog, jcache = jengine.prefill(jf.params, jcfg, jnp.asarray(prompt),
                                       jengine.init_cache(jcfg, 1, 128, jdt), True)
        log, cache = engine.prefill(pf.params, cfg, torch.from_numpy(prompt),
                                    engine.init_cache(cfg, 1, 128, dt, device="cpu"))
        assert log.shape == (1, cfg.vocab_size)
        if dt == torch.float32:
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(cache[1][0].numpy(), np.asarray(jcache[1][0]),
                                       rtol=2e-4, atol=2e-4)
            continue
        for f in ("k", "v"):
            d = np.abs(cache[0][f].numpy().astype(np.int32) - np.asarray(jcache[0][f], np.int32))
            assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size
            np.testing.assert_allclose(cache[0][f + "_scale"].numpy(),
                                       np.asarray(jcache[0][f + "_scale"]), rtol=1e-5)


def test_decode_loop_flat_matches_jax(models):
    _, jf, pf = models
    cfg, jcfg = pf.config, jf.config
    prompt = _prompt(19, seed=13)
    T, n = 256, 3
    jlog, jcache = jengine.prefill(jf.params, jcfg, jnp.asarray(prompt),
                                   jengine.init_cache(jcfg, 1, T, jnp.int8), False)
    jtok = jnp.argmax(jlog, -1)[:, None]
    jstack, jmeta = jax_stack_flat(jf)
    ref, _ = jax_decode_loop_flat(jf.params, jstack, jmeta, jcfg, jtok,
                                  jax_stack_cache_flat(jcache), jnp.asarray(19), n,
                                  interpret=True)

    log, cache = engine.prefill(pf.params, cfg, torch.from_numpy(prompt),
                                engine.init_cache(cfg, 1, T, torch.int8, device="cpu"))
    tok = torch.argmax(log, -1)[:, None]
    assert int(tok[0, 0]) == int(jtok[0, 0])
    stack, meta = stack_flat(pf)
    fcache = stack_cache_flat(cache)
    before = model_flat.launches
    got, fcache = decode_loop_flat(pf.params, stack, meta, cfg, tok, fcache, 19, n)
    assert got.tolist() == np.asarray(ref).tolist()
    assert model_flat.launches == before
    # the loop wrote one row per step into the merged cache
    assert bool((fcache["kv_scale"][:, 19:19 + n] > 0).all())
    assert bool((fcache["kv_scale"][:, 19 + n:] == 0).all())


def test_forward_and_loss_match_jax(models):
    jm, _, pf = models
    ids = _prompt(9, seed=3)
    jlog = jllama.forward(jm.params, jm.config, jnp.asarray(ids), fused=False)
    log = llama.forward(pf.params, pf.config, torch.from_numpy(ids))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)
    jloss, jcount = jllama.causal_lm_loss(jlog, jnp.asarray(ids))
    loss, count = llama.causal_lm_loss(torch.from_numpy(np.array(jlog)), torch.from_numpy(ids))
    assert int(count) == int(jcount)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 0.9), (1.0, 5, 1.0), (1.3, 8, 0.5), (1.0, 0, 0.0)])
def test_sample_masks_match_jax(monkeypatch, temperature, top_k, top_p):
    """The truncated logits the sampler draws from: JAX's `_sample` with its
    categorical draw replaced by the identity returns them."""
    logits = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32) * 3
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg, axis=-1: lg)
    ref = np.asarray(jengine._sample(jnp.asarray(logits), temperature, jax.random.PRNGKey(0),
                                     top_p, top_k))
    got = engine._filter_logits(torch.from_numpy(logits), temperature, top_p, top_k).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    keep = ~np.isinf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)
    assert keep.any(axis=-1).all()


def test_sample_greedy_and_draws_stay_in_mask():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 32)).astype(np.float32))
    assert torch.equal(engine._sample(logits, 0.0), torch.argmax(logits, -1))
    gen = torch.Generator().manual_seed(0)
    allowed = torch.topk(logits, 3).indices
    for _ in range(10):
        t = engine._sample(logits, 1.0, gen, top_k=3)
        assert bool((allowed == t[:, None]).any(-1).all())


def test_fp_model_forward_matches_jax():
    """An unquantized model (QuantizedLinear holding fp weights) converts and
    runs the same forward; the port's own tiny_llama has the reference's
    parameter structure."""
    jm = JModel.tiny_llama()
    pm = port_model(jm)
    ids = _prompt(7, seed=4, vocab=jm.config.vocab_size)
    jlog = jllama.forward(jm.params, jm.config, jnp.asarray(ids))
    log = llama.forward(pm.params, pm.config, torch.from_numpy(ids))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=2e-4, atol=2e-4)

    own = Model.tiny_llama(device="cpu")
    assert own.config == pm.config
    jlay, play = jm.params["layers"][0], own.params["layers"][0]
    assert sorted(jlay) == sorted(play)
    for k in ("q_proj", "down_proj"):
        assert tuple(play[k].weight.shape) == tuple(jlay[k].weight.shape)
    assert tuple(own.params["embed"].shape) == tuple(jm.params["embed"].shape)


def test_decode_loop_matches_jax(models):
    """engine.decode_loop on the fused model (block_fused per layer, lm_head
    through dequant_matmul) against JAX decode_loop on its unfused path."""
    jm, _, pf = models
    cfg, jcfg = pf.config, jm.config
    prompt = _prompt(10, seed=17)
    jlog, jcache = jengine.prefill(jm.params, jcfg, jnp.asarray(prompt),
                                   jengine.init_cache(jcfg, 1, 128, jnp.int8), False)
    ref, _ = jengine.decode_loop(jm.params, jcfg, jnp.argmax(jlog, -1)[:, None], jcache,
                                 jnp.asarray(10), 4, False)
    log, cache = engine.prefill(pf.params, cfg, torch.from_numpy(prompt),
                                engine.init_cache(cfg, 1, 128, torch.int8, device="cpu"))
    got, _ = engine.decode_loop(pf.params, cfg, torch.argmax(log, -1)[:, None], cache, 10, 4)
    assert got.tolist() == np.asarray(ref).tolist()


def test_block_apply_captures_match_jax(models):
    """The capture dict: the activation entering each linear."""
    jm, _, pf = models
    cfg, jcfg = pf.config, jm.config
    x = np.random.default_rng(9).standard_normal((1, 6, cfg.hidden_size)).astype(np.float32)
    jcos, jsin = jllama.rope_tables(jcfg, jnp.arange(6))
    _, _, jcaps = jllama.block_apply(jm.params["layers"][0], jnp.asarray(x), jcos, jsin,
                                     jllama.causal_mask(6), jcfg, capture=True, fused=False)
    cos, sin = llama.rope_tables(cfg, torch.arange(6))
    _, _, caps = llama.block_apply(pf.params["layers"][0], torch.from_numpy(x), cos, sin,
                                   llama.causal_mask(6), cfg, capture=True)
    assert sorted(caps) == sorted(jcaps)
    for k in caps:
        np.testing.assert_allclose(caps[k].numpy(), np.asarray(jcaps[k]), rtol=2e-4, atol=2e-4)


def test_synthetic_model_is_the_bench_configuration():
    """models/synthetic.py builds what bench.py builds: symmetric int4 g128
    packed linears (one constant zero, so the flat path applies), unit
    norms, a packed lm_head."""
    from mi_optimize_tpu_torch.models.quant_linear import dequant_weight
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama

    cfg = llama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512, head_dim=64)
    p = build_quantized_llama(cfg, dtype=torch.float32, seed=3, device="cpu")
    lins = [blk[n] for blk in p["layers"] for n in llama.ALL_LINEARS] + [p["lm_head"]]
    for lin in lins:
        assert (lin.spec.wbit, lin.spec.w_qtype, lin.spec.w_groupsize) == (4, "per_group", 128)
        assert lin.packed.dtype == torch.int32
        assert lin.packed.shape == (lin.in_features // 8, lin.out_features)
        assert bool((lin.w_zero == 8).all())
        w = dequant_weight(lin).reshape(lin.out_features, -1, 128)
        assert bool((w.abs().amax(-1) <= lin.w_scale * 8 + 1e-6).all())
    assert bool((p["layers"][0]["input_norm"] == 1).all())
    assert stack_flat(fuse_for_serving(Model(config=cfg, params=p))) is not None
