"""The unfused post-quantization path as a whole against the JAX package, f32,
on the aligned small Llama (h=512, I=1024, 4 heads over 2 kv heads, D=128,
2 layers, int4 g128) converted with `from_jax_params`: separate q/k/v and
gate/up, as quantization returns them, served without fuse_for_serving.

The port takes the reference's TPU-only branches (decode attention, fused
MLP) on CUDA tensors; here `llama.kernel_branches` is forced on, so the
plain versions run through those branches on the CPU, and the JAX package
runs its stock path on the CPU. For the W4A8 spec (every decoder linear with
dynamic symmetric per-token int8 activations) the port also takes its
integer product with MI_W4A8_INT=1, against the reference's fake-quant route.

Tolerances: one block's output and cache rows to 1e-5 (f32 sums in another
order; the int8 rows equal); greedy tokens equal; perplexity to 1e-5
relative."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.eval.ppl import compute_ppl as jax_compute_ppl
from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.models.synthetic import w4a8_spec, with_w4a8
from mi_optimize_tpu_torch.ops import decode_attention, mlp_fused
from mi_optimize_tpu_torch.ops import w4a8_matmul as pw
from mi_optimize_tpu_torch.serving import engine
from tests.test_torch_convert import port_model, small_models

torch.set_num_threads(1)


def _jax_w4a8(jm):
    """The JAX model with the W4A8 activation spec on every decoder linear."""
    from mi_optimize_tpu.models.quant_linear import QuantizedLinear

    def w4a8(lin):
        return lin.replace(spec=lin.spec.replace(abit=8, a_qtype="per_token", a_dynamic=True,
                                                 a_symmetric=True, a_unsigned=False))

    layers = [{k: w4a8(v) if isinstance(v, QuantizedLinear) else v for k, v in blk.items()}
              for blk in jm.params["layers"]]
    return JModel(config=jm.config, params=dict(jm.params, layers=layers), family=jm.family)


@pytest.fixture(scope="module")
def models():
    """{spec: (JAX model, port model)} for "int4" and "w4a8"."""
    jm, pm = small_models(seed=9)
    jw = _jax_w4a8(jm)
    return {"int4": (jm, pm), "w4a8": (jw, port_model(jw))}


@pytest.fixture
def branches(monkeypatch):
    """The TPU-only branches forced on, with a record of their calls."""
    calls = {"attn": 0, "mlp": 0, "w4a8": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def f(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, f)

    monkeypatch.setattr(llama, "kernel_branches", lambda x: True)
    spy(decode_attention, "fused_decode_attention", "attn")
    spy(mlp_fused, "mlp_apply_fused", "mlp")
    spy(pw, "w4a8_matmul", "w4a8")
    return calls


def test_convert_carries_the_unfused_w4a8_tree(models):
    jw, pw_model = models["w4a8"]
    blk = pw_model.params["layers"][1]
    assert "q_proj" in blk and "gate_proj" in blk and "qkv_proj" not in blk
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        s = blk[name].spec
        assert pw.supports_w4a8(s) and s == w4a8_spec(dataclasses.replace(s, abit=None))
    assert pw_model.params["lm_head"].spec.abit is None
    # the port's own helper gives the same specs
    mine = with_w4a8(models["int4"][1].params)
    assert mine["layers"][1]["down_proj"].spec == blk["down_proj"].spec
    assert mine["lm_head"].spec == pw_model.params["lm_head"].spec


@pytest.mark.parametrize("pos", [0, 37, 127])
def test_decode_block_matches_jax(models, branches, pos):
    """One decode step of layer 0 at `pos` over an int8 cache whose earlier
    rows hold a prefill's: the decode attention and the fused MLP run."""
    jm, pm = models["int4"]
    cfg, jcfg = pm.config, jm.config
    rng = np.random.default_rng(pos)
    T = 128
    x = rng.normal(size=(1, 1, cfg.hidden_size)).astype(np.float32)
    ck = rng.integers(-127, 128, size=(1, T, cfg.num_kv_heads, cfg.head_dim)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(1, T, cfg.num_kv_heads)).astype(np.float32)
    ck[:, pos:], ks[:, pos:] = 0, 0
    jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray([pos]))
    jout, jcache, _ = jllama.block_apply(
        jm.params["layers"][0], jnp.asarray(x), jcos, jsin,
        jnp.arange(T)[None, :] <= pos, jcfg,
        kv_cache={"k": jnp.asarray(ck), "v": jnp.asarray(ck[..., ::-1]),
                  "k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(ks[..., ::-1])},
        cache_index=pos, fused=False)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    cache = {"k": torch.tensor(ck), "v": torch.tensor(np.ascontiguousarray(ck[..., ::-1])),
             "k_scale": torch.tensor(ks),
             "v_scale": torch.tensor(np.ascontiguousarray(ks[..., ::-1]))}
    out, new, _ = llama.block_apply(pm.params["layers"][0], torch.tensor(x), cos, sin,
                                    torch.arange(T)[None, :] <= pos, cfg, kv_cache=cache,
                                    cache_index=pos)
    assert branches == {"attn": 1, "mlp": 1, "w4a8": 0}
    assert new is cache
    for f in ("k", "v"):
        np.testing.assert_array_equal(new[f].numpy(), np.asarray(jcache[f]))
        np.testing.assert_allclose(new[f + "_scale"].numpy(), np.asarray(jcache[f + "_scale"]),
                                   rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_prefill_block_matches_jax(models, branches):
    """A 16-token prefill of layer 0: the fused MLP runs, the attention is
    the stock one (S > 1)."""
    jm, pm = models["int4"]
    cfg, jcfg = pm.config, jm.config
    S = 16
    x = np.random.default_rng(3).normal(size=(1, S, cfg.hidden_size)).astype(np.float32)
    jcos, jsin = jllama.rope_tables(jcfg, jnp.arange(S))
    jout, _, _ = jllama.block_apply(jm.params["layers"][0], jnp.asarray(x), jcos, jsin,
                                    jllama.causal_mask(S), jcfg, fused=False)
    cos, sin = llama.rope_tables(cfg, torch.arange(S))
    out, _, _ = llama.block_apply(pm.params["layers"][0], torch.tensor(x), cos, sin,
                                  llama.causal_mask(S), cfg)
    assert branches == {"attn": 0, "mlp": 1, "w4a8": 0}
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_branches_keep_off_where_the_reference_does(models, branches):
    """Two rows, a float cache, per-slot positions: the stock attention."""
    _, pm = models["int4"]
    cfg = pm.config
    T, pos = 64, 5
    blk = pm.params["layers"][0]
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    mask = torch.arange(T)[None, :] <= pos
    x2 = torch.randn(2, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
    for x, cache, idx in (
            (x2, engine.init_cache(cfg, 2, T, torch.int8, device="cpu")[0], pos),
            (x2[:1], engine.init_cache(cfg, 1, T, torch.float32, device="cpu")[0], pos),
            (x2, engine.init_cache(cfg, 2, T, torch.int8, device="cpu")[0],
             torch.tensor([pos, pos]))):
        llama.block_apply(blk, x, cos, sin, mask, cfg, kv_cache=cache, cache_index=idx)
    assert branches["attn"] == 0 and branches["mlp"] == 3
    llama.block_apply(blk, x2[:1], cos, sin, mask, cfg,
                      kv_cache=engine.init_cache(cfg, 1, T, torch.int8, device="cpu")[0],
                      cache_index=pos, fused=False)
    assert branches["attn"] == 0 and branches["mlp"] == 3


@pytest.mark.parametrize("spec", ["int4", "w4a8"])
def test_generate_matches_jax(models, branches, monkeypatch, spec):
    """Greedy generate with the int8 cache: a 40-token prompt (W4A8: the
    integer product at the prefill) and 6 new tokens."""
    jm, pm = models[spec]
    monkeypatch.setenv("MI_W4A8_INT", "1")
    prompt = np.random.default_rng(17).integers(0, pm.config.vocab_size, (1, 40))
    ref = jengine.generate(jm, prompt, max_new_tokens=6, fused=False, cache_dtype=jnp.int8)
    got = engine.generate(pm, prompt, max_new_tokens=6, cache_dtype=torch.int8)
    np.testing.assert_array_equal(got, np.asarray(ref))
    layers = pm.config.num_layers  # generate runs a decode step after every new token
    assert branches["attn"] == 6 * layers
    if spec == "int4":
        assert branches["mlp"] == 7 * layers and branches["w4a8"] == 0
    else:  # the prefill's 7 linears a layer; the decode steps stay below 32 rows
        assert branches["mlp"] == 0 and branches["w4a8"] == 7 * layers


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("spec", ["int4", "w4a8"])
def test_compute_ppl_matches_jax(models, branches, monkeypatch, spec, fused):
    """Two batches of 2 x 64 tokens; the port's fused route (the fused MLP,
    or the W4A8 integer product) and its dequantize-then-matmul route.

    int4 is held to 1e-5 relative against the reference's unfused route.
    W4A8 is held to the reference's same route (its integer product, or its
    fake-quant one) at 1e-3: an int8 activation code at a rounding boundary
    flips with the last ulp of its input, which sum orders move, and one
    flipped code moves its input by amax/127; the reference's own two routes
    differ by 4.5e-4 on this model."""
    jm, pm = models[spec]
    monkeypatch.setenv("MI_W4A8_INT", "1")
    rng = np.random.default_rng(29)
    batches = [rng.integers(0, pm.config.vocab_size, (2, 64)) for _ in range(2)]
    ref = jax_compute_ppl(jm, batches, fused=fused and spec == "w4a8")
    got = compute_ppl(pm, batches, fused=fused)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-5 if spec == "int4" else 1e-3)
    layers = pm.config.num_layers
    if not fused:
        assert branches == {"attn": 0, "mlp": 0, "w4a8": 0}
    elif spec == "int4":
        assert branches == {"attn": 0, "mlp": 2 * layers, "w4a8": 0}
    else:
        assert branches == {"attn": 0, "mlp": 0, "w4a8": 2 * 7 * layers}
