"""The port's whole-model decode without the lm_head (ops/model_fused.py)
against the JAX package, f32, on the aligned small Llama (2 layers), with
symmetric grids and with the asymmetric re-quantization of the reference's
own test (tests/test_model_fused.py::test_model_kernel_asymmetric_zero_tables),
whose per-group zeros make `stack_serving` stack and the kernel stream the
bias tables.

Plain model_decode_mega against the JAX kernel (interpret=True): x_out
within 2e-4 of max|ref| (the dequant dots sum in different orders); int8 rows
equal up to one-code tie flips on at most 0.1% of entries; scales within 1e-6
relative. decode_loop_model: greedy tokens equal. Each JAX reference is
computed once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.core import packing as jpacking
from mi_optimize_tpu.core import qparams as jqparams
from mi_optimize_tpu.core.qparams import qrange as jqrange
from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.ops.model_fused import model_decode_mega as jax_model_decode_mega
from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving import megadecode
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_block_fused import _mk_cfg, _mk_params
from tests.test_torch_block_fused import assert_rows_match, random_cache
from tests.test_torch_convert import port_model

T = 128
POS = 70
PROMPT = np.array([[3, 17, 42, 9, 88, 21]])
N_TOK = 4


def _asym(lin, key):
    """Re-quantize one JAX linear on an asymmetric grid (a zero per group)."""
    w = jax.random.normal(key, (lin.out_features, lin.in_features),
                          jnp.float32) * (lin.in_features ** -0.5) + 0.02
    fake, scale, zero = jqparams.quantize_dequantize(
        w, lin.spec.wbit, "per_group", lin.spec.w_groupsize, symmetric=False)
    ints = jqparams.quantize_to_int(fake, scale, zero, lin.spec.wbit, "per_group",
                                    lin.spec.w_groupsize)
    return lin.replace(packed=jpacking.pack_weight_device(ints, lin.spec.wbit,
                                                          jqrange(lin.spec.wbit, True)),
                       w_scale=scale, w_zero=zero)


def jax_model(seed=0, asymmetric=False, **cfg_kw):
    """The reference tests' small Llama (2 layers), every decoder linear
    re-quantized asymmetrically when asked."""
    cfg_kw.setdefault("max_seq_len", 512)
    cfg = _mk_cfg(num_layers=2, **cfg_kw)
    params = _mk_params(cfg, seed=seed)
    if asymmetric:
        key = jax.random.PRNGKey(11 + seed)
        for blk in params["layers"]:
            for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                         "down_proj"):
                key, k = jax.random.split(key)
                blk[name] = _asym(blk[name], k)
    return JModel(config=cfg, params=params, family="llama")


def fused_pair(jm):
    """(JAX fused model, its stack, port fused model, its stack) of one model."""
    jf = jax_fuse_for_serving(jm)
    pf = fuse_for_serving(port_model(jm))
    return jf, jmegadecode.stack_serving(jf), pf, megadecode.stack_serving(pf)


@pytest.fixture(scope="module")
def runs():
    """For the symmetric and the asymmetric model: the models, stacks and
    the JAX references (one model_decode_mega call and one decode_loop_model
    run), computed once."""
    out = {}
    for grid, seed in (("sym", 3), ("asym", 4)):
        jf, (jstack, jmeta), pf, (stack, meta) = fused_pair(jax_model(seed, grid == "asym"))
        jcfg = jf.config
        cache = random_cache((jcfg.num_layers, T, jcfg.num_kv_heads, jcfg.head_dim), seed=seed)
        x = np.random.default_rng(seed).standard_normal((1, 1, jcfg.hidden_size)).astype(
            np.float32)
        jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray([POS]))
        kernel = jax_model_decode_mega(
            jstack, jnp.asarray(x), jcos.reshape(-1), jsin.reshape(-1),
            {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(POS), jcfg, jmeta,
            interpret=True)
        # the prompt's per-layer int8 cache from the JAX prefill, decoded by both
        logits, pcache = jengine.prefill(jf.params, jcfg, jnp.asarray(PROMPT),
                                         jengine.init_cache(jcfg, 1, T, jnp.int8), True)
        tok = np.asarray(jnp.argmax(logits, -1))[:, None]
        scache = {k: np.asarray(v) for k, v in jmegadecode.stack_cache(pcache).items()}
        toks, _ = jmegadecode.decode_loop_model(
            jf.params, jstack, jmeta, jcfg, jnp.asarray(tok),
            {k: jnp.asarray(v) for k, v in scache.items()}, jnp.asarray(PROMPT.shape[1]), N_TOK,
            interpret=True)
        out[grid] = dict(jf=jf, jmeta=jmeta, pf=pf, stack=stack, meta=meta, cache=cache, x=x,
                         kernel=[np.asarray(a) for a in kernel], tok=tok, scache=scache,
                         toks=np.asarray(toks))
    return out


@pytest.mark.parametrize("grid", ["sym", "asym"])
def test_stack_serving_meta_and_bias_tables(runs, grid):
    """Same meta as the reference; bias tables are stacked exactly where a
    zero is not constant, and the blocks read them through views of the
    stack. Stacking the model again returns the same tensors, not a copy."""
    r = runs[grid]
    stack, meta = r["stack"], r["meta"]
    assert meta == r["jmeta"]
    again, meta2 = megadecode.stack_serving(r["pf"])
    assert meta2 == meta and sorted(again) == sorted(stack)
    assert all(again[k] is stack[k] for k in stack if k not in ("n1", "n2"))
    zks = ("qz", "oz", "guz", "dz")
    if grid == "sym":
        assert meta[5:] == (8.0, 8.0, 8.0, 8.0)
        assert not any(k in stack for k in zks)
        return
    assert meta[5:] == (None, None, None, None)
    for l, blk in enumerate(r["pf"].params["layers"]):
        for name, zk, mk in (("qkv_proj", "qz", "qb"), ("o_proj", "oz", "ob"),
                             ("gateup_proj", "guz", "gub"), ("down_proj", "dz", "db")):
            assert blk[name].tables[1].data_ptr() == stack[zk][l].data_ptr()
            assert blk["mega"][mk] is blk[name].tables[1]


@pytest.mark.parametrize("grid", ["sym", "asym"])
def test_plain_matches_jax_kernel(runs, grid):
    r = runs[grid]
    cfg = r["pf"].config
    cos, sin = llama.rope_tables(cfg, torch.tensor([POS]))
    before = model_fused.launches
    x_out, krows, vrows, ksr, vsr = model_fused.model_decode_mega(
        r["stack"], torch.from_numpy(r["x"]), cos.reshape(-1), sin.reshape(-1),
        {k: torch.from_numpy(v) for k, v in r["cache"].items()}, POS, cfg, r["meta"])
    assert model_fused.launches == before
    jx, jk, jv, jks, jvs = r["kernel"]
    assert x_out.shape == jx.shape and x_out.dtype == torch.float32
    scale = np.abs(jx).max()
    assert np.abs(x_out.numpy() - jx).max() <= 2e-4 * scale
    assert krows.shape == jk.shape and ksr.shape == jks.shape
    assert_rows_match(krows.numpy(), jk)
    assert_rows_match(vrows.numpy(), jv)
    np.testing.assert_allclose(ksr.numpy(), jks, rtol=1e-6)
    np.testing.assert_allclose(vsr.numpy(), jvs, rtol=1e-6)


@pytest.mark.parametrize("grid", ["sym", "asym"])
def test_decode_loop_model_matches_jax(runs, grid):
    r = runs[grid]
    pf = r["pf"]
    cache = {k: torch.from_numpy(v.copy()) for k, v in r["scache"].items()}
    S = PROMPT.shape[1]
    toks, cache = megadecode.decode_loop_model(pf.params, r["stack"], r["meta"], pf.config,
                                               torch.from_numpy(r["tok"].copy()), cache, S, N_TOK)
    assert toks.shape == (1, N_TOK)
    np.testing.assert_array_equal(toks.numpy(), r["toks"])
    # the rows of the decoded positions were written, none after them
    assert int(cache["k"][:, S:S + N_TOK].abs().sum()) > 0
    assert int(cache["k"][:, S + N_TOK:].abs().sum()) == 0


def test_stacked_cache_layouts():
    """stack_cache / init_cache_stacked shapes; stack_cache_batched is the
    head-transposed copy that unstack_cache_batched undoes."""
    from mi_optimize_tpu_torch.serving import engine

    cfg = port_model(jax_model(0)).config
    per_layer = engine.init_cache(cfg, 3, T, torch.int8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for c in per_layer:
        for f in c:
            c[f].copy_(torch.randint(-9, 9, c[f].shape, generator=g).to(c[f].dtype))
    st = megadecode.stack_cache_batched(per_layer)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert st["k"].shape == (L, 3, Hkv, T, D) and st["k_scale"].shape == (L, 3, Hkv, T)
    assert torch.equal(st["v"][1, 2, 0, 5], per_layer[1]["v"][2, 5, 0])
    back = megadecode.unstack_cache_batched(st, L)
    for c, b in zip(per_layer, back):
        for f in c:
            assert torch.equal(c[f], b[f])
    one = megadecode.stack_cache([{f: v[:1] for f, v in c.items()} for c in per_layer])
    empty = megadecode.init_cache_stacked(cfg, T, device="cpu")
    for f in one:
        assert one[f].shape == empty[f].shape
        assert torch.equal(one[f][1], per_layer[1][f][0])
