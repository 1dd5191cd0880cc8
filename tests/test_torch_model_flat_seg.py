"""The port's multi-token flat decode (ops/model_flat_seg.py, plain version on
the CPU; serving/flatdecode.decode_loop_flat_seg) against the JAX package's
(mi_optimize_tpu/ops/model_flat_seg.py, interpret=True), f32, on the aligned
small Llama (2 layers): two segments of kseg=4 after a 17-token prefill.

Tokens equal; the segment's int8 cache rows equal up to one-code tie flips
on at most 0.1% of entries, scales within 1e-5 relative. Against the port's
per-token flat loop on the same inputs: tokens and cache rows bit for bit
(the plain version is kseg steps of model_decode_flat_ref). The JAX
reference is computed once per module."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.serving import engine as jengine
from mi_optimize_tpu.serving import flatdecode as jflatdecode
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu_torch.ops import model_flat, model_flat_seg
from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                      stack_flat)
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_torch_block_fused import assert_rows_match
from tests.test_torch_convert import small_models

T = 256
KSEG, NSEG = 4, 2


@pytest.fixture(scope="module")
def seg_run():
    jm, pm = small_models(seed=3)
    jf, pf = jax_fuse_for_serving(jm), fuse_for_serving(pm)
    jcfg = jf.config
    prompt = np.random.default_rng(103).integers(0, jcfg.vocab_size, (1, 17))
    logits, cache = jengine.prefill(jf.params, jcfg, jnp.asarray(prompt),
                                    jengine.init_cache(jcfg, 1, T, jnp.int8), False)
    tok = np.array(jnp.argmax(logits, -1))[:, None]
    fcache = jflatdecode.stack_cache_flat(cache)
    jstack, jmeta = jflatdecode.stack_flat(jf)
    toks, c2 = jflatdecode.decode_loop_flat_seg(jf.params, jstack, jmeta, jcfg, jnp.asarray(tok),
                                                fcache, jnp.asarray(17), KSEG * NSEG, kseg=KSEG,
                                                interpret=True)
    return dict(pf=pf, tok=tok, cache={f: np.asarray(v) for f, v in fcache.items()},
                toks=np.asarray(toks), c2={f: np.asarray(v) for f, v in c2.items()})


def _cache(r):
    return {f: torch.from_numpy(v.copy()) for f, v in r["cache"].items()}


def test_seg_matches_jax(seg_run):
    r = seg_run
    pf = r["pf"]
    stack, meta = stack_flat(pf)
    before = model_flat_seg.launches
    toks, c2 = decode_loop_flat_seg(pf.params, stack, meta, pf.config, torch.from_numpy(r["tok"]),
                                    _cache(r), 17, KSEG * NSEG, kseg=KSEG)
    assert model_flat_seg.launches == before
    assert toks.shape == (1, KSEG * NSEG)
    assert toks.tolist() == r["toks"].tolist()
    sl = slice(17, 17 + KSEG * NSEG)
    assert_rows_match(c2["kv"][:, sl].numpy(), r["c2"]["kv"][:, sl])
    np.testing.assert_allclose(c2["kv_scale"][:, sl].numpy(), r["c2"]["kv_scale"][:, sl],
                               rtol=1e-5)
    assert int(c2["kv"][:, sl.stop:].abs().sum()) == 0


def test_seg_equals_per_token_flat(seg_run):
    """n = 3 with kseg = 2: two launches, the last token of the second one
    surplus, and everything the per-token loop gives for the first 4."""
    r = seg_run
    pf = r["pf"]
    stack, meta = stack_flat(pf)
    args = (pf.params, stack, meta, pf.config, torch.from_numpy(r["tok"]))
    ref, c_ref = decode_loop_flat(*args, _cache(r), 17, 4)
    got, c_got = decode_loop_flat_seg(*args, _cache(r), 17, 3, kseg=2)
    assert got.shape == (1, 4) and torch.equal(got, ref)
    for f in c_ref:
        assert torch.equal(c_got[f], c_ref[f])


def test_seg_outputs_and_bounds(seg_run):
    """One launch's outputs: flat int32 token ids [kseg] (the reference's
    [kseg, 8, 128] lane tiles are not kept), rows [kseg, L, 2, Hkv, D] and
    scales [kseg, L, 2, Hkv]; a segment past the cache raises."""
    r = seg_run
    pf = r["pf"]
    cfg = pf.config
    stack, meta = stack_flat(pf)
    x = pf.params["embed"][torch.from_numpy(r["tok"])]
    cs = torch.zeros(KSEG, 2 * cfg.head_dim)
    before = model_flat.launches, model_flat_seg.launches
    toks, rows, sc = model_flat_seg.model_decode_flat_seg(stack, pf.params["embed"], x, cs,
                                                          _cache(r), 17, cfg, meta, KSEG)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert toks.dtype == torch.int32 and toks.shape == (KSEG,)
    assert rows.shape == (KSEG, L, 2, Hkv, D) and rows.dtype == torch.int8
    assert sc.shape == (KSEG, L, 2, Hkv) and sc.dtype == torch.float32
    with pytest.raises(ValueError, match="outside the cache"):
        model_flat_seg.model_decode_flat_seg(stack, pf.params["embed"], x, cs, _cache(r),
                                             T - KSEG + 1, cfg, meta, KSEG)
    assert (model_flat.launches, model_flat_seg.launches) == before
