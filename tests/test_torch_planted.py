"""The port's planted-structure models (utils/planted.py) against the JAX
package's: the token map is bit-equal to JAX's (numpy on both sides), the
zero o_proj / down_proj words dequantize to exactly 0 (finite scales, codes
at the zero point: no 0/0), and a 2-layer float32 planted model built by
the port on the CPU follows the planted chain on every serving route:
`generate` (per layer), `decode_loop_flat`, `decode_loop_flat_seg`,
`ContinuousBatcher` and `PagedMegaBatcher` on the batched kernel's plain
versions."""
import numpy as np
import pytest
import torch

from mi_optimize_tpu.utils.planted import planted_map as jax_planted_map
from mi_optimize_tpu_torch.core.packing import unpack_words
from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.ops.dequant_matmul import kernel_tables
from mi_optimize_tpu_torch.serving import engine
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                      stack_cache_flat, stack_flat)
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher
from mi_optimize_tpu_torch.utils.planted import build_planted_llama, planted_map, planted_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)


def _chain(m, t, n):
    out = []
    for _ in range(n):
        t = int(m[t])
        out.append(t)
    return out


@pytest.mark.parametrize("vocab,seed,frac", [(128, 0, 0.0), (128, 3, 0.0), (32000, 0, 0.0),
                                             (128, 0, 0.5), (32000, 0, 0.3)])
def test_planted_map_bit_equal_to_jax(vocab, seed, frac):
    got = planted_map(vocab, seed=seed, disagree_frac=frac)
    ref = jax_planted_map(vocab, seed=seed, disagree_frac=frac)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def model():
    m = planted_map(CFG.vocab_size, seed=5)
    return fuse_for_serving(Model(config=CFG, params=build_planted_llama(
        CFG, m, dtype=torch.float32, device="cpu"))), m


def test_zero_projections_dequantize_to_exactly_zero(model):
    pf, _ = model
    for blk in pf.params["layers"]:
        for name in ("o_proj", "down_proj"):
            lin = blk[name]
            s, b = kernel_tables(lin)
            assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(b).all())
            q = unpack_words(lin.packed, lin.spec.wbit).to(torch.float32)     # [K, N]
            g = lin.in_features // s.shape[0]
            w = q * s.repeat_interleave(g, 0) + b.repeat_interleave(g, 0)
            assert bool((w == 0).all())


ROUTES = ("generate", "decode_loop_flat", "decode_loop_flat_seg", "ContinuousBatcher",
          "PagedMegaBatcher")


@pytest.mark.parametrize("route", ROUTES)
def test_every_route_follows_the_chain(model, route):
    pf, m = model
    prompt = np.array([7, 42, 3, 99, 18])
    n = 6
    want = _chain(m, int(prompt[-1]), n)
    if route == "generate":
        got = engine.generate(pf, prompt[None], max_new_tokens=n, cache_dtype=torch.int8)
        got = got[0, len(prompt):].tolist()
    elif route.startswith("decode_loop_flat"):
        fstack, fmeta = stack_flat(pf)
        logits, cache = engine.prefill(pf.params, CFG, torch.from_numpy(prompt[None]),
                                       engine.init_cache(CFG, 1, 128, torch.int8, device="cpu"))
        tok = torch.argmax(logits, -1)[:, None]
        args = (pf.params, fstack, fmeta, CFG, tok, stack_cache_flat(cache), len(prompt), n - 1)
        toks, _ = (decode_loop_flat(*args) if route == "decode_loop_flat"
                   else decode_loop_flat_seg(*args, kseg=3))
        got = [int(tok)] + toks[0, :n - 1].tolist()
    elif route == "ContinuousBatcher":
        b = ContinuousBatcher(pf, n_slots=2, max_len=128, cache_dtype=torch.int8,
                              use_megakernel=True)
        assert b._mega is not None
        got = b.run_all([prompt, prompt[:2]], max_new_tokens=n)
        assert got[1] == _chain(m, int(prompt[1]), n)
        got = got[0]
    else:
        got = PagedMegaBatcher(pf, n_slots=2, max_len=256).run_all([prompt], max_new_tokens=n)[0]
    assert got == want


def test_planted_pair_draft_agreement():
    """planted_pair: the target and the draft share the embedding; the draft
    has its own depth and a map that differs from the target's on about the
    disagreement fraction."""
    t, d, m_t, m_d = planted_pair(CFG, draft_layers=1, disagree_frac=0.25, dtype=torch.float32,
                                  device="cpu")
    assert d.config.num_layers == 1 and t.config.num_layers == 2
    assert torch.equal(t.params["embed"], d.params["embed"])
    np.testing.assert_array_equal(m_t, planted_map(CFG.vocab_size))
    assert 0.1 < float(np.mean(m_t != m_d)) < 0.3
