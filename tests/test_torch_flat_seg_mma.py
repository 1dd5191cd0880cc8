"""The multi-token flat decode (`ops.model_flat_seg`, kernel B10) on the
tensor-core layer loop, in the parts the CPU can check: the argument block
of its 4-bit launch carries the one-token flat kernel's plan, partials and
staged window (the two kernels run one loop, csrc/flat_model.cuh), for the
Llama-2-7B shapes, the planted 2-layer draft at 7B width and the card tests'
small model; 2- and 8-bit launches carry none (the CUDA-core loop); the
wrapper's outputs, its count and its refusals with the launch stubbed; and
the contract the kernel is built to: the plain version's kseg tokens, rows
and scales are those of kseg one-token decodes with the rows scattered
between them, bit for bit. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py -k flat_seg); tests/test_torch_model_flat_seg.py
holds the plain version against JAX's kernel in interpret mode.
"""
import dataclasses
import types

import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.ops import _build, model_flat, model_flat_seg
from mi_optimize_tpu_torch.ops.coop_plan import H100_SMS
from tests.test_torch_cuda_kernels import _flat_chain, _seg_args

SEVEN_B = LlamaConfig.llama2_7b()
CONFIGS = {
    "7b": SEVEN_B,
    "planted 2-layer draft": dataclasses.replace(SEVEN_B, num_layers=2),
    "small": LlamaConfig(vocab_size=160, hidden_size=512, intermediate_size=1024, num_layers=3,
                         num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512),
}
ENTRIES = ("mi_model_decode_flat", "mi_model_decode_flat_seg")


@pytest.fixture(autouse=True)
def _h100_plan(monkeypatch):
    """The plan for an H100's SMs (`coop_plan.sm_count` asks the card)."""
    monkeypatch.setattr(model_flat, "sm_count", lambda dev: H100_SMS)


@pytest.fixture
def calls(monkeypatch):
    """The launch stubbed: each call's (entry, args, bits, dtype). The
    counters the stubbed launches move are restored after the test."""
    got = []
    monkeypatch.setattr(model_flat, "launches", model_flat.launches)
    monkeypatch.setattr(model_flat_seg, "launches", model_flat_seg.launches)
    monkeypatch.setattr(model_flat, "_call", lambda entry, args, bits, dt, dev, lib=None:
                        got.append((entry, args, bits, dt)))
    return got


def _meta_model(cfg, bits=4, g=128, dtype=torch.bfloat16, T=384):
    """A flat stack, meta and merged cache of cfg's shapes on the meta device
    (nothing allocated): what `flat_launch` checks, at any width."""
    h, I, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    vpw = 32 // bits
    e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    stack = {"n1": e(L, h, dt=dtype), "n2": e(L, h, dt=dtype), "fnorm": e(h, dt=dtype),
             "ue": e(h // vpw, V, dt=torch.int32), "ues": e(h // g, V)}
    for k, sk, K, N in (("qkv", "qs", h, qdim + 2 * kvdim), ("o", "os", qdim, h),
                        ("gu", "gus", h, 2 * I), ("d", "ds", I, h)):
        stack[k], stack[sk] = e(L, K // vpw, N, dt=torch.int32), e(L, K // g, N)
    meta = (bits, g, g, g, g, 8.0, 8.0, 8.0, 8.0, g, 8.0, V)
    cache = {"kv": e(L, T, 2, cfg.num_kv_heads, cfg.head_dim, dt=torch.int8),
             "kv_scale": e(L, T, 2, cfg.num_kv_heads)}
    return stack, meta, cache, e(1, 1, h, dt=dtype), e(V, h, dt=dtype)


def _launch(entry, cfg, bits=4, dtype=torch.bfloat16, kseg=5, pos=200):
    stack, meta, cache, x, emb = _meta_model(cfg, bits, dtype=dtype)
    seg = entry == "mi_model_decode_flat_seg"
    n = kseg if seg else 1
    cs = torch.empty(n, cfg.head_dim, device="meta")
    model_flat.flat_launch(entry, stack, x, cs, cs, cache, pos, cfg, meta, kseg=n,
                           emb=emb if seg else None)
    return meta


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_launch_carries_the_one_token_plan(calls, name, dtype):
    """The 4-bit multi-token launch's argument block holds the one-token
    launch's plan (warp strips and K splits of qkv, o_proj, gate/up,
    down_proj and the lm_head, unsplit), window and partials: `flat_plans`
    and `flat_scratch` at the card's SMs (shapes on the meta device, so
    every pointer is null here; `test_seg_wrapper_outputs_and_count` sees
    the partials buffer)."""
    cfg = CONFIGS[name]
    meta = _launch(ENTRIES[0], cfg, dtype=dtype)
    _launch(ENTRIES[1], cfg, dtype=dtype)
    (e1, one, b1, d1), (e2, seg, b2, d2) = calls
    assert (e1, e2, b1, b2, d1, d2) == (*ENTRIES, 4, 4, dtype, dtype)
    plans = model_flat.flat_plans(cfg, meta, H100_SMS)
    n_part, kc = model_flat.flat_scratch(plans)
    for a in (one, seg):
        assert list(a.plan_ws) == [p[3] for p in plans]
        assert list(a.plan_splits) == [p[4] for p in plans]
        assert (a.n_part, a.plan_kc) == (n_part, kc)
    assert seg.plan_splits[4] == 1 and n_part > 0 and 64 <= kc <= model_flat.FLAT_KC_MAX


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("entry", ENTRIES)
def test_2_and_8_bit_launches_carry_no_plan(calls, bits, entry):
    """2- and 8-bit words take the CUDA-core loop, which reads no plan and
    no partials."""
    fstack, emb, x, cossin, cache, pos0, cfg, fmeta, kseg = _seg_args("cpu", bits, 64, 2)
    if entry == ENTRIES[1]:
        model_flat_seg._model_decode_flat_seg_cuda(fstack, emb, x, cossin, cache, pos0, cfg,
                                                   fmeta, kseg)
    else:
        model_flat._model_decode_flat_cuda(fstack, x, cossin[0], cache, pos0, cfg, fmeta)
    ((e, a, b, _),) = calls
    assert (e, b) == (entry, bits)
    assert list(a.plan_ws) == [0] * 5 and list(a.plan_splits) == [0] * 5
    assert (a.plan_kc, a.n_part, a.part) == (0, 0, None)


@pytest.mark.parametrize("kseg", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_wrapper_outputs_and_count(calls, kseg, dtype):
    """The wrapper's launch on the small model: the multi-token entry at
    4 bits, kseg, pos0, the embedding table and the first token's row in
    its block, a partials buffer and the one-token launch's plan; tokens
    [kseg] int32, rows [kseg, L, 2, Hkv, D] int8 and scales [kseg, L, 2,
    Hkv] f32 back; one launch counted, in its own counter only."""
    args = _seg_args("cpu", 4, 128, kseg, dtype)
    fstack, emb, x, cossin, cache, pos0, cfg, fmeta, _ = args
    before, flat_before = model_flat_seg.launches, model_flat.launches
    toks, rows, scales = model_flat_seg._model_decode_flat_seg_cuda(*args)
    assert model_flat_seg.launches == before + 1 and model_flat.launches == flat_before
    model_flat._model_decode_flat_cuda(fstack, x, cossin[0], cache, pos0, cfg, fmeta)
    (entry, a, bits, dt), (_, one, _, _) = calls
    assert (entry, bits, dt) == (ENTRIES[1], 4, dtype)
    assert a.part is not None and a.n_part > 0
    assert (list(a.plan_ws), list(a.plan_splits), a.plan_kc, a.n_part) == (
        list(one.plan_ws), list(one.plan_splits), one.plan_kc, one.n_part)
    assert (a.kseg, a.pos, a.emb, a.x) == (kseg, pos0, emb.data_ptr(), x.data_ptr())
    assert (a.kv, a.kvs, a.max_len) == (cache["kv"].data_ptr(), cache["kv_scale"].data_ptr(),
                                        cache["kv"].shape[1])
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert toks.shape == (kseg,) and toks.dtype == torch.int32 and a.token == toks.data_ptr()
    assert rows.shape == (kseg, L, 2, Hkv, D) and rows.dtype == torch.int8
    assert scales.shape == (kseg, L, 2, Hkv) and scales.dtype == torch.float32
    assert (a.kvrow, a.kvsc) == (rows.data_ptr(), scales.data_ptr())


def test_refused_launch_raises_and_runs_no_plain_version(monkeypatch):
    """A launch the library refuses (a nonzero cudaError) raises from the
    public wrapper on CUDA tensors; the plain version never runs in its
    place and no launch is counted."""
    args = _seg_args("cpu", 4, 128, 3)
    seen = []

    def entry(*a):
        seen.append(a)
        return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        mi_model_decode_flat_seg=entry))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(model_flat_seg, "model_decode_flat_seg_ref",
                        lambda *a: pytest.fail("the plain version ran on CUDA tensors"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    before = model_flat_seg.launches
    with pytest.raises(RuntimeError, match="mi_model_decode_flat_seg failed with cudaError 1"):
        model_flat_seg.model_decode_flat_seg(*args)
    assert len(seen) == 1 and model_flat_seg.launches == before


@pytest.mark.parametrize("bits", [4, 8])
def test_seg_launch_needs_the_embedding_table(calls, bits):
    """The multi-token kernel reads each later token's input row from the
    embedding table: a launch without one is refused before it runs."""
    fstack, emb, x, cossin, cache, pos0, cfg, fmeta, kseg = _seg_args("cpu", bits, 64, 2)
    D = cfg.head_dim
    with pytest.raises(ValueError, match="emb"):
        model_flat.flat_launch("mi_model_decode_flat_seg", fstack, x, cossin[:, :D],
                               cossin[:, D:], cache, pos0, cfg, fmeta, kseg=kseg)
    assert not calls


@pytest.mark.parametrize("kseg", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_segment_is_a_chain_of_one_token_decodes(kseg, dtype):
    """The plain version's tokens, rows and scales are those of kseg
    one-token plain decodes (`model_decode_flat_ref`) with each token's rows
    scattered into the cache before the next, bit for bit: the contract
    the kernel's per-token loop keeps on the card."""
    args = _seg_args("cpu", 4, 128, kseg, dtype, seed=kseg)
    got = model_flat_seg.model_decode_flat_seg_ref(*args)
    chain = _flat_chain(model_flat.model_decode_flat_ref, *args)
    for g, c in zip(got, chain[:3]):
        assert torch.equal(g, c)
    assert chain[3].shape == (kseg, args[6].vocab_size)
    assert got[0].tolist() == [int(torch.argmax(lg)) for lg in chain[3]]
