"""The port's CUDA kernels against their plain versions on the card, at small
shapes and in float32, over the options the main path does not reach:
int2/int8 and per-channel weights, asymmetric grids (streamed bias tables),
ragged M and N, an intermediate size that is not a multiple of 32, head_dim
64, 1 to 8 slots, positions on and off the 128-row boundary; the batched
kernel's paged mode bitwise against its dense mode, its chunk mode (dense and
paged, C = 2 to 8, prefix 0 and across page boundaries), the paged flash
decode (f32/bf16 q and pool; split over pages: one slot at its last row,
slots around chunk boundaries, GQA groups of 1 to 16 heads, NaN in the rows
it must not read, the same bits on a second launch), and both paged
batchers against the CPU; the
batched kernel's terminal lm rows (mode d) in every mode (dense one-token,
paged, dense and paged chunk; a vocab that is not a multiple of 32), the
multi-token flat decode (kseg 1 to 5, float32 and bfloat16, 4-bit words
also at the narrowest widths its plan takes; the same bits on a second
launch, and with 4-bit words those of kseg one-token flat launches; its
plan refused as the flat kernel's is), and the speculative paths and
batchers against the CPU; the decode attention (codes and scales bitwise
against its plain version; split over the live rows: chunk boundaries,
T = 4096 at its last row, GQA groups of 4 and 12, NaN in the rows past the
position, the same bits on a second launch), the fused MLP (M from 1 to 130, int2/4/8,
per-group and per-channel, the same bits on every run), the W4A8 integer
product (bitwise), the unfused path (generate, compute_ppl, int4 and W4A8)
against the CPU, and the W4A8 activation and KV quantizers and
`find_qparams` bitwise against the CPU; the bf16 int4 dequant_matmul
kernels (gemv16 up to 16 rows, mma above) at M from 1 to 2048, the same
bits on a second launch; the flat decode kernel with 4-bit words (its
tensor-core GEMV, csrc/flat_gemv.cuh) in float32 and bfloat16 at g32 and g128
with a ragged vocab, the same bits on a second launch, and its plan refused
when the scratch it is given falls short; and the new int8 KV rows of the
per-layer, flat and batched decode kernels bitwise against their plain
versions.

Needs an NVIDIA GPU and nvcc; every test skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: the suite's conftest imports JAX, which the port's machine
does not have; this file imports only torch, numpy and the port.)

Tolerances: kernel and plain version sum in different orders in float32, so
outputs agree to 1e-4 of their largest magnitude; int8 rows to one code on
at most 0.1% of entries; greedy tokens exactly."""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.core import packing, qparams
from mi_optimize_tpu_torch.core.qparams import qrange
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear, QuantSpec, group_size
from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama, with_w4a8
from mi_optimize_tpu_torch.ops import (block_fused, decode_attention, dequant_matmul, mlp_fused,
                                       model_flat, model_flat_seg, model_fused, paged_attention,
                                       w4a8_matmul)
from mi_optimize_tpu_torch.serving import engine, megadecode
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, SpeculativeBatcher
from mi_optimize_tpu_torch.serving.paged import (PagedBatcher, PagedMegaBatcher,
                                                 PagedSpeculativeBatcher)
from mi_optimize_tpu_torch.serving.flatdecode import (decode_loop_flat, decode_loop_flat_seg,
                                                      stack_cache_flat, stack_flat)
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.speculative import speculative_generate
from mi_optimize_tpu_torch.utils.planted import planted_pair

pytestmark = pytest.mark.cuda

RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rtol=RTOL):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rtol * max(float(ref.float().abs().max()), 1e-6), err


TIE = 2e-4  # code units from a .5 tie within which rule (b) of `_rows_match` forgives a flip


def _rows_match(got, ref, pre=None):
    """int8 rows of a kernel against its plain version's. (a) Every code
    within one and at most 0.1% of them apart. Or, given `pre`, the plain
    version's values before rounding (x / scale, on the same device), (b)
    at most max(1, 0.1%) of the codes apart, each by one, each where `pre`
    lies within TIE of a .5 tie: a tie that two f32 sum orders round to
    either side, which no kernel can round as an unspecified library sum
    order does (ROADMAP C4). TIE is about 5x the 3.8e-5 by which the card's
    and the CPU's plain values of such a code differ."""
    d = (got.cpu().to(torch.int32) - ref.cpu().to(torch.int32)).abs()
    rule_a = int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()
    if pre is None or rule_a:
        assert rule_a
        return
    flips = d > 0
    p = pre.cpu().to(torch.float64)
    tie = ((p - p.trunc()).abs() - 0.5).abs()
    assert int(d.max()) == 1 and int(flips.sum()) <= max(1, 1e-3 * d.numel())
    assert float(tie[flips].max()) <= TIE, float(tie[flips].max())


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, QuantizedLinear):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(device) for f in dataclasses.fields(tree)
            if f.init and isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def _linear(out_f, in_f, bits, qtype, groupsize, symmetric, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(out_f, in_f, generator=g) * in_f ** -0.5
    fake, scale, zero = qparams.quantize_dequantize(w, bits, qtype, groupsize, symmetric)
    ints = qparams.quantize_to_int(fake, scale, zero, bits, qtype, groupsize)
    spec = QuantSpec(wbit=bits, w_qtype=qtype, w_groupsize=groupsize, w_symmetric=symmetric,
                     w_packed=True)
    return QuantizedLinear(spec=spec, out_features=out_f, in_features=in_f,
                           packed=packing.pack_weight_device(ints, bits, qrange(bits, True)),
                           w_scale=scale, w_zero=zero)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,qtype,groupsize,symmetric", [
    (4, "per_group", 128, True), (4, "per_group", 32, False), (2, "per_group", 64, True),
    (8, "per_group", 128, False), (4, "per_channel", -1, True), (8, "per_channel", -1, True)])
@pytest.mark.parametrize("M", [1, 5, 8, 9, 33, 128])
def test_dequant_matmul(dev, dtype, bits, qtype, groupsize, symmetric, M):
    K, N = 384, 200  # N not a multiple of the 32- or 64-column tiles
    lin = _to(_linear(N, K, bits, qtype, groupsize, symmetric, seed=M + bits), dev)
    st, bt = dequant_matmul.kernel_tables(lin)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(M)).to(dtype).to(dev)
    counter = dequant_matmul.COUNTERS[dequant_matmul.route(M, dtype, bits, group_size(lin))]
    before = getattr(dequant_matmul, counter)
    y = dequant_matmul.packed_matmul(x, lin.packed, st, bt, bits, group_size(lin))
    assert getattr(dequant_matmul, counter) == before + 1 and y.dtype == dtype
    ref = dequant_matmul.dequant_matmul_ref(x, lin.packed, st, bt, bits, group_size(lin))
    _close(y, ref, RTOL if dtype == torch.float32 else 2e-2)


@functools.lru_cache(maxsize=None)
def _int4_linear(N, K, qtype, groupsize, symmetric):
    return _to(_linear(N, K, 4, qtype, groupsize, symmetric, seed=K + groupsize), "cuda")


@pytest.mark.parametrize("qtype,groupsize,symmetric", [
    ("per_group", 32, False), ("per_group", 64, True), ("per_group", 128, True),
    ("per_group", 128, False), ("per_channel", -1, True)])
@pytest.mark.parametrize("K,N", [(384, 200), (4096, 4096)])
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16, 17, 64, 65, 128, 2048])
def test_dequant_matmul_bf16_int4(dev, M, K, N, qtype, groupsize, symmetric):
    """bf16 x with 4-bit words, the served case: the gemv16 kernel at M <= 16
    (grouped rescale, split K) and the tensor-core mma kernel above. Within
    2e-2 of max|plain| (bf16 output; the f32 sums run in other orders), the
    same bits on a second launch (fixed-order split sums, no atomics on
    floats), and only the route's own counter moves."""
    lin = _int4_linear(N, K, qtype, groupsize, symmetric)
    st, bt = dequant_matmul.kernel_tables(lin)
    g = group_size(lin)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(M)).to(torch.bfloat16).to(dev)
    kernel = dequant_matmul.route(M, torch.bfloat16, 4, g)
    assert kernel == ("gemv16" if M <= 16 else "mma")
    before = {c: getattr(dequant_matmul, c) for c in dequant_matmul.COUNTERS.values()}
    y1 = dequant_matmul.packed_matmul(x, lin.packed, st, bt, 4, g)
    y2 = dequant_matmul.packed_matmul(x, lin.packed, st, bt, 4, g)
    torch.cuda.synchronize()
    moved = {c: getattr(dequant_matmul, c) - n for c, n in before.items()}
    assert moved == {c: 2 if c == dequant_matmul.COUNTERS[kernel] else 0 for c in moved}
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2)
    ref = dequant_matmul.dequant_matmul_ref(x, lin.packed, st, bt, 4, g)
    _close(y1, ref, 2e-2)


def _small(device, bits=4, groupsize=128, head_dim=128, layers=2, seed=0, symmetric=True,
           inter=1024, vocab=160, dtype=torch.float32, hidden=512):
    heads = hidden // head_dim
    cfg = LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
                      num_layers=layers, num_heads=heads, num_kv_heads=heads // 2,
                      head_dim=head_dim, max_seq_len=512)
    p = build_quantized_llama(cfg, bits=bits, groupsize=groupsize, dtype=dtype,
                              seed=seed, device="cpu", symmetric=symmetric)
    gen = torch.Generator().manual_seed(seed)
    for blk in p["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    cpu = fuse_for_serving(Model(config=cfg, params=p))
    return cfg, cpu, fuse_for_serving(Model(config=cfg, params=_to(p, device)))


def _cache(cfg, T, pos, layers=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (layers, T, cfg.num_kv_heads, cfg.head_dim)
    c = {f: torch.randint(-127, 128, shape, generator=g).to(torch.int8) for f in ("k", "v")}
    for f in ("k_scale", "v_scale"):
        c[f] = torch.rand(shape[:3], generator=g) * 0.02 + 1e-3
    for v in c.values():
        v[:, pos:] = 0
    return c


@pytest.mark.parametrize("bits,head_dim,symmetric,dtype", [
    (4, 128, True, torch.float32), (8, 128, True, torch.float32), (2, 128, True, torch.float32),
    (4, 64, True, torch.float32), (4, 128, False, torch.float32), (4, 128, True, torch.bfloat16)])
@pytest.mark.parametrize("T,pos", [(128, 0), (256, 127), (256, 130), (384, 383)])
def test_block_decode(dev, bits, head_dim, symmetric, dtype, T, pos):
    """The per-layer decode against its plain version: 4-bit words on the
    "mega4" route (the tensor-core layer loop at one layer; the asymmetric
    grid through its bias tables), the same bits on a second launch, the
    int8 rows held with the plain values before rounding (`_rows_match`
    rule (b)); 2- and 8-bit words on the CUDA-core kernel. float32 to
    RTOL, scales to 1e-5; bfloat16 as `_batch_close` holds a bf16 row
    (BF16_TOL, rows within one code, scales to 1e-3)."""
    cfg, _, gpu = _small(dev, bits=bits, head_dim=head_dim, seed=bits + pos,
                         symmetric=symmetric, dtype=dtype)
    blk = gpu.params["layers"][1]
    cache = _to(_cache(cfg, T, pos, seed=pos), dev)
    x = torch.randn(1, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(T)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (blk, blk["mega"], x, cos.reshape(-1), sin.reshape(-1), cache, pos, cfg)
    mega4 = block_fused.block_route(bits, dtype) == "mega4"
    assert mega4 == (bits == 4)
    before, before4 = block_fused.launches, block_fused.launches_mega4
    got = block_fused.block_decode_rows(*args)
    if mega4:
        _same_bits(got, block_fused.block_decode_rows(*args))
    assert block_fused.launches == before + 1 + mega4
    assert block_fused.launches_mega4 == before4 + 2 * mega4
    ref = block_fused.block_decode_ref(*args, pre=True)
    if dtype == torch.bfloat16:
        _close(got[0], ref[0], BF16_TOL)
        for i in (1, 2):
            assert int((got[i].int() - ref[i].int()).abs().max()) <= 1
        _close(got[3], ref[3], 1e-3)
        _close(got[4], ref[4], 1e-3)
        return
    _close(got[0], ref[0])
    _rows_match(got[1], ref[1], ref[5] if mega4 else None)
    _rows_match(got[2], ref[2], ref[6] if mega4 else None)
    _close(got[3], ref[3], 1e-5)
    _close(got[4], ref[4], 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_decode_mega_writes_rows_in_place(dev, dtype):
    """On the "mega4" route `block_decode_mega` has the kernel write the new
    rows and scales into the cache at pos: the cache then holds
    `block_decode_rows`' rows there bit for bit (the same x_out too) and
    every other row as before, and `block_decode_rows` leaves the cache
    as it was."""
    cfg, _, gpu = _small(dev, seed=21, dtype=dtype)
    blk = gpu.params["layers"][0]
    T, pos = 256, 130
    cache = _to(_cache(cfg, T, pos, seed=3), dev)
    first = {f: t.clone() for f, t in cache.items()}
    x = torch.randn(1, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(4)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (blk, blk["mega"], x, cos.reshape(-1), sin.reshape(-1))
    assert block_fused.block_route(4, dtype) == "mega4"
    rows = block_fused.block_decode_rows(*args, cache, pos, cfg)
    assert all(torch.equal(cache[f], first[f]) for f in cache)
    before = block_fused.launches_mega4
    y, out = block_fused.block_decode_mega(*args, cache, pos, cfg)
    assert out is cache and block_fused.launches_mega4 == before + 1
    assert torch.equal(y.reshape(1, -1), rows[0])
    keep = torch.ones(T, dtype=torch.bool)
    keep[pos] = False
    for f, i in (("k", 1), ("v", 2), ("k_scale", 3), ("v_scale", 4)):
        assert torch.equal(cache[f][0, pos], rows[i])
        assert torch.equal(cache[f][0, keep], first[f][0, keep])


# (bits, head_dim, group, vocab, dtype): int4 (the tensor-core GEMV of
# csrc/flat_gemv.cuh) and int8 (the CUDA-core dot) as before, then int4 in
# both model dtypes at g32 and g128, with a vocab of 200 (not a multiple of
# a 32-column strip)
FLAT_CASES = [(4, 128, 128, 160, torch.float32), (8, 64, 128, 160, torch.float32),
              (4, 128, 32, 160, torch.float32), (4, 128, 128, 200, torch.float32),
              (4, 64, 32, 200, torch.float32), (4, 128, 128, 160, torch.bfloat16),
              (4, 128, 32, 200, torch.bfloat16)]


def _flat_args(dev, bits, head_dim, group=128, vocab=160, dtype=torch.float32, seed=7):
    cfg, _, gpu = _small(dev, bits=bits, groupsize=group, head_dim=head_dim, layers=3, seed=seed,
                         vocab=vocab, dtype=dtype)
    fstack, fmeta = stack_flat(gpu)
    T, pos = 256, 150
    cache = stack_cache_flat([_to(_cache(cfg, T, pos, seed=l), dev) for l in range(3)])
    x = llama.embed(gpu.params, torch.tensor([[9]], device=dev))
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    cossin = torch.cat([cos.reshape(-1), sin.reshape(-1)])
    return (fstack, x, cossin, cache, pos, cfg, fmeta)


def _flat_plain(args, got):
    """The plain version's outputs for a float32 flat launch `got` on
    `args`. Where the kernel's int8 k/v rows flip a tie (one code on at most
    0.1% of them, as `_rows_match` allows), the plain version runs again
    with the kernel's codes in place of its own (its own scales kept), as
    `_plain` does for the batched kernel: only the tie is forgiven, not the
    drift it causes in later layers."""
    ref = model_flat.model_decode_flat_ref(*args)
    _rows_match(got[2], ref[2])
    if torch.equal(got[2].cpu(), ref[2].cpu()):
        return ref
    calls = iter(range(2 * got[2].shape[0]))  # layer l's k rows, then its v rows

    def forced(x):
        q, s = llama.quantize_kv(x)
        l, kv = divmod(next(calls), 2)
        return got[2][l, kv][None, None].to(q.device, q.dtype), s

    with mock.patch.object(block_fused, "quantize_kv", forced):
        ref = model_flat.model_decode_flat_ref(*args)
    assert torch.equal(got[2].cpu(), ref[2].cpu())
    return ref


@pytest.mark.parametrize("bits,head_dim,group,vocab,dtype", FLAT_CASES)
def test_model_decode_flat(dev, bits, head_dim, group, vocab, dtype):
    """The flat kernel against its plain version, and a second launch bit
    for bit. float32: logits to RTOL against the plain version (run on the
    kernel's int8 codes where a tie flips one: `_plain`), the token equal,
    the scales to 1e-5; bfloat16: logits to BF16_TOL, rows within one code,
    scales to 1e-3 (`_batch_close`'s bf16 bounds), the token equal unless
    the plain version's top two logits lie within BF16_TOL."""
    args = _flat_args(dev, bits, head_dim, group, vocab, dtype)
    before = model_flat.launches
    got = model_flat.model_decode_flat(*args)
    _same_bits(got, model_flat.model_decode_flat(*args))
    assert model_flat.launches == before + 2
    assert int(got[0][0]) == int(torch.argmax(got[1][0]))
    if dtype == torch.float32:
        ref = _flat_plain(args, got)
        _close(got[1], ref[1])
        assert int(got[0][0]) == int(ref[0][0])
        _close(got[3], ref[3], 1e-5)
        return
    ref = model_flat.model_decode_flat_ref(*args)
    _close(got[1], ref[1], BF16_TOL)
    assert int((got[2].int() - ref[2].int()).abs().max()) <= 1
    _close(got[3], ref[3], 1e-3)
    top2 = torch.topk(ref[1][0].float(), 2).values
    if float(top2[0] - top2[1]) > BF16_TOL * float(ref[1].abs().max()):
        assert int(got[0][0]) == int(ref[0][0])


@pytest.mark.parametrize("short", [None, "partials", "splits", "lm_head"])
def test_model_decode_flat_plan(dev, monkeypatch, short):
    """The 4-bit flat kernel's plan is made on the host (`flat_plans`,
    `flat_scratch`) and checked again by its launch (check_plan): with
    o_proj split in 4, gate/up in 2 and down_proj in 3 the launch matches
    its plain version and repeats its bits; partials one float short of the
    plan's, a split with no group (o_proj in groups + 1) or a split lm_head
    (the argmax needs whole logits) are refused before anything runs, and
    no launch is counted."""
    plans, sizes = model_flat.flat_plans, model_flat.flat_scratch
    force = {None: {1: 4, 2: 2, 3: 3}, "partials": {1: 4, 2: 2, 3: 3}, "splits": {1: 5},
             "lm_head": {4: 2}}
    monkeypatch.setattr(model_flat, "flat_plans", lambda *a: [
        pl[:4] + (force[short].get(i, pl[4]),) for i, pl in enumerate(plans(*a))])
    cut = 1 if short == "partials" else 0
    monkeypatch.setattr(model_flat, "flat_scratch", lambda pl: (sizes(pl)[0] - cut, sizes(pl)[1]))
    args = _flat_args(dev, 4, 128, group=128)  # 512 inputs of o_proj: 4 groups
    before = model_flat.launches
    if short is not None:
        with pytest.raises(RuntimeError, match="cudaError"):
            model_flat.model_decode_flat(*args)
        assert model_flat.launches == before
        return
    got = model_flat.model_decode_flat(*args)
    _same_bits(got, model_flat.model_decode_flat(*args))
    assert model_flat.launches == before + 2
    ref = _flat_plain(args, got)
    _close(got[1], ref[1])
    assert int(got[0][0]) == int(ref[0][0])
    _close(got[3], ref[3], 1e-5)


def test_generate_and_flat_decode_match_the_cpu(dev):
    """The slice on the card (all three kernels) against the plain versions
    on the CPU: greedy tokens equal, prefill logits to 1e-4."""
    cfg, cpu, gpu = _small(dev, seed=11)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 21))
    counts = [m.launches for m in (dequant_matmul, block_fused, model_flat)]
    outs = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        toks = engine.generate(m, prompt, max_new_tokens=6, cache_dtype=torch.int8)
        d = m.params["embed"].device
        log, cache = engine.prefill(m.params, cfg, torch.as_tensor(prompt, device=d),
                                    engine.init_cache(cfg, 1, 256, torch.int8, device=d))
        fstack, fmeta = stack_flat(m)
        ftoks, _ = decode_loop_flat(m.params, fstack, fmeta, cfg, torch.argmax(log, -1)[:, None],
                                    stack_cache_flat(cache), 21, 6)
        outs[name] = (toks, log.cpu(), ftoks.cpu())
    np.testing.assert_array_equal(outs["cuda"][0], outs["cpu"][0])
    _close(outs["cuda"][1], outs["cpu"][1])
    assert torch.equal(outs["cuda"][2], outs["cpu"][2])
    after = [m.launches for m in (dequant_matmul, block_fused, model_flat)]
    assert all(a > b for a, b in zip(after, counts))


# (bits, symmetric, head_dim, intermediate, group): int4/int8, both grids,
# head_dim 64 and 128, and I = 1000 (not a multiple of 32; group 8 divides it)
WHOLE_MODEL = [(4, True, 128, 1024, 128), (4, False, 128, 1024, 128), (8, False, 64, 1024, 128),
               (8, True, 64, 1024, 128), (4, False, 128, 1000, 8), (4, True, 128, 1024, 32),
               (2, False, 128, 1024, 64)]
# the batched kernel's modes: 4-bit (the tensor-core GEMV) at g128 on both
# grids and at g32, and 8-bit (the CUDA-core tile_dot_b)
BATCH_MODES = WHOLE_MODEL[:3] + WHOLE_MODEL[5:6]
T_MEGA = 256
POSITIONS = [0, 127, 128, T_MEGA - 1]
BF16_TOL = 2e-2  # bf16 models: the x_out rounding, and a normed value a sum order may round apart


def _stacked(dev, bits, symmetric, head_dim, inter, group, seed):
    cfg, _, gpu = _small(dev, bits=bits, groupsize=group, head_dim=head_dim, seed=seed,
                         symmetric=symmetric, inter=inter)
    stack, meta = megadecode.stack_serving(gpu)
    assert (meta[5] is None) == (not symmetric)
    return cfg, gpu, stack, meta


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", WHOLE_MODEL)
@pytest.mark.parametrize("pos", POSITIONS)
def test_model_decode_mega(dev, bits, symmetric, head_dim, inter, group, pos):
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, pos + bits)
    cache = _to(_cache(cfg, T_MEGA, pos, layers=cfg.num_layers, seed=pos), dev)
    x = torch.randn(1, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(pos)).to(dev)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (stack, x, cos.reshape(-1), sin.reshape(-1), cache, pos, cfg, meta)
    before, before4 = model_fused.launches, model_fused.launches_mega4
    got = model_fused.model_decode_mega(*args)
    assert model_fused.launches == before + 1
    # 4-bit words take the tensor-core layer loop, 2- and 8-bit the CUDA-core mega_kernel
    assert model_fused.launches_mega4 == before4 + (bits == 4)
    ref = model_fused.model_decode_mega_ref(*args, pre=True)
    _close(got[0], ref[0])
    # the "mega4" route's rows with the plain values before rounding (rule (b))
    _rows_match(got[1], ref[1], ref[5] if bits == 4 else None)
    _rows_match(got[2], ref[2], ref[6] if bits == 4 else None)
    _close(got[3], ref[3], 1e-5)
    _close(got[4], ref[4], 1e-5)


def _one_row(out):
    """model_decode_mega's outputs with the batched kernel's row axis, for
    `_batch_close`."""
    return (out[0].reshape(1, 1, -1),) + tuple(t[:, None] for t in out[1:])


def _mega_close(got, args, dtype):
    """A one-token launch against its plain version on `args`: float32 as
    `test_model_decode_mega` holds it (x_out to RTOL, int8 rows one code
    off on at most 0.1%, scales to 1e-5), bfloat16 as `_batch_close` holds
    a batched row; the f32 rows with the plain values before rounding
    (`_rows_match` rule (b))."""
    ref = model_fused.model_decode_mega_ref(*args, pre=True)
    if dtype == torch.bfloat16:
        _batch_close(_one_row(got), lambda: _one_row(ref[:5]), dtype)
        return
    _close(got[0], ref[0])
    _rows_match(got[1], ref[1], ref[5])
    _rows_match(got[2], ref[2], ref[6])
    _close(got[3], ref[3], 1e-5)
    _close(got[4], ref[4], 1e-5)


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group",
                         [m for m in WHOLE_MODEL if m[0] == 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 200])
def test_model_decode_mega4(dev, bits, symmetric, head_dim, inter, group, dtype, pos):
    """The "mega4" route (csrc/model_mega4.cu) in both model dtypes, on both
    grids: `mega_route` picks it, a second launch on the same inputs gives
    the same bits, and the outputs match the plain version (`_mega_close`)."""
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, pos + 5)
    cache = _to(_cache(cfg, T_MEGA, pos, layers=cfg.num_layers, seed=pos + 1), dev)
    x = torch.randn(1, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(pos + 2)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (stack, x, cos.reshape(-1), sin.reshape(-1), cache, pos, cfg, meta)
    assert model_fused.mega_route(meta) == "mega4"
    before4 = model_fused.launches_mega4
    got = model_fused.model_decode_mega(*args)
    _same_bits(got, model_fused.model_decode_mega(*args))
    assert model_fused.launches_mega4 == before4 + 2
    _mega_close(got, args, dtype)


@pytest.mark.parametrize("short", [None, "partials", "splits"])
def test_model_decode_mega4_plan(dev, monkeypatch, short):
    """The "mega4" route's plan is made on the host (`flat_plans` without
    the lm_head, `flat_scratch`) and checked again by its launch
    (check_plan): with o_proj split in 4, gate/up in 2 and down_proj in 3
    the asymmetric launch matches its plain version and repeats its bits;
    partials one float short of the plan's, or a split with no group
    (o_proj in groups + 1), are refused before anything runs, and no launch
    is counted."""
    plans, sizes = model_fused.flat_plans, model_fused.flat_scratch
    force = {None: {1: 4, 2: 2, 3: 3}, "partials": {1: 4, 2: 2, 3: 3}, "splits": {1: 5}}
    monkeypatch.setattr(model_fused, "flat_plans", lambda *a, **k: [
        pl[:4] + (force[short].get(i, pl[4]),) for i, pl in enumerate(plans(*a, **k))])
    cut = 1 if short == "partials" else 0
    monkeypatch.setattr(model_fused, "flat_scratch",
                        lambda pl: (sizes(pl)[0] - cut, sizes(pl)[1]))
    cfg, _, stack, meta = _stacked(dev, *WHOLE_MODEL[1], seed=3)  # 512 inputs of o_proj: 4 groups
    pos = 127
    cache = _to(_cache(cfg, T_MEGA, pos, layers=cfg.num_layers, seed=4), dev)
    x = torch.randn(1, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(5)).to(dev)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (stack, x, cos.reshape(-1), sin.reshape(-1), cache, pos, cfg, meta)
    before = model_fused.launches_mega4
    if short is not None:
        with pytest.raises(RuntimeError, match="cudaError"):
            model_fused.model_decode_mega(*args)
        assert model_fused.launches_mega4 == before
        return
    got = model_fused.model_decode_mega(*args)
    _same_bits(got, model_fused.model_decode_mega(*args))
    assert model_fused.launches_mega4 == before + 2
    _mega_close(got, args, torch.float32)


def _same_bits(a, b):
    """Two launches' outputs, bit for bit."""
    assert len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _plain(ref_fn, got):
    """The plain version's outputs `ref_fn()` for a float32 launch `got`.
    Where the kernel's int8 k/v rows flip a tie (one code on at most 0.1%,
    as `_rows_match` allows), the plain version runs again with the
    kernel's codes in place of its own (its own scales kept), so that only
    the tie is forgiven and not the drift it causes in later layers."""
    ref = ref_fn()
    _rows_match(got[1], ref[1])
    _rows_match(got[2], ref[2])
    if torch.equal(got[1].cpu(), ref[1].cpu()) and torch.equal(got[2].cpu(), ref[2].cpu()):
        return ref
    calls = iter(range(2 * got[1].shape[0]))  # layer l's k rows, then its v rows
    own = []  # the plain version's own codes on the kernel's path

    def forced(x):
        q, s = llama.quantize_kv(x)
        l, kv = divmod(next(calls), 2)
        own.append(q)
        return got[1 + kv][l][:, None].to(q.device, q.dtype), s

    with mock.patch.object(block_fused, "quantize_kv", forced):
        ref = ref_fn()
    assert torch.equal(got[1].cpu(), ref[1].cpu()) and torch.equal(got[2].cpu(), ref[2].cpu())
    _rows_match(got[1], torch.stack(own[0::2])[:, :, 0])
    _rows_match(got[2], torch.stack(own[1::2])[:, :, 0])
    return ref


def _batch_close(got, ref_fn, dtype):
    """A batched launch's (x_out, krows, vrows, kscales, vscales) against its
    plain version `ref_fn()`: float32 to RTOL and scales to 1e-5 (against
    the plain version on the kernel's codes where a tie flips: `_plain`),
    int8 rows up to one-code tie flips on at most 0.1%; bf16 to BF16_TOL,
    scales to 1e-3 and rows within one code (chip_smoke's hold_rows for
    the layers whose inputs carry a bf16 layer output: a normed value that
    two sum orders round to neighbouring bf16 values moves a row by a code,
    on small models more than 0.1% of it)."""
    if dtype == torch.float32:
        ref = _plain(ref_fn, got)
        _close(got[0], ref[0])
        _close(got[3], ref[3], 1e-5)
        _close(got[4], ref[4], 1e-5)
        return
    ref = ref_fn()
    _close(got[0], ref[0], BF16_TOL)
    for i in (1, 2):
        assert int((got[i].int() - ref[i].int()).abs().max()) <= 1
    _close(got[3], ref[3], 1e-3)
    _close(got[4], ref[4], 1e-3)


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", WHOLE_MODEL)
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_decode_mega_batch(dev, bits, symmetric, head_dim, inter, group, B, dtype):
    """Mode (a) against its plain version in both model dtypes (4-bit: the
    tensor-core GEMV; 2- and 8-bit: the CUDA-core one), and a second launch
    bit for bit."""
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, B + bits)
    positions = [POSITIONS[b % len(POSITIONS)] for b in range(B)]
    slots = [_cache(cfg, T_MEGA, p, layers=cfg.num_layers, seed=b)
             for b, p in enumerate(positions)]
    cache = {f: torch.stack([c[f].transpose(1, 2) for c in slots], dim=1).contiguous().to(dev)
             for f in slots[0]}                                     # [L, B, Hkv, T(, D)]
    x = torch.randn(B, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(B)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, x, cos.reshape(B, -1), sin.reshape(B, -1), cache, positions, cfg, meta)
    before = model_fused.launches_batch
    got = model_fused.model_decode_mega_batch(*args)
    assert model_fused.launches_batch == before + 1
    _same_bits(got, model_fused.model_decode_mega_batch(*args))
    _batch_close(got, lambda: model_fused.model_decode_mega_batch_ref(*args), dtype)


@pytest.mark.parametrize("short", [None, "partials", "counters"])
def test_model_decode_mega_batch_scratch(dev, monkeypatch, short):
    """The 4-bit GEMV's scratch is sized on the host (`gemv_scratch`) and
    counted again by the kernel's dispatch: with o_proj's K split in two,
    the launch matches its plain version, and one float of partials or one
    tile counter short of the plan's is refused before anything runs."""
    cfg, _, stack, meta = _stacked(dev, *WHOLE_MODEL[5], seed=7)
    B, positions = 3, [0, 127, 200]
    plans, sizes = model_fused.batch_plans, model_fused.gemv_scratch
    monkeypatch.setattr(model_fused, "batch_plans", lambda *a: [
        pl[:3] + (2,) if i == 1 else pl for i, pl in enumerate(plans(*a))])
    n_part, n_counters = sizes(model_fused.batch_plans(cfg, meta))
    assert n_part > 0 and n_counters > 1
    cut = {None: (0, 0), "partials": (1, 0), "counters": (0, 1)}[short]
    monkeypatch.setattr(model_fused, "gemv_scratch",
                        lambda pl: tuple(n - c for n, c in zip(sizes(pl), cut)))
    cache = _slot_caches(cfg, positions, T_MEGA)
    cache = _to(cache, dev)
    x = torch.randn(B, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(B)).to(dev)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, x, cos.reshape(B, -1), sin.reshape(B, -1), cache, positions, cfg, meta)
    before = model_fused.launches_batch
    if short is not None:
        with pytest.raises(RuntimeError, match="cudaError"):
            model_fused.model_decode_mega_batch(*args)
        assert model_fused.launches_batch == before
        return
    got = model_fused.model_decode_mega_batch(*args)
    assert model_fused.launches_batch == before + 1
    _batch_close(got, lambda: model_fused.model_decode_mega_batch_ref(*args), torch.float32)


def _exact_int4(codes, scale_exp, groupsize):
    """A symmetric int4 per-group linear with the given centered codes [out,
    in] (-8..7) and scales 2^-scale_exp [out, in/groupsize]."""
    out_f, in_f = codes.shape
    spec = QuantSpec(wbit=4, w_qtype="per_group", w_groupsize=groupsize, w_symmetric=True,
                     w_packed=True)
    ints = torch.as_tensor(codes + 8, dtype=torch.int32)
    return QuantizedLinear(spec=spec, out_features=out_f, in_features=in_f,
                           packed=packing.pack_weight_device(ints, 4, qrange(4, True)),
                           w_scale=torch.as_tensor(2.0 ** -scale_exp, dtype=torch.float32),
                           w_zero=torch.full(scale_exp.shape, 8.0))


AMAX_CODE = 104  # 104 / 127 and 104 * f32(1/127) round to different f32 (an ulp apart)


def _exact_rows_model(dev, seed=0):
    """A 1-layer bf16 model on which the new k/v rows leave no room for sum
    orders: x is all ones, so the normed activation is exactly 1 (bf16
    rounding, norm weight 1); the q/k/v codes are small integers with
    power-of-two scales, so every qkv dot is exact in f32 whatever its
    order; the second half of each k head is zero, so RoPE rounds once,
    x*cos or x'*sin, in the kernels and in the plain versions alike; and
    every v head peaks at AMAX_CODE / 16, where amax / 127 (the kernels'
    old scale) and amax * f32(1/127) (the reference's, llama.KV_RCP)
    differ. Any difference in the rows is then the scale or code formula."""
    cfg = LlamaConfig(vocab_size=160, hidden_size=512, intermediate_size=1024, num_layers=1,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    p = build_quantized_llama(cfg, dtype=torch.bfloat16, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    h, D, g = cfg.hidden_size, cfg.head_dim, 128
    kv = cfg.num_kv_heads * D
    blk = p["layers"][0]
    blk["q_proj"] = _exact_int4(rng.integers(-8, 8, (cfg.num_heads * D, h)),
                                rng.integers(4, 8, (cfg.num_heads * D, h // g)), g)
    k = rng.integers(-1, 2, (kv, h))
    k.reshape(cfg.num_kv_heads, D, h)[:, D // 2:] = 0
    blk["k_proj"] = _exact_int4(k, rng.integers(4, 8, (kv, h // g)), g)
    v = rng.integers(-1, 2, (kv, h))
    v.reshape(cfg.num_kv_heads, D, h)[:, 0] = 0
    v.reshape(cfg.num_kv_heads, D, h)[:, 0, :AMAX_CODE] = 1          # column 0 of each head
    assert np.abs(v.sum(1)).reshape(cfg.num_kv_heads, D)[:, 1:].max() < AMAX_CODE
    blk["v_proj"] = _exact_int4(v, np.full((kv, h // g), 4), g)
    return cfg, fuse_for_serving(Model(config=cfg, params=_to(p, dev)))


def test_new_kv_rows_bit_equal_to_the_plain_versions(dev):
    """The int8 k/v rows and scales that the per-layer (B2), flat (B3) and
    batched (B5 mode a) decode kernels append are the plain versions' bit for
    bit, on inputs where only the quantization formula can differ
    (`_exact_rows_model`): the scale is amax * f32(1/127) as in the
    reference."""
    old = torch.tensor(AMAX_CODE / 16, dtype=torch.float32) / 127
    assert float(old) != float(torch.tensor(AMAX_CODE / 16) * llama.KV_RCP)
    cfg, gpu = _exact_rows_model(dev)
    h, T = cfg.hidden_size, 256

    def same(got, ref):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)

    blk, pos = gpu.params["layers"][0], 130
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    x = torch.ones(1, 1, h, dtype=torch.bfloat16, device=dev)
    args = (blk, blk["mega"], x, cos.reshape(-1), sin.reshape(-1),
            _to(_cache(cfg, T, pos, seed=1), dev), pos, cfg)
    got, ref = block_fused.block_decode_rows(*args), block_fused.block_decode_ref(*args)
    same(got[1:], ref[1:])
    vs = ref[4].float()
    assert torch.all(vs == torch.tensor(AMAX_CODE / 16, device=dev) * llama.KV_RCP)

    fstack, fmeta = stack_flat(gpu)
    pos = 150
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
    args = (fstack, x, torch.cat([cos.reshape(-1), sin.reshape(-1)]),
            stack_cache_flat([_to(_cache(cfg, T, pos, seed=2), dev)]), pos, cfg, fmeta)
    got, ref = model_flat.model_decode_flat(*args), model_flat.model_decode_flat_ref(*args)
    same(got[2:], ref[2:])

    stack, meta = megadecode.stack_serving(gpu)
    positions = POSITIONS * 2
    B = len(positions)
    slots = [_cache(cfg, T_MEGA, p, seed=b) for b, p in enumerate(positions)]
    cache = {f: torch.stack([c[f].transpose(1, 2) for c in slots], dim=1).contiguous().to(dev)
             for f in slots[0]}
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, torch.ones(B, 1, h, dtype=torch.bfloat16, device=dev), cos.reshape(B, -1),
            sin.reshape(B, -1), cache, positions, cfg, meta)
    got = model_fused.model_decode_mega_batch(*args)
    same(got[1:], model_fused.model_decode_mega_batch_ref(*args)[1:])


def test_batcher_and_model_loop_match_the_cpu(dev):
    """ContinuousBatcher on the one-launch batched step (a request joins
    mid-flight) and decode_loop_model on an asymmetric grid, on the card
    against the plain versions on the CPU: greedy tokens equal."""
    outs = {}
    counts = (model_fused.launches, model_fused.launches_batch)
    for symmetric in (True, False):
        cfg, cpu, gpu = _small(dev, seed=13, symmetric=symmetric)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (11, 30, 7)]
        for name, m in (("cpu", cpu), ("cuda", gpu)):
            b = ContinuousBatcher(m, n_slots=2, max_len=256, cache_dtype=torch.int8,
                                  use_megakernel=True)
            assert b._mega is not None
            toks = {}
            r0 = b.add_request(prompts[0], max_new_tokens=3)
            r1 = b.add_request(prompts[1], max_new_tokens=7)
            reqs = {r0: b.slot_req[0], r1: b.slot_req[1]}
            while any(r is not None for r in b.slot_req):
                b.step()
                if len(reqs) == 2 and None in b.slot_req:
                    r2 = b.add_request(prompts[2], max_new_tokens=5)
                    reqs[r2] = [r for r in b.slot_req if r and r.rid == r2][0]
            toks["batcher"] = [reqs[r].tokens for r in sorted(reqs)]
            if not symmetric:
                d = m.params["embed"].device
                ids = torch.as_tensor(prompts[1][None], device=d)
                log, cache = engine.prefill(m.params, cfg, ids,
                                            engine.init_cache(cfg, 1, 256, torch.int8, device=d))
                stack, meta = b._mega
                mt, _ = megadecode.decode_loop_model(m.params, stack, meta, cfg,
                                                     torch.argmax(log, -1)[:, None],
                                                     megadecode.stack_cache(cache), 30, 6)
                toks["model_loop"] = mt.cpu().tolist()
            outs[(symmetric, name)] = toks
        assert outs[(symmetric, "cuda")] == outs[(symmetric, "cpu")], symmetric
    assert model_fused.launches > counts[0] and model_fused.launches_batch > counts[1]


# ---------------------------------------------------------------------------
# the batched kernel's paged (b) and chunk (c) modes, and the paged flash
# decode (B8)
# ---------------------------------------------------------------------------

def _slot_caches(cfg, positions, T, seed=0):
    """Head-transposed [L, S, Hkv, T(, D)] cache, slot s live below positions[s]."""
    slots = [_cache(cfg, T, p, layers=cfg.num_layers, seed=seed + s)
             for s, p in enumerate(positions)]
    return {f: torch.stack([c[f].transpose(1, 2) for c in slots], dim=1).contiguous()
            for f in slots[0]}


def _mirror_pool(cache, seed, spare=1):
    """The dense cache's 128-row blocks on the pages of a pool (page 0 and
    `spare` more unused), in a seeded order. Returns (pool, table)."""
    L, S, Hkv, T = cache["k"].shape[:4]
    nt = T // 128
    n_pages = 1 + spare + S * nt
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm[:S * nt].reshape(S, nt).to(torch.int32)
    pool = {f: torch.full((L, n_pages, Hkv, 128) + c.shape[4:], 7, dtype=c.dtype)
            for f, c in cache.items()}
    for s in range(S):
        for t in range(nt):
            for f, c in cache.items():
                pool[f][:, int(table[s, t])] = c[:, s, :, t * 128:(t + 1) * 128]
    return pool, table


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", BATCH_MODES)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_decode_mega_batch_paged_equals_dense(dev, bits, symmetric, head_dim, inter,
                                                    group, B, dtype):
    """Mode (b) on a pool that mirrors the dense cache: every output bitwise
    equal to mode (a)'s (only the history addresses differ) and to a second
    paged launch, and within tolerance of the plain version."""
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, B + 20)
    positions = [POSITIONS[b % len(POSITIONS)] for b in range(B)]
    cache = _slot_caches(cfg, positions, T_MEGA)
    pool, table = _mirror_pool(cache, seed=B)
    cache, pool = _to(cache, dev), _to(pool, dev)
    x = torch.randn(B, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(B)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, x, cos.reshape(B, -1), sin.reshape(B, -1))
    dense = model_fused.model_decode_mega_batch(*args, cache, positions, cfg, meta)
    before = model_fused.launches_paged
    paged = model_fused.model_decode_mega_batch(*args, pool, positions, cfg, meta, table=table)
    assert model_fused.launches_paged == before + 1
    for d, p in zip(dense, paged):
        assert torch.equal(d, p)
    _same_bits(paged, model_fused.model_decode_mega_batch(*args, pool, positions, cfg, meta,
                                                          table=table))
    _batch_close(paged, lambda: model_fused.model_decode_mega_batch_ref(
        *args, pool, positions, cfg, meta, table), dtype)


# (slots, chunk, prefixes, paged)
CHUNK_CASES = [(1, 8, [0], False), (1, 8, [130], True), (2, 4, [0, 127], False),
               (2, 4, [126, 250], True), (4, 2, [5, 0, 128, 200], False), (1, 3, [255 - 3], True)]


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", BATCH_MODES)
@pytest.mark.parametrize("n_slots,C,prefixes,paged", CHUNK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_decode_mega_batch_chunk(dev, bits, symmetric, head_dim, inter, group, n_slots, C,
                                       prefixes, paged, dtype):
    """Mode (c), dense and paged: C consecutive tokens a slot, each row
    attending to its slot's history and the chunk's earlier rows, against
    the plain version, and a second launch bit for bit."""
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, C + 30)
    B = n_slots * C
    cache = _slot_caches(cfg, prefixes, T_MEGA, seed=C)
    table = None
    if paged:
        cache, table = _mirror_pool(cache, seed=C)
    cache = _to(cache, dev)
    positions = [p + i for p in prefixes for i in range(C)]
    x = torch.randn(B, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(C)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, x, cos.reshape(B, -1), sin.reshape(B, -1), cache, positions, cfg, meta)
    before = model_fused.launches_chunk
    got = model_fused.model_decode_mega_batch(*args, table=table, chunk=C)
    assert model_fused.launches_chunk == before + 1
    _same_bits(got, model_fused.model_decode_mega_batch(*args, table=table, chunk=C))
    _batch_close(got, lambda: model_fused.model_decode_mega_batch_ref(*args, table, C), dtype)


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.float32),
                                              (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("page_size,pps,H,Hkv", [(16, 4, 4, 2), (8, 3, 4, 2), (16, 32, 32, 32)])
def test_paged_flash_attention(dev, q_dtype, kv_dtype, page_size, pps, H, Hkv):
    B, D, n_pages = 4, 128, 1 + 4 * pps
    g = torch.Generator().manual_seed(page_size + pps)
    q = torch.randn(B, H * D, generator=g).to(q_dtype)
    pk = torch.randn(n_pages, page_size, Hkv, D, generator=g).to(kv_dtype)
    pv = torch.randn(n_pages, page_size, Hkv, D, generator=g).to(kv_dtype)
    table = (torch.randperm(n_pages - 1, generator=g)[:B * pps] + 1).reshape(B, pps).int()
    T = pps * page_size
    positions = [0, page_size - 1, page_size, T - 1]
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, page_size=page_size)
    before = paged_attention.launches
    got = paged_attention.paged_flash_attention(q.to(dev), pk.to(dev), pv.to(dev), table,
                                                positions, **kw)
    assert paged_attention.launches == before + 1 and got.dtype == q_dtype
    ref = paged_attention.paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
    _close(got.cpu(), ref, RTOL if q_dtype == torch.float32 else 2e-2)


def _split_positions(case, P, pps, H, Hkv):
    """The slots' positions of a `test_paged_flash_attention_split` case."""
    cr = paged_attention.split_plan(H, Hkv, P, pps)[0] * P  # rows of a chunk
    return {"one slot at the last row": [pps * P - 1],
            "chunk boundaries": [cr - 1, cr, cr + 1, 2 * cr, pps * P - cr]}[case]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 4), (8, 2), (16, 1), (12, 1)])
@pytest.mark.parametrize("case", ["one slot at the last row", "chunk boundaries"])
def test_paged_flash_attention_split(dev, kv_dtype, H, Hkv, case):
    """The split over pages at 32 pages of 16 a slot: one slot at its last
    row, and slots on, one before and one past chunk boundaries; GQA groups
    of 1, 2 and 4, and groups of 16 and 12 heads split into items of at most
    8; f32 and bf16 pools. NaN in every row the kernel must not read (the
    live page's rows past pos and the pages past it) leaves the output
    finite and equal to the plain version's on clean pages, and a second
    launch gives the same bits."""
    D, P, pps = 128, 16, 32
    positions = _split_positions(case, P, pps, H, Hkv)
    B, n_pages = len(positions), 1 + len(positions) * pps
    g = torch.Generator().manual_seed(H * 8 + Hkv)
    q = torch.randn(B, H * D, generator=g)
    pk = torch.randn(n_pages, P, Hkv, D, generator=g).to(kv_dtype)
    pv = torch.randn(n_pages, P, Hkv, D, generator=g).to(kv_dtype)
    table = (torch.randperm(n_pages - 1, generator=g)[:B * pps] + 1).reshape(B, pps).int()
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, page_size=P)
    ref = paged_attention.paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
    dirty_k, dirty_v = pk.clone(), pv.clone()
    for b, p in enumerate(positions):
        for j in range(p // P, pps):
            rows = slice(p % P + 1 if j == p // P else 0, P)
            dirty_k[table[b, j], rows] = float("nan")
            dirty_v[table[b, j], rows] = float("nan")
    dirty_k[0] = dirty_v[0] = float("nan")  # the page no slot holds
    tdev, pdev = (t.to(dev) for t in paged_attention.check_table(table, positions, B, n_pages,
                                                                 P))
    args = (q.to(dev), dirty_k.to(dev), dirty_v.to(dev), tdev, pdev)
    before = paged_attention.launches
    got = paged_attention.paged_flash_attention(*args, **kw)
    assert paged_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got.cpu(), ref)
    assert torch.equal(got, paged_attention.paged_flash_attention(*args, **kw))


def test_paged_batchers_match_the_cpu(dev):
    """PagedMegaBatcher (waves of 2 over 3 slots, prefix caching on prompts
    that share a page) and PagedBatcher (page 16: kernel B8) on the card
    against the plain versions on the CPU: greedy tokens equal."""
    cfg, cpu, gpu = _small(dev, seed=17)
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab_size, (128,))
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (n,))]) for n in (5, 12)]
    prompts.append(rng.integers(0, cfg.vocab_size, (40,)))
    counts = (model_fused.launches_paged, model_fused.launches_chunk, paged_attention.launches)
    outs = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        pb = PagedMegaBatcher(m, n_slots=3, max_len=256, wave_slots=2, prefix_cache=True)
        mega = pb.run_all(list(prompts), max_new_tokens=6)
        b = PagedBatcher(m, n_slots=2, page_size=16, n_pages=32, pages_per_slot=8)
        rids = [b.add_request(p[-60:], max_new_tokens=n) for p, n in zip(prompts, (3, 5))]
        reqs = dict(zip(rids, b.slot_req))
        while any(s is not None for s in b.slot_req):
            b.step()
            if len(reqs) == 2 and None in b.slot_req:  # the third joins mid-flight
                r = b.add_request(prompts[2], max_new_tokens=4)
                reqs[r] = next(s for s in b.slot_req if s is not None and s.rid == r)
        toks = [reqs[r].tokens for r in sorted(reqs)]
        outs[name] = (mega, toks, pb.prefix_cache_stats())
    assert outs["cuda"] == outs["cpu"]
    assert outs["cuda"][2]["hit_tokens"] == 128
    after = (model_fused.launches_paged, model_fused.launches_chunk, paged_attention.launches)
    assert all(a > b for a, b in zip(after, counts))


# ---------------------------------------------------------------------------
# the batched kernel's terminal lm rows (mode d), the multi-token flat decode
# (B10), and the speculative paths
# ---------------------------------------------------------------------------

def _lm_rows(dev, bits, V=200, seed=0):
    """Terminal lm rows on a symmetric packed lm_head of V outputs (200: not
    a multiple of the kernel's 32-column tiles) and a non-unit final norm."""
    lin = _linear(V, 512, bits, "per_group", 128, True, seed)
    zc = float(lin.w_zero.reshape(-1)[0]) - float(qrange(bits, True).qmin)
    fnorm = 1.0 + 0.1 * torch.randn(512, generator=torch.Generator().manual_seed(seed))
    lm = {"ue": lin.packed, "ues": dequant_matmul.kernel_tables(lin)[0], "fnorm": fnorm}
    return _to(lm, dev), (128, zc, V, 0)


# (slots, chunk, prefixes, paged): one-token dense and paged, chunk dense and paged
LM_CASES = [(1, 1, [0], False), (2, 1, [127, 128], False), (8, 1, POSITIONS * 2, False),
            (3, 1, [0, 130, 255], True), (1, 5, [100], False), (2, 4, [0, 127], False),
            (1, 5, [130], True), (2, 3, [126, 250], True)]


@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", BATCH_MODES)
@pytest.mark.parametrize("n_slots,C,prefixes,paged", LM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_decode_mega_batch_lm_rows(dev, bits, symmetric, head_dim, inter, group, n_slots,
                                         C, prefixes, paged, dtype):
    """Mode (d) with each mode it composes with: the base outputs bitwise
    equal to the same launch without the lm rows; a second launch bit for
    bit; logits against the plain version; tokens the first index of the
    kernel's own maximum, and equal to the plain version's (in bf16 where
    the plain top-2 gap exceeds the tolerance)."""
    cfg, _, stack, meta = _stacked(dev, bits, symmetric, head_dim, inter, group, C + 40)
    lm, lm_meta = _lm_rows(dev, bits, seed=n_slots + C)
    B = n_slots * C
    cache = _slot_caches(cfg, prefixes, T_MEGA, seed=C)
    table = None
    if paged:
        cache, table = _mirror_pool(cache, seed=C)
    cache = _to(cache, dev)
    positions = [p + i for p in prefixes for i in range(C)]
    x = torch.randn(B, 1, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(B)).to(dev, dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    args = (stack, x, cos.reshape(B, -1), sin.reshape(B, -1), cache, positions, cfg, meta)
    base = model_fused.model_decode_mega_batch(*args, table=table, chunk=C)
    before = model_fused.launches_lm
    got = model_fused.model_decode_mega_batch(*args, table=table, chunk=C, lm=lm, lm_meta=lm_meta)
    assert model_fused.launches_lm == before + 1
    for b, g in zip(base, got[:5]):
        assert torch.equal(b, g)
    _same_bits(got, model_fused.model_decode_mega_batch(*args, table=table, chunk=C, lm=lm,
                                                        lm_meta=lm_meta))
    ref_fn = lambda: model_fused.model_decode_mega_batch_ref(*args, table, C, lm, lm_meta)
    assert got[6].tolist() == torch.argmax(got[5], -1).tolist()
    if dtype == torch.float32:
        ref = _plain(ref_fn, got)
        _close(got[5], ref[5])
        assert got[6].tolist() == ref[6].tolist()
        return
    ref = ref_fn()
    _close(got[5], ref[5], BF16_TOL)
    top2 = torch.topk(ref[5].float(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1] > BF16_TOL * float(ref[5].abs().max())).tolist()
    assert [t for t, c in zip(got[6].tolist(), clear) if c] == \
        [t for t, c in zip(ref[6].tolist(), clear) if c]


def _seg_args(dev, bits, head_dim, kseg, dtype=torch.float32, hidden=512, group=128, inter=1024,
              seed=None):
    """The multi-token flat decode's arguments on the card tests' small model
    (3 layers), from position 150 of a random int8 history."""
    cfg, _, gpu = _small(dev, bits=bits, groupsize=group, head_dim=head_dim, layers=3,
                         seed=8 + kseg if seed is None else seed, dtype=dtype, hidden=hidden,
                         inter=inter)
    fstack, fmeta = stack_flat(gpu)
    T, pos0 = 256, 150
    cache = stack_cache_flat([_to(_cache(cfg, T, pos0, seed=l), dev) for l in range(3)])
    x = llama.embed(gpu.params, torch.tensor([[9]], device=dev))
    cos, sin = llama.rope_tables(cfg, pos0 + torch.arange(kseg, device=dev))
    return (fstack, gpu.params["embed"], x, torch.cat([cos, sin], -1), cache, pos0, cfg, fmeta,
            kseg)


def _flat_chain(flat, fstack, emb, x, cossin, cache, pos0, cfg, fmeta, kseg):
    """kseg one-token flat decodes (`flat`: model_decode_flat or its plain
    version), each token's rows scattered into a copy of the cache before
    the next and the next input its winner's embedding row: what the
    multi-token decode computes in one launch. Returns (tokens, rows,
    scales, each token's logits)."""
    work = {f: t.clone() for f, t in cache.items()}
    out = ([], [], [], [])
    for t in range(kseg):
        tok, logits, kv, sc = flat(fstack, x, cossin[t], work, pos0 + t, cfg, fmeta)
        work["kv"][:, pos0 + t] = kv
        work["kv_scale"][:, pos0 + t] = sc[:, :, 0]
        for o, v in zip(out, (tok, kv, sc[:, :, 0], logits[0])):
            o.append(v)
        x = emb[tok.long()].reshape(x.shape)
    return torch.cat(out[0]), torch.stack(out[1]), torch.stack(out[2]), torch.stack(out[3])


# (bits, head_dim, hidden, group, dtype, kseg): 4-bit (the tensor-core layer
# loop) and 8-bit (the CUDA-core decoder_layer) in both model dtypes at kseg
# 1, 3 and 5; and 4-bit at the narrowest widths the plan takes (hidden 64,
# one kv head of 32, g32), where each (token, layer)'s scales are 8 bytes and
# 16 of them share a 128-byte line: a copy of a segment row or scale through
# L1 could read a line another block is writing
SEG_CASES = [(b, d, 512, 128, dt, k) for b, d in ((4, 128), (8, 64))
             for dt in (torch.float32, torch.bfloat16) for k in (1, 3, 5)] + [
    (4, 32, 64, 32, dt, 5) for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("bits,head_dim,hidden,group,dtype,kseg", SEG_CASES)
def test_model_decode_flat_seg(dev, bits, head_dim, hidden, group, dtype, kseg):
    """B10 against its plain version: a second launch bit for bit; with
    4-bit words the tokens, rows and scales of kseg one-token flat launches
    with the rows scattered between them, bit for bit. float32: kseg tokens
    equal, every token's rows up to tie flips (`_rows_match`), scales to
    1e-5. bfloat16 (B3's bf16 bounds, `test_model_decode_flat`): each
    token's rows within one code and scales to 1e-3, and the token equal
    where the plain version's top two logits lie more than BF16_TOL apart;
    after a token that differs the later ones follow other inputs and are
    not compared. The segment's history: cache rows before pos0 and the
    launch's own earlier rows."""
    args = _seg_args(dev, bits, head_dim, kseg, dtype, hidden, group,
                     inter=128 if hidden == 64 else 1024)
    before = model_flat_seg.launches
    got = model_flat_seg.model_decode_flat_seg(*args)
    _same_bits(got, model_flat_seg.model_decode_flat_seg(*args))
    assert model_flat_seg.launches == before + 2
    if bits == 4:
        flat_before = model_flat.launches
        chain = _flat_chain(model_flat.model_decode_flat, *args)
        assert model_flat.launches == flat_before + kseg
        _same_bits(got, chain[:3])
    if dtype == torch.float32:
        ref = model_flat_seg.model_decode_flat_seg_ref(*args)
        assert got[0].tolist() == ref[0].tolist()
        _rows_match(got[1], ref[1])
        _close(got[2], ref[2], 1e-5)
        return
    ref = _flat_chain(model_flat.model_decode_flat_ref, *args)
    for t in range(kseg):
        assert int((got[1][t].int() - ref[1][t].int()).abs().max()) <= 1
        _close(got[2][t], ref[2][t], 1e-3)
        top2 = torch.topk(ref[3][t].float(), 2).values
        if int(got[0][t]) != int(ref[0][t]):
            assert float(top2[0] - top2[1]) <= BF16_TOL * float(ref[3][t].abs().max())
            break


@pytest.mark.parametrize("short", [None, "partials", "splits", "lm_head"])
def test_model_decode_flat_seg_plan(dev, monkeypatch, short):
    """The multi-token kernel takes the one-token kernel's plan, checked by
    the same launch check: with o_proj split in 4, gate/up in 2 and
    down_proj in 3 a kseg = 5 launch repeats its bits, gives the one-token
    kernel's chain under the same plan bit for bit and the plain version's
    tokens; partials one float short of the plan's, a split with no group
    (o_proj in groups + 1) or a split lm_head are refused before anything
    runs, and no launch is counted."""
    plans, sizes = model_flat.flat_plans, model_flat.flat_scratch
    force = {None: {1: 4, 2: 2, 3: 3}, "partials": {1: 4, 2: 2, 3: 3}, "splits": {1: 5},
             "lm_head": {4: 2}}
    monkeypatch.setattr(model_flat, "flat_plans", lambda *a: [
        pl[:4] + (force[short].get(i, pl[4]),) for i, pl in enumerate(plans(*a))])
    cut = 1 if short == "partials" else 0
    monkeypatch.setattr(model_flat, "flat_scratch", lambda pl: (sizes(pl)[0] - cut, sizes(pl)[1]))
    args = _seg_args(dev, 4, 128, 5, seed=30)  # 512 inputs of o_proj: 4 groups
    before = model_flat_seg.launches
    if short is not None:
        with pytest.raises(RuntimeError, match="cudaError"):
            model_flat_seg.model_decode_flat_seg(*args)
        assert model_flat_seg.launches == before
        return
    got = model_flat_seg.model_decode_flat_seg(*args)
    _same_bits(got, model_flat_seg.model_decode_flat_seg(*args))
    assert model_flat_seg.launches == before + 2
    _same_bits(got, _flat_chain(model_flat.model_decode_flat, *args)[:3])
    ref = model_flat_seg.model_decode_flat_seg_ref(*args)
    assert got[0].tolist() == ref[0].tolist()
    _rows_match(got[1], ref[1])
    _close(got[2], ref[2], 1e-5)


def test_speculative_paths_match_the_cpu(dev):
    """A planted pair (2-layer target, 1-layer draft disagreeing on 30% of
    its map) on the card against the plain versions on the CPU: the
    scan-flat route at k = 3 (fused lm rows) and k = "auto" (the split C = 9
    verify), decode_loop_flat_seg, SpeculativeBatcher and
    PagedSpeculativeBatcher at 4 slots and k = 3: tokens and stats equal."""
    # V = 256: the fused lm rows need a 128-aligned divisor of the vocab (stack_lm)
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    t, d, m_t, _ = planted_pair(cfg, draft_layers=1, disagree_frac=0.3, dtype=torch.float32,
                                device="cpu")
    prompt = np.array([[9, 77]])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, (int(n),)) for n in rng.integers(8, 140, 6)]
    counts = (model_fused.launches_lm, model_flat_seg.launches)
    outs = {}
    for name, (tm, dm) in (("cpu", (t, d)), ("cuda", (_to(t.params, dev), _to(d.params, dev)))):
        if name == "cuda":
            tm = Model(config=cfg, params=tm)
            dm = Model(config=dataclasses.replace(cfg, num_layers=1), params=dm)
        tm, dm = fuse_for_serving(tm), fuse_for_serving(dm)
        res = [speculative_generate(tm, dm, prompt, max_new_tokens=n, k=k,
                                    cache_dtype=torch.int8, draft_megakernel=True)
               for k, n in ((3, 20), ("auto", 60))]
        res = [(o.tolist(), st) for o, st in res]
        fstack, fmeta = stack_flat(dm)
        dd = dm.params["embed"].device
        log, cache = engine.prefill(dm.params, dm.config, torch.as_tensor(prompt, device=dd),
                                    engine.init_cache(dm.config, 1, 128, torch.int8, device=dd))
        seg, _ = decode_loop_flat_seg(dm.params, fstack, fmeta, dm.config,
                                      torch.argmax(log, -1)[:, None], stack_cache_flat(cache), 2,
                                      10, kseg=5)
        res.append(seg.cpu().tolist())
        for make in (lambda: SpeculativeBatcher(tm, dm, k=3, n_slots=4, max_len=256,
                                                cache_dtype=torch.int8, use_megakernel=True,
                                                use_draft_megakernel=True),
                     lambda: PagedSpeculativeBatcher(tm, dm, k=3, n_slots=4, max_len=256)):
            b = make()
            res.append((b.run_all(list(prompts), max_new_tokens=8), b.rounds, b.accepted))
        outs[name] = res
    assert outs["cuda"] == outs["cpu"]
    assert all(c1 > c0 for c0, c1 in zip(counts, (model_fused.launches_lm,
                                                   model_flat_seg.launches)))


def test_spec_batchers_random_weights_match_the_cpu(dev):
    """Both speculative batchers on random weights (a 2-layer target and its
    first layer as the draft), where the tokens and the accept stats depend
    on attention over every cache: 4 slots, k = 3, the dense batcher without
    and with the fused lm rows, the paged one in verify waves of 2 slots and
    of 3 (a padded short wave) with the lm rows, and the paged one with the
    target as its own draft. Prompts of 110-135 tokens: the rows cross the
    128-row page. On the card against the plain versions on the CPU: tokens
    and stats equal."""
    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    p = build_quantized_llama(cfg, dtype=torch.float32, seed=8, device="cpu")
    gen = torch.Generator().manual_seed(8)
    for blk in p["layers"]:
        for k in ("input_norm", "post_norm"):
            blk[k] = 1.0 + 0.1 * torch.randn(cfg.hidden_size, generator=gen)
    dp = {**p, "layers": p["layers"][:1]}
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, (int(n),)) for n in rng.integers(110, 136, 6)]
    makes = {
        "dense": lambda t, d: SpeculativeBatcher(t, d, k=3, n_slots=4, max_len=256,
                                                 cache_dtype=torch.int8, use_megakernel=True,
                                                 use_draft_megakernel=True),
        "dense-lm": lambda t, d: SpeculativeBatcher(t, d, k=3, n_slots=4, max_len=256,
                                                    cache_dtype=torch.int8, use_megakernel=True,
                                                    use_draft_megakernel=True, fused_lm=True),
        "paged": lambda t, d: PagedSpeculativeBatcher(t, d, k=3, n_slots=4, max_len=256),
        "paged-wave3-lm": lambda t, d: PagedSpeculativeBatcher(t, d, k=3, n_slots=4, max_len=256,
                                                               verify_wave_slots=3,
                                                               fused_lm=True),
        # the target as its own draft: every proposal accepted while the
        # draft's cache holds every accepted row
        "paged-self": lambda t, d: PagedSpeculativeBatcher(t, t, k=3, n_slots=4, max_len=256)}
    lm0 = model_fused.launches_lm
    outs = {}
    for name in ("cpu", "cuda"):
        d = "cpu" if name == "cpu" else dev
        # _to makes new linears: the draft's stack does not rebind the target's
        tm = fuse_for_serving(Model(config=cfg, params=_to(p, d)))
        dm = fuse_for_serving(Model(config=dataclasses.replace(cfg, num_layers=1),
                                    params=_to(dp, d)))
        outs[name] = {}
        for key, make in makes.items():
            b = make(tm, dm)
            outs[name][key] = (b.run_all(list(prompts), max_new_tokens=12), b.rounds,
                               b.proposed, b.accepted)
    assert outs["cuda"] == outs["cpu"]
    runs = outs["cuda"]
    assert all(r[0] == runs["dense"][0] for r in runs.values())     # the same tokens
    assert all(r[1:] == runs["dense"][1:] for k, r in runs.items() if k != "paged-self")
    _, _, proposed, accepted = runs["dense"]
    assert 0 < accepted < proposed
    assert runs["paged-self"][2] == runs["paged-self"][3]
    assert model_fused.launches_lm > lm0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,T,pos", [
    (32, 32, 128, 384, 200), (32, 32, 128, 2048, 2047), (4, 2, 128, 64, 0), (4, 2, 64, 96, 63),
    (8, 2, 32, 40, 17), (4, 4, 16, 24, 23), (2, 1, 256, 50, 9),
    # on and next to the split's chunk boundaries (chunks of 32 rows up to 16
    # chunks, 64 from position 512: decode_attention.split_plan)
    (32, 32, 128, 384, 63), (32, 32, 128, 384, 64), (32, 32, 128, 384, 65),
    (32, 32, 128, 384, 127), (32, 32, 128, 384, 128), (8, 2, 256, 300, 192),
    (32, 32, 128, 1024, 511), (32, 32, 128, 1024, 512),
    # Llama-2-7B's full context; Mistral-7B's groups of 4; a group of 12 in two items
    (32, 32, 128, 4096, 4095), (32, 8, 128, 2048, 2047), (32, 8, 128, 384, 200),
    (12, 1, 128, 200, 130), (4, 4, 20, 72, 70)])
def test_decode_attention(dev, dtype, H, Hkv, D, T, pos):
    """The new row's codes and scales bit-equal to the plain version's, the
    history untouched, the output to RTOL; then, over a fresh copy of the
    cache with NaN in the scales of every row t > pos (rows the split must
    never read), a second launch gives the same bits."""
    g = torch.Generator().manual_seed(T + pos + D)
    q = torch.randn(1, H * D, generator=g).to(dtype).to(dev)
    k = (2 * torch.randn(1, Hkv * D, generator=g)).to(dtype).to(dev)
    v = torch.randn(1, Hkv * D, generator=g).to(dtype).to(dev)
    cache = _to(_cache(LlamaConfig(num_kv_heads=Hkv, head_dim=D), T, pos, seed=pos), dev)
    ang = pos / (10000.0 ** (torch.arange(0, D, 2, dtype=torch.float64) / D))
    cos = torch.cos(torch.cat([ang, ang])).float().to(dev)
    sin = torch.sin(torch.cat([ang, ang])).float().to(dev)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)
    fields = ("k", "v", "k_scale", "v_scale")
    mine = [cache[f][0].clone() for f in fields]
    plain = [cache[f][0].clone() for f in fields]
    again = [cache[f][0].clone() for f in fields]
    for t in again[2:]:
        t[pos + 1:] = float("nan")
    before = decode_attention.launches
    out = decode_attention.fused_decode_attention(q, k, v, cos, sin, *mine, pos, **kw)[0]
    ref = decode_attention.fused_decode_attention_ref(q, k, v, cos, sin, *plain, pos, **kw)[0]
    out2 = decode_attention.fused_decode_attention(q, k, v, cos, sin, *again, pos, **kw)[0]
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2 and out.dtype == torch.float32
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    _close(out, ref)
    assert torch.equal(out2, out)
    for a, b in zip(again, mine):
        assert torch.equal(a[:pos + 1], b[:pos + 1])


def _mlp_lins(dev, bits, groupsize, down_qtype, K=256, inter=512, seed=0):
    mk = lambda o, i, qtype, s: _to(_linear(o, i, bits, qtype, groupsize, False, seed + s), dev)
    qtype = "per_group" if groupsize > 0 else "per_channel"
    return (mk(inter, K, qtype, 0), mk(inter, K, qtype, 1),
            mk(K, inter, down_qtype if down_qtype else qtype, 2))


def _check_mlp(dev, lins, M, K, inter, dtype, seed):
    """Two calls of mlp_apply_fused on the same x: one launch each on the
    route `mlp_fused.route` names, the same bits, within RTOL (f32) or 2e-2
    (bf16) of max|plain| of the plain version."""
    cfg = LlamaConfig(hidden_size=K, intermediate_size=inter)
    x = torch.randn(M, K, generator=torch.Generator().manual_seed(seed)).to(dtype).to(dev)
    gk, ik = group_size(lins[0]), group_size(lins[2])
    counter = mlp_fused.COUNTERS[mlp_fused.route(M, dtype, lins[0].spec.wbit, gk, ik)]
    before = (mlp_fused.launches, getattr(mlp_fused, counter))
    y = mlp_fused.mlp_apply_fused(x, *lins, cfg)
    y2 = mlp_fused.mlp_apply_fused(x, *lins, cfg)
    assert (mlp_fused.launches, getattr(mlp_fused, counter)) == tuple(b + 2 for b in before)
    assert y.dtype == dtype and y.shape == (M, K)
    assert torch.equal(y, y2)
    tabs = [t for lin in lins for t in (lin.packed, *dequant_matmul.zero_tables(lin))]
    ref = mlp_fused.fused_mlp_ref(x, *tabs, bits=lins[0].spec.wbit, k_group=gk, i_group=ik,
                                  qmin=0, inter=inter, hidden=K)
    _close(y, ref, RTOL if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,groupsize,down_qtype", [
    (4, 128, None), (4, 64, None), (8, 128, None), (2, 64, None), (4, -1, None),
    (4, 128, "per_channel")])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 16, 64, 130, 2048])
def test_mlp_fused(dev, dtype, bits, groupsize, down_qtype, M):
    """The fused MLP against its plain version (asymmetric grids: a zero per
    group); two launches give the same bits. bf16 int4 takes the
    tensor-core routes ("gemv" at M <= 8, "mma" above), the rest the
    CUDA-core kernels."""
    K, inter = 256, 512
    lins = _mlp_lins(dev, bits, groupsize, down_qtype, K, inter, seed=M + bits)
    # the reference's predicate: per-channel down groups are wider than its tile
    assert mlp_fused.mlp_supported(*lins, K, inter) == (down_qtype is None and groupsize > 0)
    _check_mlp(dev, lins, M, K, inter, dtype, M)


@pytest.mark.parametrize("M,K,inter,groupsize", [(200, 1024, 1408, 128), (40, 1024, 1408, 128)])
def test_mlp_fused_ragged_split(dev, M, K, inter, groupsize):
    """bf16 int4 "mma" route whose down phase splits I's 11 groups into 8
    splits of one or two groups (M = 200, [128, 128] tiles), and into 11
    (M = 40, [64, 128] tiles)."""
    assert mlp_fused.mma_plan(M, K, inter, groupsize) == ((True, 8) if M > 128 else (False, 11))
    lins = _mlp_lins(dev, 4, groupsize, None, K, inter, seed=M)
    _check_mlp(dev, lins, M, K, inter, torch.bfloat16, M)


@pytest.mark.parametrize("M", [1, 128])
@pytest.mark.parametrize("symmetric", [True, False])
def test_mlp_fused_7b_widths(dev, M, symmetric):
    """The tensor-core routes at Llama-2-7B's MLP widths, int4 g128, bf16."""
    K, inter = 4096, 11008
    lins = tuple(_to(_linear(o, i, 4, "per_group", 128, symmetric, seed=s), dev)
                 for s, (o, i) in enumerate(((inter, K), (inter, K), (K, inter))))
    _check_mlp(dev, lins, M, K, inter, torch.bfloat16, M)


@pytest.mark.parametrize("M,N,K,groupsize", [
    (32, 128, 256, 32), (40, 200, 384, 128), (128, 96, 512, -1), (1, 64, 128, 128),
    (130, 256, 11008 // 8, -1), (77, 64, 4096, 128), (33, 4096, 4096, 128),
    (2048, 4096, 4096, 128), (2048, 11008, 4096, -1), (2048, 200, 11008, 128)])
def test_w4a8_matmul(dev, M, N, K, groupsize):
    """The integer product bit-equal to its plain version (exact group sums,
    scaled and added in order), symmetric and asymmetric zeros."""
    for symmetric in (True, False):
        qtype = "per_group" if groupsize > 0 else "per_channel"
        lin = _to(_linear(N, K, 4, qtype, groupsize, symmetric, seed=M + K), dev)
        st, zt = dequant_matmul.zero_tables(lin)
        xi = torch.randint(-128, 128, (M, K), generator=torch.Generator().manual_seed(M))
        xi = xi.to(torch.int8).to(dev)
        kw = dict(bits=4, groupsize=groupsize, qmin=0)
        before = w4a8_matmul.launches
        got = w4a8_matmul.w4a8_matmul_int(xi, lin.packed, st, zt, **kw)
        ref = w4a8_matmul.w4a8_matmul_int_ref(xi, lin.packed, st, zt, **kw)
        torch.cuda.synchronize()
        assert w4a8_matmul.launches == before + 1
        assert torch.equal(got, ref)


def test_quantizers_match_the_cpu(dev):
    """The W4A8 activation grid (exact quotients) and the int8 KV rows
    (scale amax * f32(1/127)) give the same bits on the card as on the CPU:
    PyTorch on the GPU divides by a Python number as a multiply by its
    reciprocal, so both are written to not depend on that."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 4096, generator=g) * torch.rand(64, 1, generator=g) * 10
    for qtype in ("per_token", "per_tensor"):
        xi_c, sx_c = w4a8_matmul.quantize_activations(x, qtype)
        xi_g, sx_g = w4a8_matmul.quantize_activations(x.to(dev), qtype)
        assert torch.equal(xi_c, xi_g.cpu()) and torch.equal(sx_c, sx_g.cpu())
    kv = x.reshape(1, 64, 32, 128)
    for a, b in zip(llama.quantize_kv(kv), llama.quantize_kv(kv.to(dev))):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("symmetric", [False, True])
def test_find_qparams_matches_the_cpu(dev, symmetric):
    """int4 g128 weight scales and zeros made on the card equal the CPU's
    (and so the reference's exact quotients) bit for bit."""
    w = torch.randn(4096, 4096, generator=torch.Generator().manual_seed(0)) * 0.02
    cpu = qparams.quantize_dequantize(w, 4, "per_group", 128, symmetric)
    card = qparams.quantize_dequantize(w.to(dev), 4, "per_group", 128, symmetric)
    for a, b in zip(cpu[1:], card[1:]):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("w4a8", [False, True])
def test_unfused_path_matches_the_cpu(dev, monkeypatch, w4a8):
    """An unfused small f32 model (separate q/k/v and gate/up): generate
    with the int8 cache (a 40-token prompt) and compute_ppl, on the card
    (decode attention and fused MLP, or the W4A8 integer product) and on the
    CPU with the same branches forced through the plain versions. Tokens
    equal, perplexity to 1e-4 relative (W4A8: the activation codes may flip
    at rounding boundaries with the sums' order, 1e-3)."""
    monkeypatch.setenv("MI_W4A8_INT", "1")
    cfg = LlamaConfig(vocab_size=160, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    p = build_quantized_llama(cfg, dtype=torch.float32, seed=3, device="cpu")
    if w4a8:
        p = with_w4a8(p)
    models = {"cpu": Model(config=cfg, params=p), "cuda": Model(config=cfg, params=_to(p, dev))}
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 40))
    batches = [np.random.default_rng(6 + i).integers(0, cfg.vocab_size, (2, 64))
               for i in range(2)]
    counts = (decode_attention.launches, mlp_fused.launches, w4a8_matmul.launches)
    out = {}
    for d, m in models.items():
        if d == "cpu":
            monkeypatch.setattr(llama, "kernel_branches", lambda x: True)
        out[d] = (engine.generate(m, prompt, max_new_tokens=6, cache_dtype=torch.int8),
                  compute_ppl(m, batches))
    delta = (decode_attention.launches - counts[0], mlp_fused.launches - counts[1],
             w4a8_matmul.launches - counts[2])
    L = cfg.num_layers
    assert delta == ((6 * L, 0, 7 * L + 2 * 7 * L) if w4a8 else (6 * L, 7 * L + 2 * L, 0))
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-3 if w4a8 else 1e-4)
