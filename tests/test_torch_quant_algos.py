"""The port's other quantization algorithms (AWQ, SmoothQuant, ZeroQuant,
FP8, SpQR, QuIP, AWQ+GPTQ, SmoothQuant+GPTQ) and the W8A8 and fp8-activation
routes against the JAX package on the same numpy inputs, on the CPU.

Tolerances:
  * bit-equal: AWQ's pseudo_quantize, SmoothQuant's absmax fake-quant and
    ZeroQuant's linear (words, scales, zeros) against JAX's jitted qparams
    (run op by op, JAX's exact_div is one ulp off the true quotient for a
    few percent of inputs; tests/test_torch_quant.py), FP8's grid on every
    bf16 bit pattern at three scales: E4M3 against JAX's as it is, E5M2
    against JAX's with `jnp.exp2` at exact powers of two (JAX's CPU exp2 is
    not exact at some integer arguments, and the port's grid is the fp8
    value set: every value where the two differ is off that set in JAX's
    and on it in the port's), the native float8 weights dequantized against
    the fake-quantized ones;
  * smooth scales (SmoothQuant's, AWQ's chosen candidate) within 5e-7 of
    their largest magnitude (a few ulps: the port's powers are correctly
    rounded and its means summed in float64, XLA's CPU pow and mean differ
    from those in the last bits at times);
  * AWQ's ratio and clip searches: the same indices;
  * w8a8_matmul within 1e-6 relative, its int32 sums exactly numpy's;
  * spqr_quantize_matrix and quip_quantize_matrix from the same W and H
    (and U and V): at least 99.9% of the codes equal, each off by at most
    one; SpQR's outlier positions and count and average bits equal; QuIP's
    LDL rounding from the same inputs bit-equal; rand_ortho_butterfly
    bit-equal;
  * the reference's end-to-end tests (tests/test_awq_combos.py,
    tests/test_spqr_quip.py, tests/test_quantize_e2e.py's SmoothQuant,
    ZeroQuant and FP8 cases) on the JAX tiny Llama carried across by
    convert.from_jax_params: the port's perplexity within 1% of JAX's; each
    linear's codes (fake-quantized weights where unpacked) at least 99.9%
    equal to JAX's when the port's algorithm is given the stats JAX's saw
    (`_replay`), and layer by layer in the port's own pipeline where no
    GPTQ runs. The GPTQ-based combos turn a last-bit difference of their
    Hessian into flipped codes at rounding ties (tests/test_torch_quant.py),
    so their own pipelines hold 99% of each layer's codes."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mi_optimize_tpu as mt
import mi_optimize_tpu_torch as pt
from mi_optimize_tpu.core import qparams as jqparams
from mi_optimize_tpu.eval.ppl import compute_ppl as jax_ppl
from mi_optimize_tpu.models.llama import GROUP_ORDER
from mi_optimize_tpu.models.quant_linear import QuantizedLinear as JQuantizedLinear
from mi_optimize_tpu.models.quant_linear import QuantSpec as JQuantSpec
from mi_optimize_tpu.quant import awq_impl as jawq
from mi_optimize_tpu.quant import base as jbase
from mi_optimize_tpu.quant import combos as jcombos  # noqa: F401  (registers)
from mi_optimize_tpu.quant import fp8 as jfp8
from mi_optimize_tpu.quant import quip_impl as jquip
from mi_optimize_tpu.quant import smoothquant as jsq
from mi_optimize_tpu.quant import spqr_impl as jspqr
from mi_optimize_tpu.quant import zeroquant as jzq
from mi_optimize_tpu.quant.config import QuantConfig as JQuantConfig
from mi_optimize_tpu.ops.int8_matmul import w8a8_matmul as jax_w8a8
from mi_optimize_tpu_torch.convert import linear_from_jax
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models.quant_linear import QuantSpec, dequant_weight
from mi_optimize_tpu_torch.ops import int8_matmul
from mi_optimize_tpu_torch.quant import awq_impl, fp8, get_algo, quip_impl, smoothquant, spqr_impl
from mi_optimize_tpu_torch.quant.config import QuantConfig
from tests.test_quantize_e2e import make_model_and_data
from tests.test_torch_convert import jax_tree, port_model
from tests.test_torch_quant import _codes, _w_h

LINEARS = [n for g in GROUP_ORDER for n in g]
SMOOTH_RTOL = 5e-7
CODE_SHARE = 0.999


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _fp_weights(out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((out_f, in_f)) * in_f ** -0.5).astype(np.float32)


def _jit_qd():
    return jax.jit(jqparams.quantize_dequantize, static_argnums=(1, 2, 3),
                   static_argnames=("symmetric", "unsigned"))


def assert_codes_close(got, want, what="", share=CODE_SHARE):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 1, f"{what}: a code differs by {diff.max()}"
    assert (diff == 0).mean() >= share, f"{what}: {(diff == 0).mean():.5f} of codes equal"


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("bits,groupsize", [(3, 16), (4, 128), (4, -1), (8, 64)])
def test_pseudo_quantize_bit_equal(bits, groupsize, zero_point):
    w = _fp_weights(96, 256, bits) * np.float32(3.0)
    w[0] = 0.0       # the 1e-5 floors
    f = jax.jit(jawq.pseudo_quantize, static_argnums=(1, 2, 3, 4))
    jdq, js, jz = (np.asarray(a) for a in f(jnp.asarray(w), bits, zero_point, groupsize, True))
    tdq, ts, tz = awq_impl.pseudo_quantize(_t(w), bits, zero_point, groupsize,
                                           return_qparams=True)
    for got, want in ((tdq, jdq), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(got.numpy(), want)


def _awq_inputs(oc, ci, nt, seed):
    rng = np.random.default_rng(seed)
    w = _fp_weights(oc, ci, seed)
    x = (rng.standard_normal((nt, ci)) * rng.uniform(0.2, 5.0, ci)).astype(np.float32)
    x[:, :4] *= 20.0  # a few salient channels
    return w, x, (np.abs(x).sum(0) / nt).astype(np.float32)


AWQ_CASES = [(96, 256, 300, 128, 4), (128, 512, 700, 64, 4), (64, 256, 128, 16, 3)]


@pytest.mark.parametrize("oc,ci,nt,g,bits", AWQ_CASES)
def test_awq_searches_pick_jax_indices(oc, ci, nt, g, bits):
    """The ratio search's index (JAX returns the chosen scales: its index is
    the port's candidate nearest to them, within SMOOTH_RTOL) and the clip
    search's per-[oc, group] indices (its values bit-equal)."""
    w, x, xma = _awq_inputs(oc, ci, nt, oc + nt)
    kw = dict(n_bit=bits, groupsize=g, zero_point=True, n_grid=20)
    js = np.asarray(jawq.auto_scale_search(jnp.asarray(w), jnp.asarray(x), jnp.asarray(xma), **kw))
    losses, scales = awq_impl.scale_losses(_t(w), _t(x), _t(xma), **kw)
    rel = [float(np.abs(s - js).max() / np.abs(js).max()) for s in scales.numpy()]
    best = int(awq_impl._first_within_eps(losses))
    assert best == int(np.argmin(rel)) and rel[best] <= SMOOTH_RTOL, (best, rel)
    ts = awq_impl.auto_scale_search(_t(w), _t(x), _t(xma), **kw)
    torch.testing.assert_close(ts, scales[best], rtol=0, atol=0)
    # the clip search on JAX's smoothed weights and first token
    Q, xs = w * js[None], (x / js[None])[:1]
    jc = np.asarray(jawq.auto_clip_search(jnp.asarray(Q), jnp.asarray(xs), max_shrink=0.5, **kw))
    errs, mvs = awq_impl.clip_errors(_t(Q), _t(xs), max_shrink=0.5, **kw)
    jidx = np.argmin(np.abs(mvs.numpy() - jc[None]), axis=0)
    np.testing.assert_array_equal(awq_impl._first_within_eps(errs).numpy(), jidx)
    np.testing.assert_array_equal(awq_impl.auto_clip_search(_t(Q), _t(xs), max_shrink=0.5,
                                                            **kw).numpy(), jc)


def test_first_within_eps_takes_the_earliest_near_minimum():
    errs = torch.tensor([[3.0, 1.0], [1.000005, 2.0], [1.0, 1.0], [0.5, 1.0000001]])
    np.testing.assert_array_equal(awq_impl._first_within_eps(errs).numpy(),
                                  np.asarray(jawq._first_within_eps(jnp.asarray(errs.numpy()))))
    assert awq_impl._first_within_eps(errs).tolist() == [3, 0]


# ---------------------------------------------------------------------------
# SmoothQuant, ZeroQuant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_smooth_scales_match_jax(alpha):
    w = _fp_weights(128, 256, 3)
    act = np.random.default_rng(4).uniform(0.01, 30.0, 256).astype(np.float32)
    act[:3] = 0.0    # the 1e-5 floor
    want = np.asarray(jsq.smooth_scales(jnp.asarray(w), jnp.asarray(act), alpha))
    np.testing.assert_allclose(smoothquant.smooth_scales(_t(w), _t(act), alpha).numpy(), want,
                               rtol=SMOOTH_RTOL, atol=0)


@pytest.mark.parametrize("qtype,groupsize", [("per_channel", -1), ("per_group", 64),
                                             ("per_tensor", -1)])
@pytest.mark.parametrize("bits", [4, 8])
def test_absmax_fake_quant_weight_bit_equal(bits, qtype, groupsize):
    w = _fp_weights(64, 256, bits) * np.float32(2.0)
    with mock.patch.object(jsq.qparams, "quantize_dequantize", _jit_qd()):
        want = jsq.absmax_fake_quant_weight(jnp.asarray(w), bits, qtype, groupsize)
    got = smoothquant.absmax_fake_quant_weight(_t(w), bits, qtype, groupsize)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("w_unsign", [True, False])
@pytest.mark.parametrize("wbit,groupsize", [("int8", 16), ("int8", -1), ("int4", 64)])
def test_zeroquant_linear_bit_equal(wbit, groupsize, w_unsign):
    kw = dict(algo="zeroquant", wbit=wbit, abit="int8", w_groupsize=groupsize, w_unsign=w_unsign)
    w = _fp_weights(96, 256, 5)
    with mock.patch.object(jzq.qparams, "quantize_dequantize", _jit_qd()):
        jq = jzq.ZeroQuantAlgo(JQuantConfig(**kw)).quantize_linear(
            JQuantizedLinear.fp(jnp.asarray(w)), {})
    tq = get_algo("zeroquant", QuantConfig(**kw)).quantize_linear(
        pt.QuantizedLinear.fp(_t(w)), {})
    assert tq.spec == linear_from_jax(jax_tree(jq), "cpu").spec
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed).view(np.int32))
    np.testing.assert_array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale))
    np.testing.assert_array_equal(tq.w_zero.numpy(), np.asarray(jq.w_zero))


# ---------------------------------------------------------------------------
# FP8
# ---------------------------------------------------------------------------

def _bf16_patterns():
    v = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return np.abs(v[np.isfinite(v)])


def _exact_exp2(x):
    return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))


@pytest.mark.parametrize("scale", [1.0, 3.0, 1.0 / 7.0])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_grid_on_every_bf16_pattern(fmt, scale):
    with np.errstate(over="ignore"):
        ab = _bf16_patterns() * np.float32(scale)
    ab = ab[np.isfinite(ab)]
    got = fp8._fp8_grid(_t(ab), fmt).numpy()
    raw = np.asarray(jfp8._fp8_grid(jnp.asarray(ab), fmt))
    with mock.patch.object(jfp8.jnp, "exp2", _exact_exp2):
        exact = np.asarray(jfp8._fp8_grid(jnp.asarray(ab), fmt))
    np.testing.assert_array_equal(got.view(np.uint32), exact.view(np.uint32))
    f8 = ml_dtypes.float8_e4m3fn if fmt == "e4m3" else ml_dtypes.float8_e5m2
    np.testing.assert_array_equal(got.astype(f8).astype(np.float32), got)  # the fp8 value set
    off = got != raw
    if fmt == "e4m3":
        assert not off.any()
    else:  # where JAX's CPU exp2 is inexact: JAX's value off the e5m2 set
        assert off.any() and not (raw[off].astype(f8).astype(np.float32) == raw[off]).any()


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_quantize_value_and_activations_match_jax(fmt):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((8, 64)) * 3.0).astype(np.float32)
    x[0, :3] = [0.0, np.inf, np.nan]
    s = np.float32(240.0) / np.abs(x[1:]).max() if fmt == "e4m3" else np.float32(0.01)
    xa = x[1:]
    with mock.patch.object(jfp8.jnp, "exp2", _exact_exp2):  # a no-op for E4M3's exponents
        want = np.asarray(jfp8.fp8_quantize_value(jnp.asarray(x), jnp.float32(s), fmt))
        want_a = np.asarray(jfp8.fp8_fake_quant(jnp.asarray(xa), fmt))
    np.testing.assert_array_equal(fp8.fp8_quantize_value(_t(x), torch.tensor(s), fmt).numpy(),
                                  want)
    np.testing.assert_array_equal(fp8.fp8_fake_quant(_t(xa), fmt).numpy(), want_a)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_linear_native_storage(fmt):
    """The FP8 linear: its fake-quantized weights and scales JAX's (E4M3
    bit-equal; E5M2 up to JAX's inexact exp2), and the native float8
    weights dequantize to the fake-quantized ones bit for bit."""
    w = _fp_weights(64, 256, 7)
    cfg = dict(algo="fp8", wbit="int8", abit="int8", fp8_format=fmt)
    fake = get_algo("fp8", QuantConfig(**cfg, pack=False)).quantize_linear(
        pt.QuantizedLinear.fp(_t(w)), {})
    native = get_algo("fp8", QuantConfig(**cfg, pack=True)).quantize_linear(
        pt.QuantizedLinear.fp(_t(w)), {})
    assert native.weight.dtype == (torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2)
    np.testing.assert_array_equal(dequant_weight(native).numpy(), fake.weight.numpy())
    jalgo = jfp8.FP8Algo(JQuantConfig(**cfg, pack=False))
    with mock.patch.object(jfp8.jnp, "exp2", _exact_exp2):
        jl = jalgo.quantize_linear(JQuantizedLinear.fp(jnp.asarray(w)), {})
    np.testing.assert_array_equal(fake.weight.numpy(), np.asarray(jl.weight))
    np.testing.assert_array_equal(fake.w_scale.numpy(), np.asarray(jl.w_scale))
    assert fake.spec == linear_from_jax(jax_tree(jl), "cpu").spec


# ---------------------------------------------------------------------------
# the W8A8 route
# ---------------------------------------------------------------------------

def _w8_linear(out_f, in_f, qtype, unsigned, seed):
    w = jnp.asarray(_fp_weights(out_f, in_f, seed))
    fake, scale, zero = _jit_qd()(w, 8, qtype, -1, symmetric=True, unsigned=unsigned)
    ints = jqparams.quantize_to_int(fake, scale, zero, 8, qtype, -1, unsigned)
    from mi_optimize_tpu.core import packing as jpacking

    spec = JQuantSpec(wbit=8, abit=8, w_qtype=qtype, a_qtype="per_token", w_unsigned=unsigned,
                      a_unsigned=False, w_packed=True)
    return JQuantizedLinear(spec=spec, out_features=out_f, in_features=in_f,
                            packed=jpacking.pack_weight_device(ints, 8,
                                                               jqparams.qrange(8, unsigned)),
                            w_scale=scale, w_zero=zero)


@pytest.mark.parametrize("qtype,unsigned", [("per_channel", True), ("per_channel", False),
                                            ("per_tensor", False)])
@pytest.mark.parametrize("a_qtype", ["per_token", "per_tensor"])
@pytest.mark.parametrize("M", [1, 17, 64])
def test_w8a8_matmul_matches_jax(M, a_qtype, qtype, unsigned):
    jl = _w8_linear(96, 256, qtype, unsigned, seed=M)
    jl = jl.replace(spec=jl.spec.replace(a_qtype=a_qtype))
    tl = linear_from_jax(jax_tree(jl), "cpu")
    x = (np.random.default_rng(M).standard_normal((M, 256)) * 2.0).astype(np.float32)
    want = np.asarray(jax_w8a8(jnp.asarray(x), jl))
    got = int8_matmul.w8a8_matmul(_t(x), tl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the int32 sums, exact
    from mi_optimize_tpu_torch.ops.w4a8_matmul import quantize_activations

    xi, _ = quantize_activations(_t(x), a_qtype)
    wi8 = int8_matmul.weight_int8(tl)
    acc = int8_matmul.w8a8_matmul_int(xi, wi8)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), xi.numpy().astype(np.int64)
                                  @ wi8.numpy().astype(np.int64).T)


# ---------------------------------------------------------------------------
# SpQR and QuIP on one matrix
# ---------------------------------------------------------------------------

def _spqr_codes(Q, s, z, g, bits, qq_bits=3, qq_g=16):
    """(codes on the double-quantized grid, outlier mask) of SpQR's Q."""
    Q, s, z = _t(Q), _t(s), _t(z)
    o, c = Q.shape
    qs, qz = (torch.stack([spqr_impl._double_quant(v[:, k], qq_bits, qq_g)
                           for k in range(v.shape[1])], 1) for v in (s, z))
    Qg = Q.reshape(o, -1, g)
    codes = torch.clamp(torch.round(Qg / torch.clamp(qs, min=1e-9)[:, :, None] + qz[:, :, None]),
                        0, 2 ** bits - 1)
    on_grid = (codes - qz[:, :, None]) * qs[:, :, None]
    out = (on_grid - Qg).abs() > 1e-5 * qs[:, :, None].abs()
    return codes.reshape(o, c).numpy(), out.reshape(o, c).numpy()


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("shape", [(128, 256), (256, 512)])
def test_spqr_matrix_matches_jax(shape, bits):
    W, H = _w_h(*shape, seed=shape[0] + bits)
    kw = dict(bits=bits, blocksize=128, groupsize=16, qq_bits=3, qq_groupsize=16)
    jQ, js, jz, jn = jspqr.spqr_quantize_matrix(jnp.asarray(W), jnp.asarray(H), **kw)
    tQ, ts, tz, tn = spqr_impl.spqr_quantize_matrix(_t(W), _t(H), **kw)
    jc, jo = _spqr_codes(jQ, js, jz, 16, bits)
    tc, to = _spqr_codes(tQ, ts, tz, 16, bits)
    assert_codes_close(tc, jc, f"spqr {shape}")
    assert float(tn) == float(jn) > 0
    np.testing.assert_array_equal(to, jo)
    assert int(to.sum()) == int(float(tn))
    cfg = dict(algo="spqr", wbit=f"int{bits}", w_groupsize=16)
    assert spqr_impl.average_bits(QuantConfig(**cfg), float(tn), W.size) == \
        jspqr.average_bits(JQuantConfig(**cfg), float(jn), W.size)


@pytest.mark.parametrize("n", [12, 256, 344])
def test_rand_ortho_butterfly_matches_jax(n):
    got = quip_impl.rand_ortho_butterfly(np.random.default_rng(n), n)
    want = jquip.rand_ortho_butterfly(np.random.default_rng(n), n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got @ got.T, np.eye(n), atol=1e-4)


def _quip_pair(W, H, U, V, qfn):
    """(JAX's, the port's) (LDL input, H, codes) and fake-quantized weights."""
    caps = {}
    jorig, torig = jquip.round_ldl_gptqequiv, quip_impl.round_ldl_gptqequiv

    def jspy(w, H, nbits, blocksize=128):
        out = jorig(w, H, nbits, blocksize=blocksize)
        caps["jax"] = (np.asarray(w), np.asarray(H), np.asarray(out))
        return out

    def tspy(w, H, nbits, blocksize=128):
        out = torig(w, H, nbits, blocksize=blocksize)
        caps["port"] = (w.numpy(), H.numpy(), out.numpy())
        return out

    with mock.patch.object(jquip, "round_ldl_gptqequiv", jspy):
        jW = np.asarray(jquip.quip_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=4,
                                                   qfn=qfn, U=U, V=V))
    with mock.patch.object(quip_impl, "round_ldl_gptqequiv", tspy):
        tW = quip_impl.quip_quantize_matrix(_t(W), _t(H), bits=4, qfn=qfn, U=U, V=V).numpy()
    return caps, jW, tW


@pytest.mark.parametrize("shape,qfn", [((128, 256), "a"), ((128, 256), "b"), ((256, 512), "b")])
def test_quip_matrix_matches_jax(shape, qfn):
    W, H = _w_h(*shape, seed=shape[0])
    U = jquip.rand_ortho_butterfly(np.random.default_rng(1), shape[0])
    V = jquip.rand_ortho_butterfly(np.random.default_rng(2), shape[1])
    caps, jW, tW = _quip_pair(W, H, U, V, qfn)
    assert_codes_close(caps["port"][2], caps["jax"][2], f"quip {shape} {qfn}")
    # the LDL rounding from JAX's own inputs: JAX's codes bit for bit
    same = quip_impl.round_ldl_gptqequiv(_t(caps["jax"][0]), _t(caps["jax"][1]), 4,
                                         blocksize=128).numpy()
    np.testing.assert_array_equal(same, caps["jax"][2])
    assert np.isfinite(tW).all()
    rel = np.abs(tW - W).mean() / np.abs(W).mean()
    assert abs(rel - np.abs(jW - W).mean() / np.abs(W).mean()) <= 0.01 * rel


# ---------------------------------------------------------------------------
# end to end on the JAX tiny Llama (mirrors tests/test_awq_combos.py,
# tests/test_spqr_quip.py and tests/test_quantize_e2e.py)
# ---------------------------------------------------------------------------

def _np_stats(stats):
    out = {}
    for k, v in stats.items():
        out[k] = [np.array(a) for a in v] if k == "inputs" else np.array(v)
    return out


def _torch_stats(stats):
    return {k: ([torch.from_numpy(a) for a in v] if k == "inputs" else torch.from_numpy(v))
            for k, v in stats.items()}


@pytest.fixture(scope="module")
def e2e():
    """(port model, batches, fp PPLs, run): run(**cfg) quantizes the JAX and
    the port model once per config; it returns the two quantized models and
    each call of JAX's algorithm in call order: (its fp linear, the stats it
    saw, the linear it returned)."""
    jm, batches = make_model_and_data()
    pm = port_model(jm)
    fp = jax_ppl(jm, batches, fused=False), compute_ppl(pm, batches, fused=False)
    cache = {}

    def run(**kw):
        key = repr(QuantConfig(**kw))
        if key not in cache:
            cls = type(jbase.get_algo(kw["algo"], JQuantConfig(**kw)))
            seen = []
            orig = cls.quantize_linear

            def spy(self, lin, stats):
                out = orig(self, lin, stats)
                seen.append((lin, _np_stats(stats), out))
                return out

            # JAX's final pseudo_quantize jitted, as its searches run it: op by
            # op its exact_div is one ulp off the true quotient at times
            pq = jax.jit(jawq.pseudo_quantize, static_argnums=(1, 2, 3),
                         static_argnames=("return_qparams",))
            with mock.patch.object(cls, "quantize_linear", spy), \
                    mock.patch.object(jawq, "pseudo_quantize", pq):
                jq = mt.quantize(jm, JQuantConfig(**kw), calib_data=batches)
            tq = pt.quantize(pm, QuantConfig(**kw), calib_data=batches, device="cpu")
            cache[key] = jq, tq, seen
        return cache[key]

    return pm, batches, fp, run


def _weights(lin):
    """A linear's codes, or its fake-quantized weights in float32 (native
    float8 dequantized) where it is not packed, as numpy."""
    if lin.packed is not None:
        return _codes(lin), True
    if isinstance(lin.weight, torch.Tensor):
        return dequant_weight(lin).float().numpy(), False
    w = np.asarray(lin.weight)
    if w.dtype in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        w = w.astype(np.float32) / np.asarray(lin.w_scale)
    return w.astype(np.float32), False


def _spec(jl):
    """A JAX linear's QuantSpec as the port's."""
    return QuantSpec(**{f.name: getattr(jl.spec, f.name) for f in dataclasses.fields(jl.spec)})


def _share_equal(jl, tl):
    """(equal entries, entries) of two linears: codes, or fake-quantized
    weights equal within 1e-5 of their largest magnitude."""
    a, packed = _weights(jl)
    b, _ = _weights(tl)
    if packed:
        return int((a == b).sum()), a.size
    return int((np.abs(a - b) <= 1e-5 * np.abs(a).max()).sum()), a.size


def _replay(kw, seen):
    """The port's algorithm on each fp linear from the stats JAX's saw:
    every linear's codes at least CODE_SHARE equal to JAX's. AWQ's ratio
    search picks JAX's index and then takes JAX's smooth scales (their last
    bits come from XLA's pow and mean, and a clipped group's zero point sits
    at a rounding tie, -min / scale = -(qmax + 1) / 2: see `_awq_floor`)."""
    algo = get_algo(kw["algo"], QuantConfig(**kw))
    orig = awq_impl.auto_scale_search
    for k, (jlin, stats, jout) in enumerate(seen):
        def given(w, x, x_mean_abs, **skw):
            losses, scales = awq_impl.scale_losses(w, x, x_mean_abs, **skw)
            want = np.asarray(jout.smooth_factor)
            rel = [float(np.abs(c - want).max() / np.abs(want).max()) for c in scales.numpy()]
            best = int(awq_impl._first_within_eps(losses))
            assert best == int(np.argmin(rel)) and rel[best] <= SMOOTH_RTOL, (k, best, rel)
            return torch.from_numpy(want.copy())

        with mock.patch.object(awq_impl, "auto_scale_search", given):
            got = algo.quantize_linear(linear_from_jax(jax_tree(jlin), "cpu"), _torch_stats(stats))
        same, n = _share_equal(jout, got)
        assert same / n >= CODE_SHARE, f"call {k}: {same / n:.5f} equal"
        assert got.spec == _spec(jout)
        assert (got.smooth_factor is None) == (jout.smooth_factor is None)
        if got.smooth_factor is not None and orig is awq_impl.auto_scale_search:
            np.testing.assert_allclose(got.smooth_factor.numpy(), np.asarray(jout.smooth_factor),
                                       rtol=SMOOTH_RTOL)


def _port_linear(jl):
    """A JAX quantized linear as the port's (native float8 weights cast back
    to their torch dtype, exactly)."""
    w = None if jl.weight is None else np.asarray(jl.weight)
    if w is not None and w.dtype in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        f8 = torch.float8_e4m3fn if w.dtype == ml_dtypes.float8_e4m3fn else torch.float8_e5m2
        d = dict(jax_tree(jl.replace(weight=None)))
        return linear_from_jax(d, "cpu").replace(weight=_t(w.astype(np.float32)).to(f8))
    return linear_from_jax(jax_tree(jl), "cpu")


STATS_RTOL = 1e-5  # the calibration stats of the two packages' f32 forwards


def _pipeline(pm, batches, kw, seen, jp):
    """The port's calibration pipeline against JAX's: the port's
    calibration runs with its algorithm replaced by the linear JAX's returned
    for the same call, so both walk the same quantized states. Every call's stats
    are JAX's (sums and sampled inputs within STATS_RTOL of their largest
    magnitude, counts equal), and the port's model made of JAX's linears has
    JAX's perplexity within 1e-4."""
    cls = type(get_algo(kw["algo"], QuantConfig(**kw)))
    got = []

    def given(self, lin, stats):
        got.append(_np_stats({k: (v if k == "inputs" else v.cpu()) for k, v in stats.items()}))
        return _port_linear(seen[len(got) - 1][2])

    with mock.patch.object(cls, "quantize_linear", given):
        qm = pt.quantize(pm, QuantConfig(**kw), calib_data=batches, device="cpu")
    assert len(got) == len(seen)
    for k, (g, (_, w, _)) in enumerate(zip(got, seen)):
        assert set(g) == set(w), k
        for key in w:
            a, b = (np.concatenate(g[key]), np.concatenate(w[key])) if key == "inputs" else (
                g[key], w[key])
            assert a.shape == b.shape, (k, key)
            np.testing.assert_allclose(a, b, rtol=STATS_RTOL,
                                       atol=STATS_RTOL * float(np.abs(b).max() or 1.0),
                                       err_msg=f"call {k} {key}")
    tp = compute_ppl(qm, batches, fused=False)
    assert abs(tp - jp) / jp < 1e-4, (tp, jp)


def check_pair(e2e, kw, floor=CODE_SHARE, ppl_rtol=0.01):
    """The port against JAX for one config: the replay, the pipeline, the
    port's own quantized perplexity within `ppl_rtol` of JAX's, and every
    layer's codes at least `floor` equal (None: not held). Returns (JAX's,
    the port's quantized model, the port's PPL, its fp PPL)."""
    pm, batches, fp, run = e2e
    jq, tq, seen = run(**kw)
    assert len(seen) == len(LINEARS) * len(pm.params["layers"])
    _replay(kw, seen)
    jp, tp = jax_ppl(jq, batches, fused=False), compute_ppl(tq, batches, fused=False)
    _pipeline(pm, batches, kw, seen, jp)
    assert abs(tp - jp) / jp < ppl_rtol, (tp, jp)
    for i, (jl, tl) in enumerate(zip(jq.params["layers"], tq.params["layers"])):
        same, n = map(sum, zip(*(_share_equal(jl[k], tl[k]) for k in LINEARS)))
        assert floor is None or same / n >= floor, f"layer {i}: {same / n:.5f} equal"
    return jq, tq, tp, fp[1]


GPTQ_FLOOR = 0.99  # GPTQ-based pipelines: see the module docstring
# AWQ's own pipeline against JAX's: not held code by code, its perplexity
# within 5% (see the module docstring)
AWQ_PIPELINE = dict(floor=None, ppl_rtol=0.05)


def test_awq_int4(e2e):
    _, tq, ppl, fp = check_pair(e2e, dict(algo="awq", wbit="int4", w_groupsize=16),
                                **AWQ_PIPELINE)
    lin = tq.params["layers"][0]["q_proj"]
    assert lin.smooth_factor is not None and lin.packed is not None
    assert not lin.spec.w_symmetric
    assert ppl < fp * 3


def test_awq_gptq_combo(e2e):
    _, tq, ppl, fp = check_pair(e2e, dict(algo="awq+gptq", wbit="int4", w_qtype="per_group",
                                          w_groupsize=16, blocksize=32, w_has_zero=True),
                                **AWQ_PIPELINE)
    assert tq.params["layers"][0]["q_proj"].smooth_factor is not None
    assert ppl < fp * 3


def test_smooth_gptq_combo(e2e):
    _, tq, ppl, fp = check_pair(e2e, dict(algo="smoothquant+gptq", wbit="int8", abit="int8",
                                          w_qtype="per_channel", a_qtype="per_tensor",
                                          blocksize=32, w_has_zero=True), floor=GPTQ_FLOOR)
    lin = tq.params["layers"][0]["q_proj"]
    assert lin.smooth_factor is not None and lin.spec.abit == 8
    assert abs(ppl - fp) / fp < 0.1


def test_spqr_matrix_reconstruction():
    W = _fp_weights(32, 64, 0) * np.float32(8.0)
    _, H = _w_h(32, 64, seed=1)
    Q, scales, _, _ = spqr_impl.spqr_quantize_matrix(_t(W), _t(H), bits=8, blocksize=32,
                                                     groupsize=16, qq_bits=8, qq_groupsize=8)
    assert torch.isfinite(Q).all() and scales.shape == (32, 4)
    assert float((Q - _t(W)).abs().mean() / _t(W).abs().mean()) < 0.05


def test_spqr_outliers_kept_fp():
    W = _fp_weights(32, 64, 2) * np.float32(8.0)
    W[5, 17] = 40.0  # a massive outlier
    _, H = _w_h(32, 64, seed=3)
    Q, _, _, n_out = spqr_impl.spqr_quantize_matrix(_t(W), _t(H), bits=3, blocksize=32,
                                                    groupsize=16, qq_bits=3, qq_groupsize=8)
    assert float(n_out) >= 1
    assert abs(float(Q[5, 17]) - 40.0) < 0.5


def test_quip_butterfly_orthogonal():
    for n in (12, 64):
        Q = quip_impl.rand_ortho_butterfly(np.random.default_rng(0), n)
        np.testing.assert_allclose(Q @ Q.T, np.eye(n), atol=1e-4)


def test_quip_matrix_reconstruction():
    W = _fp_weights(32, 64, 4)
    _, H = _w_h(32, 64, seed=5)
    Wq = quip_impl.quip_quantize_matrix(_t(W), _t(H), bits=8).numpy()
    assert np.isfinite(Wq).all()
    assert np.abs(Wq - W).mean() / np.abs(W).mean() < 0.1


@pytest.mark.parametrize("algo", ["spqr", "quip"])
def test_e2e_tiny_model(e2e, algo):
    _, _, ppl, fp = check_pair(e2e, dict(algo=algo, wbit="int4", w_groupsize=16, blocksize=32,
                                         qq_groupsize=8))
    assert np.isfinite(ppl) and ppl < fp * 5


def test_smoothquant_w8a8(e2e):
    jq, tq, ppl, fp = check_pair(e2e, dict(algo="smoothquant", wbit="int8", abit="int8",
                                           w_qtype="per_channel", a_qtype="per_tensor"))
    lin = tq.params["layers"][0]["q_proj"]
    assert lin.smooth_factor is not None
    assert int8_matmul.supports_native_int8(lin.spec)
    assert abs(ppl - fp) / fp < 0.05
    # the served W8A8 route (fused=True): within 1e-2 of the fake-quant route, and JAX's
    _, batches, _, _ = e2e
    w8 = compute_ppl(tq, batches, fused=True)
    assert abs(w8 - ppl) / ppl < 1e-2
    assert abs(w8 - jax_ppl(jq, batches, fused=True)) / w8 < 0.01


def test_zeroquant(e2e):
    _, tq, ppl, fp = check_pair(e2e, dict(algo="zeroquant", wbit="int8", abit="int8",
                                          w_groupsize=16))
    assert tq.params["layers"][0]["q_proj"].spec.a_qtype == "per_token"
    assert abs(ppl - fp) / fp < 0.05


def test_fp8_e4m3(e2e):
    _, _, ppl, fp = check_pair(e2e, dict(algo="fp8", wbit="int8", abit="int8", fp8_format="e4m3"))
    assert abs(ppl - fp) / fp < 0.05


def test_fp8_native_storage_exact(e2e):
    """Native float8 storage reproduces the emulated grid bit for bit (the
    native model held against JAX's, the fake-quantized one the port's)."""
    pm, batches, _, _ = e2e
    kw = dict(algo="fp8", wbit="int8", abit="float16", fp8_format="e4m3")
    _, qn, _, _ = check_pair(e2e, dict(kw, pack=True))
    qf = pt.quantize(pm, QuantConfig(**kw, pack=False), device="cpu")
    ln, lf = qn.params["layers"][0]["q_proj"], qf.params["layers"][0]["q_proj"]
    assert ln.weight.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(dequant_weight(ln).numpy(), lf.weight.numpy())
    assert abs(compute_ppl(qn, batches, fused=False) - compute_ppl(qf, batches, fused=False)) < 1e-3
