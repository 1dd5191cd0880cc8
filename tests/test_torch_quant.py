"""Calibration in the port (mi_optimize_tpu_torch.quant) against the JAX
package on the same numpy inputs, on the CPU.

Tolerances:
  * config fields equal; reducers: xtx within rtol 1e-5, minmax and absmax
    exact, absmean within 1e-6, the same sampled input rows;
  * observer qparams and RTN (packed words, scales, zeros) bit-equal to
    JAX's jitted qparams (see ULP below);
  * gptq_quantize_matrix from the same W and H: the same permutation, at
    most 0.1% of codes apart and each by one, scales within 1e-5
    relative and zeros equal in each row up to its first differing code;
  * the reference's end-to-end quantize tests (tests/test_quantize_e2e.py)
    on the JAX tiny Llama carried across by convert.from_jax_params: the
    port's quantized perplexity within 1% of JAX's, and the codes of every
    layer at least 99.9% equal to JAX's. GPTQ turns a last-bit difference of
    its Hessian into a flipped code at a rounding tie, and its error
    feedback carries that flip into the later columns of the group and
    block: the two packages' f32 forwards round the calibration activations
    apart in the last bits (MKL's and XLA's sum orders), and with act-order
    groups on these 64-token calibration sets that moved 0.7% of layer 0's
    codes (all in down_proj), then every layer after it under
    block_sequential. So for GPTQ the 99.9% rule is held on the port's
    algorithm fed JAX's own Hessians of every linear (`_replay`), and the
    port's own pipeline keeps it where no act-order group runs; with
    act-order groups it holds layer 0 to 99% (PPL within 1% everywhere).
    The pipeline itself (group order, stats after the earlier groups,
    propagation between blocks) is held on its Hessians: with its GPTQ
    replaced by JAX's result for each call (`_pipeline`), the xtx of every
    calibration call, in every layer, is JAX's within rtol 1e-5."""
import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mi_optimize_tpu as mt
import mi_optimize_tpu_torch as pt
from mi_optimize_tpu.eval.ppl import compute_ppl as jax_ppl
from mi_optimize_tpu.models.llama import GROUP_ORDER
from mi_optimize_tpu.quant import base as jbase
from mi_optimize_tpu.quant import gptq as jgptq
from mi_optimize_tpu.quant import rtn as jrtn
from mi_optimize_tpu.quant.config import QuantConfig as JQuantConfig
from mi_optimize_tpu_torch.core import packing
from mi_optimize_tpu_torch.core.qparams import qrange
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear
from mi_optimize_tpu_torch.quant import base, get_algo, gptq, rtn
from mi_optimize_tpu_torch.quant.config import QuantConfig
from tests.test_quantize_e2e import make_model_and_data
from mi_optimize_tpu_torch.convert import linear_from_jax
from tests.test_torch_convert import jax_tree, port_model

LINEARS = [n for g in GROUP_ORDER for n in g]
# JAX's exact_div run op by op (as its quantize runs RTN) rounds its residual
# step on its own and lands one ulp off the true quotient for a few percent
# of inputs; jitted, XLA fuses the step into an fma and gives the true
# quotient, as the port (and JAX's jitted GPTQ) does
ULP = 1.2e-7
HESS_RTOL = 1e-5            # the reducers' xtx rule, on every calibration call


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["wbit"], d["abit"] = cfg.wbit.name, cfg.abit.name
    return d


def test_config_from_reference_style_dict():
    d = {"quant_config": {
        "algo": "gptq", "model_type": "llama",
        "kwargs": {"wbit": "int4", "w_groupsize": 128, "actorder": True},
        "calibrate_config": {"name": "wikitext2", "nsample": 4, "seqlen": 64}}}
    cfg = QuantConfig.from_dict(copy.deepcopy(d))
    assert cfg.algo == "gptq" and cfg.w_groupsize == 128
    assert cfg.calibrate.nsamples == 4
    assert _fields(cfg) == _fields(JQuantConfig.from_dict(d))


@pytest.mark.parametrize("d", [{"algo": "rtn", "not_a_key": 1},
                               {"algo": "rtn", "calibrate_config": {"name": "c4", "bad": 1}}])
def test_unknown_config_key_rejected(d):
    with pytest.raises(ValueError):
        JQuantConfig.from_dict(d)
    with pytest.raises(ValueError):
        QuantConfig.from_dict(d)


def test_config_from_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    p = tmp_path / "q.yaml"
    p.write_text(yaml.safe_dump({"algo": "gptq", "wbit": "int3", "w_groupsize": 64,
                                 "calibrate_config": {"name": "ptb", "nsamples": 8}}))
    assert _fields(QuantConfig.from_yaml(str(p))) == _fields(JQuantConfig.from_yaml(str(p)))


# ---------------------------------------------------------------------------
# reducers, observer qparams, RTN
# ---------------------------------------------------------------------------

def test_reducers_match_jax():
    kinds = ("xtx", "minmax", "absmax", "absmean", "inputs")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 3000, 48)).astype(np.float32) * s for s in (1.0, 3.0)]
    js = jbase.init_stats(kinds, 48)
    ts = base.init_stats(kinds, 48, "cpu")
    dev_kinds = kinds[:-1]
    for x in xs:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        jd = jbase.update_stats_device(dev_kinds, {k: v for k, v in js.items() if k != "inputs"},
                                       jx)
        js = dict(jbase.update_stats_host(kinds, js, jx), **jd)
        td = base.update_stats_device(dev_kinds, {k: v for k, v in ts.items() if k != "inputs"},
                                      tx)
        ts = dict(base.update_stats_host(kinds, ts, tx), **td)
    np.testing.assert_allclose(ts["xtx"].numpy(), np.asarray(js["xtx"]), rtol=1e-5,
                               atol=1e-5 * float(np.abs(js["xtx"]).max()))
    assert int(ts["nsamples"]) == int(js["nsamples"]) == 4
    for k in ("min", "max", "absmax"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    np.testing.assert_allclose(ts["abssum"].numpy() / float(ts["ntokens"]),
                               np.asarray(js["abssum"]) / float(js["ntokens"]), rtol=1e-6)
    got, want = np.concatenate([a.numpy() for a in ts["inputs"]]), np.concatenate(js["inputs"])
    assert got.shape == want.shape == (base.MAX_INPUT_SAMPLE_TOKENS, 48)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(base.finalize_hessian(ts).numpy(),
                               np.asarray(jbase.finalize_hessian(js)), rtol=1e-5,
                               atol=1e-5 * float(np.abs(js["xtx"]).max()))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_observer_qparams_bit_equal(bits, symmetric):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((40, 8, 64)).astype(np.float32)
    w[0] = np.abs(w[0])          # all positive: the include-zero clamp on min
    w[1] = -np.abs(w[1])
    w[2] = 0.0                   # the 1e-9 floor
    js, jz = jax.jit(jgptq.observer_qparams, static_argnums=(1, 2))(jnp.asarray(w), bits,
                                                                      symmetric)
    ts, tz = gptq.observer_qparams(torch.from_numpy(w), bits, symmetric)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def _codes(lin):
    """The integer grid [out, in] of a packed linear of either package."""
    p = lin.packed
    p = p if isinstance(p, torch.Tensor) else torch.from_numpy(np.array(p).view(np.int32))
    s = lin.spec
    return packing.unpack_weight(p, s.wbit, qrange(s.wbit, s.w_unsigned), lin.in_features).numpy()


def _fp_linears(out_f=96, in_f=256, seed=0):
    from mi_optimize_tpu.models.quant_linear import QuantizedLinear as JQuantizedLinear

    w = (np.random.default_rng(seed).standard_normal((out_f, in_f)) * in_f ** -0.5).astype(
        np.float32)
    return JQuantizedLinear.fp(jnp.asarray(w)), QuantizedLinear.fp(torch.from_numpy(w))


@pytest.mark.parametrize("wbit", ["int3", "int4", "int8"])
@pytest.mark.parametrize("qtype,groupsize", [("per_channel", -1), ("per_group", 16),
                                             ("per_group", 128)])
@pytest.mark.parametrize("has_zero", [False, True])
def test_rtn_quantize_linear_bit_equal(wbit, qtype, groupsize, has_zero):
    kw = dict(algo="rtn", wbit=wbit, w_qtype=qtype, w_groupsize=groupsize, w_has_zero=has_zero)
    jl, tl = _fp_linears()
    jqd = jax.jit(jrtn.qparams.quantize_dequantize, static_argnums=(1, 2, 3),
                  static_argnames=("symmetric", "unsigned"))
    with mock.patch.object(jrtn.qparams, "quantize_dequantize", jqd):
        jq = jrtn.RTNAlgo(JQuantConfig(**kw)).quantize_linear(jl, {})
    tq = rtn.RTNAlgo(QuantConfig(**kw)).quantize_linear(tl, {})
    assert tq.spec == linear_from_jax(jax_tree(jq), "cpu").spec
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed).view(np.int32))
    np.testing.assert_array_equal(tq.w_scale.numpy(), np.asarray(jq.w_scale))
    np.testing.assert_array_equal(tq.w_zero.numpy(), np.asarray(jq.w_zero))


# ---------------------------------------------------------------------------
# GPTQ on one matrix
# ---------------------------------------------------------------------------

def _w_h(out_f, in_f, dead=False, seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((out_f, in_f)) * in_f ** -0.5).astype(np.float32)
    X = rng.standard_normal((4 * in_f, in_f)).astype(np.float32)
    X[:, : in_f // 8] *= 3.0       # uneven diagonal: a real act-order permutation
    if dead:
        X[:, [5, 77, 300]] = 0.0   # dead columns: tied diagonals after H_ii = 1
    return W, (X.T @ X) * np.float32(0.5)


def assert_codes_close(got_codes, want_codes, what=""):
    diff = np.abs(got_codes.astype(np.int64) - want_codes)
    assert diff.max() <= 1, f"{what}: a code differs by {diff.max()}"
    assert (diff > 0).mean() <= 1e-3, f"{what}: {(diff > 0).mean():.4%} of codes differ"


def _grid(Q, s, z, perm, g):
    Qp = Q if perm is None else Q[:, perm]
    out_f = Qp.shape[0]
    return np.round(Qp.reshape(out_f, -1, g) / s[:, :, None] + z[:, :, None]).reshape(out_f, -1)


@pytest.mark.parametrize("shape,actorder,symmetric,dead", [
    ((256, 512), True, False, False), ((256, 512), True, True, False),
    ((256, 512), False, False, False), ((256, 512), False, True, False),
    ((512, 1024), True, False, False), ((512, 1024), True, True, False),
    ((512, 1024), False, False, False), ((512, 1024), False, True, False),
    ((256, 512), True, False, True)])
def test_gptq_matrix_matches_jax(shape, actorder, symmetric, dead):
    W, H = _w_h(*shape, dead=dead)
    jQ, js, jz, jp = jgptq.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=4,
                                                groupsize=128, actorder=actorder,
                                                symmetric=symmetric)
    tQ, ts, tz, tp = gptq.gptq_quantize_matrix(torch.from_numpy(W), torch.from_numpy(H), bits=4,
                                               groupsize=128, actorder=actorder,
                                               symmetric=symmetric)
    jQ, js, jz = np.asarray(jQ), np.asarray(js), np.asarray(jz)
    if actorder:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    else:
        assert tp is None and jp is None
    perm = None if tp is None else tp.numpy()
    jc, tc = _grid(jQ, js, jz, perm, 128), _grid(tQ.numpy(), ts.numpy(), tz.numpy(), perm, 128)
    assert_codes_close(tc, jc, str(shape))
    # up to a row's first differing code: a flipped code moves its row's
    # later columns, and so the start state of its later groups
    same = np.cumprod((tc == jc).reshape(shape[0], -1, 128).all(-1), axis=-1).astype(bool)
    np.testing.assert_allclose(ts.numpy()[same], js[same], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tz.numpy()[same], jz[same])
    if dead:
        np.testing.assert_array_equal(tQ.numpy()[:, [5, 77, 300]], 0.0)


def test_gptq_per_channel_matrix_matches_jax():
    W, H = _w_h(128, 256, seed=3)
    jQ, js, jz, _ = jgptq.gptq_quantize_matrix(jnp.asarray(W), jnp.asarray(H), bits=3,
                                               groupsize=-1, actorder=True)
    tQ, ts, tz, _ = gptq.gptq_quantize_matrix(torch.from_numpy(W), torch.from_numpy(H), bits=3,
                                              groupsize=-1, actorder=True)
    assert ts.shape == js.shape == (128, 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=0, atol=1e-6)


def test_gptq_holds_full_f32_under_tf32():
    """GPTQ runs its products in full float32 whatever the caller's TF32
    setting, and restores it (on the CPU the flag changes nothing; the card
    test holds the codes)."""
    W, H = _w_h(64, 256)
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    seen = []
    orig = gptq._gptq_core

    def spy(*a, **k):
        seen.append(m.allow_tf32)
        return orig(*a, **k)

    m.allow_tf32 = True
    try:
        with mock.patch.object(gptq, "_gptq_core", spy):
            gptq.gptq_quantize_matrix(torch.from_numpy(W), torch.from_numpy(H), bits=4,
                                      groupsize=128)
        assert seen == [False] and m.allow_tf32
    finally:
        m.allow_tf32 = old


# ---------------------------------------------------------------------------
# end to end on the JAX tiny Llama (mirrors tests/test_quantize_e2e.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def e2e():
    """(JAX model, port model, batches, fp PPLs, run): run(**cfg) quantizes
    both models once per config; it returns the two quantized models and,
    for each call of JAX's GPTQ in call order, the Hessian stats it saw and
    the linear it returned."""
    jm, batches = make_model_and_data()
    pm = port_model(jm)
    fp = jax_ppl(jm, batches, fused=False), compute_ppl(pm, batches, fused=False)
    cache = {}

    def run(**kw):
        key = repr(QuantConfig(**kw))      # spellings of one config share its run
        if key not in cache:
            seen = []
            orig = jgptq.GPTQAlgo.quantize_linear

            def spy(self, lin, stats):
                out = orig(self, lin, stats)
                seen.append(({k: np.array(stats[k]) for k in ("xtx", "nsamples")}, out))
                return out

            with mock.patch.object(jgptq.GPTQAlgo, "quantize_linear", spy):
                jq = mt.quantize(jm, JQuantConfig(**kw), calib_data=batches)
            tq = pt.quantize(pm, QuantConfig(**kw), calib_data=batches, device="cpu")
            cache[key] = jq, tq, seen
        return cache[key]

    return jm, pm, batches, fp, run


def _layer_eq(jl, tl):
    """Share of equal codes (of equal fake-quantized weights where the
    linears are not packed) over a layer's linears."""
    n = same = 0
    for name in LINEARS:
        if jl[name].packed is not None:
            a, b = _codes(jl[name]), _codes(tl[name])
        else:
            a, b = np.asarray(jl[name].weight), tl[name].weight.numpy()
            b = np.where(np.abs(a - b) <= 1e-6, a, b)
        n += a.size
        same += int((a == b).sum())
    return same / n


def _replay(pm, kw, jq, seen):
    """The port's GPTQ on each linear of the fp model from the Hessian stats
    JAX's GPTQ saw for it: every layer's codes within the 99.9% rule of
    JAX's."""
    algo = gptq.GPTQAlgo(QuantConfig(**kw))
    calls = iter(seen)
    for i, blk in enumerate(pm.params["layers"]):
        for name in LINEARS:
            st, _ = next(calls)
            got = algo.quantize_linear(blk[name], {k: torch.from_numpy(v) for k, v in st.items()})
            want = jq.params["layers"][i][name]
            if want.packed is None:
                np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                                           rtol=0, atol=1e-6)
                continue
            assert_codes_close(_codes(got), _codes(want), f"layer {i} {name}")
            if want.perm is not None:
                np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert next(calls, None) is None


def _pipeline(pm, batches, kw, seen):
    """The port's calibration pipeline against JAX's: the group order, each
    group's stats taken after the block's earlier groups are quantized, and
    what one block feeds the next. The port's driver runs with its GPTQ
    replaced by the linear JAX's GPTQ returned for the same call, so both
    drivers walk the same quantized states; the stats each call sees (xtx
    within rtol HESS_RTOL of the largest entry, nsamples equal) are JAX's."""
    got = []

    def sub(self, lin, stats):
        got.append({k: stats[k].numpy().copy() for k in ("xtx", "nsamples")})
        return linear_from_jax(jax_tree(seen[len(got) - 1][1]), "cpu")

    with mock.patch.object(gptq.GPTQAlgo, "quantize_linear", sub):
        pt.quantize(pm, QuantConfig(**kw), calib_data=batches, device="cpu")
    assert len(got) == len(seen) == len(LINEARS) * len(pm.params["layers"])
    for k, (g, (w, _)) in enumerate(zip(got, seen)):
        what = f"layer {k // len(LINEARS)} {LINEARS[k % len(LINEARS)]}"
        assert int(g["nsamples"]) == int(w["nsamples"]), what
        np.testing.assert_allclose(g["xtx"], w["xtx"], rtol=HESS_RTOL,
                                   atol=HESS_RTOL * float(np.abs(w["xtx"]).max()), err_msg=what)


def check_pair(e2e, kw, floors=(0.999, 0.999)):
    """The port against JAX for one config: PPL within 1%, layer i's codes
    at least floors[i] equal (None: not held), and for GPTQ the replay."""
    jm, pm, batches, fp, run = e2e
    jq, tq, seen = run(**kw)
    jp, tp = jax_ppl(jq, batches, fused=False), compute_ppl(tq, batches, fused=False)
    assert abs(tp - jp) / jp < 0.01, (tp, jp)
    for i, (jl, tl, floor) in enumerate(zip(jq.params["layers"], tq.params["layers"], floors)):
        eq = _layer_eq(jl, tl)
        assert floor is None or eq >= floor, f"layer {i}: {eq:.5f} of codes equal"
    if kw["algo"] == "gptq":
        _replay(pm, kw, jq, seen)
        _pipeline(pm, batches, kw, seen)
    return jq, tq, tp, fp[1]


GRP = dict(algo="gptq", wbit="int4", w_qtype="per_group", w_groupsize=16, blocksize=32,
           w_has_zero=True)
ACT_ORDER = (0.99, 0.999)   # act-order groups: see the module docstring


def test_rtn_int8_close_to_fp(e2e):
    _, _, ppl, fp = check_pair(e2e, dict(algo="rtn", wbit="int8", w_qtype="per_channel"))
    assert abs(ppl - fp) / fp < 0.02


def test_rtn_int4_per_group_packed(e2e):
    _, tq, ppl, fp = check_pair(e2e, dict(algo="rtn", wbit="int4", w_qtype="per_group",
                                          w_groupsize=16))
    assert ppl < fp * 3
    lin = tq.params["layers"][0]["q_proj"]
    assert lin.packed is not None and lin.weight is None


def test_rtn_static_act_quant(e2e):
    jq, tq, ppl, fp = check_pair(e2e, dict(algo="rtn", wbit="int8", abit="int8",
                                           quantization_type="static", a_qtype="per_tensor"))
    lin, jlin = tq.params["layers"][0]["q_proj"], jq.params["layers"][0]["q_proj"]
    assert lin.a_scale is not None
    np.testing.assert_allclose(lin.a_scale.numpy(), np.asarray(jlin.a_scale), rtol=ULP, atol=0)
    assert ppl < fp * 2


def test_gptq_int4(e2e):
    # act-order groups (the config's default actorder=True): see the module docstring
    _, _, ppl, fp = check_pair(e2e, GRP, floors=ACT_ORDER)
    assert ppl < fp * 3


def test_gptq_beats_rtn_int3(e2e):
    _, _, rtn_ppl, _ = check_pair(e2e, dict(algo="rtn", wbit="int3", w_qtype="per_channel"))
    _, _, gptq_ppl, _ = check_pair(e2e, dict(algo="gptq", wbit="int3", blocksize=32,
                                             w_has_zero=True))
    assert gptq_ppl < rtn_ppl * 1.1


def test_gptq_int4_without_actorder(e2e):
    _, _, ppl, fp = check_pair(e2e, dict(GRP, actorder=False))
    assert ppl < fp * 3


def test_passthrough_fp16(e2e):
    _, pm, batches, _, _ = e2e
    qm = pt.quantize(pm, QuantConfig(algo="rtn", wbit="float16", abit="float16"),
                     calib_data=batches, device="cpu")
    assert qm is pm


def test_gptq_actorder_grouped_packs_with_perm(e2e):
    """The north-star config serves PACKED through the stored permutation,
    and matches the fake-quant model."""
    _, pm, batches, _, run = e2e
    kw = dict(GRP, actorder=True)
    jq, tq, _, _ = check_pair(e2e, dict(kw, pack=True), floors=ACT_ORDER)
    check_pair(e2e, dict(kw, pack=False), floors=ACT_ORDER)
    _, tq_fake, _ = run(**dict(kw, pack=False))
    lin = tq.params["layers"][0]["q_proj"]
    assert lin.packed is not None and lin.perm is not None
    ppl_packed = compute_ppl(tq, batches, fused=True)
    ppl_fake = compute_ppl(tq_fake, batches, fused=False)
    assert abs(ppl_packed - ppl_fake) / ppl_fake < 5e-3
    assert abs(ppl_packed - jax_ppl(jq, batches, fused=True)) / ppl_packed < 0.01


def test_block_sequential_propagation(e2e):
    """block_sequential=True feeds the quantized block outputs forward:
    different stats from block 1 on, the same block 0."""
    _, _, _, fp, _ = e2e
    # layer 1 sees layer 0's quantized outputs, which carry layer 0's flipped codes
    _, qm_bs, ppl_bs, _ = check_pair(e2e, dict(GRP, block_sequential=True), floors=(0.99, None))
    _, qm_fp, _, _ = check_pair(e2e, dict(GRP, block_sequential=False), floors=ACT_ORDER)
    assert np.isfinite(ppl_bs) and ppl_bs < fp[1] * 3
    w1 = qm_bs.params["layers"][1]["q_proj"].packed
    w2 = qm_fp.params["layers"][1]["q_proj"].packed
    assert not torch.equal(w1, w2)
    assert torch.equal(qm_bs.params["layers"][0]["q_proj"].packed,
                       qm_fp.params["layers"][0]["q_proj"].packed)


def test_generic_driver_matches_shapes(e2e):
    """layer_sequential=False (the reference toolbox's quant_other_model)
    quantizes everything from full-model fp forwards."""
    _, qm, ppl, fp = check_pair(e2e, dict(algo="gptq", wbit="int4", blocksize=32,
                                          w_has_zero=True, layer_sequential=False))
    assert np.isfinite(ppl) and ppl < fp * 3
    for blk in qm.params["layers"]:
        for name in ("q_proj", "down_proj"):
            assert blk[name].packed is not None or blk[name].weight is not None


def test_quantize_moves_to_the_device_and_not_ported_algos_raise(e2e):
    _, pm, batches, _, _ = e2e
    cfg = QuantConfig(algo="gptq", wbit="int4", blocksize=32, w_has_zero=True)
    # the resumable journal is ported (tests/test_torch_checkpoint.py holds
    # its resume bit for bit): a journal that refuses to save stops the pass
    class Refusing:
        def last_completed(self):
            return -1

        def save_block(self, i, blk, xs=None):
            raise OSError("journal full")

    with pytest.raises(OSError, match="journal full"):
        pt.quantize(pm, cfg, calib_data=batches, journal=Refusing(), device="cpu")
    # every algorithm the reference registers is ported
    for name, cls in (("awq", "AWQAlgo"), ("smoothquant", "SmoothQuantAlgo"),
                      ("smooth", "SmoothQuantAlgo"), ("zeroquant", "ZeroQuantAlgo"),
                      ("fp8", "FP8Algo"), ("spqr", "SpQRAlgo"), ("quip", "QuIPAlgo"),
                      ("awq+gptq", "AWQGPTQAlgo"), ("smoothquant+gptq", "SmoothGPTQAlgo")):
        assert type(get_algo(name, cfg)).__name__ == cls
    with pytest.raises(ValueError, match="unknown algo"):
        get_algo("nope", cfg)
    # the fp model's tensors stay where they were; the result lives on `device`
    qm = pt.quantize(pm, dict(algo="rtn", wbit="int4", w_qtype="per_group", w_groupsize=16),
                     device="cpu")
    assert qm.params["embed"] is pm.params["embed"]
    assert pm.params["layers"][0]["q_proj"].packed is None
    assert qm.params["layers"][0]["q_proj"].packed.device.type == "cpu"


def test_fused_mlp_declines_act_order_linears(monkeypatch):
    """A GPTQ act-order model's MLP linears carry `perm`; the fused MLP
    reads x in natural order, so it declines them and the served model
    keeps the unfused route (the reference's mlp_supported does not look at
    perm). Run on the CPU through the kernel branches, as on the card."""
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.ops import mlp_fused

    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_layers=1,
                      num_heads=2, num_kv_heads=1, head_dim=128, max_seq_len=256)
    fp = Model(config=cfg, params=llama.init_params(cfg, device="cpu"))
    batches = [np.random.default_rng(1).integers(0, 64, (1, 64)) for _ in range(2)]
    kw = dict(algo="gptq", wbit="int4", w_qtype="per_group", w_groupsize=128, w_has_zero=True)
    qm = pt.quantize(fp, QuantConfig(**kw), calib_data=batches, device="cpu")
    blk = qm.params["layers"][0]
    lins = (blk["gate_proj"], blk["up_proj"], blk["down_proj"])
    assert all(lin.perm is not None for lin in lins)
    assert not mlp_fused.mlp_supported(*lins, 256, 512)
    assert mlp_fused.mlp_supported(*(lin.replace(perm=None) for lin in lins), 256, 512)
    monkeypatch.setattr(llama, "kernel_branches", lambda x: True)
    got = compute_ppl(qm, batches, fused=True)
    assert abs(got - compute_ppl(qm, batches, fused=False)) / got < 1e-4
