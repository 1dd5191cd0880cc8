"""The port's W4A8 route (ops/w4a8_matmul.py, quant_linear_apply's branch)
against the JAX package's in interpret mode, on int4 linears packed by the
JAX package: the integer product per group (32) and per channel, the int8
activation codes, `w4a8_matmul` end to end, and the routing by flattened
rows with `MI_W4A8_INT` set, mirroring tests/test_dequant_matmul.py.

Tolerances: the activation codes equal; the integer product equal to 1e-6
of its scale (each group's sum is exact on both sides; per channel the
reference rescales per k tile, the port once per group); the layer outputs
to 1e-5 of their scale."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.core.qparams import div_round as jax_div_round
from mi_optimize_tpu.core.qparams import exact_div as jax_exact_div
from mi_optimize_tpu.core.qparams import qrange
from mi_optimize_tpu.models.quant_linear import quant_linear_apply as jax_apply
from mi_optimize_tpu.ops import w4a8_matmul as jw
from mi_optimize_tpu_torch.convert import linear_from_jax
from mi_optimize_tpu_torch.models import quant_linear as pq
from mi_optimize_tpu_torch.ops import w4a8_matmul as pw
from tests.test_dequant_matmul import make_packed_linear
from tests.test_torch_convert import jax_tree

torch.set_num_threads(1)

CASES = [("per_group", 32), ("per_channel", -1)]


def _w4a8_pair(out_f, in_f, qtype, groupsize, seed):
    """(JAX linear, port linear) with the W4A8 activation spec."""
    qlin, _ = make_packed_linear(np.random.default_rng(seed), out_f, in_f, 4, qtype, groupsize)
    qlin = qlin.replace(spec=qlin.spec.replace(abit=8, a_qtype="per_token", a_dynamic=True,
                                               a_symmetric=True, a_unsigned=False))
    return qlin, linear_from_jax(jax_tree(qlin), "cpu")


def _tables(qlin, K):
    s = qlin.spec
    ng = K // (s.w_groupsize if s.w_qtype == "per_group" else K)
    n = qlin.out_features
    return tuple(np.array(np.broadcast_to(np.asarray(t).reshape(-1, ng).T, (ng, n)))
                 for t in (qlin.w_scale, qlin.w_zero))


@pytest.mark.parametrize("qtype,groupsize", CASES)
def test_int_product_matches_jax(qtype, groupsize):
    jl, pl = _w4a8_pair(192, 256, qtype, groupsize, seed=1)
    assert jw.supports_w4a8(jl.spec) and pw.supports_w4a8(pl.spec)
    xi = np.random.default_rng(2).integers(-128, 128, size=(64, 256)).astype(np.int8)
    st, zt = _tables(jl, 256)
    kw = dict(bits=4, groupsize=groupsize, qmin=qrange(4, True).qmin)
    ref = np.asarray(jw.w4a8_matmul_int(jnp.asarray(xi), jl.packed, jnp.asarray(st),
                                        jnp.asarray(zt), interpret=True, **kw))
    before = pw.launches
    got = pw.w4a8_matmul_int(torch.from_numpy(xi), pl.packed, torch.from_numpy(st),
                             torch.from_numpy(zt), **kw)
    assert got.dtype == torch.float32 and got.shape == (64, 192)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert pw.launches == before


@pytest.mark.parametrize("qtype,groupsize", CASES)
def test_w4a8_matmul_matches_jax(qtype, groupsize):
    jl, pl = _w4a8_pair(128, 256, qtype, groupsize, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 40, 256)).astype(np.float32)
    x2 = jnp.asarray(x.reshape(-1, 256))
    amax = jnp.clip(jnp.abs(x2).max(axis=-1, keepdims=True), 1e-12, None)
    jxi = jnp.clip(jax_div_round(x2, jax_exact_div(amax, jnp.float32(127.0))), -128, 127)
    pxi, _ = pw.quantize_activations(torch.from_numpy(x.reshape(-1, 256)), "per_token")
    np.testing.assert_array_equal(pxi.numpy(), np.asarray(jxi).astype(np.int8))
    ref = np.asarray(jw.w4a8_matmul(jnp.asarray(x), jl))
    got = pw.w4a8_matmul(torch.from_numpy(x), pl)
    assert got.shape == (2, 40, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("qtype,groupsize", CASES)
def test_routing_by_rows(monkeypatch, qtype, groupsize):
    """With MI_W4A8_INT=1, 32 rows or more take the integer product, fewer
    stay on the dequant route; without it every size stays there. Each
    output agrees with the JAX package's on the same route."""
    jl, pl = _w4a8_pair(128, 128, qtype, groupsize, seed=5)
    x_big = np.random.default_rng(6).normal(size=(1, 40, 128)).astype(np.float32)
    calls = []
    real = pw.w4a8_matmul
    monkeypatch.setattr(pw, "w4a8_matmul", lambda x, q: calls.append(x.shape) or real(x, q))
    for env in ("1", None):
        if env:
            monkeypatch.setenv("MI_W4A8_INT", env)
        else:
            monkeypatch.delenv("MI_W4A8_INT", raising=False)
        for x in (x_big, x_big[:, :4]):
            calls.clear()
            got = pq.quant_linear_apply(pl, torch.from_numpy(np.ascontiguousarray(x)),
                                        fused=True)
            ref = np.asarray(jax_apply(jl, jnp.asarray(x), fused=True))
            assert calls == ([(1, 40, 128)] if env and x.shape[1] == 40 else [])
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())


def test_per_tensor_activations():
    jl, pl = _w4a8_pair(128, 128, "per_group", 32, seed=7)
    spec = dataclasses.replace(pl.spec, a_qtype="per_tensor")
    jl = jl.replace(spec=jl.spec.replace(a_qtype="per_tensor"))
    pl = pl.replace(spec=spec)
    x = np.random.default_rng(8).normal(size=(48, 128)).astype(np.float32)
    ref = np.asarray(jw.w4a8_matmul(jnp.asarray(x), jl))
    got = pw.w4a8_matmul(torch.from_numpy(x), pl)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
