"""Plain version of the port's dequant_matmul against the JAX kernel
(ops/dequant_matmul.py, interpret mode off-TPU), f32, rtol = atol = 2e-4:
the two sum in different orders, and small M takes the grouped rescale on
both sides while larger M dequantizes first."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.core import packing as jpacking
from mi_optimize_tpu.core import qparams as jqparams
from mi_optimize_tpu.core.qparams import qrange as jqrange
from mi_optimize_tpu.models.quant_linear import QuantSpec, QuantizedLinear
from mi_optimize_tpu.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
from mi_optimize_tpu_torch.ops import dequant_matmul as tdm
from tests.test_torch_convert import jax_tree
from mi_optimize_tpu_torch.convert import linear_from_jax

K, N = 256, 384


def _jax_lin(bits, qtype, groupsize, seed):
    w = jax.random.normal(jax.random.PRNGKey(seed), (N, K), jnp.float32) * K ** -0.5
    fake, scale, zero = jqparams.quantize_dequantize(w, bits, qtype, groupsize)
    ints = jqparams.quantize_to_int(fake, scale, zero, bits, qtype, groupsize)
    spec = QuantSpec(wbit=bits, w_qtype=qtype, w_groupsize=groupsize, w_packed=True)
    return QuantizedLinear(spec=spec, out_features=N, in_features=K,
                           packed=jpacking.pack_weight_device(ints, bits, jqrange(bits, True)),
                           w_scale=scale, w_zero=zero)


@pytest.mark.parametrize("M", [1, 19, 128])
@pytest.mark.parametrize("bits,qtype,groupsize", [
    (4, "per_group", 128), (8, "per_group", 128), (4, "per_channel", -1), (8, "per_channel", -1),
])
def test_plain_matches_jax_kernel(M, bits, qtype, groupsize):
    jl = _jax_lin(bits, qtype, groupsize, seed=M + bits)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    ref = np.asarray(jax_dequant_matmul(jnp.asarray(x), jl))
    got = tdm.dequant_matmul(torch.from_numpy(x), linear_from_jax(jax_tree(jl), "cpu"))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_batch_dims_and_bf16_output_dtype():
    tl = linear_from_jax(jax_tree(_jax_lin(4, "per_group", 128, seed=3)), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, K)).astype(np.float32))
    y = tdm.dequant_matmul(x, tl)
    assert y.shape == (2, 3, N)
    yb = tdm.dequant_matmul(x.to(torch.bfloat16), tl)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy(), y.numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("fused", [True, False])
def test_quant_linear_apply_matches_jax(fused):
    """The routing of quant_linear_apply: smooth factor, act-order gather,
    packed dequant product (or dequantize-then-matmul unfused), bias."""
    from mi_optimize_tpu.models.quant_linear import quant_linear_apply as jax_apply
    from mi_optimize_tpu_torch.models.quant_linear import quant_linear_apply

    rng = np.random.default_rng(11)
    jl = _jax_lin(4, "per_group", 128, seed=4).replace(
        bias=jnp.asarray(rng.standard_normal(N).astype(np.float32)),
        smooth_factor=jnp.asarray(rng.uniform(0.5, 2.0, K).astype(np.float32)),
        perm=jnp.asarray(rng.permutation(K).astype(np.int32)))
    x = rng.standard_normal((3, K)).astype(np.float32)
    ref = np.asarray(jax_apply(jl, jnp.asarray(x), fused=fused))
    got = quant_linear_apply(linear_from_jax(jax_tree(jl), "cpu"), torch.from_numpy(x),
                             fused=fused)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_w8a8_route_is_not_ported_yet():
    from mi_optimize_tpu_torch.models.quant_linear import quant_linear_apply

    jl = _jax_lin(8, "per_channel", -1, seed=2)
    tl = linear_from_jax(jax_tree(jl), "cpu")
    tl = tl.replace(spec=dataclasses.replace(tl.spec, abit=8, a_qtype="per_token",
                                             a_unsigned=False))
    with pytest.raises(NotImplementedError, match="A8"):
        quant_linear_apply(tl, torch.zeros(2, K))


@pytest.mark.parametrize("M,grouped", [(1, True), (19, True), (40, True), (64, False),
                                       (128, False)])
def test_plain_version_takes_the_path_the_reference_tile_selects(M, grouped):
    """The reference's row tile is the largest of 256..8 dividing M padded to
    8; tiles of at most 16 rows take the grouped rescale."""
    assert tdm._grouped(M, 4, 128) is grouped
