"""Port quantization numerics (mi_optimize_tpu_torch.core.qparams) against the
JAX package: identical integer grids, per-channel and per-group, symmetric
and asymmetric (both round half to even on a correctly rounded quotient)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.core import qparams as jq
from mi_optimize_tpu_torch.core import qparams as tq


@pytest.mark.parametrize("qtype,groupsize", [("per_channel", -1), ("per_group", 32)])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_matches_jax(qtype, groupsize, symmetric, bits):
    x = np.random.default_rng(bits).standard_normal((24, 128)).astype(np.float32)
    jdq, js, jz = jq.quantize_dequantize(jnp.asarray(x), bits, qtype, groupsize, symmetric)
    tdq, ts, tz = tq.quantize_dequantize(torch.from_numpy(x), bits, qtype, groupsize, symmetric)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tdq.numpy(), np.asarray(jdq), rtol=1e-6, atol=1e-7)
    ji = jq.quantize_to_int(jdq, js, jz, bits, qtype, groupsize)
    ti = tq.quantize_to_int(tdq, ts, tz, bits, qtype, groupsize)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_qrange_and_half_even_rounding():
    assert tq.qrange(4, False) == (-8, 7, 4, False)
    assert tq.qrange(4, True) == (0, 15, 4, True)
    r = tq.qrange(8, False)
    q = tq.quantize(torch.tensor([0.5, 1.5, 2.5, -0.5]), torch.tensor(1.0), torch.tensor(0.0), r)
    assert q.tolist() == [0.0, 2.0, 2.0, -0.0]
