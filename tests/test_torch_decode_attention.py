"""The port's decode attention (ops/decode_attention.py) against the JAX
package's fused_decode_attention in interpret mode: the same numpy inputs,
GQA with 2 q heads a kv head and with 1, the position at 0, mid-cache and
the last row, f32 and bf16 rows.

Tolerances: the new int8 row and its scales equal (the same IEEE operations
on both sides), the rest of the cache untouched, the attention output to
1e-5 (f32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.ops.decode_attention import fused_decode_attention as jax_fda
from mi_optimize_tpu_torch.ops import decode_attention as da

T, D = 24, 32


def _inputs(H, Hkv, pos, seed, bf16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, H * D)).astype(np.float32)
    k = (2.0 * rng.normal(size=(1, Hkv * D))).astype(np.float32)
    v = rng.normal(size=(1, Hkv * D)).astype(np.float32)
    if bf16:  # the bf16 values both sides see, as exact f32 numbers
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (q, k, v))
    ang = pos / (10000.0 ** (np.arange(0, D, 2) / D))
    cos = np.cos(np.concatenate([ang, ang]))[None].astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang]))[None].astype(np.float32)
    ck = rng.integers(-127, 128, size=(T, Hkv, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(T, Hkv, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(T, Hkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(T, Hkv)).astype(np.float32)
    return q, k, v, cos, sin, ck, cv, ks, vs


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (2, 2)])
@pytest.mark.parametrize("pos", [0, 11, T - 1])
def test_matches_jax(H, Hkv, pos, bf16):
    q, k, v, cos, sin, ck, cv, ks, vs = _inputs(H, Hkv, pos, seed=pos + 7 * H, bf16=bf16)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jout, jck, jcv, jks, jvs = jax_fda(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs), pos,
        interpret=True, **kw)
    caches = [torch.from_numpy(a.copy()) for a in (ck, cv, ks, vs)]
    before = da.launches
    out, pck, pcv, pks, pvs = da.fused_decode_attention(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), torch.from_numpy(cos),
        torch.from_numpy(sin), *caches, pos, **kw)
    assert pck is caches[0] and pks is caches[2]  # written in place
    for got, ref in ((pck, jck), (pcv, jcv), (pks, jks), (pvs, jvs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # rows other than pos are untouched
    others = np.arange(T) != pos
    np.testing.assert_array_equal(pck.numpy()[others], ck[others])
    assert out.dtype == torch.float32 and out.shape == (1, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    assert da.launches == before  # CPU tensors: the plain version, no launch
