"""The port's paged flash decode (ops/paged_attention.py, kernel B8) against
the JAX kernel in interpret mode, on the JAX test's two shapes (page 16 with
4 pages a slot, page 8 with 3) and its inputs: slots at position 0, at the
first row of the last page and at the last row, distinct pages per slot.
float32, rtol = atol = 2e-5 (the JAX test's tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.ops.paged_attention import paged_flash_attention as jax_paged
from mi_optimize_tpu_torch.ops import paged_attention

H, HKV, D, B, N_PAGES = 4, 2, 128, 3, 16


def _inputs(page_size, pps):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, H * D)).astype(np.float32)
    pk = rng.normal(size=(N_PAGES, page_size, HKV, D)).astype(np.float32)
    pv = rng.normal(size=(N_PAGES, page_size, HKV, D)).astype(np.float32)
    table = rng.choice(N_PAGES, size=(B, pps), replace=False).astype(np.int32)
    positions = np.array([0, page_size * (pps - 1), page_size * pps - 1], np.int32)
    return q, pk, pv, table, positions


@pytest.mark.parametrize("page_size,pps", [(16, 4), (8, 3)])
def test_plain_matches_jax_kernel(page_size, pps):
    assert paged_attention.paged_attention_supported(page_size, D)
    q, pk, pv, table, positions = _inputs(page_size, pps)
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=D, page_size=page_size)
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                jnp.asarray(table), jnp.asarray(positions), interpret=True, **kw))
    before = paged_attention.launches
    got = paged_attention.paged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), table, positions, **kw)
    assert paged_attention.launches == before
    assert got.dtype == torch.float32 and got.shape == (B, H * D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # bf16 q: the output comes back in q's dtype, within bf16 rounding
    q16 = torch.from_numpy(q).to(torch.bfloat16)
    got16 = paged_attention.paged_flash_attention(
        q16, torch.from_numpy(pk), torch.from_numpy(pv), table, positions, **kw)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_dead_pages_are_not_read():
    """Pages past a slot's live page may hold anything (a stale page, NaN):
    the result is the same, as with the reference's live-page clamp."""
    q, pk, pv, table, positions = _inputs(16, 4)
    kw = dict(n_heads=H, n_kv_heads=HKV, head_dim=D, page_size=16)
    args = [torch.from_numpy(a) for a in (q, pk, pv)]
    ref = paged_attention.paged_flash_attention(*args, table, positions, **kw)
    dead = table.copy()
    dead[0, 1:] = N_PAGES - 1
    args[1][table[0, 1:]] = float("nan")
    got = paged_attention.paged_flash_attention(*args, dead, positions, **kw)
    assert torch.equal(got[0], ref[0])
