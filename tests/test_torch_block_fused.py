"""Plain version of the port's block_decode_mega against the JAX kernel
(ops/block_fused.py, interpret mode), f32, on the aligned small Llama.

x_out: rtol = atol = 2e-4 (the two sum the dequant dots in different orders).
New int8 rows: equal, except that a one-code difference is allowed on at
most 0.1% of entries, since a different sum order can move a value across a
.5 rounding tie. Scales: rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.ops.block_fused import block_decode_mega as jax_block_decode_mega
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import block_fused
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from tests.test_torch_convert import small_models


def random_cache(shape, seed):
    """int8 k/v codes and positive scales for a cache of `shape` [.., T, Hkv, D]."""
    rng = np.random.default_rng(seed)
    c = {f: rng.integers(-90, 91, shape).astype(np.int8) for f in ("k", "v")}
    for f in ("k_scale", "v_scale"):
        c[f] = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 1e-3).astype(np.float32)
    return c


def assert_rows_match(got, ref):
    """int8 rows equal up to rare one-code tie flips (<= 0.1% of entries)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1
    assert np.count_nonzero(d) <= 1e-3 * d.size


@pytest.mark.parametrize("T,pos", [(128, 5), (256, 5), (256, 130)])
def test_plain_matches_jax_kernel(T, pos):
    jm, pm = small_models(seed=T + pos)
    jblk = jax_fuse_for_serving(jm).params["layers"][1]
    pblk = fuse_for_serving(pm).params["layers"][1]
    jcfg, cfg = jm.config, pm.config
    cache = random_cache((1, T, cfg.num_kv_heads, cfg.head_dim), seed=pos)
    x = np.random.default_rng(T).standard_normal((1, 1, cfg.hidden_size)).astype(np.float32)

    jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray([pos]))
    jx, jcache = jax_block_decode_mega(
        {k: v for k, v in jblk.items() if k != "mega"}, jblk["mega"], jnp.asarray(x),
        jcos.reshape(-1), jsin.reshape(-1), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos), jcfg, interpret=True)

    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    before = block_fused.launches
    x_out, krow, vrow, ks, vs = block_fused.block_decode_rows(
        pblk, pblk["mega"], torch.from_numpy(x), cos.reshape(-1), sin.reshape(-1), tcache,
        pos, cfg)
    assert block_fused.launches == before

    np.testing.assert_allclose(x_out.numpy().reshape(1, 1, -1), np.asarray(jx),
                               rtol=2e-4, atol=2e-4)
    assert_rows_match(krow.numpy(), np.asarray(jcache["k"][0, pos]))
    assert_rows_match(vrow.numpy(), np.asarray(jcache["v"][0, pos]))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jcache["k_scale"][0, pos]), rtol=1e-5)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jcache["v_scale"][0, pos]), rtol=1e-5)


def test_block_decode_mega_scatters_rows_in_place():
    _, pm = small_models(seed=4)
    pblk = fuse_for_serving(pm).params["layers"][0]
    cfg = pm.config
    T, pos = 128, 9
    tcache = {k: torch.from_numpy(v) for k, v in
              random_cache((1, T, cfg.num_kv_heads, cfg.head_dim), seed=1).items()}
    before = {k: v.clone() for k, v in tcache.items()}
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 1, cfg.hidden_size)).astype(np.float32))
    rows = block_fused.block_decode_rows(pblk, pblk["mega"], x, cos.reshape(-1),
                                         sin.reshape(-1), tcache, pos, cfg)
    y, cache = block_fused.block_decode_mega(pblk, pblk["mega"], x, cos.reshape(-1),
                                             sin.reshape(-1), tcache, pos, cfg)
    assert cache is tcache and y.shape == x.shape
    torch.testing.assert_close(y.reshape(1, -1), rows[0])
    for f, i in (("k", 1), ("v", 2), ("k_scale", 3), ("v_scale", 4)):
        assert torch.equal(cache[f][0, pos], rows[i])
        keep = torch.ones(T, dtype=torch.bool)
        keep[pos] = False
        assert torch.equal(cache[f][0, keep], before[f][0, keep])


def test_mega_contract_matches_reference():
    """The port attaches "mega" where the reference does, and not to a block
    with a bias or a non-packed linear."""
    jm, pm = small_models(seed=2)
    assert all("mega" in b for b in jax_fuse_for_serving(jm).params["layers"])
    pf = fuse_for_serving(pm)
    assert all("mega" in b for b in pf.params["layers"])
    blk = dict(pf.params["layers"][0])
    blk["o_proj"] = blk["o_proj"].replace(bias=torch.zeros(blk["o_proj"].out_features))
    assert not block_fused.block_mega_supported(blk, pm.config)
