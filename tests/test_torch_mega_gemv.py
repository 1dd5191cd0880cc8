"""The one-token whole-model kernel's tensor-core layer loop
(csrc/model_mega4.cu over csrc/flat_gemv.cuh, the "mega4" route of
`ops.model_fused.model_decode_mega`) in the parts the CPU can check: the
grouped rescale with a bias table a group and column (an asymmetric grid),
as a plain-torch model of fg_gemv<T, true>'s sums held against the plain
version `qdot_ref`; its work plan (`model_flat.flat_plans(..., lm=False)`: the
flat kernel's plan of the four layer GEMVs, no lm_head) and scratch; and `mega_route`, which
sends 4-bit words to the new loop and 2- and 8-bit words to the CUDA-core
mega_kernel. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py -k model_decode_mega).
"""
import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import model_flat, model_fused
from mi_optimize_tpu_torch.ops.dequant_matmul import qdot_ref
from mi_optimize_tpu_torch.serving import megadecode
from tests.test_torch_cuda_kernels import WHOLE_MODEL, _cache, _small
from tests.test_torch_flat_gemv import (BLOCKS, GEMV_SHAPES, _cfg_7b, _kernel_model, _packed,
                                        _small_cfg, check_covers, check_scratch)

GEMVS = ("qkv", "o", "gate_up", "down")


def _meta(g, zc=None):
    """model_decode_mega's meta: 4-bit words in groups of g, a zero constant
    zc a linear, or None (bias tables)."""
    return (4, g, g, g, g, zc, zc, zc, zc)


# (name, config, group): Llama-2-7B at g128 and g32, and the card tests'
# 4-bit whole-model configurations (WHOLE_MODEL): intermediate size 1024 at
# g128 and g32, and 1000 at group 8
PLANS = [("7b", _cfg_7b(), 128), ("7b", _cfg_7b(), 32), ("small", _small_cfg(1024, 160), 128),
         ("small_g32", _small_cfg(1024, 160), 32), ("small_1000", _small_cfg(1000, 160), 8)]


def _plans(name, g):
    cfg = next(c for n, c, gg in PLANS if n == name and gg == g)
    return model_flat.flat_plans(cfg, _meta(g), lm=False)


# ---------------------------------------------------------------------------
# (a) the grouped rescale with a bias table
# ---------------------------------------------------------------------------

# the g8 / I = 1000 case's down_proj (1000 inputs, 66 splits of its 125
# groups: one or two a split) and gate/up (512 inputs at group 8)
BIAS_SHAPES = GEMV_SHAPES + [(1000, 512, 8, 4, 66), (512, 64, 8, 1, 8)]


@pytest.mark.parametrize("K,N,g,ws,splits", BIAS_SHAPES)
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_grouped_rescale_with_bias_table_agrees_with_qdot_ref(K, N, g, ws, splits, rows):
    """fg_gemv<T, true>'s arithmetic on numpy inputs from a seed: an f32 row
    in three planes or a bf16-valued row in one, an affine grid's bias
    b = -z * s with a zero z in 0..15 a group and column (so b + 8s is far
    from 0 where z is), agrees with qdot_ref on the same table to 1e-6 of
    its largest output: only the order of the f32 additions differs."""
    rng = np.random.default_rng(K + N + g + splits)
    x = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    if rows == "bf16":
        x = x.to(torch.bfloat16).float()
    packed = _packed(rng, K, N)
    s = torch.from_numpy((rng.random((K // g, N)) * 0.02 + 1e-3).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 16, (K // g, N)).astype(np.float32))
    b = -z * s
    assert float((z - 8).abs().mean()) > 3
    ref = qdot_ref(x[None], packed, s, b, 4, g)[0]
    got = _kernel_model(x, packed, s, 0.0, g, ws, splits, 1 if rows == "bf16" else 3, b=b)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_bias_table_is_not_one_constant():
    """The table matters: the same inputs through the model with one
    constant zero (8, the mean of 0..15 rounded) miss qdot_ref on the table
    by far more than 1e-6."""
    rng = np.random.default_rng(5)
    K, N, g = 1024, 64, 128
    x = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    packed = _packed(rng, K, N)
    s = torch.full((K // g, N), 0.01)
    b = -torch.from_numpy(rng.integers(0, 16, (K // g, N)).astype(np.float32)) * s
    ref = qdot_ref(x[None], packed, s, b, 4, g)[0]
    got = _kernel_model(x, packed, s, 8.0, g, 8, 1, 3)
    assert float((got - ref).abs().max()) > 1e-3 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# (b), (c) the plan and its scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,g", [(n, g) for n, _, g in PLANS])
def test_plan_is_the_flat_plan_without_the_lm_head(name, g):
    """The four layer GEMVs take the flat kernel's plan (the same shapes,
    the same search), so the layer loop's phases are cut as B3's are."""
    cfg = next(c for n, c, gg in PLANS if n == name and gg == g)
    flat = model_flat.flat_plans(cfg, _meta(g, 8.0) + (g, 8.0, cfg.vocab_size))
    assert _plans(name, g) == flat[:4]


@pytest.mark.parametrize("name,g", [(n, g) for n, _, g in PLANS])
@pytest.mark.parametrize("i", range(4))
def test_plan_covers_every_column_and_word_row_once(name, g, i):
    """Every (output column, word row) of qkv, o_proj, gate/up and down_proj
    is streamed by exactly one warp, in whole-group splits that cover K."""
    plans = _plans(name, g)
    assert len(plans) == 4
    check_covers(*plans[i])


@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("i", range(4))
def test_plan_fills_the_grid_at_7b(g, i):
    """At every Llama-2-7B layer GEMV, at group 32 and 128, the items leave
    at most 5% of the 264 blocks' turns idle, and 250 or more blocks have an
    item in the first wave."""
    ncols, K, gg, ws, splits = _plans("7b", g)[i]
    items = -(-ncols // (ws * model_flat.FLAT_STRIP)) * splits
    waves = -(-items // BLOCKS)
    assert waves * BLOCKS - items <= 0.05 * waves * BLOCKS
    assert min(items, BLOCKS) >= 0.94 * BLOCKS


@pytest.mark.parametrize("name,g", [(n, g) for n, _, g in PLANS])
def test_scratch_fits_the_plan(name, g):
    """The wrapper's flat_scratch of the four GEMVs holds every split's
    partials and stages each split in one window (`check_scratch`)."""
    check_scratch(_plans(name, g))


# ---------------------------------------------------------------------------
# (d) the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,symmetric,head_dim,inter,group", WHOLE_MODEL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_the_tensor_core_loop_for_4_bit_words(monkeypatch, bits, symmetric,
                                                          head_dim, inter, group, dtype):
    """`mega_route` on every whole-model configuration the card tests run,
    both grids: "mega4" for 4-bit words, "cuda_core" (the CUDA-core
    mega_kernel) for 2- and 8-bit words. The wrapper follows it in both model
    dtypes:
    with the launch stubbed, a 4-bit stack goes to mi_model_decode_mega4 in
    model_mega4's library with the plan without the lm_head, flat_scratch's partials
    and the stack's bias tables (none on the symmetric grid), and counts a
    launch in both `launches` and `launches_mega4`; the others go to
    mi_model_decode_mega and count in `launches` only."""
    cfg, cpu, _ = _small("cpu", bits=bits, groupsize=group, head_dim=head_dim,
                         symmetric=symmetric, inter=inter)
    stack, meta = megadecode.stack_serving(cpu)
    assert (meta[5] is None) == (not symmetric)
    route = model_fused.mega_route(meta)
    assert route == ("mega4" if bits == 4 else "cuda_core")

    calls = []
    monkeypatch.setattr(model_fused, "_call", lambda name, args, argtype, b, dt, dev,
                        lib="model_fused": calls.append((name, lib, args)))
    monkeypatch.setattr(model_fused, "sm_count", lambda dev: 132)
    pos = 100
    cache = _cache(cfg, 256, pos, layers=cfg.num_layers)
    x = torch.randn(1, 1, cfg.hidden_size).to(dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    for counter in ("launches", "launches_mega4"):
        monkeypatch.setattr(model_fused, counter, getattr(model_fused, counter))
    before, before4 = model_fused.launches, model_fused.launches_mega4
    model_fused._model_decode_mega_cuda(stack, x, cos.reshape(-1), sin.reshape(-1), cache, pos,
                                        cfg, meta)
    (name, lib, args), = calls
    assert model_fused.launches == before + 1
    assert model_fused.launches_mega4 == before4 + (route == "mega4")
    if route == "cuda_core":
        assert (name, lib) == ("mi_model_decode_mega", "model_fused")
        return
    assert (name, lib) == ("mi_model_decode_mega4", "model_mega4")
    plans = model_flat.flat_plans(cfg, meta, lm=False)
    assert list(args.f.plan_ws[:4]) == [p[3] for p in plans]
    assert list(args.f.plan_splits[:4]) == [p[4] for p in plans]
    assert (args.f.n_part, args.f.plan_kc) == model_flat.flat_scratch(plans)
    assert all(getattr(args.f, n) == getattr(args.m, n) for n in ("qkv", "ds", "scratch", "pos"))
    tables = [args.m.qb, args.m.ob, args.m.gub, args.m.db]
    assert all((t is None) == symmetric for t in tables)
