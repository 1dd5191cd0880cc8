"""The batched whole-model kernel's 4-bit GEMV (csrc/batch_gemv.cuh) in the
parts the CPU can check: its work plan (`ops.model_fused.gemv_plan`, run on
every launch), which cuts each GEMV into (column tile x K split) items, and
a plain-torch model of the kernel's arithmetic (rows as exact bf16 planes,
centered codes, the grouped rescale per group, the warps' and splits' sums
added in order), held against the plain version `qdot_ref`.

`_deal` mirrors bg_gemv's index arithmetic (items, tiles, splits, warp
strips and their share of a split's groups); `_kernel_model` mirrors its
sums. The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.ops import model_fused as mf
from mi_optimize_tpu_torch.ops.dequant_matmul import qdot_ref

BLOCKS = mf.COOP_PER_SM * mf.H100_SMS  # the cooperative grid on an H100: 264 blocks

# (name, output columns (gate columns for gate/up), K, nc) of Llama-2-7B's GEMVs
SHAPES_7B = [("qkv", 12288, 4096, 1), ("o", 4096, 4096, 1), ("gate_up", 11008, 4096, 2),
             ("down", 4096, 11008, 1), ("lm_head", 32000, 4096, 1)]
# small ragged shapes: a vocab that is not a multiple of a strip, the card
# tests' intermediate size 1000 at group 8 (gate/up and down)
SHAPES_SMALL = [("ragged", 200, 384, 1, 128), ("gate_up_1000", 1000, 512, 2, 8),
                ("down_1000", 512, 1000, 1, 8)]
CASES = ([(n, c, k, nc, g) for n, c, k, nc in SHAPES_7B for g in (32, 128)]
         + SHAPES_SMALL)


def _deal(ncols, K, g, nc, ws, splits):
    """What each warp of bg_gemv computes: [(item, split, (ga, gb), first
    column, (wa, wb))], a warp's strip of GEMV_STRIP // nc output columns from
    `first column` over groups [wa, wb) of its item's split [ga, gb)."""
    ng, sw, ks = K // g, mf.GEMV_STRIP // nc, mf.GEMV_WARPS // ws
    ntiles = -(-ncols // (ws * sw))
    out = []
    for item in range(ntiles * splits):
        tile, sp = item % ntiles, item // ntiles
        ga, gb = sp * ng // splits, (sp + 1) * ng // splits
        for warp in range(mf.GEMV_WARPS):
            strip, ksub = warp % ws, warp // ws
            wa, wb = ga + ksub * (gb - ga) // ks, ga + (ksub + 1) * (gb - ga) // ks
            out.append((item, sp, (ga, gb), (tile * ws + strip) * sw, (wa, wb)))
    return out


@pytest.mark.parametrize("name,ncols,K,nc,g", CASES)
def test_plan_covers_every_column_and_group_once(name, ncols, K, nc, g):
    """Every (output column, group) is computed by exactly one warp; the
    splits are whole groups, in order, covering K, none empty; a split that
    the block's warps share fits one staged window."""
    ws, splits = mf.gemv_plan(ncols, K, g, nc, BLOCKS)
    ng = K // g
    assert ws in (1, 2, 4, 8) and 1 <= splits <= ng
    count = np.zeros((ncols, ng), np.int32)
    bounds = {}
    for item, sp, (ga, gb), col, (wa, wb) in _deal(ncols, K, g, nc, ws, splits):
        bounds[sp] = (ga, gb)
        if col < ncols:
            count[col:col + mf.GEMV_STRIP // nc, wa:wb] += 1
        if ws < mf.GEMV_WARPS:
            assert (gb - ga) * g <= mf.GEMV_KC
    assert (count == 1).all()
    b = [bounds[s] for s in range(splits)]
    assert b[0][0] == 0 and b[-1][1] == ng
    assert all(ga < gb for ga, gb in b)
    assert all(b[i][1] == b[i + 1][0] for i in range(splits - 1))


@pytest.mark.parametrize("name,ncols,K,nc", SHAPES_7B)
@pytest.mark.parametrize("g", [32, 128])
def test_plan_fills_the_grid_at_7b(name, ncols, K, nc, g):
    """At every Llama-2-7B GEMV, at group 32 and 128, the items leave at
    most 5% of the 264 blocks' turns idle (waves x 264 - items): N = 4096
    (o, down) as well as N = 32000."""
    ws, splits = mf.gemv_plan(ncols, K, g, nc, BLOCKS)
    items = -(-ncols // (ws * mf.GEMV_STRIP // nc)) * splits
    waves = -(-items // BLOCKS)
    assert waves * BLOCKS - items <= 0.05 * waves * BLOCKS


@pytest.mark.parametrize("g", [32, 128])
def test_scratch_fits_the_wrappers_allocation(g):
    """The wrapper allocates gemv_scratch(batch_plans(...)): the f32
    partials every split of every GEMV writes (bg_gemv's index of a lane's
    last value), and a counter for every tile."""
    cfg = LlamaConfig.llama2_7b()
    meta = (4, g, g, g, g, 8.0, 8.0, 8.0, 8.0)
    plans = mf.batch_plans(cfg, meta, (g, 8.0, cfg.vocab_size, 0))
    assert [p[:2] for p in plans] == [(12288, 1), (4096, 1), (11008, 2), (4096, 1), (32000, 1)]
    n_part, n_counters = mf.gemv_scratch(plans)
    for ncols, nc, ws, splits in plans:
        ntiles = -(-ncols // (ws * mf.GEMV_STRIP // nc))
        assert ntiles <= n_counters
        if splits > 1:
            last = (((splits - 1) * ntiles + ntiles - 1) * ws + ws - 1) * mf.GEMV_PART
            assert last + mf.GEMV_PART <= n_part
    assert mf.batch_plans(cfg, meta)[4] == (0, 1, 1, 1)
    assert mf.batch_plans(cfg, meta)[:4] == plans[:4]  # the lm rows change no other plan


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def _planes(x, n):
    """x (f32) as n bf16 planes, each rounded to nearest from what the
    planes before it leave: bg_stage's split."""
    out, rem = [], x.clone()
    for _ in range(n):
        p = rem.to(torch.bfloat16)
        out.append(p)
        rem = rem - p.float()
    return out


def _split_values(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4096).astype(np.float32) * np.exp2(
        rng.integers(-20, 21, 4096)).astype(np.float32)
    near = np.concatenate([np.exp2(np.float32(e)) * (1 + rng.random(64).astype(np.float32))
                           for e in (-100, 100)]).astype(np.float32)
    exact = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.concatenate([x, near, -near, [0.0]]).astype(np.float32)), exact


@pytest.mark.parametrize("seed", [0, 1])
def test_three_planes_reconstruct_f32_rows_exactly(seed):
    """hi + mid + lo is x exactly, for values over 40 binades, near 2^-100
    and 2^100, and 0; an exact bf16 value is its own first plane (mid = lo
    = 0); a centered code times a plane is exact in f32."""
    x, exact = _split_values(seed)
    hi, mid, lo = _planes(x, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    e = _planes(exact.float(), 3)
    assert torch.equal(e[0], exact) and not e[1].float().any() and not e[2].float().any()
    codes = torch.arange(-8, 8, dtype=torch.float32)[:, None]
    for p in (hi, mid, lo):
        assert torch.equal((codes * p.float()).double(), codes.double() * p.double())


def _packed(rng, K, N):
    """Random 4-bit codes [K, N] as words-major int32 [K/8, N]."""
    u = rng.integers(0, 16, (K // 8, 8, N)).astype(np.uint32)
    words = (u << (4 * np.arange(8, dtype=np.uint32))[None, :, None]).sum(axis=1, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32))


def _kernel_model(x, packed, s, b, g, ws, splits, n_planes):
    """bg_gemv's sums in plain torch: per group D = sum over the planes of
    plane x (q - 8) (exact products, f32 sums), xsum = the sum of the
    group's words' 8-value sums, y += s*D + (b + 8s)*xsum; a split's warps
    (the 8 // ws that share a strip) each sum their groups and add in warp
    order; the splits' partials add in split order."""
    M, K = x.shape
    ng, wpg, ks = K // g, g // 8, mf.GEMV_WARPS // ws
    codes = (torch.stack([(packed >> (4 * i)) & 15 for i in range(8)], 1).reshape(K, -1)
             - 8).float()
    planes = [p.float() for p in _planes(x, n_planes)]
    wsum = x.reshape(M, K // 8, 8).sum(-1)
    y = torch.zeros(M, packed.shape[1])
    for sp in range(splits):
        ga, gb = sp * ng // splits, (sp + 1) * ng // splits
        part = torch.zeros_like(y)
        for k in range(ks):
            acc = torch.zeros_like(y)
            for gi in range(ga + k * (gb - ga) // ks, ga + (k + 1) * (gb - ga) // ks):
                sl = slice(gi * g, (gi + 1) * g)
                d = sum(p[:, sl] @ codes[sl] for p in planes)
                xs = wsum[:, gi * wpg:(gi + 1) * wpg].sum(-1, keepdim=True)
                acc = acc + (s[gi] * d + (b[gi] + 8 * s[gi]) * xs)
            part = part + acc
        y = y + part
    return y


@pytest.mark.parametrize("M,K,N,g,ws,splits", [(8, 4096, 96, 128, 8, 11), (8, 4096, 64, 128, 1, 4),
                                               (5, 11008, 64, 128, 4, 16),
                                               (3, 1024, 64, 32, 8, 6), (1, 512, 40, 8, 2, 8)])
@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_grouped_rescale_model_agrees_with_qdot_ref(M, K, N, g, ws, splits, rows, symmetric):
    """The kernel's arithmetic on numpy inputs from a seed (f32 rows in three
    planes, bf16-valued rows in one; a symmetric grid's bias -8s or a bias
    table) agrees with qdot_ref to 1e-6 of its largest output: only the
    order of the f32 additions differs."""
    rng = np.random.default_rng(K + N + g + M)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    if rows == "bf16":
        x = x.to(torch.bfloat16).float()
    packed = _packed(rng, K, N)
    s = torch.from_numpy((rng.random((K // g, N)) * 0.02 + 1e-3).astype(np.float32))
    zero = 8.0 if symmetric else torch.from_numpy(rng.integers(0, 16, (K // g, N)).astype(
        np.float32))
    b = -zero * s
    ref = qdot_ref(x, packed, s, b, 4, g)
    got = _kernel_model(x, packed, s, b, g, ws, splits, 1 if rows == "bf16" else 3)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_one_plane_of_f32_rows_is_not_exact():
    """The three planes matter: the same f32 rows through one bf16 plane
    miss qdot_ref by far more than 1e-6 (the bf16 rounding of x)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32))
    packed = _packed(rng, 1024, 64)
    s = torch.full((8, 64), 0.01)
    ref = qdot_ref(x, packed, s, -8 * s, 4, 128)
    got = _kernel_model(x, packed, s, -8 * s, 128, 8, 1, 1)
    assert float((got - ref).abs().max()) > 1e-4 * float(ref.abs().max())
