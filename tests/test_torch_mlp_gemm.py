"""The fused MLP's tensor-core routes (csrc/mlp_fused.cu, `mi_mlp_fused_mma`) in
the parts the CPU can check: their work plans (`ops.mlp_fused.gemv_plans`
for the M <= 8 kernel, `mma_plan` for the down phase above 8 rows), the
scratch the wrapper sizes, and a plain-torch model of the kernels'
arithmetic (centered codes, the grouped rescale with the rows' group sums,
act as bf16 planes, the K splits' partials added in split order), held
against the plain version `fused_mlp_ref`.

`_deal_gemv` mirrors mg_gemv's item arithmetic, `_deal_mma` the grids of
launch_tiled and mlp_mma_kernel's split ranges, and `_kernel_model` the
sums of both routes. The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py -k mlp_fused).

Tolerances: the model and the plain version are both f32 with the sums in
other orders, so the three-plane model agrees to 1e-5 of max|plain|; two
planes leave act within 2^-17 of itself, which the down product carries
into y at about 1e-5 of max|plain| (held to 5e-5).
"""
import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.core.packing import unpack_words
from mi_optimize_tpu_torch.ops import mlp_fused as mf

BLOCKS = mf.COOP_PER_SM * mf.H100_SMS  # the cooperative grid on an H100: 264 blocks
K7, I7 = 4096, 11008                   # Llama-2-7B's MLP widths

torch.set_num_threads(1)


def _ranges(n, splits):
    """Split s of n groups: [s*n // S, (s+1)*n // S), as the kernels cut K."""
    return [(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def _deal_gemv(M, K, inter, hidden, gk, ik, splits):
    """{(matrix, word column, word row): times streamed} of the "gemv" route:
    mg_gemv's items (column block of GEMV_COLS virtual columns, K split), a
    warp's 64 virtual columns, a lane's two word columns of 4 and the word
    rows 4c + t of its chunks c."""
    seen = {}
    for phase, (K_, g, nv, S) in enumerate(((K, gk, 2 * inter, splits[0]),
                                            (inter, ik, hidden, splits[1]))):
        ng, cpg = K_ // g, g // 32
        nblk = -(-nv // mf.GEMV_COLS)
        for item in range(nblk * S):
            cb, sp = item % nblk, item // nblk
            ga, gb = _ranges(ng, S)[sp]
            for warp in range(mf.GEMV_COLS // 64):
                v0 = cb * mf.GEMV_COLS + warp * 64
                if v0 >= nv:
                    continue
                for gq in range(8):
                    c0 = (v0 // 2 if phase == 0 else v0) + 4 * gq
                    cols = ([("gate", c0 + i) for i in range(4)] +
                            [("up", c0 + i) for i in range(4)] if phase == 0 else
                            [("down", c0 + i) for i in range(4)] +
                            [("down", c0 + 32 + i) for i in range(4)])
                    for mat, col in cols:
                        if col >= (inter if phase == 0 else hidden):
                            continue
                        for c in range(ga * cpg, gb * cpg):
                            for t in range(4):
                                key = (mat, col, 4 * c + t)
                                seen[key] = seen.get(key, 0) + 1
    return seen


def _deal_mma(M, K, inter, hidden, ik, plan):
    """{(matrix, word column, word row, row tile): times} of the "mma" route:
    P1's grid (I / 64 column tiles of gate and up, all of K), P2's (tiles of
    MMA_BN down columns x splits of I), each over the plan's row tiles; a
    stage is 8 word rows."""
    big, splits = plan
    seen = {}
    tiles_m = -(-M // mf.MMA_TILES[big][0])
    for mt in range(tiles_m):
        for tc in range(inter // 64):
            for v in range(128):  # virtual columns, gate and up interleaved by 8
                mat = "up" if (v >> 3) & 1 else "gate"
                col = tc * 64 + (v >> 4) * 8 + (v & 7)
                for r in range(K // 8):
                    seen[(mat, col, r, mt)] = seen.get((mat, col, r, mt), 0) + 1
        for tn in range(-(-hidden // mf.MMA_BN)):
            for ga, gb in _ranges(inter // ik, splits):
                for n in range(tn * mf.MMA_BN, min(hidden, (tn + 1) * mf.MMA_BN)):
                    for r in range(ga * ik // 8, gb * ik // 8):
                        seen[("down", n, r, mt)] = seen.get(("down", n, r, mt), 0) + 1
    return seen, tiles_m


# (M, K, inter, hidden, gk, ik): Llama-2-7B at g128 and per-channel gate/up,
# and the card tests' small shapes (a ragged split of 11 groups)
GEMV_SHAPES = [(1, K7, I7, K7, 128, 128), (8, K7, I7, K7, K7, 128), (3, 256, 512, 256, 64, 64),
               (8, 256, 512, 256, 256, 128), (5, 1024, 1408, 1024, 128, 128)]
MMA_SHAPES = [(9, 256, 512, 256, 128), (130, 256, 512, 256, 64), (200, 1024, 1408, 1024, 128),
              (40, 1024, 1408, 1024, 128), (2048, 256, 512, 256, 128)]


@pytest.mark.parametrize("M,K,inter,hidden,gk,ik", GEMV_SHAPES)
def test_gemv_plan_covers_every_column_and_word_row_once(M, K, inter, hidden, gk, ik):
    splits = mf.gemv_plans(M, K, inter, hidden, gk, ik)
    if K > 1024:  # the counting loops at 7B widths: only the plan's arithmetic below
        for (K_, g, nv), S in zip(((K, gk, 2 * inter), (inter, ik, hidden)), splits):
            r = _ranges(K_ // g, S)
            assert r[0][0] == 0 and r[-1][1] == K_ // g
            assert all(a1 == b0 for (_, a1), (b0, _) in zip(r, r[1:]))
            assert -(-nv // mf.GEMV_COLS) * mf.GEMV_COLS >= nv
        return
    seen = _deal_gemv(M, K, inter, hidden, gk, ik, splits)
    want = ({("gate", c, r) for c in range(inter) for r in range(K // 8)} |
            {("up", c, r) for c in range(inter) for r in range(K // 8)} |
            {("down", c, r) for c in range(hidden) for r in range(inter // 8)})
    assert set(seen) == want and set(seen.values()) == {1}


@pytest.mark.parametrize("M,K,inter,hidden,ik", MMA_SHAPES)
def test_mma_plan_covers_every_column_and_word_row_once(M, K, inter, hidden, ik):
    seen, tiles_m = _deal_mma(M, K, inter, hidden, ik, mf.mma_plan(M, hidden, inter, ik))
    want = ({(mat, c, r, mt) for mat in ("gate", "up") for c in range(inter)
             for r in range(K // 8) for mt in range(tiles_m)} |
            {("down", c, r, mt) for c in range(hidden) for r in range(inter // 8)
             for mt in range(tiles_m)})
    assert set(seen) == want and set(seen.values()) == {1}
    assert tiles_m * mf.MMA_TILES[M > mf.MMA_BIG_M][0] >= M


def test_ragged_split_of_the_card_test():
    """tests/test_torch_cuda_kernels.py::test_mlp_fused_ragged_split: 11
    groups of I in 8 splits of one or two groups, and in 11."""
    assert mf.mma_plan(200, 1024, 1408, 128) == (True, 8)
    assert sorted({b - a for a, b in _ranges(11, 8)}) == [1, 2]
    assert mf.mma_plan(40, 1024, 1408, 128) == (False, 11)


def _idle(items, blocks):
    waves = -(-items // blocks)
    return (waves * blocks - items) / (waves * blocks)


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("gk", [128, K7])
def test_gemv_plan_fills_the_grid_at_7b(M, gk):
    """Both phases of the M <= 8 kernel leave at most 5% of the 264 blocks
    idle at Llama-2-7B: P1 43 column blocks x 6 splits of K (per-channel
    gate/up: no split is possible, 43 items), P2 8 x 32 splits of I."""
    s1, s2 = mf.gemv_plans(M, K7, I7, K7, gk, 128)
    assert s2 == 32 and _idle(8 * s2, BLOCKS) <= 0.05
    if gk == 128:
        assert s1 == 6 and _idle(43 * s1, BLOCKS) <= 0.05
    else:
        assert s1 == 1


@pytest.mark.parametrize("M,splits,waves", [(9, 8, 1), (128, 4, 1), (2048, 1, 4)])
def test_mma_plan_fills_the_grid_at_7b(M, splits, waves):
    """The down phase's (tile x split) items fill the card at Llama-2-7B to
    5%: 264 blocks of [64, 128] tiles up to 128 rows, 132 of [128, 128]
    above; at M = 2048 its 512 tiles need no split."""
    big, s = mf.mma_plan(M, K7, I7, 128)
    rows, per_sm = mf.MMA_TILES[big]
    assert s == splits and big == (M > 128)
    items = -(-M // rows) * -(-K7 // mf.MMA_BN) * splits
    blocks = per_sm * mf.H100_SMS
    assert -(-items // blocks) == waves and _idle(items, blocks) <= 0.05


@pytest.mark.parametrize("M,K,inter,hidden,gk,ik", GEMV_SHAPES)
def test_gemv_scratch_fits_the_plan(M, K, inter, hidden, gk, ik):
    splits = mf.gemv_plans(M, K, inter, hidden, gk, ik)
    part, cnt = mf.gemv_scratch(M, inter, hidden, splits)
    for nv, s in zip((2 * inter, hidden), splits):
        if s > 1:  # the partials [s][M][virtual columns] and a counter a column block
            assert part >= s * M * nv and cnt >= -(-nv // mf.GEMV_COLS)
    assert 4 * part <= mf.MMA_SCRATCH


def _planes(a, n):
    """n bf16 planes of f32 a, each the rounding of what the ones before leave."""
    out, r = [], a
    for _ in range(n):
        p = r.to(torch.bfloat16).to(torch.float32)
        out.append(p)
        r = r - p
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_act_planes(seed):
    """Three bf16 planes rebuild an f32 exactly; two leave it within 2^-17."""
    a = torch.from_numpy(np.random.default_rng(seed).normal(size=4096).astype(np.float32))
    assert torch.equal(sum(_planes(a, 3)), a)
    two = sum(_planes(a, 2))
    assert not torch.equal(two, a)
    assert ((two - a).abs() <= a.abs() * 2.0 ** -17).all()


def _pack(q):
    """int codes [K, N] in 0..15 -> words-major int32 words [K/8, N]."""
    K, N = q.shape
    w = np.zeros((K // 8, N), dtype=np.uint32)
    for i in range(8):
        w |= q[i::8].astype(np.uint32) << np.uint32(4 * i)
    return torch.from_numpy(w.view(np.int32))


def _lin(rng, rows, cols, g, symmetric):
    """(words, scales, zeros) of a random packed int4 linear, kernel layout."""
    q = rng.integers(0, 16, (rows, cols))
    s = rng.uniform(0.5, 1.5, (rows // g, cols)).astype(np.float32) * rows ** -0.5 / 4
    z = (np.full_like(s, 8.0) if symmetric else
         rng.integers(2, 14, s.shape).astype(np.float32))
    return _pack(q), torch.from_numpy(s), torch.from_numpy(z)


def _qdot(planes, xsum_src, words, s, b, g, splits):
    """The kernels' sums for one product: per group D = sum over planes of
    plane . (q - 8) on the centered codes, y += s*D + (b + 8s) * xsum, the
    groups of each K split in order, the splits' partials added in split
    order."""
    c = (unpack_words(words, 4) - 8).to(torch.float32)
    ng = c.shape[0] // g
    out = None
    for ga, gb in _ranges(ng, splits):
        y = torch.zeros(planes[0].shape[0], c.shape[1])
        for gi in range(ga, gb):
            ks = slice(gi * g, (gi + 1) * g)
            d = sum(p[:, ks] @ c[ks] for p in planes)
            xs = xsum_src[:, ks].sum(dim=1, keepdim=True)
            y = y + (s[gi] * d + (b[gi] + 8.0 * s[gi]) * xs)
        out = y if out is None else out + y
    return out


def _kernel_model(x, lins, gk, ik, route, n_planes):
    """y [M, N] f32 as the route computes it: P1 gate and up (x one bf16
    plane; the "gemv" route splits K), act = silu(g) * u in f32, then down
    over act as `n_planes` bf16 planes with the rows' sums of the f32 act
    ("gemv") or of the planes ("mma": its ones column)."""
    (gw, gs, gz), (uw, us, uz), (dw, ds, dz) = lins
    M, K = x.shape
    inter, hidden = gw.shape[1], dw.shape[1]
    if route == "gemv":
        s1, s2 = mf.gemv_plans(M, K, inter, hidden, gk, ik)
    else:
        s1, s2 = 1, mf.mma_plan(M, hidden, inter, ik)[1]
    x32 = x.to(torch.float32)
    g = _qdot([x32], x32, gw, gs, -gz * gs, gk, s1)
    u = _qdot([x32], x32, uw, us, -uz * us, gk, s1)
    act = g * (1.0 / (1.0 + torch.exp(-g))) * u
    planes = _planes(act, n_planes)
    return _qdot(planes, act if route == "gemv" else sum(planes), dw, ds, -dz * ds, ik, s2)


@pytest.mark.parametrize("M", [1, 8, 9, 130])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("gk,ik", [(64, 64), (128, 128), ("K", 128)])
@pytest.mark.parametrize("n_planes", [2, 3])
def test_kernel_model_agrees_with_fused_mlp_ref(M, symmetric, gk, ik, n_planes):
    K, inter, hidden = 256, 512, 256
    gk = K if gk == "K" else gk  # per-channel gate and up
    rng = np.random.default_rng(M * 7 + gk + symmetric)
    lins = (_lin(rng, K, inter, gk, symmetric), _lin(rng, K, inter, gk, symmetric),
            _lin(rng, inter, hidden, ik, symmetric))
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    route = mf.route(M, torch.bfloat16, 4, gk, ik)
    assert route == ("gemv" if M <= 8 else "mma")
    got = _kernel_model(x, lins, gk, ik, route, n_planes)
    ref = mf.fused_mlp_ref(x.to(torch.float32), *(t for lin in lins for t in lin), bits=4,
                           k_group=gk, i_group=ik, qmin=0, inter=inter, hidden=hidden)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= (1e-5 if n_planes == 3 else 5e-5) * scale


@pytest.mark.parametrize("dtype,bits,gk,ik,M,want", [
    (torch.bfloat16, 4, 128, 128, 1, "gemv"), (torch.bfloat16, 4, 128, 128, 8, "gemv"),
    (torch.bfloat16, 4, 128, 128, 9, "mma"), (torch.bfloat16, 4, 4096, 32, 2048, "mma"),
    (torch.bfloat16, 4, 16, 128, 1, "cuda_core"), (torch.bfloat16, 4, 128, 16, 128, "cuda_core"),
    (torch.float32, 4, 128, 128, 1, "cuda_core"), (torch.bfloat16, 8, 128, 128, 128, "cuda_core"),
    (torch.bfloat16, 2, 64, 64, 1, "cuda_core")])
def test_route(dtype, bits, gk, ik, M, want):
    assert mf.route(M, dtype, bits, gk, ik) == want
