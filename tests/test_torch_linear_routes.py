"""The packed-int4 linear kernels' routing and tiling, which run in Python on
every call: which dequant_matmul kernel an (M, dtype, bits, group) call
takes, how the gemv16 kernel splits K (whole groups, in order, covering K,
within its scratch limit, enough blocks to fill the card), and which tile
the tensor-core kernels of dequant_matmul and w4a8_matmul take."""
import pytest
import torch

from mi_optimize_tpu_torch.ops import dequant_matmul as dm
from mi_optimize_tpu_torch.ops import w4a8_matmul as w4

BF16, F32 = torch.bfloat16, torch.float32


def _splits(n, S):
    """[(first, end)] of each of S splits of n units, as the kernels cut
    them: split s covers [s*n/S, (s+1)*n/S)."""
    return [(s * n // S, (s + 1) * n // S) for s in range(S)]


@pytest.mark.parametrize("M,dtype,bits,group,kernel", [
    (1, BF16, 4, 128, "gemv16"), (8, BF16, 4, 128, "gemv16"), (16, BF16, 4, 32, "gemv16"),
    (1, BF16, 4, 4096, "gemv16"), (17, BF16, 4, 128, "mma"), (128, BF16, 4, 128, "mma"),
    (2048, BF16, 4, 64, "mma"), (1, BF16, 4, 8, "mma"), (16, BF16, 4, 16, "mma"),
    (1, F32, 4, 128, "cuda_core"), (128, F32, 4, 128, "cuda_core"),
    (1, BF16, 8, 128, "cuda_core"), (128, BF16, 2, 64, "cuda_core")])
def test_route(M, dtype, bits, group, kernel):
    """bf16 x with 4-bit words takes the tensor-core kernels (gemv16 up to 16
    rows where a group is whole k32 chunks, mma otherwise); f32 x and the 2-
    and 8-bit widths keep the CUDA-core kernels."""
    assert dm.route(M, dtype, bits, group) == kernel
    assert kernel in dm.COUNTERS


SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]


@pytest.mark.parametrize("N,K,group", [(n, k, g) for n, k in SHAPES_7B for g in (32, 128)]
                         + [(200, 384, 128), (4096, 4096, 4096), (11008, 4096, 4096),
                            (64, 11008, 128)])
@pytest.mark.parametrize("M", [1, 16])
def test_gemv_splits_cover_k_in_whole_groups(M, N, K, group):
    """Splits cover the groups exactly, in order, none empty (so no split
    straddles a group); the f32 partials fit GEMV_SCRATCH; and the grid
    reaches a block an SM unless every group already has a split of its
    own."""
    ng = K // group
    S = dm.gemv_splits(M, N, K, group)
    bounds = _splits(ng, S)
    assert 1 <= S <= ng and len(bounds) == S
    assert bounds[0][0] == 0 and bounds[-1][1] == ng
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(S - 1))
    assert sum(b - a for a, b in bounds) * group == K
    assert S == 1 or S * M * N * 4 <= dm.GEMV_SCRATCH
    blocks = -(-N // dm.GEMV_COLS) * S
    assert blocks >= dm.SMS or S == ng


def test_gemv_splits_stay_within_the_scratch_limit():
    M, N, K, group = 16, 1 << 20, 4096, 32
    S = dm.gemv_splits(M, N, K, group)
    assert S * M * N * 4 <= dm.GEMV_SCRATCH < 2 * S * M * N * 4


@pytest.mark.parametrize("M,N,K", [(17, 4096, 4096), (64, 200, 384), (65, 12288, 4096),
                                   (128, 4096, 4096), (128, 4096, 11008), (128, 12288, 4096),
                                   (128, 22016, 4096), (128, 32000, 4096), (2048, 4096, 4096),
                                   (2048, 32000, 4096), (1, 4096, 1000)])
def test_mma_plan(M, N, K):
    """The mma kernel's tile is [64, 128] up to 64 rows, else [128, 128];
    tiles that fill the card take all of K; fewer are split over whole
    64-k steps, in order, covering K, into no more than two blocks an SM
    asks and within MMA_SCRATCH."""
    tile, S = dm.mma_plan(M, N, K)
    assert tile == dm.MMA_TILES[0 if M <= 64 else 1]
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    steps = -(-K // dm.MMA_STEP)
    bounds = _splits(steps, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == steps and all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(S - 1))
    assert S == 1 or (tiles < dm.SMS and S * M * N * 4 <= dm.MMA_SCRATCH)
    assert tiles * S >= dm.SMS or S == steps
    assert tiles * (S - 1) < 2 * dm.SMS


def test_mma_plan_fills_the_card_at_the_prefill():
    """At M = 128, N = 4096 (a prefill's o_proj, the narrowest served
    linear) the split gives every SM two blocks."""
    tile, S = dm.mma_plan(128, 4096, 4096)
    assert -(-128 // tile[0]) * -(-4096 // tile[1]) * S >= 2 * dm.SMS


@pytest.mark.parametrize("M,N,tile", [(128, 4096, 2), (128, 11008, 1), (2048, 4096, 0),
                                      (2048, 11008, 0), (33, 96, 2), (512, 4096, 1)])
def test_w4a8_tile(M, N, tile):
    """The W4A8 kernel's tile: the largest of [128, 64], [64, 64], [64, 32]
    that gives two blocks an SM (no split of K: each group sum stays whole
    and in order)."""
    assert dm.fill_tile(M, N, w4.TILES) == tile
    bm, bn = w4.TILES[tile]
    assert tile == 2 or -(-M // bm) * -(-N // bn) >= 2 * dm.SMS


@pytest.mark.parametrize("M,dtype,bits,kernel", [(17, BF16, 4, "gemv16"), (1, F32, 4, "mma"),
                                                 (1, BF16, 8, "gemv16")])
def test_a_kernel_outside_its_inputs_raises(M, dtype, bits, kernel):
    """`packed_matmul(kernel=...)` on the card refuses a kernel that does not
    take the call's inputs (checked before any launch)."""
    K, N, group = 256, 64, 128
    x = torch.zeros(M, K, dtype=dtype)
    packed = torch.zeros(K * bits // 32, N, dtype=torch.int32)
    tab = torch.zeros(K // group, N)
    with pytest.raises(ValueError, match=kernel):
        dm._packed_matmul_cuda(x, packed, tab, tab, bits, group, kernel)
