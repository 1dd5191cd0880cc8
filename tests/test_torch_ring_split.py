"""The ring dequant-matmul window's tensor-core arithmetic (csrc/overlap.cu,
kernel B11: ring_gemv_kernel up to 16 rows, ring_mma_kernel above) on the
CPU.

A plain emulation of the kernels' arithmetic (`window`): K cut into the
plan's splits of whole groups, each split's groups taken by the block's
warps in contiguous runs (four warps on the "gemv" route, one chain of
groups on the "mma" route); per group the centered-code sum D = x @ (q - 8)
and the row sums xsum in f32, rescaled as y += s * D + (8 - zq) * s * xsum;
the warps' sums added in warp order, the splits' in split order, then the
received partial. Held, within tests/test_overlap.py's tolerance (rtol 1e-5,
atol 1e-4: the sums and the rescale round at other points than the
reference's f32 dequant-then-dot), against the reference's dequantized
window (x @ W[:, cols] + add) and, with every window of the port's ring
taken by the emulation (ranks as LocalGroup threads, D = 2 and 4, per-group
and per-channel grids, 1 to 130 rows on both routes), against JAX's
overlapped_row_parallel_dequant_matmul in interpret mode (its ring kernel
and `_dequant_chunk`). x holds bf16 values: the card's tensor-core route
takes bf16 x. The plans come from the shapes alone; with the library load
faked, the wrapper passes them, keeps one workspace a device and stream
(grown only when a call needs more, its counters zero), takes the f32 tiles
for f32 x, and a refused launch raises without running the plain version.
The emulation lives here: nothing on the main path uses it."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.parallel import make_mesh
from mi_optimize_tpu.parallel.overlap import overlapped_row_parallel_dequant_matmul as jax_ring
from mi_optimize_tpu_torch.core.packing import unpack_words
from mi_optimize_tpu_torch.ops import _build
from mi_optimize_tpu_torch.parallel import LocalGroup
from mi_optimize_tpu_torch.parallel import overlap
from tests.test_overlap import _operands

RTOL, ATOL = 1e-5, 1e-4
K = N = 512


def window(x, packed, scale_t, zq_t, add, group, col0, nc, splits, warps):
    """The tensor-core kernels' arithmetic for one window, in f32: f32 [M,
    nc] = add + x @ W[:, col0:col0+nc] by the grouped rescale, K in
    `splits` splits of whole groups, each split's groups in `warps`
    contiguous runs (warp w: groups [w*n/W, (w+1)*n/W) of the split's n)."""
    M, Kl = x.shape
    ng = Kl // group
    q = unpack_words(packed[:, col0:col0 + nc], 4).to(torch.float32) - 8.0
    s, z = scale_t[:, col0:col0 + nc], zq_t[:, col0:col0 + nc]
    xf = x.to(torch.float32)
    y = None
    for sp in range(splits):
        ga, gb = sp * ng // splits, (sp + 1) * ng // splits
        block = None
        for w in range(warps):
            wa, wb = ga + w * (gb - ga) // warps, ga + (w + 1) * (gb - ga) // warps
            acc = torch.zeros(M, nc)
            for gi in range(wa, wb):
                xs = xf[:, gi * group:(gi + 1) * group]
                d = xs @ q[gi * group:(gi + 1) * group]
                acc = acc + (s[gi] * d + ((8.0 - z[gi]) * s[gi]) * xs.sum(-1, keepdim=True))
            block = acc if block is None else block + acc
        y = block if y is None else y + block
    return y if add is None else add + y


def emulated(x, packed, scale_t, zq_t, add, bits, group, col0, nc, route=None):
    """`window` with the plan of the route ring_chunk takes for bf16 x."""
    M = x.shape[0]
    assert bits == 4 and overlap.ring_route(M, torch.bfloat16, bits, group, nc) != "cuda_core"
    if M <= overlap.GEMV_MAX_M:
        return window(x, packed, scale_t, zq_t, add, group, col0, nc,
                      overlap.gemv_plan(nc, x.shape[1], group), overlap.GEMV_WARPS)
    _, splits = overlap.mma_plan(M, nc, x.shape[1], group)
    return window(x, packed, scale_t, zq_t, add, group, col0, nc, splits, 1)


def _case(qtype, gs, M, seed=41):
    """JAX's operands (tests/test_overlap.py) and x of M rows of bf16 values."""
    rng = np.random.default_rng(seed + M)
    qlin, fake_w, scales_t, zeros_t = _operands(rng, K, N, 4, qtype, gs)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).to(torch.float32))
    return qlin, fake_w, np.array(scales_t), np.array(zeros_t), x


@pytest.mark.parametrize("splits,warps", [(1, 1), (1, 4), (2, 4), (3, 1), (8, 4), (16, 1)])
@pytest.mark.parametrize("M", [1, 8, 17])
def test_window_matches_the_dequantized_window(splits, warps, M):
    """Any cut of K into splits of whole groups and warp runs gives the
    reference's window: x @ dequant(W)[:, cols] + add (g32, K 512: 16 groups)."""
    qlin, fake_w, st, zt, x = _case("per_group", 32, M)
    add = np.random.default_rng(M).normal(size=(M, 128)).astype(np.float32)
    packed = torch.from_numpy(np.array(qlin.packed).view(np.int32))
    got = window(torch.from_numpy(x), packed, torch.from_numpy(st), torch.from_numpy(zt),
                 torch.from_numpy(add), 32, 256, 128, splits, warps)
    np.testing.assert_allclose(got.numpy(), add + x @ fake_w.T[:, 256:384], rtol=RTOL, atol=ATOL)


# (world, qtype, groupsize, M): both routes, per-group and per-channel grids
RING = [(2, "per_group", 32, 8), (2, "per_group", 64, 16), (2, "per_channel", -1, 5),
        (4, "per_group", 32, 17), (2, "per_group", 32, 130), (4, "per_channel", -1, 64)]


@pytest.mark.parametrize("world,qtype,gs,M", RING)
def test_emulated_ring_matches_jax(monkeypatch, world, qtype, gs, M):
    """Every window of the port's ring (LocalGroup threads) through the
    emulation of the route it takes for bf16 x: each rank's output against
    JAX's ring kernel in interpret mode."""
    qlin, _, st, zt, x = _case(qtype, gs, M)
    want = np.asarray(jax_ring(jnp.asarray(x), qlin.packed, jnp.asarray(st), jnp.asarray(zt),
                               make_mesh(n_model=world, n_data=1), bits=4, groupsize=gs, qmin=0,
                               interpret=True))
    monkeypatch.setattr(overlap, "ring_chunk", emulated)
    packed = torch.from_numpy(np.array(qlin.packed).view(np.int32))
    k, ng = K // world, st.shape[0] // world if gs > 0 else 1

    def rank(g):
        r = g.rank
        rows = slice(r * ng, (r + 1) * ng) if gs > 0 else slice(0, 1)
        return overlap.overlapped_row_parallel_dequant_matmul(
            torch.from_numpy(x[:, r * k:(r + 1) * k]), packed[r * k // 8:(r + 1) * k // 8],
            torch.from_numpy(st[rows]), torch.from_numpy(zt[rows]), g, bits=4, groupsize=gs,
            qmin=0)

    out = LocalGroup(world).run(rank)
    for r in range(world):
        np.testing.assert_allclose(out[r].numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("M,dtype,bits,group,nc,want", [
    (1, torch.bfloat16, 4, 128, 1024, "gemv"), (16, torch.bfloat16, 4, 128, 1024, "gemv"),
    (17, torch.bfloat16, 4, 128, 1024, "mma"), (2048, torch.bfloat16, 4, 2048, 512, "mma"),
    (8, torch.float32, 4, 128, 1024, "cuda_core"), (8, torch.bfloat16, 8, 128, 1024, "cuda_core"),
    (8, torch.bfloat16, 4, 16, 1024, "cuda_core"), (8, torch.bfloat16, 4, 128, 100, "cuda_core")])
def test_route(M, dtype, bits, group, nc, want):
    assert overlap.ring_route(M, dtype, bits, group, nc) == want


@pytest.mark.parametrize("nc,Kl,g,want", [
    (1024, 2048, 128, 4),   # Llama-2-7B o_proj at D = 2: 16 groups, one a warp
    (1024, 5504, 128, 11),  # down_proj at D = 2: 43 groups
    (512, 1024, 128, 2),    # o_proj at D = 4
    (1024, 2048, 2048, 1),  # per-channel: one group
])
def test_gemv_plan(nc, Kl, g, want):
    assert overlap.gemv_plan(nc, Kl, g) == want


@pytest.mark.parametrize("M,nc,Kl,g,want", [
    (2048, 1024, 2048, 128, (True, 1)),   # 128 [128, 128] tiles fill the card
    (2048, 512, 1024, 128, (True, 2)),    # 64 tiles: two splits
    (128, 1024, 2048, 128, (False, 8)),   # path t's prompts: 16 [64, 128] tiles, 8 splits
    (256, 1024, 5504, 128, (True, 8)),
    (40, 1024, 2048, 2048, (False, 1)),   # per-channel: no split
])
def test_mma_plan(M, nc, Kl, g, want):
    assert overlap.mma_plan(M, nc, Kl, g) == want


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on the card; the library's three entry
    points record their arguments and return `err` (0 by default)."""
    lib = types.SimpleNamespace(err=0, seen=[])

    def entry(name):
        def fn(*args):
            lib.seen.append((name, args))
            return lib.err
        return fn

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        **{n: entry(n) for n in ("mi_ring_chunk", "mi_ring_chunk_gemv", "mi_ring_chunk_mma")}))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(overlap, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for n in ("launches", "launches_gemv", "launches_mma", "launches_cuda_core"):
        monkeypatch.setattr(overlap, n, 0)
    monkeypatch.setattr(overlap, "_workspaces", {})
    return lib


def _window_args(M, Kl=1024, Nw=1024, g=128, dtype=torch.bfloat16):
    x = torch.zeros(M, Kl, dtype=dtype)
    return (x, torch.zeros(Kl // 8, Nw, dtype=torch.int32), torch.ones(Kl // g, Nw),
            torch.full((Kl // g, Nw), 8.0), torch.zeros(M, 256), 4, g, 512, 256)


def test_wrapper_passes_the_plans_and_keeps_one_workspace(fake_card):
    """Windows at 1 to 2048 rows take the route and plan of their shapes; the
    gemv and mma launches share one workspace, grown only when a window needs
    more partials than it holds (a smaller window after the largest keeps
    it), its counters zero."""
    Ms = (1, 8, 16, 17, 128, 2048, 8)
    for M in Ms:
        overlap.ring_chunk(*_window_args(M))
    assert (overlap.launches, overlap.launches_gemv, overlap.launches_mma) == (7, 4, 3)
    for M, (name, a) in zip(Ms, fake_card.seen):
        route = overlap.ring_route(M, torch.bfloat16, 4, 128, 256)
        assert name == f"mi_ring_chunk_{route}"
        if route == "gemv":
            assert a[8:15] == (M, 1024, 1024, 128, 512, 256, overlap.gemv_plan(256, 1024, 128))
        else:
            big, splits = overlap.mma_plan(M, 256, 1024, 128)
            assert a[8:16] == (M, 1024, 1024, 128, 512, 256, int(big), splits)
    (part, cnt), = overlap._workspaces.values()
    assert fake_card.seen[-1][1][6] == fake_card.seen[-2][1][6] == part.data_ptr()
    need = max(overlap.mma_plan(M, 256, 1024, 128)[1] * M * 256 for M in Ms if M > 16)
    assert part.numel() == need and not bool(cnt.any())


def test_f32_x_takes_the_cuda_core_tiles(fake_card):
    overlap.ring_chunk(*_window_args(8, dtype=torch.float32))
    assert fake_card.seen[0][0] == "mi_ring_chunk" and overlap.launches_cuda_core == 1
    with pytest.raises(ValueError, match="route"):
        overlap.ring_chunk(*_window_args(8, dtype=torch.float32), route="gemv")
    with pytest.raises(ValueError, match="route"):
        overlap.ring_chunk(*_window_args(17), route="gemv")


@pytest.mark.parametrize("M", [8, 128])
def test_refused_launch_raises_and_runs_no_plain_version(fake_card, monkeypatch, M):
    fake_card.err = 1  # cudaErrorInvalidValue
    monkeypatch.setattr(overlap, "ring_chunk_ref",
                        lambda *a, **k: pytest.fail("the plain version ran on CUDA tensors"))
    with pytest.raises(RuntimeError, match="ring_chunk failed with cudaError 1"):
        overlap.ring_chunk(*_window_args(M))
    assert len(fake_card.seen) == 1 and overlap.launches == 0
