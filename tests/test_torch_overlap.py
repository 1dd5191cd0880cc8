"""The port's overlapped row-parallel dequant matmul (parallel/overlap.py,
kernel csrc/overlap.cu: B11) against the JAX package's
(mi_optimize_tpu/parallel/overlap.py, the ring kernel in interpret mode on
the conftest's virtual devices), int4, K = N = 512, M = 8, float32, the
cases of tests/test_overlap.py.

The port's ranks run as gloo processes (tests/torch_tp_workers.py, world 2
and 4; on the CPU every ring window runs ring_chunk_ref, the kernel's plain
version) and as threads of a LocalGroup; each rank's output against JAX's
within rtol 1e-5 / atol 1e-4 (tests/test_overlap.py's tolerance: the chunk
products and the ring's adds sum in other orders). The reduce-scatter form
(gather=False) gives rank r JAX's column chunk r. One rank takes the local
packed matmul; shapes the ring cannot cut raise, as in the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.parallel import make_mesh
from mi_optimize_tpu.parallel.overlap import overlapped_row_parallel_dequant_matmul as jax_ring
from mi_optimize_tpu_torch.parallel import LocalGroup, launch
from mi_optimize_tpu_torch.parallel import overlap
from tests.test_overlap import _operands

RTOL, ATOL = 1e-5, 1e-4
K = N = 512
# (world, qtype, groupsize, gather)
CASES = [(2, "per_group", 32, True), (2, "per_channel", -1, True), (4, "per_group", 32, True),
         (4, "per_channel", -1, True), (4, "per_group", 32, False)]


def _case(qtype, gs, seed=31):
    rng = np.random.default_rng(seed)
    qlin, fake_w, scales_t, zeros_t = _operands(rng, K, N, 4, qtype, gs)
    x = rng.normal(size=(8, K)).astype(np.float32)
    return qlin, fake_w, np.asarray(scales_t), np.asarray(zeros_t), x


@pytest.fixture(scope="module")
def runs():
    """JAX's output of each case, and every port rank's from one spawn of
    each world size."""
    out = {}
    for world in (2, 4):
        cases, jax_out = [], []
        for w, qtype, gs, gather in CASES:
            if w != world:
                continue
            qlin, _, st, zt, x = _case(qtype, gs)
            jax_out.append(np.asarray(jax_ring(
                jnp.asarray(x), qlin.packed, jnp.asarray(st), jnp.asarray(zt),
                make_mesh(n_model=world, n_data=1), bits=4, groupsize=gs, qmin=0,
                gather=gather, interpret=True)))
            cases.append(("overlap", dict(x=x, packed=np.array(qlin.packed).view(np.int32),
                                          scales=st, zeros=zt, bits=4, groupsize=gs, qmin=0,
                                          gather=gather)))
        res = launch.spawn("tests.torch_tp_workers:run_cases", world, cases=cases)
        out[world] = (jax_out, res)
    return out


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_matches_jax(runs, i):
    world, qtype, gs, gather = CASES[i]
    j = [c for c in CASES if c[0] == world].index(CASES[i])
    want, res = runs[world][0][j], runs[world][1]
    nc = N // world
    for r in range(world):
        got = res[r][j]
        ref = want if gather else want[:, r * nc:(r + 1) * nc]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=f"rank {r}")


def test_ring_on_local_threads_matches_jax():
    """The same ring with the ranks as threads of one process (LocalGroup),
    D = 4, per-group: every rank's output against JAX's."""
    qlin, _, st, zt, x = _case("per_group", 32, seed=35)
    want = np.asarray(jax_ring(jnp.asarray(x), qlin.packed, jnp.asarray(st), jnp.asarray(zt),
                               make_mesh(n_model=4, n_data=1), bits=4, groupsize=32, qmin=0,
                               interpret=True))
    packed = torch.from_numpy(np.array(qlin.packed).view(np.int32))
    k = K // 4

    def rank(g):
        r = g.rank
        return overlap.overlapped_row_parallel_dequant_matmul(
            torch.from_numpy(x[:, r * k:(r + 1) * k]), packed[r * k // 8:(r + 1) * k // 8],
            torch.from_numpy(st[r * 4:(r + 1) * 4]), torch.from_numpy(zt[r * 4:(r + 1) * 4]),
            g, bits=4, groupsize=32, qmin=0)

    out = LocalGroup(4).run(rank)
    for r in range(4):
        np.testing.assert_allclose(out[r].numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qtype,gs", [("per_group", 32), ("per_channel", -1)])
def test_ring_chunk_ref_is_the_dequant_window(qtype, gs):
    """The kernel's plain version: add + x @ W over a column window, W =
    (q - (zero - qmin)) * s, against the reference's dequantized weight."""
    qlin, fake_w, st, zt, x = _case(qtype, gs, seed=37)
    add = np.random.default_rng(5).normal(size=(8, 128)).astype(np.float32)
    ng = st.shape[0]
    got = overlap.ring_chunk_ref(torch.from_numpy(x), torch.from_numpy(
        np.array(qlin.packed).view(np.int32)), torch.from_numpy(st), torch.from_numpy(zt),
        torch.from_numpy(add), 4, K // ng, 256, 128)
    np.testing.assert_allclose(got.numpy(), add + x @ fake_w.T[:, 256:384], rtol=RTOL, atol=ATOL)


def test_one_rank_and_shape_checks():
    """D = 1 takes the local packed matmul, as the reference; shapes the
    ring cannot cut raise ValueError, as in the reference."""
    qlin, fake_w, st, zt, x = _case("per_group", 32, seed=39)
    packed = torch.from_numpy(np.array(qlin.packed).view(np.int32))
    before = overlap.launches
    y = overlap.overlapped_row_parallel_dequant_matmul(
        torch.from_numpy(x), packed, torch.from_numpy(st), torch.from_numpy(zt),
        LocalGroup(1).rank(0), bits=4, groupsize=32, qmin=0)
    want = np.asarray(jax_ring(jnp.asarray(x), qlin.packed, jnp.asarray(st), jnp.asarray(zt),
                               make_mesh(n_model=1, n_data=1), bits=4, groupsize=32, qmin=0,
                               interpret=True))
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
    assert overlap.launches == before  # the plain versions count nothing
    g = LocalGroup(4).rank(0)
    with pytest.raises(ValueError, match="lane-aligned"):
        overlap.overlapped_row_parallel_dequant_matmul(
            torch.zeros(8, 128), packed[:16, :256], torch.from_numpy(st[:4, :256]),
            torch.from_numpy(zt[:4, :256]), g, bits=4, groupsize=32, qmin=0)
    with pytest.raises(ValueError, match="whole"):
        overlap.overlapped_row_parallel_dequant_matmul(
            torch.zeros(8, 16), packed[:2], torch.from_numpy(st[:1]), torch.from_numpy(zt[:1]),
            g, bits=4, groupsize=32, qmin=0)
    with pytest.raises(ValueError, match="whole"):
        jax_ring(jnp.zeros((8, 64)), qlin.packed[:8], jnp.asarray(st[:2]), jnp.asarray(zt[:2]),
                 make_mesh(n_model=4, n_data=1), bits=4, groupsize=32, qmin=0, interpret=True)
