"""The paged flash decode's split over pages (csrc/paged_attention.cu,
kernel B8) on the CPU.

A plain PyTorch emulation of the kernel's arithmetic (`split_merge`: each
(slot, kv head, chunk) item's warps' online softmaxes over their rows of its
slabs, merged in warp order, then the chunks' partials merged in chunk
order) is held against the JAX kernel in
interpret mode at rtol = atol = 2e-5, the JAX test's tolerance, for chunks
of 1, 2 and 4 pages, GQA groups of 1, 2 and 4, and slots at position 0, on,
one before and one past chunk boundaries and at the last row. NaN in the
rows the kernel must not read leaves it (and the plain version) unchanged.
With the library load and the stream faked, the wrapper's split and
workspace come from the table's shape alone, and a refused launch raises
without running the plain version. The emulation lives here: nothing on
the main path uses it."""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.ops.paged_attention import paged_flash_attention as jax_paged
from mi_optimize_tpu_torch.ops import _build, paged_attention

D, P, PPS, H = 128, 8, 8, 4
# 0, around the chunk boundaries of 1, 2 and 4 pages of 8, the last row
POSITIONS = (0, 7, 8, 9, 15, 16, 17, 31, 32, 33, P * PPS - 1)
GROUPS = (4, 2, 1)  # Hkv for GQA groups of 1, 2 and 4


def _online(qg, batches, pk, pv, table, g, page_size, head_dim):
    """One warp's online softmax (m, l, acc) of the q heads qg [R, D] over
    its batches of slot rows, in order."""
    R = qg.shape[0]
    m = torch.full((R,), -torch.inf)
    l, acc = torch.zeros(R), torch.zeros(R, head_dim)
    for batch in batches:
        idx = [int(table[t // page_size]) for t in batch]
        off = [t % page_size for t in batch]
        k, v = pk[idx, off, g].float(), pv[idx, off, g].float()
        s = qg @ k.T / float(head_dim) ** 0.5
        mn = torch.maximum(m, s.max(-1).values)
        e = torch.exp(s - mn[:, None])
        corr = torch.exp(m - mn)
        l = l * corr + e.sum(-1)
        acc = acc * corr[:, None] + e @ v
        m = mn
    return m, l, acc


def _merge(parts, batch=None):
    """(m, l, acc) partials merged in their order: (M, sum l e^(m - M),
    sum acc e^(m - M)); with `batch`, M is the running max of batches of
    that many partials, the sums rescaled between them, as the kernel's
    chunk merge takes them."""
    batch = batch or len(parts)
    M, L, A = None, None, None
    for i in range(0, len(parts), batch):
        group = parts[i:i + batch]
        Mn = torch.stack([p[0] for p in group]).max(0).values
        if M is None:
            L, A = torch.zeros_like(Mn), torch.zeros_like(group[0][2])
        else:
            Mn = torch.maximum(M, Mn)
            r = torch.exp(M - Mn)
            L, A = L * r, A * r[:, None]
        for m, l, acc in group:
            w = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - Mn))
            L = L + l * w
            A = A + acc * w[:, None]
        M = Mn
    return M, L, A


def split_merge(q, pk, pv, table, positions, *, n_heads, n_kv_heads, head_dim, page_size,
                chunk_pages):
    """The kernel's arithmetic in f32. Each (slot, kv head, chunk of
    `chunk_pages` pages) item with a live row: its chunk's live rows in
    slabs of the plan's `slab_rows` rows (rows past the position never
    read), warp w of 4 taking rows w, w + 4, ... of each slab, four at a
    time, in an online softmax of each q head of the group; the warps'
    (m, l, acc) merged in warp order into the item's partial; then the
    chunks' partials merged in chunk order, eight at a time, out = acc /
    l."""
    B, R = q.shape[0], n_heads // n_kv_heads
    _, _, sr, _ = paged_attention.split_plan(n_heads, n_kv_heads, page_size, table.shape[1],
                                             chunk_pages)
    crows, nw = chunk_pages * page_size, 4
    out = torch.empty(B, n_heads, head_dim)
    for b in range(B):
        last = int(positions[b])
        for g in range(n_kv_heads):
            qg = q[b].reshape(n_heads, head_dim)[g * R:(g + 1) * R].float()
            chunks = []
            for t_c in range(0, last + 1, crows):
                slabs = [list(range(t0, min(t0 + sr, last + 1)))
                         for t0 in range(t_c, min(t_c + crows, last + 1), sr)]
                # warp w: rows w, w + 4, ... of each slab, up to four at a time
                warps = [_online(qg, [sl[w::nw][i:i + 4] for sl in slabs
                                      for i in range(0, len(sl[w::nw]), 4)],
                                 pk, pv, table[b], g, page_size, head_dim) for w in range(nw)]
                chunks.append(_merge(warps))
            _, L, A = _merge(chunks, batch=8)
            out[b, g * R:(g + 1) * R] = A / L[:, None]
    return out.reshape(B, -1).to(q.dtype)


def _inputs(n_kv_heads, positions=POSITIONS, seed=3):
    rng = np.random.default_rng(seed)
    B = len(positions)
    n_pages = 1 + B * PPS
    q = rng.normal(size=(B, H * D)).astype(np.float32)
    pk = rng.normal(size=(n_pages, P, n_kv_heads, D)).astype(np.float32)
    pv = rng.normal(size=(n_pages, P, n_kv_heads, D)).astype(np.float32)
    table = (rng.permutation(n_pages - 1)[:B * PPS] + 1).reshape(B, PPS).astype(np.int32)
    return q, pk, pv, table, np.asarray(positions, np.int32)


def _kw(n_kv_heads):
    return dict(n_heads=H, n_kv_heads=n_kv_heads, head_dim=D, page_size=P)


@functools.lru_cache(maxsize=None)
def _jax_out(n_kv_heads):
    q, pk, pv, table, positions = _inputs(n_kv_heads)
    return np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, pk, pv, table, positions)),
                                interpret=True, **_kw(n_kv_heads)))


@pytest.mark.parametrize("n_kv_heads", GROUPS)
@pytest.mark.parametrize("chunk_pages", [1, 2, 4])
def test_split_and_merge_matches_jax_kernel(chunk_pages, n_kv_heads):
    q, pk, pv, table, positions = (torch.from_numpy(a) for a in _inputs(n_kv_heads))
    got = split_merge(q, pk, pv, table, positions, chunk_pages=chunk_pages, **_kw(n_kv_heads))
    np.testing.assert_allclose(got.numpy(), _jax_out(n_kv_heads), rtol=2e-5, atol=2e-5)


def _poisoned(pk, pv, table, positions):
    """Copies of the pools with NaN in every row the kernel must not read:
    the live page's rows past the position, the slot's later pages and the
    page no slot holds."""
    pk, pv = pk.clone(), pv.clone()
    for b, p in enumerate(positions.tolist()):
        for j in range(p // P, table.shape[1]):
            rows = slice(p % P + 1 if j == p // P else 0, P)
            pk[table[b, j], rows] = pv[table[b, j], rows] = float("nan")
    pk[0] = pv[0] = float("nan")
    return pk, pv


@pytest.mark.parametrize("n_kv_heads", GROUPS)
def test_nan_in_unread_rows_changes_nothing(n_kv_heads):
    q, pk, pv, table, positions = (torch.from_numpy(a) for a in _inputs(n_kv_heads))
    kw = _kw(n_kv_heads)
    dk, dv = _poisoned(pk, pv, table, positions)
    assert bool(dk.isnan().any())
    for cp in (1, 2, 4):
        want = split_merge(q, pk, pv, table, positions, chunk_pages=cp, **kw)
        got = split_merge(q, dk, dv, table, positions, chunk_pages=cp, **kw)
        assert torch.equal(got, want)
    want = paged_attention.paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
    assert torch.equal(paged_attention.paged_flash_attention_ref(q, dk, dv, table, positions,
                                                                 **kw), want)


@pytest.mark.parametrize("page_size,pps,heads,want", [
    (16, 32, (32, 32), (4, 8, 16, 1)),   # Llama-2-7B as PagedBatcher runs it
    (16, 4, (4, 2), (4, 1, 16, 1)),      # a chunk no longer than the table
    (8, 3, (4, 2), (3, 1, 8, 1)),
    (64, 2, (8, 8), (1, 2, 32, 1)),      # slabs of 32 rows, half a page
    (40, 5, (12, 1), (1, 5, 8, 2)),      # a group of 12 in items of 8 and 4
    (16, 8, (64, 8), (4, 2, 16, 1)),
])
def test_split_plan(page_size, pps, heads, want):
    assert paged_attention.split_plan(*heads, page_size, pps) == want


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on the card and the launch is faked: it
    records each argument block and returns `err` (0 by default). The launch
    counter and the workspace cache are restored after the test."""
    lib = types.SimpleNamespace(err=0, seen=[])

    def entry(args, q_dtype, kv_dtype, stream):
        a = args._obj
        lib.seen.append({f: getattr(a, f) for f, _ in a._fields_})
        return lib.err

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        mi_paged_attention=entry))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(paged_attention, "launches", paged_attention.launches)
    monkeypatch.setattr(paged_attention, "_workspaces", {})
    return lib


@pytest.mark.parametrize("n_kv_heads", GROUPS)
def test_split_and_workspace_come_from_the_table_shape(fake_card, n_kv_heads):
    """Two launches at other positions (one with every slot at 0, one at
    the POSITIONS) pass the same split and the same workspace: the grid and
    the workspace are sized from the table's shape, never from the
    positions, which stay on the card."""
    q, pk, pv, table, positions = (torch.from_numpy(a) for a in _inputs(n_kv_heads))
    kw = _kw(n_kv_heads)
    before = paged_attention.launches
    for pos in (torch.zeros_like(positions), positions):
        paged_attention.paged_flash_attention(q, pk, pv, table, pos, **kw)
    assert paged_attention.launches == before + 2
    a, b = fake_card.seen
    assert {k: v for k, v in a.items() if k not in ("out", "pos")} == {
        k: v for k, v in b.items() if k not in ("out", "pos")}
    cp, n_chunks, sr, n_sub = paged_attention.split_plan(H, n_kv_heads, P, PPS)
    assert (a["chunk_pages"], a["n_chunks"], a["slab_rows"], a["n_sub"]) == (cp, n_chunks, sr,
                                                                            n_sub)
    (part, count), = paged_attention._workspaces.values()
    B = len(POSITIONS)
    assert part.numel() == B * H * n_chunks * (D + 2) and part.dtype == torch.float32
    assert count.numel() == B * n_kv_heads * n_sub and not bool(count.any())
    assert (a["part"], a["count"]) == (part.data_ptr(), count.data_ptr())


def test_refused_launch_raises_and_runs_no_plain_version(fake_card, monkeypatch):
    """A launch the library refuses (a nonzero cudaError) raises from the
    public wrapper on CUDA tensors; the plain version never runs in its
    place and no launch is counted."""
    fake_card.err = 1  # cudaErrorInvalidValue
    monkeypatch.setattr(paged_attention, "paged_flash_attention_ref",
                        lambda *a, **k: pytest.fail("the plain version ran on CUDA tensors"))
    q, pk, pv, table, positions = (torch.from_numpy(a) for a in _inputs(2))
    before = paged_attention.launches
    with pytest.raises(RuntimeError, match="paged_flash_attention failed with cudaError 1"):
        paged_attention.paged_flash_attention(q, pk, pv, table, positions, **_kw(2))
    assert len(fake_card.seen) == 1 and paged_attention.launches == before


def test_merge_of_more_than_eight_chunks_matches_plain():
    """Sixteen chunks of one page: the merge takes them eight at a time,
    rescaling between the batches, and still agrees with the plain version
    (rtol = atol = 2e-5)."""
    rng = np.random.default_rng(5)
    pps, n_kv_heads = 16, 2
    q = torch.from_numpy(rng.normal(size=(1, H * D)).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.normal(size=(1 + pps, P, n_kv_heads, D)).astype(np.float32))
              for _ in range(2))
    table = torch.arange(1, 1 + pps, dtype=torch.int32)[None]
    positions = torch.tensor([pps * P - 1], dtype=torch.int32)
    kw = _kw(n_kv_heads)
    got = split_merge(q, pk, pv, table, positions, chunk_pages=1, **kw)
    want = paged_attention.paged_flash_attention_ref(q, pk, pv, table, positions, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
