"""The decode attention's split over the live rows (csrc/decode_attention.cu,
kernel B6) on the CPU.

A plain PyTorch emulation of the kernel's arithmetic (`split_merge`: the new
row roped and quantized by the chunk that holds `pos` and taken as that
chunk's last row; each (kv head, chunk) item's warps' online softmaxes over
their rows of its slabs, a row's score ks[t] * sum(q * code) and its value
weight p * vs[t], merged in warp order; then the chunks' partials merged in
chunk order, every head's max first) is held against the JAX kernel in interpret
mode at the tolerance of tests/test_torch_decode_attention.py (the new row's
codes and scales equal, the output to 1e-5), for chunks of 1, 2 and 4
slabs, GQA groups of 1, 2 and 4, f32 and bf16 rows, and positions at 0, on,
one before and one past chunk boundaries and at the last row. NaN in the
scales of rows t > pos leaves it and the plain version unchanged (the JAX
kernel reads those rows, so that case is held against the plain version
only). With the library load and the stream faked, the wrapper's split and
workspace come from the shapes and the position alone, the workspace is
allocated once per shape, and a refused launch raises without running the
plain version. The emulation lives here: nothing on the main path uses it."""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.ops.decode_attention import fused_decode_attention as jax_fda
from mi_optimize_tpu_torch.ops import _build
from mi_optimize_tpu_torch.ops import decode_attention as da

T, D, H = 40, 32, 4
SLAB = 8  # the emulation's slab rows: chunks of 8, 16 and 32 rows are 1, 2 and 4 slabs
# 0, around the chunk boundaries of 8, 16 and 32 rows, the last row
POSITIONS = (0, 7, 8, 9, 15, 16, 17, 31, 32, 33, T - 1)
GROUPS = (4, 2, 1)  # Hkv for GQA groups of 1, 2 and 4
NW = 4              # warps an item


def _inputs(n_kv_heads, pos, bf16, seed=5):
    """Seeded numpy inputs as tests/test_torch_decode_attention.py makes
    them: q, k, v rows (bf16 values as exact f32 numbers where `bf16`),
    the position's split-half rope tables, and an int8 cache whose every
    row holds codes and scales."""
    rng = np.random.default_rng(seed + 97 * pos + n_kv_heads)
    q = rng.normal(size=(1, H * D)).astype(np.float32)
    k = (2.0 * rng.normal(size=(1, n_kv_heads * D))).astype(np.float32)
    v = rng.normal(size=(1, n_kv_heads * D)).astype(np.float32)
    if bf16:
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (q, k, v))
    ang = pos / (10000.0 ** (np.arange(0, D, 2) / D))
    cos = np.cos(np.concatenate([ang, ang]))[None].astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang]))[None].astype(np.float32)
    ck = rng.integers(-127, 128, size=(T, n_kv_heads, D)).astype(np.int8)
    cv = rng.integers(-127, 128, size=(T, n_kv_heads, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(T, n_kv_heads)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(T, n_kv_heads)).astype(np.float32)
    return q, k, v, cos, sin, ck, cv, ks, vs


def _kw(n_kv_heads):
    return dict(n_heads=H, n_kv_heads=n_kv_heads, head_dim=D, max_len=T)


def _torch(args, bf16):
    """The inputs as the port takes them: q/k/v in their dtype, the rest
    copies (the cache is written in place)."""
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v, cos, sin, *cache = args
    return ([torch.tensor(a).to(dt) for a in (q, k, v)]
            + [torch.from_numpy(a.copy()) for a in (cos, sin, *cache)])


def _online(qg, batches, kc, vc, ksc, vsc, scale):
    """One warp's online softmax (m, l, acc) of the q heads qg [R, D] over
    its batches of rows of one kv head (codes kc/vc [T, D], scales [T]), in
    order."""
    R = qg.shape[0]
    m = torch.full((R,), -torch.inf)
    l, acc = torch.zeros(R), torch.zeros(R, D)
    for batch in batches:
        s = qg @ kc[batch].float().T * ksc[batch] * scale
        mn = torch.maximum(m, s.max(-1).values)
        e = torch.exp(s - mn[:, None])
        corr = torch.exp(m - mn)
        l = l * corr + e.sum(-1)
        acc = acc * corr[:, None] + (e * vsc[batch]) @ vc[batch].float()
        m = mn
    return m, l, acc


def _merge(parts):
    """(m, l, acc) partials merged in their order: (M, sum l e^(m - M),
    sum acc e^(m - M)), M the max of every partial's m, taken first."""
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp(m - M))
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def split_merge(q, k, v, cos, sin, ck, cv, ks, vs, pos, *, n_heads, n_kv_heads, head_dim,
                max_len, chunk_rows, slab_rows=SLAB):
    """The kernel's arithmetic in f32: (out [1, H*D], the new row's k codes,
    v codes, k scales, v scales), the cache left as it is. The new row is
    roped and quantized as the plain version does it and takes the place of
    row `pos` (never read from the cache). Each (kv head, chunk of
    `chunk_rows` rows) item with its chunk's live rows in slabs of
    `slab_rows` rows (the kernel's are 32; smaller here): warp w of
    4 takes rows w, w + 4, ... of each slab, four at a time, in an online
    softmax of each q head of the group; the warps' (m, l, acc) merged in
    warp order into the item's partial; then the chunks' partials merged in
    chunk order with every chunk's weight e^(m - M) from the heads' max M
    over all chunks, out = acc / l."""
    R, scale = n_heads // n_kv_heads, 1.0 / float(head_dim) ** 0.5
    cr, sr, n_live = chunk_rows, slab_rows, pos // chunk_rows + 1
    cos, sin = (t.reshape(-1)[-head_dim:].float() for t in (cos, sin))
    qr = da._rope_rows(q.reshape(n_heads, head_dim).float(), cos, sin)
    kq, ksn = da._quantize_rows(da._rope_rows(k.reshape(n_kv_heads, head_dim).float(), cos, sin))
    vq, vsn = da._quantize_rows(v.reshape(n_kv_heads, head_dim).float())
    live = lambda c, new: torch.cat([c[:pos], new[None]])  # rows 0..pos, row pos the new one
    kc, vc, kss, vss = live(ck, kq), live(cv, vq), live(ks, ksn), live(vs, vsn)
    out = torch.empty(n_heads, head_dim)
    for g in range(n_kv_heads):
        qg = qr[g * R:(g + 1) * R]
        chunks = []
        for t_c in range(0, n_live * cr, cr):
            end = min(t_c + cr, pos + 1)
            slabs = [list(range(t0, min(t0 + sr, end))) for t0 in range(t_c, end, sr)]
            # warp w: rows w, w + 4, ... of each slab, up to four at a time
            warps = [_online(qg, [sl[w::NW][i:i + 4] for sl in slabs
                                  for i in range(0, len(sl[w::NW]), 4)],
                             kc[:, g], vc[:, g], kss[:, g], vss[:, g], scale) for w in range(NW)]
            chunks.append(_merge(warps))
        _, L, A = _merge(chunks)
        out[g * R:(g + 1) * R] = A / L[:, None]
    return out.reshape(1, -1), kq, vq, ksn, vsn


@functools.lru_cache(maxsize=None)
def _jax_out(n_kv_heads, pos, bf16):
    """JAX's fused_decode_attention in interpret mode: (out, the new row's
    k codes, v codes, k scales, v scales)."""
    q, k, v, cos, sin, ck, cv, ks, vs = _inputs(n_kv_heads, pos, bf16)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    out, jck, jcv, jks, jvs = jax_fda(*(jnp.asarray(a, dt) for a in (q, k, v)), jnp.asarray(cos),
                                      jnp.asarray(sin), jnp.asarray(ck), jnp.asarray(cv),
                                      jnp.asarray(ks), jnp.asarray(vs), pos, interpret=True,
                                      **_kw(n_kv_heads))
    return tuple(np.asarray(a) for a in (out, jck[pos], jcv[pos], jks[pos], jvs[pos]))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_kv_heads", GROUPS)
@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_split_and_merge_matches_jax_kernel(slabs, n_kv_heads, bf16):
    for pos in POSITIONS:
        args = _torch(_inputs(n_kv_heads, pos, bf16), bf16)
        got = split_merge(*args, pos, chunk_rows=slabs * SLAB, **_kw(n_kv_heads))
        want = _jax_out(n_kv_heads, pos, bf16)
        for g, w in zip(got[1:], want[1:]):  # the new row's codes and scales
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("n_kv_heads", GROUPS)
def test_nan_in_rows_past_pos_changes_nothing(n_kv_heads):
    """NaN scales in every row t > pos (int8 codes cannot hold one): the
    emulation, which never reads those rows, and the plain version give the
    same output as on the clean cache."""
    kw = _kw(n_kv_heads)
    for pos in (0, 15, 16, 33):
        q, k, v, cos, sin, ck, cv, ks, vs = _torch(_inputs(n_kv_heads, pos, False), False)
        dks, dvs = ks.clone(), vs.clone()
        dks[pos + 1:] = dvs[pos + 1:] = float("nan")
        assert bool(dks.isnan().any())
        for cr in (8, 16, 32):
            want = split_merge(q, k, v, cos, sin, ck, cv, ks, vs, pos, chunk_rows=cr, **kw)[0]
            got = split_merge(q, k, v, cos, sin, ck, cv, dks, dvs, pos, chunk_rows=cr, **kw)[0]
            assert torch.equal(got, want)
        want = da.fused_decode_attention_ref(q, k, v, cos, sin, ck.clone(), cv.clone(),
                                             ks.clone(), vs.clone(), pos, **kw)[0]
        got = da.fused_decode_attention_ref(q, k, v, cos, sin, ck.clone(), cv.clone(), dks, dvs,
                                            pos, **kw)[0]
        assert torch.equal(got, want) and not bool(got.isnan().any())


def test_merge_of_more_than_eight_chunks_matches_plain():
    """Twelve chunks of 8 rows at the last row of a 96-row cache (the
    kernel's merge loads them eight at a time) agree with the plain version
    (rtol = atol = 1e-5)."""
    rng = np.random.default_rng(8)
    Tl, Hkv, pos = 96, 2, 95
    q = torch.from_numpy(rng.normal(size=(1, H * D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, Hkv * D)).astype(np.float32)) for _ in range(2))
    cos, sin = (torch.from_numpy(rng.uniform(-1, 1, size=D).astype(np.float32)) for _ in range(2))
    ck, cv = (torch.from_numpy(rng.integers(-127, 128, size=(Tl, Hkv, D)).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.03, size=(Tl, Hkv)).astype(np.float32))
              for _ in range(2))
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=Tl)
    got = split_merge(q, k, v, cos, sin, ck, cv, ks, vs, pos, chunk_rows=8, **kw)[0]
    want = da.fused_decode_attention_ref(q, k, v, cos, sin, ck, cv, ks, vs, pos, **kw)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads,D_,max_len,pos,chunk,want", [
    ((32, 32), 128, 384, 200, None, (32, 7, 12, 1, 1)),        # Llama-2-7B at position 200
    ((32, 32), 128, 2048, 2047, None, (128, 16, 16, 1, 1)),    # at its last row of 2048
    ((32, 32), 128, 4096, 4095, None, (256, 16, 16, 1, 1)),    # of 4096, Llama-2's context
    ((32, 8), 128, 2048, 2047, None, (128, 16, 16, 4, 1)),     # Mistral-7B's groups of 4
    ((32, 32), 128, 4096, 0, None, (32, 1, 16, 1, 1)),         # the first row
    ((32, 32), 128, 4096, 512, None, (64, 9, 16, 1, 1)),       # one past 16 chunks of 32
    ((12, 1), 128, 50, 49, None, (32, 2, 2, 8, 2)),            # a group of 12: items of 8, 4
    ((8, 1), 256, 100, 99, None, (32, 4, 4, 4, 2)),            # D = 256: at most 4 heads
    ((4, 2), 32, 200, 133, 64, (64, 3, 4, 2, 1)),              # a fixed chunk of 64 rows
])
def test_split_plan(heads, D_, max_len, pos, chunk, want):
    assert da.split_plan(*heads, D_, max_len, pos, chunk) == want


@pytest.mark.parametrize("max_len", [50, 384, 512, 513, 2048, 5000])
def test_split_plan_at_every_position(max_len):
    """At every position the chunk is the smallest power of two of rows, at
    least CHUNK_MIN, that leaves at most LIVE_CHUNKS live chunks, and the
    workspace's chunk count (the same at every position) holds them."""
    plans = [da.split_plan(32, 8, 128, max_len, pos) for pos in range(max_len)]
    assert len({p[2] for p in plans}) == 1
    for pos, (cr, n_live, n_chunks, group, n_sub) in enumerate(plans):
        assert cr >= da.CHUNK_MIN and cr & (cr - 1) == 0 and n_live == pos // cr + 1
        assert n_live <= min(da.LIVE_CHUNKS, n_chunks)
        assert cr == da.CHUNK_MIN or pos // (cr // 2) + 1 > da.LIVE_CHUNKS
        assert (group, n_sub) == (4, 1)


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on the card and the launch is faked: it
    records each argument block and returns `err` (0 by default). The launch
    counter and the workspace cache are restored after the test."""
    lib = types.SimpleNamespace(err=0, seen=[])

    def entry(args, dtype, stream):
        a = args._obj
        lib.seen.append({f: getattr(a, f) for f, _ in a._fields_})
        return lib.err

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        mi_decode_attention=entry))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(da, "launches", da.launches)
    monkeypatch.setattr(da, "_workspaces", {})
    return lib


@pytest.mark.parametrize("n_kv_heads", GROUPS)
def test_split_and_workspace_come_from_the_shapes_and_pos(fake_card, n_kv_heads):
    """Launches at every position of POSITIONS pass the plan of the shapes
    and that position, and all share one workspace, allocated once for the
    shape: the grid follows `pos`, a host int, and the workspace `max_len`."""
    kw = _kw(n_kv_heads)
    before = da.launches
    for pos in POSITIONS:
        q, k, v, cos, sin, *cache = _torch(_inputs(n_kv_heads, pos, False), False)
        da.fused_decode_attention(q, k, v, cos, sin, *cache, pos, **kw)
    assert da.launches == before + len(POSITIONS)
    for pos, a in zip(POSITIONS, fake_card.seen):
        cr, _, n_chunks, group, _ = da.split_plan(H, n_kv_heads, D, T, pos)
        assert (a["pos"], a["chunk_rows"], a["n_chunks"], a["group"]) == (
            pos, cr, n_chunks, group)
    (part, count), = da._workspaces.values()
    _, _, n_chunks, _, n_sub = da.split_plan(H, n_kv_heads, D, T, 0)
    assert part.numel() == H * n_chunks * (D + 2) and part.dtype == torch.float32
    assert count.numel() == n_kv_heads * n_sub and not bool(count.any())
    assert {(a["part"], a["count"]) for a in fake_card.seen} == {(part.data_ptr(),
                                                                 count.data_ptr())}


def test_refused_launch_raises_and_runs_no_plain_version(fake_card, monkeypatch):
    """A launch the library refuses (a nonzero cudaError) raises from the
    public wrapper on CUDA tensors; the plain version never runs in its
    place and no launch is counted."""
    fake_card.err = 1  # cudaErrorInvalidValue
    monkeypatch.setattr(da, "fused_decode_attention_ref",
                        lambda *a, **k: pytest.fail("the plain version ran on CUDA tensors"))
    q, k, v, cos, sin, *cache = _torch(_inputs(2, 9, False), False)
    before = da.launches
    with pytest.raises(RuntimeError, match="decode_attention failed with cudaError 1"):
        da.fused_decode_attention(q, k, v, cos, sin, *cache, 9, **_kw(2))
    assert len(fake_card.seen) == 1 and da.launches == before
