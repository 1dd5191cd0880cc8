"""Half 0's attention in the batched kernel's tensor-parallel mode, split over
the live rows (csrc/model_fused_tp.cu attention_split, kernel B5(e)), on the
CPU.

A plain emulation of the kernel's arithmetic (`split_attention`): for each
slot b at position p, its rows 0..p, row p the new one (RoPE and int8
quantization as the plain TP step makes them, ops/block_fused.py), cut into
chunks of `chunk_rows` rows; an item is (slot, chunk, kv head, sub-group of
at most 4 of its q heads); warp w of 8 takes rows w, w + 8, ... of the
chunk, four at a time, in an online softmax a head in base 2 (a row's score
ks[t] * sum(q * code) * log2(e) / sqrt(D), its value weight p * vs[t]); the
warps merged in warp order into the item's partial (m, l, acc); then the
chunks' partials merged in chunk order, every head's max over the chunks
first. Held against JAX's decode attention of each slot
(mi_optimize_tpu/ops/decode_attention.py, interpret mode: the new row's
RoPE, quantization and attention over rows 0..p of its cache; JAX's TP step
does not finish in interpret mode here), outputs within rtol = atol = 1e-5
(tests/test_torch_decode_split.py's tolerance: f32 sums in other orders),
the new rows' codes by the int8-row rule (one-code flips of a rounding tie
on at most 0.1%: the plain TP step rounds RoPE's two products apart, JAX's
kernel fuses them) and their scales within 1e-6; chunks of 8, 16 and 32
rows with slots at position 0, on, one before and one past chunk boundaries
and at the last row; kv heads of 1, 2 and 4 q heads, and of 8 (two
sub-groups). The split comes from the shapes and the positions alone
(`tp_split_plan`); with the library load faked, tp_prepare/tp_launch pass
it with each slot's position and first item, every step shares one
workspace a shape, and a refused launch raises without running the plain
version. The emulation lives here: nothing on the main path uses it."""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.ops.decode_attention import fused_decode_attention as jax_fda
from mi_optimize_tpu_torch.models.llama import LlamaConfig, quantize_kv, rope_tables
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
from mi_optimize_tpu_torch.ops import _build
from mi_optimize_tpu_torch.ops import model_fused as mf
from mi_optimize_tpu_torch.ops.block_fused import _rope_rows
from mi_optimize_tpu_torch.parallel import LocalGroup
from mi_optimize_tpu_torch.serving.megadecode import stack_serving_tp
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

T, D = 40, 32
NW = 8  # warps an item
# slots at 0, around the chunk boundaries of 8, 16 and 32 rows, the last row
POSITIONS = (0, 7, 8, 9, 16, 17, 33, T - 1)
HEADS = ((4, 4), (4, 2), (4, 1), (8, 1))  # (q heads, kv heads): groups of 1, 2, 4 and 8


def _step(H, Hkv, seed=3):
    """Seeded numpy inputs of one step: each slot's f32 qkv row (k twice as
    wide), its position's split-half rope tables [B, D], and its int8 cache
    [T, Hkv, D] whose every row holds codes and scales."""
    rng = np.random.default_rng(seed + 10 * H + Hkv)
    B = len(POSITIONS)
    qkv = rng.normal(size=(B, (H + 2 * Hkv) * D)).astype(np.float32)
    qkv[:, H * D:(H + Hkv) * D] *= 2.0
    ang = np.array(POSITIONS)[:, None] / (10000.0 ** (np.arange(0, D, 2) / D))[None]
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)
    caches = [(rng.integers(-127, 128, size=(T, Hkv, D)).astype(np.int8),
               rng.integers(-127, 128, size=(T, Hkv, D)).astype(np.int8),
               rng.uniform(0.005, 0.03, size=(T, Hkv)).astype(np.float32),
               rng.uniform(0.005, 0.03, size=(T, Hkv)).astype(np.float32)) for _ in range(B)]
    return qkv, cos, sin, caches


def _online(q, batches, kc, vc, ksc, vsc, scale2):
    """One warp's online softmax (m, l, acc) in base 2 of the q heads q [R, D]
    over its batches of rows (codes kc/vc [n, D], scales [n]), in order."""
    R = q.shape[0]
    m = torch.full((R,), -torch.inf)
    l, acc = torch.zeros(R), torch.zeros(R, D)
    for batch in batches:
        s = q @ kc[batch].float().T * ksc[batch] * scale2
        mn = torch.maximum(m, s.max(-1).values)
        corr = torch.exp2(m - mn)
        e = torch.exp2(s - mn[:, None])
        l = l * corr + e.sum(-1)
        acc = acc * corr[:, None] + (e * vsc[batch]) @ vc[batch].float()
        m = mn
    return m, l, acc


def _merge(parts):
    """(m, l, acc) partials merged in their order, base 2: (M, sum l
    2^(m - M), sum acc 2^(m - M)), M every partial's max, taken first."""
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m), torch.exp2(m - M))
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def split_attention(qkv, cos, sin, caches, positions, H, Hkv, chunk_rows, group=4):
    """The kernel's arithmetic in f32: (attn [B, H*D], the new rows' k codes
    [B, Hkv, D], v codes, k scales [B, Hkv], v scales). Slot b's rows 0..p
    (p = positions[b]) are its cache's rows t < p and the new row, cut into
    chunks of `chunk_rows` rows; each (chunk, kv head, sub-group of `group`
    q heads) item's warps run `_online` over rows w, w + 8, ... in batches
    of four, merged in warp order; the chunks merged in chunk order."""
    B, reps = len(positions), H // Hkv
    qdim, kvdim = H * D, Hkv * D
    scale2 = 1.4426950408889634 / D ** 0.5
    attn = torch.empty(B, H, D)
    rows = []
    for b, p in enumerate(positions):
        x = torch.from_numpy(qkv[b])
        c, s = torch.from_numpy(cos[b]), torch.from_numpy(sin[b])
        q = _rope_rows(x[:qdim].reshape(H, D), c, s)
        kq, ks = quantize_kv(_rope_rows(x[qdim:qdim + kvdim].reshape(Hkv, D), c, s)[None, None])
        vq, vs = quantize_kv(x[qdim + kvdim:].reshape(Hkv, D)[None, None])
        kq, ks, vq, vs = kq[0, 0], ks[0, 0], vq[0, 0], vs[0, 0]
        rows.append((kq, vq, ks, vs))
        ck, cv, cks, cvs = (torch.from_numpy(a) for a in caches[b])
        live = lambda hist, new: torch.cat([hist[:p], new[None]])  # row p is the new one
        kc, vc, ksc, vsc = live(ck, kq), live(cv, vq), live(cks, ks), live(cvs, vs)
        for g in range(Hkv):
            for h0 in range(g * reps, (g + 1) * reps, group):
                qg = q[h0:min(h0 + group, (g + 1) * reps)]
                chunks = []
                for t0 in range(0, p + 1, chunk_rows):
                    ts = list(range(t0, min(t0 + chunk_rows, p + 1)))
                    warps = [_online(qg, [mine[i:i + 4] for i in range(0, len(mine), 4)],
                                     kc[:, g], vc[:, g], ksc[:, g], vsc[:, g], scale2)
                             for mine in (ts[w::NW] for w in range(NW))]
                    chunks.append(_merge(warps))
                _, L, A = _merge(chunks)
                attn[b, h0:h0 + len(qg)] = A / L[:, None]
    return (attn.reshape(B, H * D),) + tuple(torch.stack(r) for r in zip(*rows))


@functools.lru_cache(maxsize=None)
def _jax_slots(H, Hkv):
    """JAX's decode attention of every slot of `_step(H, Hkv)` in interpret
    mode: (out [B, H*D], new k codes [B, Hkv, D], v codes, k scales, v
    scales)."""
    qkv, cos, sin, caches = _step(H, Hkv)
    qdim, kvdim = H * D, Hkv * D
    outs = []
    for b, p in enumerate(POSITIONS):
        out, jck, jcv, jks, jvs = jax_fda(
            jnp.asarray(qkv[b:b + 1, :qdim]), jnp.asarray(qkv[b:b + 1, qdim:qdim + kvdim]),
            jnp.asarray(qkv[b:b + 1, qdim + kvdim:]), jnp.asarray(cos[b:b + 1]),
            jnp.asarray(sin[b:b + 1]), *(jnp.asarray(a) for a in caches[b]), p, interpret=True,
            n_heads=H, n_kv_heads=Hkv, head_dim=D, max_len=T)
        outs.append((out[0], jck[p], jcv[p], jks[p], jvs[p]))
    return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(5))


def _codes_match(got, want):
    """The int8-row rule: every code within one, at most 0.1% of them apart."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size


@pytest.mark.parametrize("H,Hkv", HEADS)
@pytest.mark.parametrize("chunk_rows", [8, 16, 32])
def test_split_attention_matches_jax(chunk_rows, H, Hkv):
    qkv, cos, sin, caches = _step(H, Hkv)
    got = split_attention(qkv, cos, sin, caches, POSITIONS, H, Hkv, chunk_rows)
    want = _jax_slots(H, Hkv)
    for g, w in zip(got[1:3], want[1:3]):
        _codes_match(g.numpy(), w)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("positions,heads,cap,want", [
    # Llama-2-7B's rank at TP = 2 (16 q over 16 kv heads): the batched row's positions
    ((0, 17, 64, 127, 128, 200, 383, 510), (16, 16, 128), 512, (128, 16, 1, 1, 240)),
    ((510,) + (0,) * 7, (16, 16, 128), 512, (64, 16, 1, 1, 240)),  # one long slot
    ((0,) * 8, (16, 16, 128), 512, (32, 16, 1, 1, 128)),            # every slot at 0
    ((200,) * 8, (16, 16, 128), 512, (128, 16, 1, 1, 256)),
    ((2047, 5), (32, 8, 128), 2048, (128, 64, 4, 1, 136)),  # GQA groups of 4
    ((30, 99), (12, 1, 128), 128, (32, 4, 4, 3, 15)),        # a group of 12 in 3 items
    ((100, 100), (8, 1, 256), 256, (32, 8, 2, 4, 32)),       # D = 256: 2 heads an item
])
def test_split_plan(positions, heads, cap, want):
    assert mf.tp_split_plan(positions, *heads, cap) == want


@pytest.mark.parametrize("seed", range(6))
def test_split_plan_on_random_steps(seed):
    """At any positions the chunk is the smallest power of two of rows, at
    least TP_CHUNK_MIN, whose items number at most TP_ITEMS, unless one
    chunk a slot still exceeds it; the workspace's chunks hold every slot's."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        B, cap = int(rng.integers(1, 9)), int(rng.choice([128, 512, 2048]))
        pos = [int(p) for p in rng.integers(0, cap, B)]
        Hkv = int(rng.choice([1, 8, 16, 32]))
        cr, n_chunks, group, n_sub, n = mf.tp_split_plan(pos, 32, Hkv, 128, cap)
        per = Hkv * n_sub
        assert cr >= mf.TP_CHUNK_MIN and cr & (cr - 1) == 0
        assert n == sum(p // cr + 1 for p in pos) * per
        assert n <= mf.TP_ITEMS or cr > max(pos)
        if cr > mf.TP_CHUNK_MIN:
            assert sum(p // (cr // 2) + 1 for p in pos) * per > mf.TP_ITEMS
        assert n_chunks * mf.TP_CHUNK_MIN >= cap and max(pos) // cr + 1 <= n_chunks
        assert group == min(32 // Hkv, 4) and group * n_sub >= 32 // Hkv


@pytest.fixture(scope="module")
def rank0():
    """Rank 0 of 2 of a small aligned bf16 model's mode (e) shard: (stack,
    meta, the model's config)."""
    cfg = LlamaConfig(vocab_size=160, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, dtype=torch.bfloat16, seed=2, device="cpu")))
    stack, meta, _ = stack_serving_tp(model, 2, 0)
    return stack, meta, cfg


def _rank_inputs(cfg, positions, Tc=256):
    B, D = len(positions), cfg.head_dim
    x = torch.randn(B, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(B))
    cos, sin = rope_tables(cfg, torch.tensor(positions)[:, None])
    cache = {"k": torch.zeros(cfg.num_layers, B, 1, Tc, D, dtype=torch.int8),
             "v": torch.zeros(cfg.num_layers, B, 1, Tc, D, dtype=torch.int8),
             "k_scale": torch.ones(cfg.num_layers, B, 1, Tc),
             "v_scale": torch.ones(cfg.num_layers, B, 1, Tc)}
    return x.to(torch.bfloat16), cos.reshape(B, D), sin.reshape(B, D), cache


@pytest.fixture
def fake_card(monkeypatch):
    """Every tensor claims to be on the card and the launch is faked: it
    records each argument block (with the GEMV counters it points at) and
    returns `err` (0 by default)."""
    lib = types.SimpleNamespace(err=0, seen=[], counters={})

    def entry(args, bits, dtype, stream):
        a = args._obj
        lib.seen.append({f: getattr(a, f) for f, _ in a._fields_ if f != "b"})
        lib.seen[-1]["counters"] = a.b.counters
        return lib.err

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        mi_model_decode_mega_batch_tp=entry))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(mf, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(mf, "launches_tp", 0)
    monkeypatch.setattr(mf, "_tp_workspaces", {})
    return lib


def test_split_and_workspace_come_from_the_shapes_and_positions(fake_card, rank0):
    """Steps at three position sets pass the plan of their positions (the
    chunk, the slots' positions and first items) and share one workspace,
    allocated once for the shape (its counters zero)."""
    stack, meta, cfg = rank0
    steps = ([0, 7, 8, 200], [31, 32, 33, 255], [0, 0, 0, 0])
    for positions in steps:
        x, cos, sin, cache = _rank_inputs(cfg, positions)
        cfg_l = mf.tp_config(stack, cache, cfg, meta)
        prep = mf.tp_prepare(stack, x, cos, sin, cache, positions, cfg_l, meta)
        x32 = x.reshape(len(positions), -1).float()
        for half in (0, 1):
            mf.tp_launch(prep, 0, half, x32, None)
    assert mf.launches_tp == 2 * len(steps)
    part, count = next(iter(mf._tp_workspaces.values()))
    assert len(mf._tp_workspaces) == 1 and not bool(count.any())
    for i, positions in enumerate(steps):
        cr, n_chunks, group, n_sub, _ = mf.tp_split_plan(positions, 2, 1, 128, 256)
        first = np.cumsum([0] + [(p // cr + 1) * n_sub for p in positions]).tolist()
        for a in fake_card.seen[2 * i:2 * i + 2]:
            assert (a["chunk_rows"], a["n_chunks"], a["group"]) == (cr, n_chunks, group)
            assert list(a["slot_pos"])[:4] == positions and list(a["slot_item"])[:5] == first
            assert (a["apart"], a["acount"]) == (part.data_ptr(), count.data_ptr())
    assert part.numel() == 4 * 2 * n_chunks * (128 + 2) and count.numel() == 4 * 1 * n_sub


def test_refused_launch_raises_and_runs_no_plain_version(fake_card, rank0, monkeypatch):
    """A launch the library refuses raises from model_decode_mega_batch's TP
    mode on CUDA tensors; the plain version never runs in its place and no
    launch is counted."""
    stack, meta, cfg = rank0
    fake_card.err = 1  # cudaErrorInvalidValue
    monkeypatch.setattr(mf, "model_decode_mega_batch_ref",
                        lambda *a, **k: pytest.fail("the plain version ran on CUDA tensors"))
    positions = [3, 9]
    x, cos, sin, cache = _rank_inputs(cfg, positions)
    with pytest.raises(RuntimeError, match="model_decode_mega_batch_tp failed with cudaError 1"):
        mf.model_decode_mega_batch(stack, x, cos, sin, cache, positions, cfg, meta, tp=2,
                                   group=LocalGroup(2).rank(0))
    assert len(fake_card.seen) == 1 and mf.launches_tp == 0
