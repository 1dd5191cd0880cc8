"""The flat whole-model kernel's 4-bit GEMV (csrc/flat_gemv.cuh) in the parts
the CPU can check: its work plan (`ops.model_flat.flat_plan`, run on every
launch), which cuts each GEMV into (column tile x K split) items and the
items' chunks among a strip's warps, the staged windows, the scratch the
wrapper sizes, and a plain-torch model of the kernel's arithmetic for its
one row (exact bf16 planes in the n8 columns, centered codes, the grouped
rescale at each group's and each warp's end, the warps' sums added in warp
order, the splits' partials added in split order by the phase that reads
them), held against the plain version `qdot_ref`.

`_deal` mirrors FgItem's index arithmetic, `_windows` fg_window_end's and
`_kernel_model` fg_gemv's sums. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py -k flat).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.ops import model_flat as mf
from mi_optimize_tpu_torch.ops.dequant_matmul import qdot_ref

BLOCKS = mf.COOP_PER_SM * mf.H100_SMS  # the cooperative grid on an H100: 264 blocks
GEMVS = ("qkv", "o", "gate_up", "down", "lm_head")
# the share of the grid's block turns (waves x 264 - items) a plan leaves
# idle at Llama-2-7B: the GEMVs that split K fill it to 5%; the lm_head
# (no split: the argmax needs whole logits) to 5.3%, its 1000 strips in 250
# tiles of four
IDLE = {"qkv": 0.05, "o": 0.05, "gate_up": 0.05, "down": 0.05, "lm_head": 0.06}


def _cfg_7b(layers=32):
    return dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=layers)


def _meta(g, vocab, zc=8.0):
    return (4, g, g, g, g, zc, zc, zc, zc, g, zc, vocab)


def _small_cfg(inter, vocab):
    return LlamaConfig(vocab_size=vocab, hidden_size=512, intermediate_size=inter, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)


# (name, config, group): Llama-2-7B at g128 and g32, its 2-layer draft at
# the same widths, and the card tests' small models with ragged widths: a
# vocab of 200 (not a multiple of a 32-column strip) and intermediate size
# 1000 at group 8 (a chunk of 8 word rows holds one of a group's word row)
PLANS = [("7b", _cfg_7b(), 128), ("7b", _cfg_7b(), 32), ("draft", _cfg_7b(2), 128),
         ("small_ragged", _small_cfg(1024, 200), 128), ("small_1000", _small_cfg(1000, 160), 8),
         ("small_g32", _small_cfg(1024, 160), 32)]
GEMV_CASES = [(name, g, i) for name, _, g in PLANS for i in range(5)]


def _plans(name, g):
    cfg = next(c for n, c, gg in PLANS if n == name and gg == g)
    return mf.flat_plans(cfg, _meta(g, cfg.vocab_size))


def _deal(ncols, K, g, ws, splits):
    """What each warp of fg_gemv streams: [(item, split, (ga, gb), first
    column, (jlo, jhi))], a warp's strip of FLAT_STRIP output columns from
    `first column` over chunks [jlo, jhi) of its item's split [ga, gb)
    (chunk j: group ga + j // cpg, word rows 8 (j % cpg) .. + 7 of it)."""
    ng, cpg = K // g, -(-(g // 8) // mf.FLAT_CHUNK_ROWS)
    sw, ks = mf.FLAT_STRIP, mf.FLAT_WARPS // ws
    ntiles = -(-ncols // (ws * sw))
    out = []
    for item in range(ntiles * splits):
        tile, sp = item % ntiles, item // ntiles
        ga, gb = sp * ng // splits, (sp + 1) * ng // splits
        L = (gb - ga) * cpg
        for warp in range(mf.FLAT_WARPS):
            strip, ksub = warp % ws, warp // ws
            out.append((item, sp, (ga, gb), (tile * ws + strip) * sw,
                        (ksub * L // ks, (ksub + 1) * L // ks)))
    return out


def check_covers(ncols, K, gg, ws, splits):
    """Every (output column, word row) of one GEMV's plan is streamed by
    exactly one warp; the splits are whole groups, in order, covering K,
    none empty."""
    ng, wpg, R = K // gg, gg // 8, mf.FLAT_CHUNK_ROWS
    cpg = -(-wpg // R)
    assert ws in (1, 2, 4, 8) and 1 <= splits <= ng and gg % 8 == 0 and K % gg == 0
    count = np.zeros((ncols, K // 8), np.int32)
    bounds = {}
    for item, sp, (ga, gb), col, (jlo, jhi) in _deal(ncols, K, gg, ws, splits):
        bounds[sp] = (ga, gb)
        if col >= ncols:
            continue
        for j in range(jlo, jhi):
            gi, q = ga + j // cpg, j % cpg
            rows = [gi * wpg + R * q + t for t in range(R) if R * q + t < wpg]
            count[col:col + mf.FLAT_STRIP, rows] += 1
    assert (count == 1).all()
    b = [bounds[s] for s in range(splits)]
    assert b[0][0] == 0 and b[-1][1] == ng
    assert all(ga < gb for ga, gb in b)
    assert all(b[k][1] == b[k + 1][0] for k in range(splits - 1))


@pytest.mark.parametrize("name,g,i", GEMV_CASES)
def test_plan_covers_every_column_and_word_row_once(name, g, i):
    """`check_covers` for each GEMV of each plan; the lm_head is unsplit
    (the kernel's check_plan refuses anything else)."""
    ncols, K, gg, ws, splits = _plans(name, g)[i]
    check_covers(ncols, K, gg, ws, splits)
    if GEMVS[i] == "lm_head":
        assert splits == 1


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("g", [32, 128])
def test_plan_fills_the_grid_at_7b(g, i):
    """At every Llama-2-7B GEMV, at group 32 and 128, the items leave at most
    IDLE[gemv] of the 264 blocks' turns idle, and 250 or more blocks have an
    item in the first wave: o_proj and down_proj (N = 4096) and gate/up split
    K to fill the grid as qkv and the lm_head fill it with columns."""
    ncols, K, gg, ws, splits = _plans("7b", g)[i]
    items = -(-ncols // (ws * mf.FLAT_STRIP)) * splits
    waves = -(-items // BLOCKS)
    assert waves * BLOCKS - items <= IDLE[GEMVS[i]] * waves * BLOCKS
    assert min(items, BLOCKS) >= 0.94 * BLOCKS


def test_draft_takes_the_7b_plan():
    """The 2-layer planted draft has Llama-2-7B's widths: the same plan a
    launch, so its 5 launches a speculative round fill the grid alike."""
    assert _plans("draft", 128) == _plans("7b", 128)


def _windows(L, g, cpg, kc):
    """fg_window_end's windows over a split of L chunks: [(jw0, jw1)]."""
    out, jw0 = [], 0
    while jw0 < L:
        jw1 = min(L, jw0 + (kc // g) * cpg) if g <= kc else min(
            (jw0 // cpg + 1) * cpg, jw0 + kc // (8 * mf.FLAT_CHUNK_ROWS))
        out.append((jw0, jw1))
        jw0 = jw1
    return out


def _window_rows(ga, jw0, jw1, wpg, cpg):
    """The word rows fg_gemv stages for chunks [jw0, jw1): [wa, wb)."""
    R = mf.FLAT_CHUNK_ROWS
    wa = (ga + jw0 // cpg) * wpg + R * (jw0 % cpg)
    gl = ga + (jw1 - 1) // cpg
    return wa, min(gl * wpg + R * ((jw1 - 1) % cpg) + R, (gl + 1) * wpg)


def check_scratch(plans):
    """flat_scratch(plans) holds the f32 partials every split of qkv,
    o_proj, gate/up and down_proj writes (the kernel's index of the last
    column of the last split, at its region's offset), and a window that
    holds every split whole (one staged window an item), a multiple of 64 k
    within FLAT_KC_MAX."""
    n_part, kc = mf.flat_scratch(plans)
    assert kc % 64 == 0 and 64 <= kc <= mf.FLAT_KC_MAX
    off = 0
    for i in range(4):
        ncols, _, _, _, splits = plans[i]
        off += splits * ncols
        assert off <= n_part
    assert off == n_part
    for ncols, K, gg, ws, splits in plans:
        wpg, cpg, ng = gg // 8, -(-(gg // 8) // mf.FLAT_CHUNK_ROWS), K // gg
        for sp in range(splits):
            ga, gb = sp * ng // splits, (sp + 1) * ng // splits
            win = _windows((gb - ga) * cpg, gg, cpg, kc)
            assert len(win) == 1
            wa, wb = _window_rows(ga, *win[0], wpg, cpg)
            assert (wa, wb) == (ga * wpg, gb * wpg)


@pytest.mark.parametrize("name,g", [(n, g) for n, _, g in PLANS])
def test_scratch_fits_the_plan(name, g):
    """The wrapper allocates flat_scratch(plans): `check_scratch`."""
    check_scratch(_plans(name, g))


@pytest.mark.parametrize("K,g,kc", [(11008, 11008, 8192), (4096, 4096, 1024), (1000, 8, 64),
                                    (4096, 128, 640)])
def test_windows_stage_every_word_row_once(K, g, kc):
    """Where a split is longer than the window (a per-channel group above
    FLAT_KC_MAX, or a window the plan did not size), the windows cut it in
    order, each at most kc / 8 word rows, and together stage every word row
    of the split once: whole groups up to kc, else kc-sized pieces of one."""
    wpg, cpg = g // 8, -(-(g // 8) // mf.FLAT_CHUNK_ROWS)
    for ga, gb in ((0, K // g), (K // g // 2, K // g)):
        if ga == gb:
            continue
        rows = []
        for jw0, jw1 in _windows((gb - ga) * cpg, g, cpg, kc):
            wa, wb = _window_rows(ga, jw0, jw1, wpg, cpg)
            assert 0 < wb - wa <= kc // 8
            rows += list(range(wa, wb))
        assert rows == list(range(ga * wpg, gb * wpg))


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def _planes(x, n):
    """x (f32) as n bf16 planes, each rounded to nearest from what the planes
    before it leave: fg_stage's split."""
    out, rem = [], x.clone()
    for _ in range(n):
        p = rem.to(torch.bfloat16)
        out.append(p)
        rem = rem - p.float()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_three_planes_reconstruct_f32_rows_exactly(seed):
    """hi + mid + lo is x exactly, for values over 40 binades, near 2^-100
    and 2^100, and 0; an exact bf16 value (a bf16 model's normed row) is its
    own first plane (mid = lo = 0); a centered code times a plane is exact
    in f32, so the tensor cores' products are."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4096).astype(np.float32) * np.exp2(
        rng.integers(-20, 21, 4096)).astype(np.float32)
    near = np.concatenate([np.exp2(np.float32(e)) * (1 + rng.random(64).astype(np.float32))
                           for e in (-100, 100)]).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x, near, -near, [0.0]]).astype(np.float32))
    hi, mid, lo = _planes(x, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    exact = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(torch.bfloat16)
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


def _kernel_model(x, packed, s, zc, g, ws, splits, n_planes, b=None):
    """fg_gemv's sums for one row x [K], in plain torch, and the consumer's
    sum of the splits: per item split, each of the ks = 8 // ws warps of a
    strip streams chunks [jlo, jhi) of the split (8 word rows of one group
    each); a warp's segment (its chunks of one group) gives D = the planes'
    products with the centered codes (exact, f32 sums, planes added in
    order) and xsum = the segment's word sums, and y += s*D + (8s - zc*s) *
    xsum, or with a bias table b [K/g, N] (fg_gemv<T, true>) y += s*D +
    (8s + b) * xsum; the warps add in warp order, the splits in split
    order."""
    K = x.shape[0]
    ng, wpg, ks, R = K // g, g // 8, mf.FLAT_WARPS // ws, mf.FLAT_CHUNK_ROWS
    cpg = -(-wpg // mf.FLAT_CHUNK_ROWS)
    codes = (torch.stack([(packed >> (4 * i)) & 15 for i in range(8)], 1).reshape(K, -1)
             - 8).float()
    planes = [p.float() for p in _planes(x, n_planes)]
    wsum = x.reshape(K // 8, 8).sum(-1)
    y = None
    for sp in range(splits):
        ga, gb = sp * ng // splits, (sp + 1) * ng // splits
        L = (gb - ga) * cpg
        part = None
        for ksub in range(ks):
            acc = torch.zeros(packed.shape[1])
            jlo, jhi = ksub * L // ks, (ksub + 1) * L // ks
            j = jlo
            while j < jhi:  # one segment: the warp's chunks of group gi
                gi = ga + j // cpg
                je = min(jhi, (gi - ga + 1) * cpg)
                r0 = gi * wpg + R * (j % cpg)
                r1 = min(gi * wpg + R * ((je - 1) % cpg) + R, (gi + 1) * wpg)
                sl = slice(8 * r0, 8 * r1)
                d = None
                for p in planes:
                    dp = p[sl] @ codes[sl]
                    d = dp if d is None else d + dp
                xs = wsum[r0:r1].sum()
                cb = 8 * s[gi] - zc * s[gi] if b is None else 8 * s[gi] + b[gi]
                acc = acc + (s[gi] * d + cb * xs)
                j = je
            part = acc if part is None else part + acc
        y = part if y is None else y + part
    return y


# (K, N, g, ws, splits) of the model of the sums
GEMV_SHAPES = [
    (4096, 96, 128, 8, 11),     # qkv's plan: 11 splits of 2-3 groups, one warp a strip
    (4096, 64, 128, 1, 2),      # o_proj's: 8 warps split 16 groups (32 chunks)
    (11008, 64, 128, 1, 2),     # down_proj's: 86 chunks a split, 10-11 a warp, mid-group ends
    (4096, 40, 32, 4, 1),       # the lm_head's shape at g32, a ragged N
    (1000, 48, 8, 1, 5),        # group 8: a chunk holds one word row of a group
    (2048, 32, 32, 1, 2),       # group 32: half a chunk a group
    (1024, 32, 1024, 2, 1)]     # a per-channel group cut among 4 warps


@pytest.mark.parametrize("K,N,g,ws,splits", GEMV_SHAPES)
@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("zc", [8.0, 7.0])
def test_grouped_rescale_model_agrees_with_qdot_ref(K, N, g, ws, splits, rows, zc):
    """The kernel's arithmetic on numpy inputs from a seed (an f32 row in
    three planes, a bf16-valued row in one; the symmetric grid's zero 8, so
    that the xsum term is 0, and 7, so that it is not) agrees with qdot_ref
    to 1e-6 of its largest output: only the order of the f32 additions
    differs."""
    rng = np.random.default_rng(K + N + g + ws)
    x = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    if rows == "bf16":
        x = x.to(torch.bfloat16).float()
    packed = _packed(rng, K, N)
    s = torch.from_numpy((rng.random((K // g, N)) * 0.02 + 1e-3).astype(np.float32))
    ref = qdot_ref(x[None], packed, s, s * (-zc), 4, g)[0]
    got = _kernel_model(x, packed, s, zc, g, ws, splits, 1 if rows == "bf16" else 3)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_one_plane_of_an_f32_row_is_not_exact():
    """The three planes matter: the same f32 row through one bf16 plane
    misses qdot_ref by far more than 1e-6 (the bf16 rounding of x)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    packed = _packed(rng, 1024, 64)
    s = torch.full((8, 64), 0.01)
    ref = qdot_ref(x[None], packed, s, -8 * s, 4, 128)[0]
    got = _kernel_model(x, packed, s, 8.0, 128, 8, 1, 1)
    assert float((got - ref).abs().max()) > 1e-4 * float(ref.abs().max())
