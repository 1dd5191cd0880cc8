"""The per-layer decode (`ops.block_fused.block_decode_mega`) on the "mega4"
route, in the parts the CPU can check: `block_route`, which sends 4-bit
words in float32 or bfloat16 to the whole-model kernel's tensor-core layer
loop at one layer (csrc/model_mega4.cu) and 2- and 8-bit words to the
CUDA-core block_decode_kernel; the block's one-layer view (`mega4_view`):
storage shared with the block, the plan, the grid's zero constants, made
once a block; the wrapper with the launch stubbed; the plain versions of
the two kernels, which agree bit for bit on one layer; and the tie rule of
the card tests' `_rows_match`. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py -k block_decode).
"""
import pytest
import torch

from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.ops import block_fused, model_flat, model_fused
from mi_optimize_tpu_torch.ops.coop_plan import H100_SMS
from mi_optimize_tpu_torch.serving import megadecode
from tests.test_torch_cuda_kernels import TIE, _cache, _rows_match, _small

LINEARS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
GRIDS = [True, False]  # symmetric (one zero constant), asymmetric (bias tables)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _h100_plan(monkeypatch):
    """The view's plan for an H100's SMs (`coop_plan.sm_count` asks the
    card)."""
    monkeypatch.setattr(model_fused, "sm_count", lambda dev: H100_SMS)


def _block(symmetric, dtype, seed=3, bits=4):
    """Layer 1 of the card tests' small Llama (hidden 512, 4 heads of 128,
    2 kv heads, I = 1024, g128) on the CPU, served (`fuse_for_serving`),
    with its norms in the model dtype."""
    cfg, cpu, _ = _small("cpu", bits=bits, symmetric=symmetric, dtype=dtype, seed=seed)
    blk = cpu.params["layers"][1]
    for k in ("input_norm", "post_norm"):
        blk[k] = blk[k].to(dtype)
    return cfg, blk


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES + [torch.float16])
def test_route_by_bits_and_dtype(bits, dtype):
    want = "mega4" if bits == 4 and dtype in DTYPES else "cuda_core"
    assert block_fused.block_route(bits, dtype) == want


@pytest.mark.parametrize("symmetric", GRIDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_view_shares_the_blocks_storage(symmetric, dtype):
    """The one-layer stack is [1, ...] views of the block's packed words,
    its `mega` scale (and, on an asymmetric grid, bias) tables and its
    norms: the same storage, nothing copied."""
    cfg, blk = _block(symmetric, dtype)
    mega = blk["mega"]
    v = block_fused.mega4_view(blk, mega, cfg, dtype)
    pairs = [(v.stack["n1"], blk["input_norm"]), (v.stack["n2"], blk["post_norm"])]
    for (name, wk, sk, zk), key in zip(megadecode._STACKED, ("q", "o", "gu", "d")):
        pairs += [(v.stack[wk], blk[name].packed), (v.stack[sk], mega[key + "s"])]
        if symmetric:
            assert zk not in v.stack
        else:
            pairs.append((v.stack[zk], mega[key + "b"]))
    for view, t in pairs:
        assert view.shape == (1,) + tuple(t.shape)
        assert view.data_ptr() == t.data_ptr()
        assert view.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    a = v.prep.args.m
    assert (a.qkv, a.qs, a.dn, a.ds, a.n1) == (
        blk["qkv_proj"].packed.data_ptr(), mega["qs"].data_ptr(),
        blk["down_proj"].packed.data_ptr(), mega["ds"].data_ptr(),
        blk["input_norm"].data_ptr())
    assert v.cfg.num_layers == 1 and a.n_layers == 1 and v.prep.args.f.n_layers == 1


@pytest.mark.parametrize("symmetric", GRIDS)
def test_view_plan_is_the_flat_plan_without_the_lm_head(symmetric):
    cfg, blk = _block(symmetric, torch.float32)
    v = block_fused.mega4_view(blk, blk["mega"], cfg, torch.float32)
    plans = model_flat.flat_plans(cfg, v.meta, H100_SMS, lm=False)
    assert v.prep.plans == plans
    f = v.prep.args.f
    assert list(f.plan_ws[:4]) == [p[3] for p in plans]
    assert list(f.plan_splits[:4]) == [p[4] for p in plans]
    assert (f.n_part, f.plan_kc) == model_flat.flat_scratch(plans) == (v.prep.n_part, f.plan_kc)


@pytest.mark.parametrize("symmetric", GRIDS)
def test_view_grid_follows_zconst(symmetric):
    """A linear whose zero is one constant takes -zc*s in the kernel and
    passes no bias table (BIAS = 0 where all four do); the others pass
    their table (the BIAS instance)."""
    cfg, blk = _block(symmetric, torch.float32)
    v = block_fused.mega4_view(blk, blk["mega"], cfg, torch.float32)
    zcs = tuple(megadecode._zconst([blk], n) for n in LINEARS)
    assert v.meta == (4,) + tuple(block_fused.group_size(blk[n]) for n in LINEARS) + zcs
    assert all((z is not None) == symmetric for z in zcs)
    m = v.prep.args.m
    for zc, table, field in zip(zcs, (m.qb, m.ob, m.gub, m.db), ("zc_qkv", "zc_o", "zc_gu",
                                                                 "zc_d")):
        assert (table is None) == (zc is not None)
        assert getattr(m, field) == pytest.approx(0.0 if zc is None else zc)


def test_view_made_once_a_block_and_dtype(monkeypatch):
    """The meta, the zero test (a device sync on the card) and the plan are
    paid at a block's first launch in a dtype, not at every launch."""
    cfg, blk = _block(True, torch.float32)
    calls = []
    zconst = megadecode._zconst
    monkeypatch.setattr(megadecode, "_zconst", lambda *a: calls.append(a) or zconst(*a))
    v = block_fused.mega4_view(blk, blk["mega"], cfg, torch.float32)
    assert block_fused.mega4_view(blk, blk["mega"], cfg, torch.float32) is v
    assert len(calls) == 4
    assert block_fused.mega4_view(blk, blk["mega"], cfg, torch.bfloat16) is not v
    assert len(calls) == 8


@pytest.mark.parametrize("symmetric", GRIDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_launches_mega4_on_the_view(monkeypatch, symmetric, dtype):
    """With the launch stubbed, a 4-bit block goes to mi_model_decode_mega4
    in model_mega4's library at one layer, with the block's own words and
    tables, its per-layer cache as the stacked cache, the bias tables only
    on the asymmetric grid, and counts in `launches` and
    `launches_mega4`; a second launch reuses the view."""
    cfg, blk = _block(symmetric, dtype)
    calls = []
    monkeypatch.setattr(model_fused, "_call", lambda name, args, argtype, b, dt, dev,
                        lib="model_fused": calls.append((name, lib, args, b, dt)))
    T, pos = 256, 130
    cache = _cache(cfg, T, pos)
    x = torch.randn(1, 1, cfg.hidden_size).to(dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    for counter in ("launches", "launches_mega4"):
        monkeypatch.setattr(block_fused, counter, getattr(block_fused, counter))
    before, before4 = block_fused.launches, block_fused.launches_mega4
    for _ in range(2):
        block_fused._block_decode_cuda(blk, blk["mega"], x, cos.reshape(-1), sin.reshape(-1),
                                       cache, pos, cfg)
    assert block_fused.launches == before + 2 and block_fused.launches_mega4 == before4 + 2
    assert len(blk["mega"]["mega4"]) == 1
    (name, lib, args, b, dt), _ = calls
    assert (name, lib, b, dt) == ("mi_model_decode_mega4", "model_mega4", 4, dtype)
    m, f = args.m, args.f
    assert (m.n_layers, m.max_len, m.pos, f.max_len, f.pos) == (1, T, pos, T, pos)
    assert (m.ck, m.cvs, m.qkv, m.gus) == (cache["k"].data_ptr(), cache["v_scale"].data_ptr(),
                                           blk["qkv_proj"].packed.data_ptr(),
                                           blk["mega"]["gus"].data_ptr())
    assert all(getattr(f, n) == getattr(m, n) for n in ("x", "cos", "scratch", "qkv", "ds"))
    # the plan's partials after the scratch, 256-byte aligned
    qdim, kvdim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    need = 2 * cfg.hidden_size + 2 * qdim + 2 * kvdim + cfg.intermediate_size
    assert (f.part - m.scratch) % 256 == 0 and f.part - m.scratch >= 4 * need
    assert all((t is None) == symmetric for t in (m.qb, m.ob, m.gub, m.db))


def test_block_decode_mega_points_the_kernel_at_the_cache_rows(monkeypatch):
    """`block_decode_mega` on the "mega4" route hands the kernel the cache's
    own rows and scales at pos as its outputs (the kernel writes them in
    place) and scatters nothing after it: with the launch stubbed, the
    cache is left as it was."""
    cfg, blk = _block(True, torch.bfloat16)
    calls = []
    monkeypatch.setattr(model_fused, "_call", lambda name, args, *a, **k: calls.append(args))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for counter in ("launches", "launches_mega4"):
        monkeypatch.setattr(block_fused, counter, getattr(block_fused, counter))
    T, pos = 256, 130
    cache = _cache(cfg, T, pos)
    before = {f: t.clone() for f, t in cache.items()}
    x = torch.randn(1, 1, cfg.hidden_size).to(torch.bfloat16)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    y, out = block_fused.block_decode_mega(blk, blk["mega"], x, cos.reshape(-1),
                                           sin.reshape(-1), cache, pos, cfg)
    (args,) = calls
    m = args.m
    assert out is cache and y.shape == x.shape
    assert (m.krow, m.vrow, m.ks, m.vs) == tuple(
        cache[f][0, pos].data_ptr() for f in ("k", "v", "k_scale", "v_scale"))
    assert all(torch.equal(cache[f], before[f]) for f in cache)


@pytest.mark.parametrize("symmetric", GRIDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [0, 130])
def test_one_layer_plain_versions_agree_bit_for_bit(symmetric, dtype, pos):
    """The whole-model plain version over the block's one-layer view is the
    per-layer plain version, bit for bit, before rounding too: the two run
    `layer_rows_ref` on the same words and tables (-zc*s on a symmetric
    grid equals the block's bias table). tests/test_torch_block_fused.py
    holds the per-layer one against JAX's kernel in interpret mode."""
    cfg, blk = _block(symmetric, dtype, seed=pos + 1)
    v = block_fused.mega4_view(blk, blk["mega"], cfg, dtype)
    cache = _cache(cfg, 256, pos, seed=pos)
    x = torch.randn(1, 1, cfg.hidden_size, generator=torch.Generator().manual_seed(pos)).to(dtype)
    cos, sin = llama.rope_tables(cfg, torch.tensor([pos]))
    cos, sin = cos.reshape(-1), sin.reshape(-1)
    got = model_fused.model_decode_mega_ref(v.stack, x, cos, sin, cache, pos, v.cfg, v.meta,
                                            pre=True)
    ref = block_fused.block_decode_ref(blk, blk["mega"], x, cos, sin, cache, pos, cfg, pre=True)
    assert got[0].shape == x.shape and got[0].dtype == dtype
    assert torch.equal(got[0].reshape(1, -1), ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape[0] == 1 and torch.equal(g[0], r)
    assert torch.equal(torch.round(ref[5]).clamp(-127, 127).to(torch.int8), ref[1])


# ---------------------------------------------------------------------------
# the card tests' tie rule (`_rows_match` rule (b))
# ---------------------------------------------------------------------------

def _planted(n, at, flips=(), step=1, sign=1):
    """(got, ref, pre) for n codes: pre = k + 0.3 (k = -60..59) but at the
    positions of `at`, sign * (57.5 - at[i]): that far inside a .5 tie; ref
    rounds pre half to even; got moves the codes at `flips` by `step` away
    from zero, to the tie's other side."""
    pre = (torch.arange(n) % 120 - 60).to(torch.float32) + 0.3
    for i, dist in at.items():
        pre[i] = sign * (57.5 - dist)
    ref = torch.round(pre).to(torch.int8)
    got = ref.clone()
    for i in flips:
        got[i] += sign * step
    return got, ref, pre


@pytest.mark.parametrize("sign", [1, -1])
def test_tie_rule_forgives_one_flip_at_a_tie(sign):
    """One code of 512 a step away, its plain value 1e-5 from a .5 tie:
    rule (a) refuses it (0.1% of 512 is no code), rule (b) forgives it."""
    got, ref, pre = _planted(512, {73: 1e-5}, flips=[73], sign=sign)
    with pytest.raises(AssertionError):
        _rows_match(got, ref)
    _rows_match(got, ref, pre)


def test_tie_rule_rejects_a_flip_away_from_a_tie():
    got, ref, pre = _planted(512, {73: 1e-2}, flips=[73])
    with pytest.raises(AssertionError):
        _rows_match(got, ref, pre)


def test_tie_rule_rejects_a_flip_of_two():
    got, ref, pre = _planted(512, {73: 1e-5}, flips=[73], step=2)
    with pytest.raises(AssertionError):
        _rows_match(got, ref, pre)


@pytest.mark.parametrize("n,k", [(512, 2), (4096, 5)])
def test_tie_rule_rejects_more_flips_than_its_share(n, k):
    """max(1, 0.1%) codes: 1 of 512, 4 of 4096; one more is refused, each
    at a tie."""
    at = {7 * i + 1: 1e-5 for i in range(k)}
    with pytest.raises(AssertionError):
        _rows_match(*_planted(n, at, flips=list(at)))
    fewer = dict(list(at.items())[:-1])
    _rows_match(*_planted(n, fewer, flips=list(fewer)))


def test_tie_rule_bound_is_two_ten_thousandths_of_a_code():
    assert TIE == 2e-4
    _rows_match(*_planted(512, {73: 1.9e-4}, flips=[73]))
    with pytest.raises(AssertionError):
        _rows_match(*_planted(512, {73: 3e-4}, flips=[73]))
