"""The port's tensor-parallel batched step (serving/megadecode.py
stack_serving_tp, model_step_batch_tp, model_step_batch_paged_tp; kernel
ops/model_fused.py::model_decode_mega_batch mode (e), csrc/model_fused_tp.cu:
B5(e)) against the JAX package, float32, on the aligned small Llama (2
layers, h=512, 4 heads over 2 kv heads, D=128, g128).

- stack_serving_tp: each rank's packed words bit-equal to its cut of JAX's
  shard-major stack, its scale rows equal, the same meta and rank config, on
  a symmetric and an asymmetric grid; None exactly where JAX returns None
  (Llama-2-7B's g128 MLP at tp = 4, heads that do not split).
- The TP steps at ntp = 2 against JAX's single-device model_step_batch
  (dense: B = 2 at the reference TP test's positions 6 and 17, one step; B =
  3 on the asymmetric grid with a free slot, two steps) and
  model_step_batch_paged (B = 2 over a page pool, two steps): first-step
  logits within 2e-4 of max|ref| (the batched tests' tolerance; tighter
  than the reference TP test's 2e-3), greedy tokens of every step equal,
  every rank's kv rows equal to JAX's rows of its heads by the int8-row
  rule (one-code tie flips on at most 0.1% of entries), scales within 1e-5.
  JAX's own model_step_batch_tp is not run: in interpret mode on this
  JAX (0.9.0) its simulated remote DMAs did not finish within 300 s.
- mode (e) refuses the chunk mode and the lm rows, as JAX asserts.
The port's ranks run as gloo processes of world 2 (tests/torch_tp_workers.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models.llama import LlamaConfig as JLlamaConfig
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.models.quant_linear import QuantSpec as JQuantSpec
from mi_optimize_tpu.models.quant_linear import QuantizedLinear as JQuantizedLinear
from mi_optimize_tpu.serving import megadecode as jmegadecode
from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.quant_linear import QuantSpec, QuantizedLinear
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.parallel import LocalGroup, launch
from mi_optimize_tpu_torch.serving import engine, megadecode
from tests.test_torch_batching import _slot_cache
from tests.test_torch_block_fused import assert_rows_match
from tests.test_torch_model_fused import fused_pair, jax_model
from tests.test_torch_paged import FIELDS, P, _at, _at_pages, _mirror, _prefilled

NTP = 2
STEPS = 2
# the shard axis of each stacked array of JAX's shard-major stack
AXIS = {"qkv": 2, "qs": 2, "o": 1, "os": 1, "gu": 2, "gus": 2, "d": 1, "ds": 1}


@pytest.fixture(scope="module")
def models():
    """(JAX fused model, port fused model, port stack, meta) of each grid."""
    out = {}
    for grid, seed in (("sym", 3), ("asym", 6)):
        jf, _, pf, (stack, meta) = fused_pair(jax_model(seed, grid == "asym"))
        out[grid] = (jf, pf, stack, meta)
    return out


@pytest.fixture(scope="module")
def runs(models):
    """JAX's references and the port's ranks: the TP step against JAX's TP
    step (sym, B = 2), the dense steps against JAX's single-device step
    (asym, B = 3, a free slot), the paged steps against JAX's paged step (sym,
    B = 2 over a pool of pages of 128)."""
    jf, pf, _, _ = models["sym"]
    ja, pa, _, _ = models["asym"]
    cases, ref = [], {}
    # 1. the reference TP test's setting (positions 6 and 17), one step,
    # against JAX's single-device step
    cache, last = _slot_cache(jf, [6, 17], seed=9)
    sc = jmegadecode.stack_cache_batched([{f: jnp.asarray(v) for f, v in c.items()}
                                          for c in cache])
    jst, jm = jmegadecode.stack_serving(jf)
    lg, sc2 = jmegadecode.model_step_batch(jf.params, jst, jm, jf.config, jnp.asarray(last), sc,
                                           jnp.asarray([6, 17]), interpret=True)
    ref["tp"] = dict(logits=np.asarray(lg), tokens=np.asarray(jnp.argmax(lg, -1))[:, None],
                     positions=[6, 17], cache={f: np.asarray(v) for f, v in sc2.items()})
    cases.append(("tp_step", dict(model=pf, tokens=last, positions=[6, 17],
                                  cache={f: np.asarray(v) for f, v in sc.items()}, steps=1)))
    # 2. dense steps against the single-device step
    positions = [11, 0, 37]
    cache, last = _slot_cache(ja, positions, seed=6)
    sc = jmegadecode.stack_cache_batched([{f: jnp.asarray(v) for f, v in c.items()}
                                          for c in cache])
    scn = {f: np.asarray(v) for f, v in sc.items()}
    jst, jm = jmegadecode.stack_serving(ja)
    pos, cur, toks, first = jnp.asarray(positions), jnp.asarray(last), [], None
    for _ in range(STEPS):
        lg, sc = jmegadecode.model_step_batch(ja.params, jst, jm, ja.config, cur, sc, pos,
                                              interpret=True)
        first = np.asarray(lg) if first is None else first
        cur = jnp.argmax(lg, -1).astype(cur.dtype)[:, None]
        toks.append(np.asarray(cur[:, 0]))
        pos = pos + 1
    ref["dense"] = dict(logits=first, tokens=np.stack(toks, 1), positions=positions,
                        cache={f: np.asarray(v) for f, v in sc.items()})
    cases.append(("tp_step", dict(model=pa, tokens=last, positions=positions, cache=scn,
                                  steps=STEPS)))
    # 3. paged steps against the single-device paged step
    positions = [9, 140]
    scp, last = _prefilled(jf, positions, 2 * P, np.random.default_rng(11))
    pool, table = _mirror(scp, jf.config, seed=1)
    jst, jm = jmegadecode.stack_serving(jf)
    jpool = {f: jnp.asarray(v) for f, v in pool.items()}
    pos, cur, toks, first = jnp.asarray(positions), jnp.asarray(last), [], None
    for _ in range(STEPS):
        lg, jpool = jmegadecode.model_step_batch_paged(jf.params, jst, jm, jf.config, cur, jpool,
                                                       jnp.asarray(table), pos, interpret=True)
        first = np.asarray(lg) if first is None else first
        cur = jnp.argmax(lg, -1).astype(cur.dtype)[:, None]
        toks.append(np.asarray(cur[:, 0]))
        pos = pos + 1
    ref["paged"] = dict(logits=first, tokens=np.stack(toks, 1), positions=positions,
                        table=table, pool={f: np.asarray(v) for f, v in jpool.items()})
    cases.append(("tp_step", dict(model=pf, tokens=last, positions=positions, cache=pool,
                                  steps=STEPS, table=table)))
    res = launch.spawn("tests.torch_tp_workers:run_cases", NTP, cases=cases)
    return ref, res


def _close(got, ref, rtol=2e-4):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _heads(res, i):
    """The ranks' caches of case i, their kv heads put back together."""
    return {f: np.concatenate([r[i]["cache"][f] for r in res], axis=2) for f in FIELDS}


def _rows(got, want):
    for f in ("k", "v"):
        assert np.abs(got[f]).sum() > 0, f"{f} rows not written"
        assert_rows_match(got[f], want[f])
        np.testing.assert_allclose(got[f + "_scale"], want[f + "_scale"], rtol=1e-5)


@pytest.mark.parametrize("grid", ["sym", "asym"])
def test_stack_serving_tp_cuts_match_jax(models, grid):
    jf, pf, _, meta = models[grid]
    gstack, jmeta, jcfg_l = jmegadecode.stack_serving_tp(jf, NTP)
    for r in range(NTP):
        stack, m, cfg_l = megadecode.stack_serving_tp(pf, NTP, r)
        assert m == jmeta == meta
        assert (cfg_l.num_heads, cfg_l.num_kv_heads, cfg_l.intermediate_size) == (
            jcfg_l.num_heads, jcfg_l.num_kv_heads, jcfg_l.intermediate_size)
        for k, ax in AXIS.items():
            j = np.asarray(gstack[k])
            n = j.shape[ax] // NTP
            j = np.take(j, range(r * n, (r + 1) * n), axis=ax)
            got = stack[k].numpy()
            il = got.shape[2] // 2
            if k == "gu":  # JAX pads a rank's gate and up columns to its MLP tile
                ip = j.shape[2] // 2
                j = np.concatenate([j[..., :il], j[..., ip:ip + il]], axis=2)
            elif k == "gus":  # JAX's [gate rows; up rows] over the padded columns
                ng = got.shape[1]
                j = np.concatenate([j[:, :ng, :il], j[:, ng:2 * ng, :il]], axis=2)
            elif k == "d":  # ... and the down_proj word rows with zeros
                j = j[:, :got.shape[1]]
            if k in ("qkv", "o", "gu", "d"):
                np.testing.assert_array_equal(got.view(np.uint32), j, err_msg=k)
            else:  # scale rows: JAX pads a rank's rows (to 8, or repeats them to its tile)
                np.testing.assert_array_equal(got, j[:, :got.shape[1]], err_msg=k)


def _stub_block(lin_cls, spec_cls, cfg):
    """A block that holds only the linears' shapes and specs: enough for
    stack_serving_tp's checks, which decline before any tensor."""
    h, I = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    spec = spec_cls(wbit=4, w_qtype="per_group", w_groupsize=128, w_packed=True)
    lin = lambda o, i: lin_cls(spec=spec, out_features=o, in_features=i)
    blk = {"qkv_proj": lin(q + 2 * kv, h), "o_proj": lin(h, q), "gateup_proj": lin(2 * I, h),
           "down_proj": lin(h, I)}
    return blk


def test_declines_where_jax_declines(models):
    """Llama-2-7B g128 at tp = 4 (2752 MLP columns a rank, not whole groups of
    128): None in both; tp = 3 on the small model (4 heads): None in both."""
    cfg = LlamaConfig.llama2_7b()
    jcfg = JLlamaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    pm = Model(config=cfg, params={"layers": [_stub_block(QuantizedLinear, QuantSpec, cfg)]})
    jm = JModel(config=jcfg, params={"layers": [_stub_block(JQuantizedLinear, JQuantSpec,
                                                            jcfg)]})
    assert jmegadecode.stack_serving_tp(jm, 4) is None
    assert megadecode.stack_serving_tp(pm, 4, 0) is None
    jf, pf, _, _ = models["sym"]
    assert jmegadecode.stack_serving_tp(jf, 3) is None
    assert megadecode.stack_serving_tp(pf, 3, 0) is None


@pytest.mark.parametrize("mode", ["tp", "dense", "paged"])
def test_tp_steps_match_single_device(runs, mode):
    ref, res = runs
    i = {"tp": 0, "dense": 1, "paged": 2}[mode]
    r0 = ref[mode]
    for r in range(NTP):
        _close(res[r][i]["logits"], r0["logits"])
        np.testing.assert_array_equal(res[r][i]["tokens"], r0["tokens"])
        assert res[r][i]["cfg"] == (2, 1, 512)
        assert res[r][i]["launches_tp"] == 0  # the plain versions count nothing
    assert np.array_equal(res[0][i]["logits"], res[1][i]["logits"])  # one sum on every rank
    got = _heads(res, i)
    steps = res[0][i]["tokens"].shape[1]
    rows = [(b, p + s) for b, p in enumerate(r0["positions"]) for s in range(steps)]
    if mode != "paged":
        _rows(_at(got, rows), _at(r0["cache"], rows))
    else:
        _rows(_at_pages(got, r0["table"], rows), _at_pages(r0["pool"], r0["table"], rows))


def test_mode_e_refuses_chunk_and_lm_rows(models):
    """As the reference asserts tp == 1 for them; and a group must hold tp
    ranks."""
    _, pf, stack, meta = models["sym"]
    cfg = pf.config
    x, cs = torch.zeros(2, 1, cfg.hidden_size), torch.zeros(2, cfg.head_dim)
    cache = megadecode.stack_cache_batched(engine.init_cache(cfg, 1, 128, torch.int8,
                                                             device="cpu"))
    g = LocalGroup(2).rank(0)
    with pytest.raises(ValueError, match="tp = 1"):
        model_fused.model_decode_mega_batch(stack, x, cs, cs, cache, [3, 4], cfg, meta, chunk=2,
                                            tp=2, group=g)
    with pytest.raises(ValueError, match="tp = 1"):
        model_fused.model_decode_mega_batch(stack, x, cs, cs, cache, [3, 4], cfg, meta, tp=2,
                                            group=g, lm={}, lm_meta=(128, 8.0, 128, 128))
    with pytest.raises(ValueError, match="group of 4"):
        model_fused.model_decode_mega_batch(stack, x, cs, cs, cache, [3, 4], cfg, meta, tp=4,
                                            group=g)
