"""The port's tensor and data parallelism (mi_optimize_tpu_torch/parallel)
against the JAX package's (mi_optimize_tpu/parallel, GSPMD on the
conftest's virtual devices), float32, tiny models.

- The sharding rules: each rank's shard of a packed linear (words, scales,
  zeros, bias, smooth factor) equal to its piece of JAX's NamedSharding of
  the same linear under `_linear_pspecs`, column- and row-parallel,
  per-group and per-channel.
- sharded_xtx / sharded_absmax / row_parallel_matmul of 2 gloo ranks
  against JAX's on a (model 2, data 4) mesh, rtol 1e-5 / atol 1e-4 (the
  sums run in other orders; JAX's own test holds them to 1e-4 of numpy).
- shard_model's forward at TP 2 and at TP 2 x DP 2 (each data rank on its
  rows) against JAX's sharded forward in tests/test_sharding.py's
  test_tp_packed_fused_forward_matches setting, rtol 2e-4 / atol 2e-4.
- generate on a TP-sharded model, token-equal to the unsharded one: RTN int4
  packed (the JAX model converted: JAX's unsharded tokens too) and the
  port's act-order GPTQ packed model (its K-permuted row-parallel linears
  gather their input).
- shard_batcher over (data 2, model 2): every request's tokens equal to the
  unsharded batcher's, and a slot count that does not split raises.
- launch: the single-process start-up, global_mesh and per_host_batch_slice;
  and the torch dry run (parallel/dryrun.py) over 4 ranks.
The ranks run as gloo processes (tests/torch_tp_workers.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import mi_optimize_tpu as mt
from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.parallel import batch_pspec, make_mesh as jmake_mesh, shard_params
from mi_optimize_tpu.parallel.collectives import (row_parallel_matmul as jrpm,
                                                   sharded_absmax as jabsmax,
                                                   sharded_xtx as jxtx)
from mi_optimize_tpu.parallel.sharding import LINEAR_KIND as JKIND, _linear_pspecs
from mi_optimize_tpu.quant.config import QuantConfig as JQuantConfig
from mi_optimize_tpu.serving import generate as jgenerate
from mi_optimize_tpu_torch.convert import linear_from_jax
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.parallel import LINEAR_KIND, launch, sharding
from mi_optimize_tpu_torch.parallel.dryrun import dryrun_multichip
from mi_optimize_tpu_torch.quant import QuantConfig, quantize
from mi_optimize_tpu_torch.serving import generate
from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher
from tests.test_dequant_matmul import make_packed_linear
from tests.test_torch_convert import jax_tree, port_model
from tests.test_torch_model_fused import fused_pair, jax_model

FWD_TOL = 2e-4
N_NEW = 5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def runs():
    """JAX's references, and the port's ranks from one spawn at world 2 and
    one at world 4."""
    ref = {}
    # collectives (tests/test_sharding.py's inputs)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    mesh = jmake_mesh(n_model=2, n_data=4)
    ref["xtx"] = np.asarray(jxtx(jnp.asarray(x), mesh))
    ref["absmax"] = np.asarray(jabsmax(jnp.asarray(x), mesh))
    ref["rpm"] = np.asarray(jrpm(jnp.asarray(x), jnp.asarray(w), mesh))
    # the packed fused forward (test_tp_packed_fused_forward_matches)
    m = JModel.tiny_llama()
    rng = np.random.default_rng(21)
    qm = mt.quantize(m, JQuantConfig(algo="rtn", wbit="int4", w_qtype="per_group",
                                     w_groupsize=16, pack=True),
                     calib_data=[rng.integers(0, 256, (1, 32))])
    ids = rng.integers(0, 256, (4, 16))
    jmesh = jmake_mesh(n_model=2, n_data=2)
    fwd = jax.jit(lambda p, i: jllama.forward(p, qm.config, i, fused=True))
    ref["forward"] = np.asarray(fwd(shard_params(qm.params, jmesh), jax.device_put(
        jnp.asarray(ids), NamedSharding(jmesh, batch_pspec()))))
    pm = port_model(qm)
    prompt = np.random.default_rng(9).integers(0, 256, (2, 8))
    ref["rtn_tokens"] = np.asarray(jgenerate(qm, prompt, max_new_tokens=N_NEW, fused=False))
    # the port's act-order GPTQ packed model
    base = Model.tiny_llama(generator=torch.Generator().manual_seed(23), device="cpu")
    calib = [np.random.default_rng(23).integers(0, 256, (1, 32)) for _ in range(2)]
    gm = quantize(base, QuantConfig(algo="gptq", wbit="int4", w_qtype="per_group",
                                    w_groupsize=16, blocksize=16, actorder=True, pack=True),
                  calib_data=calib, device="cpu")
    assert gm.params["layers"][0]["o_proj"].perm is not None
    # the batcher: the aligned small serving model, unsharded, 4 slots
    _, _, fm, _ = fused_pair(jax_model(12))
    prompts = [np.random.default_rng(12 + i).integers(0, 128, (n,)) for i, n in
               enumerate((9, 14, 6, 11))]
    b = ContinuousBatcher(fm, n_slots=4, max_len=128, cache_dtype=torch.int8,
                          use_megakernel=True)
    toks = b.run_all(prompts, max_new_tokens=N_NEW)
    ref["batcher"] = [toks[r] for r in sorted(toks)]
    ref["rtn_port"] = generate(pm, prompt, max_new_tokens=N_NEW)
    ref["gptq_port"] = generate(gm, prompt, max_new_tokens=N_NEW)
    ref["ids"] = ids
    w2 = [("collectives", dict(x=x, w=w)), ("launch_facts", dict(n_model=2)),
          ("forward", dict(model=pm, ids=ids, n_model=2)),
          ("generate", dict(model=pm, prompt=prompt, n_new=N_NEW)),
          ("generate", dict(model=gm, prompt=prompt, n_new=N_NEW))]
    w4 = [("launch_facts", dict(n_model=2)), ("forward", dict(model=pm, ids=ids, n_model=2)),
          ("batcher", dict(model=fm, prompts=prompts, n_slots=4, n_model=2, n_new=N_NEW))]
    return ref, launch.spawn("tests.torch_tp_workers:run_cases", 2, cases=w2), \
        launch.spawn("tests.torch_tp_workers:run_cases", 4, cases=w4)


def test_linear_kinds_match_reference():
    assert {k: v for k, v in LINEAR_KIND.items() if k in JKIND} == JKIND


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("qtype,gs", [("per_group", 32), ("per_channel", -1)])
def test_shard_rules_match_reference_specs(kind, qtype, gs):
    """Rank r's shard of each field is its piece of JAX's NamedSharding of
    that field under the reference's PartitionSpec; the row-parallel bias is
    kept whole for after the sum."""
    rng = np.random.default_rng(3)
    jl, _ = make_packed_linear(rng, 64, 256, 4, qtype, gs)
    jl = jl.replace(bias=jnp.asarray(rng.normal(size=(64,)).astype(np.float32)),
                    smooth_factor=jnp.asarray(rng.uniform(0.5, 2, size=(256,)).astype(
                        np.float32)))
    specs = _linear_pspecs(kind, jl)
    mesh = jmake_mesh(n_model=2, n_data=1)
    pl = linear_from_jax(jax_tree(jl), "cpu")
    for r in range(2):
        sh = sharding.shard_linear(pl, kind, r, 2, None)
        dev = mesh.devices[0, r]
        for f in ("packed", "w_scale", "w_zero", "bias", "smooth_factor"):
            arr = jax.device_put(getattr(jl, f), NamedSharding(mesh, getattr(specs, f)))
            want = np.asarray([s.data for s in arr.addressable_shards if s.device == dev][0])
            got = getattr(sh, f)
            if f == "bias" and kind == "row":
                got = sh.tp.bias  # added once, after the sum over the ranks
            got = _np(got)
            if f == "packed":
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, want.reshape(got.shape), err_msg=f"{f} rank {r}")
        assert sh.tp.kind == kind


def test_collectives_match_reference(runs):
    ref, w2, _ = runs
    for r in range(2):
        for k in ("xtx", "absmax", "rpm"):
            np.testing.assert_allclose(w2[r][0][k], ref[k], rtol=1e-5, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_model_forward_matches_reference(runs, world):
    """TP 2 (every rank all rows) and TP 2 x DP 2 (each data rank its rows)
    against JAX's TP+DP forward."""
    ref, w2, w4 = runs
    res = {2: w2, 4: w4}[world]
    i = 2 if world == 2 else 1
    rows = set()
    for r in range(world):
        a, b = res[r][i]["rows"]
        rows |= set(range(a, b))
        np.testing.assert_allclose(res[r][i]["logits"], ref["forward"][a:b], rtol=FWD_TOL,
                                   atol=FWD_TOL)
    assert rows == set(range(len(ref["ids"])))


@pytest.mark.parametrize("which", ["rtn", "gptq"])
def test_sharded_generate_token_exact(runs, which):
    ref, w2, _ = runs
    want = ref[f"{which}_port"]
    if which == "rtn":
        np.testing.assert_array_equal(want, ref["rtn_tokens"])
    for r in range(2):
        np.testing.assert_array_equal(w2[r][3 if which == "rtn" else 4], want)


def test_shard_batcher(runs):
    """Each data rank serves its half of the requests with half the slots;
    the two model ranks of a data rank give the same tokens, all equal to
    the unsharded batcher's."""
    ref, _, w4 = runs
    for r in range(4):
        got = w4[r][2]
        assert got["slots"] == 2 and got["mega"] and got["tp"]
        assert got["tokens"] == [ref["batcher"][i] for i in got["requests"]]
    assert sorted(i for r in (0, 2) for i in w4[r][2]["requests"]) == [0, 1, 2, 3]


def test_shard_batcher_refuses_uneven_slots():
    class Mesh:  # the two things shard_batcher reads of a DeviceMesh
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(i):
            return 2

    _, _, fm, _ = fused_pair(jax_model(12))
    with pytest.raises(ValueError, match="not divisible"):
        from mi_optimize_tpu_torch.serving.batching import shard_batcher

        shard_batcher(ContinuousBatcher(fm, n_slots=3, max_len=128, cache_dtype=torch.int8), Mesh)


def test_launch(runs, monkeypatch):
    """One process without torchrun's variables: initialize_multihost returns
    False and starts nothing; per_host_batch_slice gives all rows. In the
    ranks: global_mesh's shape and each rank's rows."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    assert launch.per_host_batch_slice(16) == slice(0, 16)
    _, w2, w4 = runs
    for r in range(2):
        assert w2[r][1] == {"mesh": {"data": 1, "model": 2}, "slice": (0, 16), "multi": True}
    for r in range(4):
        d = r // 2
        assert w4[r][0] == {"mesh": {"data": 2, "model": 2}, "slice": (8 * d, 8 * d + 8),
                            "multi": True}


def test_dryrun_multichip():
    res = dryrun_multichip(4)
    assert len(res) == 4
    for r in res:
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["forward_rel"] <= 2e-4 and r["hessian_rel"] <= 1e-4
        assert r["tp_step"] == "within 2e-3"
    # the two model ranks of a data rank generate its rows alike
    assert res[1]["generate_tokens"] == res[0]["generate_tokens"]
    assert res[3]["generate_tokens"] == res[2]["generate_tokens"]
