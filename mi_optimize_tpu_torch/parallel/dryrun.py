"""The multi-rank dry run: the torch twin of __graft_entry__.dryrun_multichip.

    python -m mi_optimize_tpu_torch.parallel.dryrun [n_ranks] [backend]

builds an n-rank ("data", "model") mesh (model 2 where n is even) in local
processes (`launch.spawn`) and runs, on tiny shapes in float32, each rank
against the same work unsharded in its own process:
  * the TP+DP quantized forward and its loss (int4 g64 RTN, packed), each
    data rank on its rows;
  * the data-sharded Hessian accumulation (`sharded_xtx` over "data");
  * `generate` on a TP-sharded act-order GPTQ packed model, token-exact;
  * the batched step's tensor-parallel mode (`model_step_batch_tp`) against
    the single-rank `model_step_batch`, logits within 2e-3.
Imports no JAX. Returns each rank's summary; raises if a check fails.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

FWD_TOL = 2e-4   # the sharded forward sums in other orders (the reference's test's tolerance)
STEP_TOL = 2e-3  # the TP batched step against the single-rank one (the reference's)


def _quantized_tiny(hidden=256, layers=2, heads=4, kv_heads=2, inter=512, vocab=512):
    from ..models.llama import LlamaConfig, init_params
    from ..models.model import Model
    from ..quant import QuantConfig, quantize

    cfg = LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
                      num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
                      head_dim=hidden // heads, max_seq_len=256)
    model = Model(config=cfg, params=init_params(cfg, torch.Generator().manual_seed(0),
                                                 device="cpu"))
    qcfg = QuantConfig(algo="rtn", wbit="int4", w_qtype="per_group", w_groupsize=64, pack=True)
    return quantize(model, qcfg, calib_data=[], device="cpu")


def dryrun_rank(rank: int, world: int):
    """One rank of the dry run (run by `launch.spawn`)."""
    from ..models import llama
    from ..models.llama import LlamaConfig, init_params
    from ..models.model import Model
    from ..quant import QuantConfig, quantize
    from ..serving import fuse_for_serving, generate
    from ..serving.engine import init_cache
    from ..serving.megadecode import (model_step_batch, model_step_batch_tp,
                                      stack_cache_batched, stack_serving, stack_serving_tp)
    from .collectives import sharded_xtx
    from .launch import per_host_batch_slice
    from .sharding import cache_shard, make_mesh, model_group, shard_model

    n_model = 2 if world % 2 == 0 else 1
    n_data = world // n_model
    mesh = make_mesh(n_model=n_model, n_data=n_data, device_type="cpu")
    data_group = model_group(mesh, "data")[0]
    out = {"mesh": {"data": n_data, "model": n_model}}

    # TP+DP quantized forward + loss, and the data-sharded Hessian
    model = _quantized_tiny()
    sm = shard_model(model, mesh)
    batch = max(n_data, 2)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (batch, 32)))
    rows = per_host_batch_slice(batch, mesh)
    with torch.no_grad():
        ref = llama.forward(model.params, model.config, ids)
        got = llama.forward(sm.params, sm.config, ids[rows])
    err = float((got - ref[rows]).abs().max()) / float(ref[rows].abs().max())
    loss, _ = llama.causal_lm_loss(got, ids[rows])
    h = model.config.hidden_size
    H = sharded_xtx(got[..., :h].reshape(-1, h), data_group)
    xr = ref[..., :h].reshape(-1, h)
    herr = float((H - xr.t() @ xr).abs().max()) / float((xr.t() @ xr).abs().max())
    if not (err <= FWD_TOL and herr <= 1e-4 and bool(torch.isfinite(loss))):
        raise AssertionError(f"sharded forward {err:.2e} / Hessian {herr:.2e} off")
    out.update(forward_rel=err, loss=float(loss), hessian_rel=herr)

    # the packed serving path: generate on a TP-sharded act-order GPTQ model
    base = Model(config=model.config,
                 params=init_params(model.config, torch.Generator().manual_seed(2), device="cpu"))
    gcfg = QuantConfig(algo="gptq", wbit="int4", w_qtype="per_group", w_groupsize=64,
                       blocksize=64, actorder=True, pack=True)
    qgm = quantize(base, gcfg, calib_data=[np.random.default_rng(3).integers(0, 512, (1, 32))],
                   device="cpu")
    prompt = np.random.default_rng(4).integers(0, 512, (batch, 8))[rows]
    want = generate(qgm, prompt, max_new_tokens=4)
    got_t = generate(shard_model(qgm, mesh), prompt, max_new_tokens=4)
    if not np.array_equal(want, got_t):
        raise AssertionError("sharded packed generate diverged from the unsharded one")
    out["generate_tokens"] = got_t.tolist()

    # the batched kernel's tensor-parallel mode against the single-rank step
    out["tp_step"] = "skipped"
    if n_model > 1:
        cfg_m = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                            max_seq_len=256)
        base_m = Model(config=cfg_m, params=init_params(cfg_m, torch.Generator().manual_seed(5),
                                                        device="cpu"))
        qmk = fuse_for_serving(quantize(base_m, QuantConfig(
            algo="rtn", wbit="int4", w_qtype="per_group", w_groupsize=128, pack=True),
            calib_data=[], device="cpu"))
        _, mrank, _ = model_group(mesh, "model")
        st1, sttp = stack_serving(qmk), stack_serving_tp(qmk, n_model, mrank)
        if st1 is None or sttp is None:
            raise AssertionError("the step's model should shard")
        cache = stack_cache_batched(init_cache(cfg_m, 2, 128, torch.int8, device="cpu"))
        toks = torch.as_tensor(np.random.default_rng(6).integers(0, 512, (2, 1)))
        pos = np.asarray([3, 9])
        ref_l, _ = model_step_batch(qmk.params, *st1, cfg_m, toks,
                                    {f: v.clone() for f, v in cache.items()}, pos)
        tp_l, _ = model_step_batch_tp(qmk.params, sttp[0], sttp[1], cfg_m, toks,
                                      cache_shard(cache, mrank, n_model), pos,
                                      model_group(mesh)[0])
        e = float((tp_l - ref_l).abs().max())
        if not torch.allclose(tp_l, ref_l, rtol=STEP_TOL, atol=STEP_TOL):
            raise AssertionError(f"the TP batched step diverged from the single-rank one ({e})")
        out.update(tp_step="within 2e-3", tp_step_max_abs=e)
    return out


def dryrun_multichip(n_devices: int, backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run the dry run over `n_devices` local ranks; returns their
    summaries (rank order) and prints rank 0's."""
    from .launch import spawn

    res = spawn("mi_optimize_tpu_torch.parallel.dryrun:dryrun_rank", n_devices,
                backend=backend, timeout=timeout)
    r = res[0]
    print(f"dryrun_multichip ok: mesh={r['mesh']} loss={r['loss']:.4f} "
          f"packed-gptq generate TP-exact, TP-batched-step={r['tp_step']}")
    return res


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "gloo")
