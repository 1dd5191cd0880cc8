"""Rank functions of the port's tensor-parallel tests, run in gloo processes
by mi_optimize_tpu_torch.parallel.launch.spawn (tests/test_torch_parallel.py,
test_torch_tp_serving.py, test_torch_overlap.py). This module imports no
JAX: the tests compute the JAX references in their own process and pass the
port's inputs here, and each rank returns numpy arrays.

`run_cases(rank, world, cases)` runs [(name, kwargs), ...] in order on one
rank, so that a test module starts its processes once."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy().copy()


def collectives(rank, world, x, w):
    """sharded_xtx and sharded_absmax of this rank's rows of x, and
    row_parallel_matmul of its K slice of x and w."""
    from mi_optimize_tpu_torch.parallel import collectives as c

    g = dist.group.WORLD
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    n, k = xt.shape[0] // world, xt.shape[1] // world
    rows, ks = slice(rank * n, (rank + 1) * n), slice(rank * k, (rank + 1) * k)
    return {"xtx": _np(c.sharded_xtx(xt[rows], g)), "absmax": _np(c.sharded_absmax(xt[rows], g)),
            "rpm": _np(c.row_parallel_matmul(xt[:, ks], wt[:, ks], g))}


def launch_facts(rank, world, n_model):
    """The mesh of `launch.global_mesh`, this rank's batch slice of 16 rows
    on it, and initialize_multihost on a group already up."""
    from mi_optimize_tpu_torch.parallel import launch

    mesh = launch.global_mesh(n_model=n_model, device_type="cpu")
    s = launch.per_host_batch_slice(16, mesh)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "slice": (s.start, s.stop),
            "multi": launch.initialize_multihost()}


def forward(rank, world, model, ids, n_model, fused=True):
    """The shard_model forward of this rank's data rows."""
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.parallel import launch, make_mesh, shard_model

    mesh = make_mesh(n_model=n_model, n_data=world // n_model, device_type="cpu")
    sm = shard_model(model, mesh)
    rows = launch.per_host_batch_slice(ids.shape[0], mesh)
    with torch.no_grad():
        out = llama.forward(sm.params, sm.config, torch.from_numpy(ids[rows]), fused=fused)
    return {"rows": (rows.start, rows.stop), "logits": _np(out)}


def generate(rank, world, model, prompt, n_new, fused=True):
    """generate() on this rank's shard of `model` (TP over all ranks)."""
    from mi_optimize_tpu_torch.parallel import make_mesh, shard_model
    from mi_optimize_tpu_torch.serving import generate as pgenerate

    mesh = make_mesh(n_model=world, n_data=1, device_type="cpu")
    return pgenerate(shard_model(model, mesh), prompt, max_new_tokens=n_new, fused=fused)


def batcher(rank, world, model, prompts, n_slots, n_model, n_new, max_len=128):
    """shard_batcher over a (data, model) mesh: this rank's batcher serves
    its data coordinate's share of the prompts (round robin)."""
    from mi_optimize_tpu_torch.parallel import make_mesh
    from mi_optimize_tpu_torch.serving.batching import ContinuousBatcher, shard_batcher

    mesh = make_mesh(n_model=n_model, n_data=world // n_model, device_type="cpu")
    b = shard_batcher(ContinuousBatcher(model, n_slots=n_slots, max_len=max_len,
                                        cache_dtype=torch.int8, use_megakernel=True), mesh)
    d, nd = mesh.get_local_rank("data"), world // n_model
    mine = list(range(d, len(prompts), nd))
    toks = b.run_all([prompts[i] for i in mine], max_new_tokens=n_new)
    return {"requests": mine, "tokens": [toks[r] for r in sorted(toks)], "slots": b.n_slots,
            "mega": b._mega is not None, "tp": b._tp is not None}


def tp_step(rank, world, model, tokens, positions, cache, steps, table=None):
    """`steps` greedy steps of model_step_batch_tp (model_step_batch_paged_tp
    with a table) on this rank's stack_serving_tp shard and its kv heads of
    `cache` (the batched layout, or the page pool): the first logits, the
    tokens, this rank's cache after the steps, and the launch counters."""
    from mi_optimize_tpu_torch.ops import model_fused
    from mi_optimize_tpu_torch.parallel.sharding import cache_shard
    from mi_optimize_tpu_torch.serving import megadecode

    g = dist.group.WORLD
    st = megadecode.stack_serving_tp(model, world, rank)
    stack, meta, cfg_l = st
    c = cache_shard({f: torch.from_numpy(v.copy()) for f, v in cache.items()}, rank, world)
    cur, pos = torch.from_numpy(tokens.copy()), np.asarray(positions)
    first, toks = None, []
    before = model_fused.launches_tp
    for _ in range(steps):
        if table is None:
            logits, c = megadecode.model_step_batch_tp(model.params, stack, meta, model.config,
                                                       cur, c, pos, g)
        else:
            logits, c = megadecode.model_step_batch_paged_tp(model.params, stack, meta,
                                                             model.config, cur, c, table, pos, g)
        first = _np(logits) if first is None else first
        cur = torch.argmax(logits, -1)[:, None]
        toks.append(_np(cur[:, 0]))
        pos = pos + 1
    return {"logits": first, "tokens": np.stack(toks, 1), "meta": meta,
            "cfg": (cfg_l.num_heads, cfg_l.num_kv_heads, cfg_l.intermediate_size),
            "cache": {f: _np(v) for f, v in c.items()},
            "launches_tp": model_fused.launches_tp - before}


def overlap(rank, world, x, packed, scales, zeros, bits, groupsize, qmin, gather):
    """overlapped_row_parallel_dequant_matmul of this rank's K slice (on the
    CPU every ring step's window runs ring_chunk_ref, the plain version of
    the B11 kernel)."""
    from mi_optimize_tpu_torch.parallel.overlap import overlapped_row_parallel_dequant_matmul

    K = x.shape[1]
    k = K // world
    vpw = 32 // bits
    ng = scales.shape[0]
    gs = slice(rank * ng // world, (rank + 1) * ng // world) if ng > 1 else slice(0, 1)
    y = overlapped_row_parallel_dequant_matmul(
        torch.from_numpy(x[:, rank * k:(rank + 1) * k]),
        torch.from_numpy(packed[rank * k // vpw:(rank + 1) * k // vpw]),
        torch.from_numpy(scales[gs]), torch.from_numpy(zeros[gs]), dist.group.WORLD,
        bits=bits, groupsize=groupsize, qmin=qmin, gather=gather)
    return _np(y)


def run_cases(rank, world, cases):
    """[(name of a function above, kwargs), ...] in order on this rank."""
    torch.manual_seed(0)
    return [globals()[name](rank, world, **kw) for name, kw in cases]
