"""Tensor and data parallelism of a Llama: the mesh and each rank's shard.

Port of mi_optimize_tpu/parallel/sharding.py. The reference annotates the
params with PartitionSpecs over a ("data", "model") mesh and lets GSPMD
place the collectives; here each rank holds its own shard and every
collective is explicit. The Megatron layout is the reference's:

    q/k/v/gate/up : column-parallel (the rank's out-features: its heads and
                    MLP columns; no collective)
    o/down        : row-parallel (the rank's in-features; the partial
                    products are summed over "model")
    lm_head       : column-parallel over the vocabulary, gathered
    KV cache      : the rank's kv heads; batch rows over "data"

Packed words are cut on whole 32-bit words and whole quant groups:
column cuts take the rank's columns of the words-major [K*b/32, N] words,
of the [N, K/g] scales and zeros and of the bias; row cuts take its word
rows and its groups of the scales and zeros (per-channel ones stay whole),
the bias is added once after the sum, a smooth factor is cut with K. A
row-parallel linear with an act-order permutation, or with activation
quantization, gathers its input over "model" first (the permutation and
the per-token scales read the whole row) and then takes its K slice.

A group here is what parallel.collectives takes: a torch.distributed group,
or a LocalGroup rank. `shard_model(model, mesh)` takes a DeviceMesh with a
"model" dimension (or a group for that dimension); data parallelism is the
caller's: each "data" rank feeds its own rows (`launch.per_host_batch_slice`,
`cache_shard`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..models.model import Model
from ..models.quant_linear import QuantizedLinear, group_size, local_apply
from .collectives import LocalRank, all_gather, all_reduce, rank_of, size_of

COL, ROW = "col", "row"

# tensor-parallel kind of each llama linear (the fused serving linears too)
LINEAR_KIND = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "qkv_proj": COL,
    "o_proj": ROW,
    "gate_proj": COL, "up_proj": COL, "gateup_proj": COL,
    "down_proj": ROW,
    "lm_head": COL,
}


def make_mesh(n_model: int = 1, n_data: int = 1, device_type: Optional[str] = None):
    """("data", "model") DeviceMesh of n_data x n_model ranks over the
    process group, "model" the inner (fastest) dimension; device_type None
    is the card ("cpu" for gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    need, world = n_model * n_data, dist.get_world_size()
    if world != need:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {need} ranks, the group has {world}")
    return init_device_mesh(resolve_device(device_type).type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def model_group(mesh, dim: str = "model"):
    """(group, rank in it, its size) of a DeviceMesh's dimension, a
    torch.distributed group or a LocalGroup rank."""
    if isinstance(mesh, LocalRank) or isinstance(mesh, dist.ProcessGroup):
        return mesh, rank_of(mesh), size_of(mesh)
    i = mesh.mesh_dim_names.index(dim)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(i)


@dataclasses.dataclass
class TPInfo:
    """A shard's place in the tensor-parallel layout (QuantizedLinear.tp)."""
    kind: str                   # COL or ROW
    group: Any                  # the "model" group
    gather: bool = False        # COL: all-gather the output columns (the lm_head)
    bias: Optional[torch.Tensor] = None  # ROW: the bias, added after the sum
    k0: int = 0                 # ROW: the rank's in-features [k0, k1) in the linear's
    k1: int = 0                 # own order (the act-order permuted one, if any)
    pre: Optional[QuantizedLinear] = None  # ROW, gathered input: the whole linear's
    # smoothing, activation quantization and permutation, applied before the slice


def _scales(lin):
    """(scale, zero) of a packed or fake-quant linear as [N, ngroups]."""
    ng = lin.in_features // group_size(lin)
    return tuple(None if t is None else t.reshape(-1, ng) for t in (lin.w_scale, lin.w_zero))


def _per_channel(lin) -> bool:
    return group_size(lin) == lin.in_features


def cut_cols(lin: QuantizedLinear, spans) -> QuantizedLinear:
    """The out-features in `spans` [(a, b), ...] of a linear, concatenated
    (q, k and v heads of a fused qkv_proj; gate and up columns of gateup)."""
    def cat(t, dim):
        if t is None:
            return None
        parts = [t.narrow(dim, a, b - a) for a, b in spans]
        return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim)

    scale, zero = lin.w_scale, lin.w_zero
    if scale is not None and scale.numel() > 1:  # [N, K/g]; a per-tensor scale stays
        scale, zero = (cat(t, 0) for t in _scales(lin))
    return lin.replace(
        out_features=sum(b - a for a, b in spans), weight=cat(lin.weight, 0),
        packed=cat(lin.packed, 1), w_scale=scale, w_zero=zero,
        bias=cat(lin.bias, 0), tp=None)


def cut_rows(lin: QuantizedLinear, a: int, b: int) -> QuantizedLinear:
    """The in-features [a, b) of a linear (in its own, possibly permuted,
    order): whole words of the packed words and whole groups of per-group
    scales; per-channel scales, the bias and the permutation stay as they
    are (the caller decides where they go)."""
    kw = None
    if lin.packed is not None:
        vpw = 32 // lin.spec.wbit
        if a % vpw or b % vpw:
            raise ValueError(f"in-features [{a}, {b}) do not cut on {vpw}-value words")
        kw = lin.packed[a // vpw:b // vpw].contiguous()
    scale, zero = lin.w_scale, lin.w_zero
    if scale is not None and scale.numel() > 1 and not _per_channel(lin):
        g = group_size(lin)
        if a % g or b % g:
            raise ValueError(f"in-features [{a}, {b}) do not cut on groups of {g}")
        scale, zero = (None if t is None else t[:, a // g:b // g].contiguous()
                       for t in _scales(lin))
    return lin.replace(
        in_features=b - a, packed=kw, w_scale=scale, w_zero=zero,
        weight=None if lin.weight is None else lin.weight[:, a:b].contiguous(), tp=None)


def _gathers_input(lin: QuantizedLinear) -> bool:
    """A row-parallel linear whose input must be whole before its K slice:
    an act-order permutation or activation quantization reads the row."""
    return lin.perm is not None or lin.spec.abit is not None


def shard_linear(lin: QuantizedLinear, kind: str, rank: int, size: int, group,
                 spans=None, gather: bool = False) -> QuantizedLinear:
    """Rank `rank`'s shard of a linear. COL: the out-feature `spans`
    (default: the rank's equal share); ROW: its equal share of the
    in-features."""
    if kind == COL:
        if spans is None:
            n = lin.out_features // size
            spans = [(rank * n, (rank + 1) * n)]
        out = cut_cols(lin, spans)
        out.tp = TPInfo(COL, group, gather=gather)
        return out
    k = lin.in_features // size
    a, b = rank * k, (rank + 1) * k
    out = cut_rows(lin, a, b)
    info = TPInfo(ROW, group, bias=lin.bias, k0=a, k1=b)
    if _gathers_input(lin):
        info.pre = QuantizedLinear(spec=lin.spec, out_features=lin.out_features,
                                   in_features=lin.in_features,
                                   smooth_factor=lin.smooth_factor, a_scale=lin.a_scale,
                                   a_zero=lin.a_zero, perm=lin.perm)
        out = out.replace(spec=dataclasses.replace(lin.spec, abit=None), smooth_factor=None,
                          a_scale=None, a_zero=None, perm=None, tp=None)
    elif lin.smooth_factor is not None:
        out = out.replace(smooth_factor=lin.smooth_factor[a:b].contiguous(), tp=None)
    out.bias = None
    out.tp = info
    return out


def _ring_ok(lin, size) -> bool:
    from .overlap import ring_ok

    s = lin.spec
    return (size > 1 and lin.packed is not None and s.wbit in (2, 4, 8) and s.abit is None
            and s.fp8_format is None
            and ring_ok(lin.out_features, lin.in_features * size, size, s.wbit,
                        -1 if _per_channel(lin) else group_size(lin)))


def tp_apply(q: QuantizedLinear, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """A shard's forward with its collectives (`quant_linear_apply` of a
    linear with `tp`). COL: the local columns, all-gathered for the
    lm_head. ROW: the partial product over the rank's K slice summed over
    the group, then the bias; packed int2/4/8 words take the overlapped ring
    (parallel.overlap, the B11 kernel) where the shapes ring-shard, else the
    local product (ops.dequant_matmul) and an all-reduce."""
    info = q.tp
    if info.kind == COL:
        y = local_apply(q, x, fused)
        if info.gather:
            y = torch.cat(all_gather(y.contiguous(), info.group), dim=-1)
        return y
    in_dtype = x.dtype
    if info.pre is not None:
        from ..models.quant_linear import _quant_activations

        pre = info.pre
        x = torch.cat(all_gather(x.contiguous(), info.group), dim=-1)
        if pre.smooth_factor is not None:
            x = x / pre.smooth_factor.to(x.dtype)
        x = _quant_activations(pre, x)
        if pre.perm is not None:
            x = torch.index_select(x, -1, pre.perm.to(torch.long))
        x = x[..., info.k0:info.k1]
    if fused and info.pre is None and _ring_ok(q, size_of(info.group)):
        from ..ops.dequant_matmul import zero_tables
        from .overlap import ring_matmul

        if q.smooth_factor is not None:
            x = x / q.smooth_factor.to(x.dtype)
        lead = x.shape[:-1]
        st, zt = zero_tables(q)
        y = ring_matmul(x.reshape(-1, q.in_features), q.packed, st, zt, info.group,
                        bits=q.spec.wbit, group=group_size(q))
        y = y.reshape(*lead, q.out_features)
    else:
        y = all_reduce(local_apply(q, x, fused), info.group)
    if info.bias is not None:
        y = y + info.bias
    return y.to(in_dtype)


def _block_spans(name, cfg, rank, size):
    """The out-feature spans of a column-parallel block linear."""
    D = cfg.head_dim
    qdim, kvdim, inter = cfg.num_heads * D, cfg.num_kv_heads * D, cfg.intermediate_size
    ql, kl, il = qdim // size, kvdim // size, inter // size
    q = (rank * ql, (rank + 1) * ql)
    kv = (rank * kl, (rank + 1) * kl)
    mlp = (rank * il, (rank + 1) * il)
    return {"q_proj": [q], "k_proj": [kv], "v_proj": [kv], "gate_proj": [mlp],
            "up_proj": [mlp],
            "qkv_proj": [q, (qdim + kv[0], qdim + kv[1]), (qdim + kvdim + kv[0],
                                                           qdim + kvdim + kv[1])],
            "gateup_proj": [mlp, (inter + mlp[0], inter + mlp[1])]}[name]


def rank_config(cfg, size: int):
    """A rank's config: its share of the q and kv heads and of the MLP
    columns; the residual width, head size and depth are the model's."""
    if cfg.num_heads % size or cfg.num_kv_heads % size or cfg.intermediate_size % size:
        raise ValueError(f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads and "
                         f"{cfg.intermediate_size} MLP columns do not split over {size} ranks")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // size,
                               num_kv_heads=cfg.num_kv_heads // size,
                               intermediate_size=cfg.intermediate_size // size)


def shard_block(blk, cfg, rank: int, size: int, group=None):
    """Rank `rank`'s shard of a decoder block (unfused q/k/v and gate/up, or
    the serving model's fused qkv_proj and gateup_proj): norms as they are,
    every linear cut by its kind, and the shard's own kernel tables where
    the block had them."""
    from ..ops.block_fused import prepare_block

    out = {}
    for name, v in blk.items():
        if name == "mega":
            continue
        if isinstance(v, QuantizedLinear):
            kind = LINEAR_KIND[name]
            out[name] = shard_linear(v, kind, rank, size, group,
                                     spans=_block_spans(name, cfg, rank, size)
                                     if kind == COL else None)
        else:
            out[name] = v
    if "mega" in blk:
        out["mega"] = prepare_block(out, cfg)
    return out


def shard_params(params, cfg, group, rank: int, size: int):
    """Rank `rank`'s shard of a llama params tree: the blocks by
    `shard_block`, the lm_head over its vocabulary (gathered) where the
    vocabulary splits, else whole; the embedding and final norm whole."""
    out = dict(params)
    out["layers"] = [shard_block(b, cfg, rank, size, group) for b in params["layers"]]
    lm = params.get("lm_head")
    if isinstance(lm, QuantizedLinear) and lm.out_features % size == 0:
        out["lm_head"] = shard_linear(lm, COL, rank, size, group, gather=True)
    return out


def shard_model(model: Model, mesh, dim: str = "model") -> Model:
    """This rank's Model under the TP rules over `mesh`'s "model" dimension
    (a DeviceMesh, a torch.distributed group, or a LocalGroup rank): its
    params shard and its config (`rank_config`). The serving entry points
    (prefill, generate, the batchers) work on it unchanged; the batched
    whole-model step takes its tensor-parallel mode (e); the tp = 1
    whole-model kernels refuse it (megadecode.refuse_shard)."""
    group, rank, size = model_group(mesh, dim)
    cfg = rank_config(model.config, size)
    return Model(config=cfg, params=shard_params(model.params, model.config, group, rank, size),
                 family=model.family)


def tp_group(model):
    """The "model" group of a sharded Model (or of its params tree), or None."""
    params = model.params if isinstance(model, Model) else model
    for blk in params.get("layers", [])[:1]:  # shard_params cuts every block alike
        for v in blk.values():
            if isinstance(v, QuantizedLinear) and v.tp is not None:
                return v.tp.group
    return None


def cache_shard(cache, rank: int, size: int, axis: int = 2):
    """A rank's kv heads of a per-layer cache list or a stacked cache dict
    (`axis`: the kv-head axis, 2 in engine.init_cache's [B, T, Hkv, D] and
    in the batched kernel's [L, B, Hkv, T, D])."""
    def cut(t):
        n = t.shape[axis] // size
        return t.narrow(axis, rank * n, n).contiguous()

    if isinstance(cache, dict):
        return {f: cut(v) for f, v in cache.items()}
    return [{f: cut(v) for f, v in c.items()} if isinstance(c, dict) else tuple(map(cut, c))
            for c in cache]
