"""Serving-time fusion of the QKV and gate/up projections.

Port of mi_optimize_tpu/serving/optimize.py. Linears that share an input and
a compute path concatenate along N (words-major packed [K*b/32, N] and
logical scales [N, ngroups] both concatenate there), which gives one launch
and a wider N per fused matmul. A block that also meets the decode kernel's
contract gets `blk["mega"]`, the kernel-layout scale and bias tables of
ops/block_fused.prepare_block.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from ..models.model import Model
from ..models.quant_linear import QuantizedLinear

log = logging.getLogger(__name__)


def _can_fuse(lins) -> bool:
    if len({l.spec for l in lins}) != 1:
        return False
    if len({l.in_features for l in lins}) != 1:
        return False
    smooths = [l.smooth_factor for l in lins]
    if any(s is not None for s in smooths):
        if any(s is None for s in smooths):
            return False
        if not all(torch.allclose(smooths[0].float(), s.float()) for s in smooths[1:]):
            return False
    if any(l.a_scale is not None for l in lins):
        return False  # static act qparams are per-projection
    if any(l.perm is not None for l in lins):
        return False  # act-order permutations are per-projection
    if len({l.bias is not None for l in lins}) != 1:
        return False
    return True


def _fuse(lins) -> Optional[QuantizedLinear]:
    if not _can_fuse(lins):
        return None
    l0 = lins[0]

    def cat(field, dim):
        vals = [getattr(l, field) for l in lins]
        if vals[0] is None:
            return None
        return torch.cat(vals, dim=dim)

    return QuantizedLinear(
        spec=l0.spec,
        out_features=sum(l.out_features for l in lins),
        in_features=l0.in_features,
        weight=cat("weight", 0),
        packed=cat("packed", 1),     # words-major: N is dim 1
        w_scale=cat("w_scale", 0),
        w_zero=cat("w_zero", 0),
        bias=cat("bias", 0),
        smooth_factor=l0.smooth_factor,
    )


def _make_tables(lin) -> None:
    from ..ops.dequant_matmul import kernel_tables

    if isinstance(lin, QuantizedLinear) and lin.packed is not None:
        kernel_tables(lin)


def fuse_for_serving(model: Model) -> Model:
    """A model whose blocks hold fused qkv_proj / gateup_proj linears, plus
    `blk["mega"]` where the one-launch decode kernel applies. Every packed
    linear, the lm_head included, gets its kernel tables here, once."""
    from ..ops.block_fused import block_mega_supported, prepare_block

    new_layers = []
    n_fused = n_mega = 0
    _make_tables(model.params.get("lm_head"))
    for blk in model.params["layers"]:
        nb = dict(blk)
        qkv = _fuse([blk["q_proj"], blk["k_proj"], blk["v_proj"]])
        if qkv is not None:
            nb["qkv_proj"] = qkv
            del nb["q_proj"], nb["k_proj"], nb["v_proj"]
            n_fused += 1
        gu = _fuse([blk["gate_proj"], blk["up_proj"]])
        if gu is not None:
            nb["gateup_proj"] = gu
            del nb["gate_proj"], nb["up_proj"]
        for lin in nb.values():
            _make_tables(lin)
        if block_mega_supported(nb, model.config):
            nb["mega"] = prepare_block(nb, model.config)
            n_mega += 1
        new_layers.append(nb)
    log.info("fused qkv in %d/%d blocks; decode kernel in %d", n_fused, len(new_layers),
             n_mega)
    params = dict(model.params)
    params["layers"] = new_layers
    return Model(config=model.config, params=params, family=model.family)
