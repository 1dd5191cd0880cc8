"""Stacked [L, ...] serving weights for the whole-model decode kernel.

Port of the part of mi_optimize_tpu/serving/megadecode.py that the flat
decode path needs: `_grp`, `_zconst` and `stack_serving`. The stacked layout
is the port's own: the natural words-major per-layer packed arrays [L, KW, N]
and their f32 scale tables [L, K/g, N], with no TPU tiling of the
intermediate axis. Bias tables are not stacked: the flat kernel takes
symmetric grids only and computes the bias from `meta`'s constant zeros.
The blocks then read their words and scales through views of the stack.
"""
from __future__ import annotations

import torch

from ..core.qparams import qrange
from ..models.model import Model
from ..models.quant_linear import group_size as _grp
from ..ops.block_fused import prepare_block
from ..ops.dequant_matmul import kernel_tables

_LINEARS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
# (linear, stack key of its words, stack key of its scale table)
_STACKED = (("qkv_proj", "qkv", "qs"), ("o_proj", "o", "os"), ("gateup_proj", "gu", "gus"),
            ("down_proj", "d", "ds"))


def _zconst(layers, name):
    """Constant (zero - qmin) shared by `name` across ALL layers, else None."""
    z = torch.cat([b[name].w_zero.reshape(-1).to(torch.float32) for b in layers])
    if not bool(torch.all(z == z[0])):
        return None
    lin = layers[0][name]
    return float(z[0]) - float(qrange(lin.spec.wbit, lin.spec.w_unsigned).qmin)


def stack_serving(model: Model):
    """(stack dict, meta tuple) for the whole-model kernel, or None.

    meta = (bits, g_qkv, g_o, g_gu, g_d, zc_qkv, zc_o, zc_gu, zc_d); a zc is
    None where that linear's zero is not one constant across the model.
    The model's blocks are rebound to views of the stack (same values)."""
    layers = model.params["layers"]
    if not layers or any("mega" not in b for b in layers):
        return None

    def key(b):
        return ((b["qkv_proj"].spec.wbit, b["qkv_proj"].spec.w_unsigned)
                + tuple(_grp(b[n]) for n in _LINEARS))

    k0 = key(layers[0])
    if any(key(b) != k0 for b in layers[1:]):
        return None

    def stk(fn):
        return torch.stack([fn(b) for b in layers])

    stack = {"n1": stk(lambda b: b["input_norm"].reshape(-1)),
             "n2": stk(lambda b: b["post_norm"].reshape(-1))}
    for name, wk, sk in _STACKED:
        stack[wk] = stk(lambda b: b[name].packed)
        stack[sk] = stk(lambda b: kernel_tables(b[name])[0])
    meta = (k0[0],) + k0[2:] + tuple(_zconst(layers, n) for n in _LINEARS)
    _share(model, stack)
    return stack, meta


def _share(model: Model, stack) -> None:
    """Rebind every block's packed words and scale tables to views of the
    stack, so the card keeps one copy of them, not two."""
    for l, b in enumerate(model.params["layers"]):
        for name, wk, sk in _STACKED:
            lin = b[name]
            lin.packed = stack[wk][l]
            lin.tables = (stack[sk][l], lin.tables[1])
        b["mega"] = prepare_block(b, model.config)
