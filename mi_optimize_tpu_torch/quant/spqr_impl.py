"""SpQR: a GPTQ-style column loop with fp outliers and double-quantized qparams.

Port of mi_optimize_tpu/quant/spqr_impl.py, step for step:

  * identity permutation, blocks of `blocksize` columns, per-row asymmetric
    qparams of each group of `groupsize` columns taken at the group's first
    column (SpQR's find_params: a degenerate row maps to [-1, 1], the zero
    is the fractional -min / scale; quant = clamp(round(x / scale + zero),
    0, maxq));
  * outlier threshold = rel_threshold · mean(var(W, 0) / diag(U)^2), the
    variance unbiased (ddof = 1, as torch's .var());
  * at each group's start: the leave-one-out error reduction of every
    weight flags the likely outliers, and the group's qparams are refit on
    the weights with those replaced by their row's mean;
  * double quantization: the group's scales and zeros are themselves
    quantized at qq_bits in groups of qq_groupsize along the out axis;
  * each column is quantized with the double-quantized qparams; weights whose
    scaled error exceeds the threshold stay fp (outliers); the error is fed
    back within the block (a rank-1 update of the block's later columns) and
    to the later blocks (Err @ U[block rows, later columns]);
  * average-bits accounting.

As in the port's GPTQ (gptq.py), the damping mean and the Cholesky chain
H -> L -> H^-1 -> U run in float64 with U rounded to float32 once, and the
tail product Err @ U sums in float64 and rounds once: the same U and the
same feedback on any device and library (the reference computes them in
float32). The column loop runs as eager torch ops on the weights' device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.qparams import exact_div
from ..models.quant_linear import QuantizedLinear
from .base import finalize_hessian
from .common import make_weight_spec
from .config import QuantConfig

_EPS = 1e-9


def _find_params_rows(x2d, bits, sym):
    """SpQR find_params over each row: (scale, zero) [rows]."""
    maxq = float(2 ** bits - 1)
    mn = x2d.amin(dim=1)
    mx = x2d.amax(dim=1)
    if sym:
        mx = torch.maximum(mn.abs(), mx)
        mn = torch.where(mn < 0, -mx, mn)
    deg = mn == mx
    mn = torch.where(deg, torch.full_like(mn, -1.0), mn)
    mx = torch.where(deg, torch.full_like(mx, 1.0), mx)
    scale = exact_div(mx - mn, maxq)
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = -(mn / scale)
    return scale, zero


def _quant(x, scale, zero, bits):
    maxq = float(2 ** bits - 1)
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=_EPS) + zero), 0.0, maxq)
    return scale * (q - zero)


def _double_quant(v, qq_bits, qq_groupsize):
    """Quantize a [out] qparam vector in groups of qq_groupsize along out."""
    g = v.reshape(-1, qq_groupsize)
    s, z = _find_params_rows(g, qq_bits, sym=False)
    return _quant(g, s[:, None], z[:, None], qq_bits).reshape(v.shape)


def _loo_index(g):
    """[g, g-1]: row i lists the group's columns other than i."""
    return torch.from_numpy(np.arange(g)[1:][None, :] - (
        np.arange(g)[:, None] >= np.arange(g)[1:][None, :]).astype(np.int64))


def _loo_error_reduction(group_w, d_group, bits, sym, loo_idx):
    """The error reduction [out, g] of leaving each weight out of its group."""
    loo = group_w[:, loo_idx]  # [out, g, g-1]
    out_f, g, _ = loo.shape
    flat = loo.reshape(out_f * g, g - 1)
    s, z = _find_params_rows(flat, bits, sym)
    rec = _quant(flat, s[:, None], z[:, None], bits).reshape(out_f, g, g - 1)
    d_loo = d_group[loo_idx]  # [g, g-1]
    loo_err = (((rec - loo) / d_loo[None]) ** 2).sum(-1)  # [out, g]
    s0, z0 = _find_params_rows(group_w, bits, sym)
    base = _quant(group_w, s0[:, None], z0[:, None], bits)
    base_err = (((base - group_w) / d_group[None]) ** 2).sum(1, keepdim=True)
    return base_err - loo_err


def _group_qparams(gw, dg, thr, bits, sym, qq_bits, qq_groupsize, loo_idx):
    """(double-quantized scale, zero, raw scale, zero) [out] of a group,
    refit on its weights with the likely outliers set to their row's mean."""
    red = _loo_error_reduction(gw, dg, bits, sym, loo_idx)
    likely = (red > thr).to(torch.float32)
    keep = 1.0 - likely
    mean_keep = (gw * keep).sum(1, keepdim=True) / torch.clamp(keep.sum(1, keepdim=True), min=1.0)
    s, z = _find_params_rows(gw * keep + mean_keep * likely, bits, sym)
    return _double_quant(s, qq_bits, qq_groupsize), _double_quant(z, qq_bits, qq_groupsize), s, z


def spqr_quantize_matrix(
    W: torch.Tensor,
    H: torch.Tensor,
    *,
    bits: int,
    blocksize: int = 128,
    groupsize: int = 16,
    qq_bits: int = 3,
    qq_groupsize: int = 16,
    sym: bool = False,
    percdamp: float = 0.01,
    rel_threshold: float = 0.2,
):
    """Quantize W [out, in] against H [in, in] on W's device. Returns (Q, the
    fake-quantized weights with the fp outliers in place; scales and zeros
    [out, ngroups], before double quantization; the outlier count, a 0-dim
    float32)."""
    out_f, cols = W.shape
    if cols % blocksize or blocksize % groupsize:
        raise ValueError(f"in_features {cols}, blocksize {blocksize} and groupsize {groupsize} "
                         "must divide one another")
    W = W.to(torch.float32).clone()
    H = H.to(device=W.device, dtype=torch.float32).clone()
    dead = torch.diagonal(H) == 0.0
    H.diagonal().add_(percdamp * torch.diagonal(H).abs().double().mean().float())
    H.diagonal()[dead] = 1.0
    W[:, dead] = 0.0
    # U, the upper Cholesky factor of H^-1 (H^-1 = U^T U), in float64 and rounded once
    L = torch.linalg.cholesky(H.double())
    del H
    U = torch.linalg.cholesky(torch.cholesky_inverse(L), upper=True).float()
    del L
    d = torch.diagonal(U)
    # torch's .var() is unbiased (ddof = 1), as in the reference
    thr = rel_threshold * torch.mean(torch.var(W, dim=0) / torch.clamp(d, min=_EPS) ** 2)
    loo_idx = _loo_index(groupsize).to(W.device)
    scales = torch.zeros(out_f, cols // groupsize, dtype=torch.float32, device=W.device)
    zeros = torch.zeros_like(scales)
    n_out = torch.zeros((), dtype=torch.float32, device=W.device)
    Err = torch.empty(out_f, blocksize, dtype=torch.float32, device=W.device)
    for i1 in range(0, cols, blocksize):
        i2 = i1 + blocksize
        for col in range(i1, i2):
            if col % groupsize == 0:
                gi = col // groupsize
                qs, qz, scales[:, gi], zeros[:, gi] = _group_qparams(
                    W[:, col:col + groupsize], d[col:col + groupsize], thr, bits, sym,
                    qq_bits, qq_groupsize, loo_idx)
            w_col = W[:, col]
            d_i = d[col]
            err = (w_col - _quant(w_col, qs, qz, bits)) / d_i
            is_out = (err ** 2 > thr).to(torch.float32)
            wq = _quant(w_col * (1.0 - is_out), qs, qz, bits) * (1.0 - is_out) \
                + w_col * is_out
            err = (w_col - wq) / d_i
            n_out += is_out.sum()
            # feedback within the block: columns col .. i2 (col itself lands on w - err·d)
            W[:, col:i2] -= err[:, None] * U[col, col:i2][None, :]
            Err[:, col - i1] = err
        if i2 < cols:
            W[:, i2:] -= (Err.double() @ U[i1:i2, i2:].double()).float()
    return W, scales, zeros, n_out


def average_bits(cfg: QuantConfig, n_outliers: float, numel: int) -> float:
    """The reference's average bits a weight (round_zero=False)."""
    w = cfg.wbit.bits
    g = cfg.w_groupsize if cfg.w_groupsize > 0 else 16
    avg = w + (cfg.qq_scale_bits + cfg.qq_zero_bits) / g + 2 * (16 + 16) / (g * cfg.qq_groupsize)
    share = n_outliers / max(numel, 1)
    return round(avg + 32 * share, 2)


def spqr_quantize_linear(cfg: QuantConfig, lin: QuantizedLinear, stats) -> QuantizedLinear:
    """SpQR of one linear. The outliers stay fp, so the linear keeps its
    fake-quantized weights (unpacked)."""
    if not cfg.quantize_weights:
        return lin
    groupsize = cfg.w_groupsize if cfg.w_groupsize > 0 else 16
    Q, scales, zeros, _ = spqr_quantize_matrix(
        lin.weight, finalize_hessian(stats), bits=cfg.wbit.bits,
        blocksize=min(cfg.blocksize, lin.in_features), groupsize=groupsize,
        qq_bits=cfg.qq_scale_bits, qq_groupsize=cfg.qq_groupsize, sym=False,
        percdamp=cfg.percdamp, rel_threshold=cfg.outlier_relative_threshold)
    spec = dataclasses.replace(make_weight_spec(cfg, packed=False), w_qtype="per_group",
                               w_groupsize=groupsize, w_symmetric=False)
    return lin.replace(spec=spec, weight=Q.to(lin.weight.dtype), w_scale=scales, w_zero=zeros)
