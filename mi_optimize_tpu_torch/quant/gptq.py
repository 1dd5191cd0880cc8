"""GPTQ: Hessian-aware error-feedback weight quantization.

Port of mi_optimize_tpu/quant/gptq.py, step for step, so that the same W and
H give the same integer codes:

  * H = (2/n)·ΣX^TX from calibration (the xtx reducer);
  * dead columns (diag == 0) get H_ii = 1 and a zeroed weight column;
  * act-order: columns by descending Hessian diagonal (a stable sort, so
    the dead columns' tied diagonals keep their order);
  * damped Cholesky, H += percdamp·mean(diag); the upper Cholesky factor U
    of H^-1 (H^-1 = U^T U) drives the updates. The reference computes the
    chain in float32; here the mean and the chain run in float64 and U is
    rounded to float32 once, so that the card's cuSOLVER and the CPU's
    LAPACK give the same U (in float32 they moved 2% of a 7B q_proj's
    codes);
  * blocks of `blocksize` columns; inside a block, column i is quantized
    and its error err = (w - q) / U_ii is fed back by a masked rank-1 update
    of the whole block (columns >= i), so that column i lands on w - err·d
    (in floating point not always exactly q); the error of the block goes to
    the columns after it as Err1 @ where(tail, U_rows, 0), the masked product
    of the reference, summed in float64 and rounded once (the same on any
    device);
  * per-group qparams from the block-start state of the block, in permuted
    column order, with torch-observer semantics (min/max clamped to include
    zero, affine zero clamped to the range, symmetric scale from the float
    half range and a midpoint zero).

The column loop runs as eager torch ops on the weights' device (the
reference jits it as a lax.fori_loop), TF32 off whatever the caller's
setting (`base.full_f32`). From the same W and H it gives JAX's codes on the
CPU, and the CPU's on the card; GPTQ carries a code flipped at a rounding
tie along its row, so Hessians that differ in their last bits (two devices'
calibration forwards) give other codes in some rows.

Act-order with groups: the scales live in permuted column order, so the
PERMUTED weight matrix is packed and the permutation is stored on the
QuantizedLinear; the runtime gathers x into the permuted order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.qparams import div_round, exact_div
from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, finalize_hessian, full_f32, register_algo
from .common import build_quantized_linear


def observer_qparams(w: torch.Tensor, bits: int, symmetric: bool):
    """Qparams over the last axis on the unsigned range [0, 2^b - 1], as
    torch's (PerChannel)MinMaxObserver with quant_min=0, quant_max=2^b - 1."""
    qmax = float(2 ** bits - 1)
    mn = torch.clamp(w.amin(dim=-1), max=0.0)
    mx = torch.clamp(w.amax(dim=-1), min=0.0)
    if symmetric:
        amax = torch.maximum(-mn, mx)
        scale = torch.clamp(exact_div(amax, qmax / 2.0), min=1e-9)
        zero = torch.full_like(scale, float((2 ** bits) // 2))
    else:
        scale = torch.clamp(exact_div(mx - mn, qmax), min=1e-9)
        zero = torch.clamp(-div_round(mn, scale), 0.0, qmax)
    return scale, zero


def _fake_quant_col(w, scale, zero, bits):
    """(clip(round(w / scale) + zero, 0, qmax) - zero) * scale, in one new
    tensor."""
    q = torch.div(w, scale).round_().add_(zero).clamp_(0.0, float(2 ** bits - 1))
    return q.sub_(zero).mul_(scale)


def gptq_quantize_matrix(
    W: torch.Tensor,
    H: torch.Tensor,
    *,
    bits: int,
    blocksize: int = 128,
    groupsize: int = -1,
    actorder: bool = True,
    symmetric: bool = False,
    percdamp: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Quantize W [out, in] against the Hessian H [in, in], on W's device.

    Returns (Q, scales, zeros, perm): Q the fake-quantized weights in natural
    column order, scales/zeros [out, ngroups] in act-order-permuted group order
    when actorder, perm the act-order permutation (None without it)."""
    out_f, cols = W.shape
    if groupsize > 0 and blocksize % groupsize != 0:
        raise ValueError(f"blocksize {blocksize} must be a multiple of groupsize {groupsize}")
    with full_f32():
        W = W.to(torch.float32).clone()
        H = H.to(device=W.device, dtype=torch.float32).clone()

        dead = torch.diagonal(H) == 0.0
        H.diagonal().add_(dead.to(torch.float32))
        W[:, dead] = 0.0

        if actorder:
            perm = torch.argsort(-torch.diagonal(H), stable=True)
            W = W[:, perm]
            H = H[perm][:, perm]
        else:
            perm = None

        damp = percdamp * torch.diagonal(H).double().mean().float()
        H.diagonal().add_(damp)

        # Hinv's upper Cholesky factor U (Hinv = U^T U), in float64 and then
        # rounded: the same float32 U on any device and library
        L = torch.linalg.cholesky(H.double())
        del H
        Hinv = torch.cholesky_inverse(L)
        del L
        U = torch.linalg.cholesky(Hinv, upper=True).float()
        del Hinv

        Q, scales, zeros = _gptq_core(W, U, bits=bits, blocksize=blocksize,
                                      groupsize=groupsize, symmetric=symmetric)
        if actorder:
            Q = Q[:, torch.argsort(perm)]
    return Q, scales, zeros, perm


def _gptq_core(W: torch.Tensor, U: torch.Tensor, *, bits: int, blocksize: int,
               groupsize: int, symmetric: bool):
    """The blocked column loop of the reference's `_gptq_core`; W is updated
    in place and returned as Q. A block is held transposed ([blocksize,
    out]: column i a contiguous row) and its rows, U's masked rows and the
    group qparams are views made once a block, so that a column costs its
    ten elementwise launches and little else."""
    out_f, cols = W.shape
    nblocks = cols // blocksize
    if nblocks * blocksize != cols:
        raise ValueError(f"in_features {cols} must be a multiple of blocksize {blocksize}")
    if groupsize == -1:
        g_scale, g_zero = observer_qparams(W, bits, symmetric)  # [out]
    gs_all, gz_all = [], []
    Err1t = torch.empty(blocksize, out_f, dtype=torch.float32, device=W.device)
    errs = Err1t.unbind(0)
    for i1 in range(0, cols, blocksize):
        i2 = i1 + blocksize
        W1t = W[:, i1:i2].t().contiguous()
        U1 = U[i1:i2, i1:i2]
        # row i of triu(U1) is where(col >= i, U1[i], 0): the rank-1 update's mask
        urows = torch.triu(U1).unbind(0)
        d = torch.diagonal(U1).unbind(0)
        if groupsize > 0:
            # qparams of the groups that start in this block, from its start state
            ngr = blocksize // groupsize
            gs, gz = observer_qparams(W1t.t().reshape(out_f, ngr, groupsize), bits, symmetric)
            gs_all.append(gs)
            gz_all.append(gz)
            scs, zcs, per = gs.t().contiguous().unbind(0), gz.t().contiguous().unbind(0), groupsize
        else:
            scs, zcs, per = (g_scale,), (g_zero,), blocksize
        for i, w in enumerate(W1t.unbind(0)):
            q = _fake_quant_col(w, scs[i // per], zcs[i // per], bits)
            err = torch.div(torch.sub(w, q, out=q), d[i], out=errs[i])
            W1t.sub_(urows[i][:, None] * err)  # column i lands on w - err·d
        W[:, i1:i2] = W1t.t()
        tail = U[i1:i2].double()
        tail[:, :i2] = 0.0
        W -= (Err1t.t().double() @ tail).float()  # the product rounded once, from exact sums
    if groupsize == -1:
        return W, g_scale[:, None], g_zero[:, None]
    # [out, ngroups] in block order
    return W, torch.cat(gs_all, dim=1), torch.cat(gz_all, dim=1)


@register_algo("gptq")
class GPTQAlgo(BaseAlgo):
    stats = ("xtx",)

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        cfg = self.cfg
        if not cfg.quantize_weights:
            return lin
        H = finalize_hessian(stats)
        groupsize = cfg.w_groupsize
        symmetric = cfg.w_qscheme == "symmetric"
        Q, scales, zeros, perm = gptq_quantize_matrix(
            lin.weight, H,
            bits=cfg.wbit.bits,
            blocksize=min(cfg.blocksize, lin.in_features),
            groupsize=groupsize,
            actorder=cfg.actorder,
            symmetric=symmetric,
            percdamp=cfg.percdamp,
        )
        del H
        w_qtype = "per_group" if groupsize > 0 else "per_channel"
        if groupsize > 0 and cfg.actorder and cfg.pack:
            # grouped act-order: the scales are in permuted column order, so
            # pack the PERMUTED weight and store `perm`
            out = build_quantized_linear(lin, cfg, Q[:, perm], scales, zeros, w_qtype=w_qtype,
                                         w_symmetric=symmetric)
            if out.packed is not None:
                return out.replace(perm=perm)
            return build_quantized_linear(lin, cfg, Q, scales, zeros, w_qtype=w_qtype,
                                          pack_ok=False, w_symmetric=symmetric)
        pack_ok = groupsize <= 0 or not cfg.actorder
        return build_quantized_linear(lin, cfg, Q, scales, zeros, w_qtype=w_qtype,
                                      pack_ok=pack_ok, w_symmetric=symmetric)
