"""AWQ: smoothing-ratio grid search plus per-group clip search.

Port of mi_optimize_tpu/quant/awq_impl.py, step for step:

  w_max  = per-in-feature mean of |W| normalized by each group's absmax;
  x_max  = per-in-feature mean |x| over the calibration tokens (the
           absmean reducer);
  grid   r = 0, 1/20, ..., 19/20 (the powers correctly rounded, the mean
           of w_max summed in float64: the same candidates on any device):
           s_r = clamp(x_max^r / w_max^(1-r), 1e-4); s_r /= sqrt(max·min);
           loss_r = MSE(x W^T, x (dq(W·s_r)/s_r)^T) over the sampled inputs
           (at most MAX_INPUT_SAMPLE_TOKENS);
  clip   per-[oc, group] shrink grid absmax·(1 - i/20), i < 20·max_shrink,
           scored on the first sampled token of x / s;
  final  asymmetric per-group fake-quant of the smoothed, clipped weight;
         the runtime divides x by s.

Each search keeps the earliest candidate within 1e-5 (relative) of the
minimum (`_first_within_eps`): neighbours on the grid often quantize alike,
so their losses differ only by the sum order, and the earliest of them is
the reference's choice on any device. The candidates run one after another
(the reference's lax.map), in float32 with TF32 off (`base.full_f32`).
"""
from __future__ import annotations

import torch

from ..core.qparams import div_round, exact_div
from ..models.quant_linear import QuantizedLinear
from .base import full_f32
from .common import build_quantized_linear
from .config import QuantConfig


def pseudo_quantize(w, n_bit, zero_point, groupsize, return_qparams=False):
    """Fake-quantize w [..., ci] in groups along its last dim: dq, and with
    return_qparams the scales and zeros [rows, ngroups]."""
    org_shape = w.shape
    g = groupsize if groupsize > 0 else org_shape[-1]
    w2 = w.reshape(-1, g)
    if zero_point:
        mx = w2.amax(dim=1, keepdim=True)
        mn = w2.amin(dim=1, keepdim=True)
        max_int = 2 ** n_bit - 1
        scales = exact_div(torch.clamp(mx - mn, min=1e-5), float(max_int))
        zeros = torch.clamp(-div_round(mn, scales), 0, max_int)
        q = torch.clamp(div_round(w2, scales) + zeros, 0, max_int)
        dq = (q - zeros) * scales
    else:
        amax = torch.clamp(w2.abs().amax(dim=1, keepdim=True), min=1e-5)
        max_int = 2 ** (n_bit - 1) - 1
        scales = exact_div(amax, float(max_int))
        zeros = torch.zeros_like(scales)
        q = torch.clamp(div_round(w2, scales), -(2 ** (n_bit - 1)), max_int)
        dq = q * scales
    dq = dq.reshape(org_shape)
    if return_qparams:
        ng = org_shape[-1] // g
        return dq, scales.reshape(-1, ng), zeros.reshape(-1, ng)
    return dq


def weight_scale(w, groupsize):
    """Per-in-feature mean of group-normalized |W|."""
    org = w.shape
    g = groupsize if groupsize > 0 else org[-1]
    wg = w.abs().reshape(-1, g)
    s = (wg / torch.clamp(wg.amax(dim=1, keepdim=True), min=1e-12)).reshape(org)
    return s.double().mean(dim=0).float()  # summed in float64, rounded once


def _pow(x: torch.Tensor, e) -> torch.Tensor:
    """x ** e in float32, computed in float64 and rounded once: the correctly
    rounded power on any device (the reference's CPU pow gives it but for a
    last bit at times; CUDA's float32 pow does not)."""
    e = e.double() if isinstance(e, torch.Tensor) else e
    return (x.double() ** e).float()


def _first_within_eps(errs, dim=0, rel=1e-5):
    """Index of the EARLIEST candidate within `rel` of the minimum along dim."""
    m = errs.amin(dim=dim, keepdim=True)
    good = errs <= m * (1.0 + rel) + 1e-12
    return torch.argmax(good.to(torch.uint8), dim=dim)


def _steps(n, n_grid, device):
    """i / n_grid for i < n, correctly rounded float32."""
    return exact_div(torch.arange(n, dtype=torch.float32, device=device), float(n_grid))


def scale_losses(w, x, x_mean_abs, *, n_bit, groupsize, zero_point, n_grid=20):
    """(losses [n_grid], scales [n_grid, ci]) of the ratio grid."""
    with full_f32():
        w_max = torch.clamp(weight_scale(w, groupsize), min=1e-12)
        org_out = x @ w.t()
        losses, scales = [], []
        for r in _steps(n_grid, n_grid, w.device).unbind(0):
            s = torch.clamp(_pow(x_mean_abs, r) / _pow(w_max, 1.0 - r), min=1e-4)
            s = s / torch.sqrt(s.amax() * s.amin())
            wq = pseudo_quantize(w * s[None, :], n_bit, zero_point, groupsize) / s[None, :]
            losses.append(torch.mean((org_out - x @ wq.t()) ** 2))
            scales.append(s)
        return torch.stack(losses), torch.stack(scales)


def auto_scale_search(w, x, x_mean_abs, *, n_bit, groupsize, zero_point, n_grid=20):
    """The MSE-minimizing smooth scales over the ratio grid."""
    losses, scales = scale_losses(w, x, x_mean_abs, n_bit=n_bit, groupsize=groupsize,
                                  zero_point=zero_point, n_grid=n_grid)
    return scales[_first_within_eps(losses)]


def clip_errors(w, x_sample, *, n_bit, groupsize, zero_point, n_grid=20, max_shrink=0.5):
    """(errors [S, oc, ng], clip maxima [S, oc, ng]) of the shrink grid."""
    oc, ci = w.shape
    g = groupsize if groupsize > 0 else ci
    ng = ci // g
    wg = w.reshape(oc, 1, ng, g)
    xg = x_sample.reshape(1, -1, ng, g)
    org_max = wg.abs().amax(dim=-1, keepdim=True)  # [oc, 1, ng, 1]
    org_out = (xg.double() * wg).sum(dim=-1)  # [oc, ntok, ng], float64 sums
    errs, mvs = [], []
    for shrink in _steps(int(max_shrink * n_grid), n_grid, w.device).unbind(0):
        mv = org_max * (1.0 - shrink)
        cur = torch.clamp(wg, -mv, mv)
        qw = pseudo_quantize(cur, n_bit, zero_point, groupsize)
        errs.append((((xg.double() * qw).sum(dim=-1) - org_out).abs()).mean(dim=1))
        mvs.append(mv[:, 0, :, 0])
    return torch.stack(errs), torch.stack(mvs)


def auto_clip_search(w, x_sample, *, n_bit, groupsize, zero_point, n_grid=20, max_shrink=0.5):
    """The best clipping absmax of each [oc, group]."""
    errs, mvs = clip_errors(w, x_sample, n_bit=n_bit, groupsize=groupsize,
                            zero_point=zero_point, n_grid=n_grid, max_shrink=max_shrink)
    best = _first_within_eps(errs)  # [oc, ng]
    return torch.gather(mvs, 0, best[None])[0]


def awq_smooth_clip(cfg: QuantConfig, lin: QuantizedLinear, stats):
    """(smooth [ci], the smoothed and clipped weight [oc, ci], groupsize) of
    AWQ's two searches; `stats` holds the sampled `inputs` and the absmean
    sums."""
    n_bit = cfg.wbit.bits
    groupsize = cfg.w_groupsize if cfg.w_groupsize > 0 else 128
    w = lin.weight.to(torch.float32)
    x = torch.cat([a.to(w.device) for a in stats["inputs"]]).to(torch.float32)
    x_mean_abs = stats["abssum"].to(w.device) / torch.clamp(stats["ntokens"].to(w.device),
                                                            min=1.0)
    smooth = auto_scale_search(w, x, x_mean_abs, n_bit=n_bit, groupsize=groupsize,
                               zero_point=True, n_grid=cfg.n_grid)
    Q = w * smooth[None, :]
    clip = auto_clip_search(Q, (x[:1] / smooth[None, :]), n_bit=n_bit, groupsize=groupsize,
                            zero_point=True, n_grid=cfg.n_grid, max_shrink=cfg.max_shrink)
    oc, ci = Q.shape
    ng = ci // groupsize
    Qc = torch.clamp(Q.reshape(oc, ng, groupsize), -clip[:, :, None], clip[:, :, None])
    return smooth, Qc.reshape(oc, ci), groupsize


def awq_quantize_linear(cfg: QuantConfig, lin: QuantizedLinear, stats) -> QuantizedLinear:
    """AWQ of one linear: asymmetric by construction (zero points), the
    smooth factor stored on the linear."""
    if not cfg.quantize_weights:
        return lin
    smooth, Qc, groupsize = awq_smooth_clip(cfg, lin, stats)
    fake_w, scales, zeros = pseudo_quantize(Qc, cfg.wbit.bits, True, groupsize,
                                            return_qparams=True)
    return build_quantized_linear(lin, cfg, fake_w, scales, zeros, w_qtype="per_group",
                                  w_groupsize=groupsize, w_symmetric=False, smooth_factor=smooth)
