"""QuIP: incoherence processing plus LDL (GPTQ-equivalent) rounding.

Port of mi_optimize_tpu/quant/quip_impl.py (defaults incoh_processing=True,
qfn='b', qmethod='ldl_gptqequiv'):

  * Hessian = ΣX^TX / nbatches (the QuIP hook: no factor 2);
  * preprocessing: H /= |H|max; scaleWH = (diagH / diagW²)^(1/4); W·s,
    H / s / s; random orthogonal butterflies U, V (prime-factor Kronecker
    blocks and permutations, drawn on the host with numpy from
    `np.random.default_rng(seed)`, the reference's draws bit for bit); H
    trace-normalized + 1e-2·I; W <- U W V^T, H <- V H V^T; then GPTQ's dead
    columns and damping;
  * qfn 'b': scale = 2.4·rms(W) + 1e-16 onto [0, maxq]; qfn 'a': per-column
    asymmetric min/max;
  * round_ldl_gptqequiv: the flipped Cholesky factor L of H, then column by
    column w_i = clamp(floor(w_i + (w - ŵ) L[:, i] + 1/2)), in blocks of
    min(128, d): the earlier blocks' part of each block's sums is one
    product, the block's own part one product a column;
  * the inverse postprocessing. The result stays fake-quantized.

The elementwise float32 arithmetic is the reference's, op for op (divisions
by a number correctly rounded on any device). The products (U W V^T, V H V^T,
the postprocessing, each block's and each column's feedback sums) sum their
float32 operands in float64 and round once, and the flipped Cholesky factor
is computed in float64 and rounded once: the same float32 values on any
device and library, where the reference sums and factors in float32. From
the same W, H, U and V the codes are the reference's on the CPU
(tests/test_torch_quant_algos.py). The column loop runs as eager torch ops
on the weights' device.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..core.qparams import exact_div
from ..models.quant_linear import QuantizedLinear
from .common import make_weight_spec
from .config import QuantConfig


# ---------------------------------------------------------------------------
# random orthogonal butterfly (host-side numpy, once per linear)
# ---------------------------------------------------------------------------

def _prime_factors(n: int):
    fs, d = [], 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def butterfly_factors(n: int) -> Tuple[int, int]:
    pf = _prime_factors(n)
    return (math.prod(pf[0::2]), math.prod(pf[1::2]))


def _rand_orthos(rng: np.random.Generator, m: int, p: int) -> np.ndarray:
    """m Haar-random SO(p) blocks via QR of Gaussians (sign-fixed)."""
    if p == 2:
        t = rng.uniform(0, 2 * np.pi, m)
        X = np.zeros((m, 2, 2), np.float32)
        X[:, 0, 0] = np.cos(t)
        X[:, 1, 1] = np.cos(t)
        X[:, 0, 1] = np.sin(t)
        X[:, 1, 0] = -np.sin(t)
        return X
    A = rng.normal(size=(m, p, p))
    Q, R = np.linalg.qr(A)
    # Haar: the columns times the sign of R's diagonal, then det fixed to +1
    s = np.sign(np.einsum("mii->mi", R))
    Q = Q * s[:, None, :]
    det = np.linalg.det(Q)
    Q[:, :, 0] *= np.sign(det)[:, None]
    return Q.astype(np.float32)


def rand_ortho_butterfly(rng: np.random.Generator, n: int) -> np.ndarray:
    """Dense [n, n] float32 random orthogonal matrix with butterfly structure."""
    pfn = butterfly_factors(n)
    Bs = [_rand_orthos(rng, n // p, p) for p in pfn]
    p_in = rng.permutation(n)
    p_out = rng.permutation(n)
    x = np.eye(n, dtype=np.float32)
    q = n
    x = x[p_in, :]
    for i, p in enumerate(pfn):
        mpfx = math.prod(pfn[:i])
        msfx = math.prod(pfn[i + 1:])
        x = x.reshape(mpfx, p, msfx, q).transpose(0, 2, 1, 3).reshape(mpfx * msfx, p, q)
        x = np.einsum("bpq,bqk->bpk", Bs[i], x)
        x = x.reshape(mpfx, msfx, p, q).transpose(0, 2, 1, 3).reshape(n, q)
    return x[p_out, :]


# ---------------------------------------------------------------------------
# LDL rounding, pre- and postprocessing
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of float32 operands summed in float64 and rounded once: the same
    float32 result on any device and library."""
    return (a.double() @ b.double()).float()


def ldl_factor(H: torch.Tensor) -> torch.Tensor:
    """The strictly upper unit-normalized factor of the flipped Cholesky
    decomposition of H (H = L L^T, L upper), in float64 and rounded once."""
    L = torch.flip(torch.linalg.cholesky(torch.flip(H.double(), (0, 1))), (0, 1))
    L = L / torch.diagonal(L)[None, :]
    L.diagonal().zero_()
    return L.float()


def round_ldl_gptqequiv(w: torch.Tensor, H: torch.Tensor, nbits: int,
                        blocksize: int = 128) -> torch.Tensor:
    """Blocked sequential LDL rounding of w [m, d] (values on [0, maxq])
    against H [d, d]; returns the integer grid as float32."""
    m, d = w.shape
    if d % blocksize:
        raise ValueError(f"in_features {d} must be a multiple of blocksize {blocksize}")
    maxq = float(2 ** nbits - 1)
    L = ldl_factor(H)
    w_hat = w.clone()
    for i1 in range(0, d, blocksize):
        i2 = i1 + blocksize
        # the earlier blocks' part of this block's sums, one product
        C_past = _mm(w[:, :i1] - w_hat[:, :i1], L[:i1, i1:i2])
        W_blk = w[:, i1:i2]
        L1 = L[i1:i2, i1:i2]
        hat = W_blk.clone()
        for i in range(blocksize):
            within = _mm(W_blk[:, :i] - hat[:, :i], L1[:i, i:i + 1])[:, 0]
            hat[:, i] = torch.clamp(torch.floor(W_blk[:, i] + (C_past[:, i] + within) + 0.5),
                                    0.0, maxq)
        w_hat[:, i1:i2] = hat
    return w_hat


def quip_quantize_matrix(
    W: torch.Tensor,
    H: torch.Tensor,
    *,
    bits: int,
    qfn: str = "b",
    percdamp: float = 0.01,
    incoh: bool = True,
    seed: int = 0,
    U=None,
    V=None,
) -> torch.Tensor:
    """QuIP of one weight matrix W [m, n] against H [n, n] on W's device;
    the fake-quantized weights. `U`/`V` replace the drawn butterflies (the
    randomness is the pipeline's only nondeterministic step)."""
    m, n = W.shape
    dev = W.device
    maxq = float(2 ** bits - 1)
    W = W.to(torch.float32)
    H = H.to(device=dev, dtype=torch.float32)
    if incoh:
        H = H / H.abs().max()
        diagH = torch.clamp(torch.diagonal(H), min=1e-8)
        diagW2 = torch.clamp(torch.sum(W * W, dim=0), min=1e-8)
        scaleWH = torch.clamp(torch.sqrt(torch.sqrt(diagH / diagW2)), min=1e-8)
        W = W * scaleWH[None, :]
        H = H / scaleWH[None, :] / scaleWH[:, None]
        if U is None or V is None:
            rng = np.random.default_rng(seed)
            U = rand_ortho_butterfly(rng, m)
            V = rand_ortho_butterfly(rng, n)
        U = torch.as_tensor(U, dtype=torch.float32).to(dev)
        V = torch.as_tensor(V, dtype=torch.float32).to(dev)
        eye = torch.eye(n, dtype=torch.float32, device=dev)
        tr = torch.trace(H) + 1e-8
        H = H * exact_div(torch.full_like(tr, n), tr) + 1e-2 * eye
        W = _mm(_mm(U, W), V.t())
        H = _mm(_mm(V, H), V.t())
    dead = torch.diagonal(H) == 0.0
    H = H.clone()
    H.diagonal()[dead] = 1.0
    W = torch.where(dead[None, :], torch.zeros_like(W), W)
    H = H + percdamp * torch.mean(torch.diagonal(H)) * torch.eye(n, dtype=torch.float32,
                                                                  device=dev)
    if qfn == "a":
        # per-column asymmetric qparams (find_params weight=False on 2-D)
        mn = W.amin(dim=0)
        mx = W.amax(dim=0)
        deg = mn == mx
        mn = torch.where(deg, torch.full_like(mn, -1.0), mn)
        mx = torch.where(deg, torch.full_like(mx, 1.0), mx)
        scale = (mx - mn) / torch.full_like(mx, maxq)
        zero = -mn / scale
        wr = torch.clamp(W / scale[None, :] + zero[None, :], 0.0, maxq)
        wr = round_ldl_gptqequiv(wr, H, bits, blocksize=min(128, n))
        Wq = scale[None, :] * (wr - zero[None, :])
    elif qfn == "b":
        scale = 2.4 * torch.sqrt(torch.mean(W * W)) + 1e-16
        wr = torch.clamp((W / scale + 1.0) / 2.0 * maxq, 0.0, maxq)
        wr = round_ldl_gptqequiv(wr, H, bits, blocksize=min(128, n))
        Wq = (exact_div(wr, maxq) * 2.0 - 1.0) * scale
    else:
        raise ValueError(f"qfn must be 'a'|'b', got {qfn}")
    if incoh:
        Wq = _mm(_mm(U.t(), Wq), V)
        Wq = Wq / scaleWH[None, :]
    return Wq


def quip_quantize_linear(cfg: QuantConfig, lin: QuantizedLinear, stats) -> QuantizedLinear:
    if not cfg.quantize_weights:
        return lin
    # QuIP's Hessian: ΣX^TX / nbatches (no factor 2)
    H = stats["xtx"] / torch.clamp(stats["nsamples"].to(torch.float32), min=1.0)
    Wq = quip_quantize_matrix(lin.weight, H, bits=cfg.wbit.bits, qfn=cfg.qfn,
                              percdamp=cfg.percdamp)
    return lin.replace(spec=make_weight_spec(cfg, packed=False), weight=Wq.to(lin.weight.dtype))
