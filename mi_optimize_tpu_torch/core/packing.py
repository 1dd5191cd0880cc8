"""Bit-packing of integer weight grids into 32-bit words.

Port of mi_optimize_tpu/core/packing.py, with the same layout:

  * values are packed along the in-features (last) axis, little-endian within
    each 32-bit word: value k of a word occupies bits [k*b, (k+1)*b);
  * packed shape is [..., in_features * bits / 32];
  * signed grids are biased by -qmin before packing, so storage is unsigned;
  * `pack_weight` stores the words-major transpose [in*bits/32, out].

torch has no shift operators for uint32 on the CPU, so the words are held as
an int32 bit-view of the uint32 words. On int32 `>>` is an arithmetic shift
that sign-extends a field with the top bit set, so every shift here is
followed by a mask (the reference can leave its top plane unmasked because its
uint32 shift is logical).
"""
from __future__ import annotations

import numpy as np
import torch

from .qparams import QRange


def packed_width(in_features: int, bits: int) -> int:
    total = in_features * bits
    if total % 32 != 0:
        raise ValueError(f"in_features*bits ({in_features}*{bits}) must be a multiple of 32")
    return total // 32


def _as_numpy(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _u32_to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 tensor of unsigned 32-bit values -> their int32 bit-view."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def pack(values, bits: int, rng: QRange) -> torch.Tensor:
    """Pack an int grid [..., in] (values in [qmin, qmax]) into int32 words
    [..., in*b/32] (bit-view of uint32). Host-side; runs once at export."""
    values = _as_numpy(values)
    in_features = values.shape[-1]
    nwords = packed_width(in_features, bits)
    u = (values.astype(np.int64) - rng.qmin).astype(np.uint64)
    if np.any(u >> np.uint64(bits)):
        raise ValueError("values out of range for bit-width")
    flat = u.reshape(-1, in_features)
    if 32 % bits == 0:
        vpw = 32 // bits
        v = flat.reshape(flat.shape[0], nwords, vpw).astype(np.uint32)
        shifts = np.arange(vpw, dtype=np.uint32) * np.uint32(bits)
        out32 = np.bitwise_or.reduce(v << shifts, axis=-1).astype(np.uint32)
    else:
        out = np.zeros((flat.shape[0], nwords), dtype=np.uint64)
        idx = (np.arange(in_features) * bits) // 32
        off = ((np.arange(in_features) * bits) % 32).astype(np.uint64)
        for w in range(nwords):
            sel = idx == w
            if sel.any():
                out[:, w] |= np.bitwise_or.reduce(flat[:, sel] << off[sel], axis=1)
            # straddling values whose high bits spill into word w
            spill = (idx == w - 1) & (off + bits > 32)
            if spill.any():
                out[:, w] |= np.bitwise_or.reduce(
                    flat[:, spill] >> (np.uint64(32) - off[spill]), axis=1)
        out32 = (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out32 = out32.reshape(*values.shape[:-1], nwords)
    return torch.from_numpy(np.ascontiguousarray(out32).view(np.int32))


def unpack(packed: torch.Tensor, bits: int, rng: QRange, in_features: int) -> torch.Tensor:
    """Unpack int32 words [..., nwords] -> int32 grid [..., in_features]."""
    nwords = packed.shape[-1]
    assert nwords == packed_width(in_features, bits)
    dev = packed.device
    pos = np.arange(in_features)
    idx = torch.as_tensor((pos * bits) // 32, device=dev)
    off_np = (pos * bits) % 32
    mask = (1 << bits) - 1
    if 32 % bits == 0:
        words = packed.to(torch.int32)[..., idx]
        vals = (words >> torch.as_tensor(off_np, dtype=torch.int32, device=dev)) & mask
    else:
        # straddling fields: work on the unsigned value in int64
        p = packed.to(torch.int64) & 0xFFFFFFFF
        low = p[..., idx] >> torch.as_tensor(off_np, device=dev)
        straddle = torch.as_tensor(off_np + bits > 32, device=dev)
        idx_hi = torch.as_tensor(np.minimum((pos * bits) // 32 + 1, nwords - 1), device=dev)
        hi = torch.where(straddle,
                         p[..., idx_hi] << torch.as_tensor((32 - off_np) % 32, device=dev),
                         torch.zeros((), dtype=torch.int64, device=dev))
        vals = (low | hi) & mask
    return vals.to(torch.int32) + rng.qmin


def unpack_words(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Words-major int32 [KW, N] -> unsigned fields [KW*vpw, N] int32, rows
    in natural in-feature order (row w*vpw + i is field i of word w)."""
    vpw = 32 // bits
    mask = (1 << bits) - 1
    parts = [(words >> (bits * i)) & mask for i in range(vpw)]
    return torch.stack(parts, dim=1).reshape(words.shape[0] * vpw, words.shape[1])


def pack_weight(values, bits: int, rng: QRange) -> torch.Tensor:
    """Pack an int weight grid [out, in] into words-major int32 [in*bits/32, out]."""
    return pack(values, bits, rng).t().contiguous()


def unpack_weight(packed_t: torch.Tensor, bits: int, rng: QRange, in_features: int) -> torch.Tensor:
    """Inverse of pack_weight: int32 [nwords, out] -> int32 [out, in]."""
    return unpack(packed_t.t(), bits, rng, in_features)


def pack_weight_device(values: torch.Tensor, bits: int, rng: QRange) -> torch.Tensor:
    """pack_weight on the values' own device (32 % bits == 0 widths), so a
    grid that lives on the GPU is packed there without a host round trip."""
    if 32 % bits != 0:
        raise ValueError("device packing supports bit-widths dividing 32 only")
    vpw = 32 // bits
    out_f, in_f = values.shape
    nwords = packed_width(in_f, bits)
    u = (values.to(torch.int64) - rng.qmin).reshape(out_f, nwords, vpw)
    words = u[..., 0].clone()
    for i in range(1, vpw):
        words |= u[..., i] << (bits * i)
    return _u32_to_i32(words).t().contiguous()
