"""Quantizer-algorithm interface and calibration statistics reducers.

Port of mi_optimize_tpu/quant/base.py. Each algorithm is a transformation

    quantize_linear(lin: QuantizedLinear, stats) -> QuantizedLinear

and the stats are reduced from the activations that
`llama.block_apply(capture=True)` returns, on the device they live on.

Reducers:
  xtx      running sum of X^T X (float32) plus the batch count; GPTQ's
           Hessian is H = (2/n)·ΣX^TX (`finalize_hessian`).
  minmax   global activation min/max (RTN static per-tensor act quant).
  absmax   per-in-feature running max |x| (SmoothQuant act scales).
  absmean  per-in-feature running sum |x| and token count.
  inputs   a host-side sample of raw input tokens, capped at
           MAX_INPUT_SAMPLE_TOKENS (AWQ's grid-search loss).

The algorithms register themselves when their modules are imported
(quant/__init__.py imports them all): rtn, gptq, awq, smoothquant (also
"smooth"), zeroquant, fp8, spqr, quip, awq+gptq and smoothquant+gptq.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from ..models.quant_linear import QuantizedLinear
from .config import QuantConfig

MAX_INPUT_SAMPLE_TOKENS = 8192  # cap for the host-side 'inputs' sample


@contextlib.contextmanager
def full_f32():
    """float32 matmuls on the GPU in full float32 inside the block, whatever
    the caller's TF32 setting (restored after it). GPTQ's error feedback and
    the Hessian sums move integer codes when their products round to TF32.
    The flag `allow_tf32` reads and sets the same state as the newer
    `fp32_precision` and `set_float32_matmul_precision` APIs."""
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = old


def init_stats(kinds: Tuple[str, ...], in_features: int, device=None) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    f32 = dict(dtype=torch.float32, device=device)
    if "xtx" in kinds:
        s["xtx"] = torch.zeros(in_features, in_features, **f32)
        s["nsamples"] = torch.zeros((), dtype=torch.int32, device=device)
    if "minmax" in kinds:
        s["min"] = torch.full((), float("inf"), **f32)
        s["max"] = torch.full((), float("-inf"), **f32)
    if "absmax" in kinds:
        s["absmax"] = torch.zeros(in_features, **f32)
    if "absmean" in kinds:
        s["abssum"] = torch.zeros(in_features, **f32)
        s["ntokens"] = torch.zeros((), **f32)
    if "inputs" in kinds:
        s["inputs"] = []  # host-side list of float32 [tokens, in_features]
    return s


def update_stats_device(kinds, stats, x: torch.Tensor):
    """The on-device part of the reduction; x is the captured activation [B,S,F]."""
    out = dict(stats)
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    if "xtx" in kinds:
        with full_f32():
            out["xtx"] = stats["xtx"] + xf.t() @ xf
        out["nsamples"] = stats["nsamples"] + x.shape[0]
    if "minmax" in kinds:
        out["min"] = torch.minimum(stats["min"], xf.min())
        out["max"] = torch.maximum(stats["max"], xf.max())
    if "absmax" in kinds:
        out["absmax"] = torch.maximum(stats["absmax"], xf.abs().amax(dim=0))
    if "absmean" in kinds:
        out["abssum"] = stats["abssum"] + xf.abs().sum(dim=0)
        out["ntokens"] = stats["ntokens"] + xf.shape[0]
    return out


def update_stats_host(kinds, stats, x: torch.Tensor):
    """The host-side part (raw input sampling)."""
    if "inputs" in kinds:
        have = sum(a.shape[0] for a in stats["inputs"])
        room = MAX_INPUT_SAMPLE_TOKENS - have
        if room > 0:
            arr = x.detach().to(torch.float32).reshape(-1, x.shape[-1])[:room]
            stats["inputs"].append(arr.cpu())
    return stats


def finalize_hessian(stats) -> torch.Tensor:
    """H = (2/nbatches)·ΣX^TX, the closed form of the reference's running update."""
    n = torch.clamp(stats["nsamples"].to(torch.float32), min=1.0)
    return stats["xtx"] * (torch.full_like(n, 2.0) / n)


class BaseAlgo:
    """One PTQ algorithm. Subclasses declare the stats they need and
    transform linears."""

    # reducer kinds needed for weight quantization
    stats: Tuple[str, ...] = ()

    def __init__(self, cfg: QuantConfig):
        self.cfg = cfg

    def act_stats(self) -> Tuple[str, ...]:
        """Extra reducers needed for static activation quantization."""
        c = self.cfg
        if c.quantize_acts and c.quantization_type == "static":
            return ("minmax",)
        return ()

    def quantize_linear(self, lin: QuantizedLinear, stats: Dict[str, Any]) -> QuantizedLinear:
        raise NotImplementedError


_REGISTRY: Dict[str, type] = {}


def register_algo(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_algo(name: str, cfg: QuantConfig) -> BaseAlgo:
    # the algorithm modules register themselves when quant/__init__.py imports them
    if name not in _REGISTRY:
        raise ValueError(f"unknown algo {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)
