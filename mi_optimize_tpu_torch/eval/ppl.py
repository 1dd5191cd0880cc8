"""Perplexity evaluation (token-weighted NLL, then exp).

Port of mi_optimize_tpu/eval/ppl.py (compute_ppl): per batch, the token-mean
loss times its count of scored tokens is summed, and the perplexity is
exp(total loss / total count). The forward runs on the device of the model's
tensors; each batch is moved there as it comes.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..models import llama
from ..models.model import Model


@torch.no_grad()
def batch_loss(model: Model, input_ids: torch.Tensor, fused: bool = True):
    """(token-mean loss, count) of one [B, S] batch."""
    logits = llama.forward(model.params, model.config, input_ids, fused=fused)
    return llama.causal_lm_loss(logits, input_ids)


def compute_ppl(model: Model, batches: Iterable[np.ndarray], fused: bool = True) -> float:
    dev = model.params["embed"].device
    total_loss = 0.0
    total_count = 0
    for b in batches:
        loss, count = batch_loss(model, torch.as_tensor(np.asarray(b), device=dev), fused)
        c = int(count)
        total_loss += float(loss) * c
        total_count += c
    return float(np.exp(total_loss / max(total_count, 1)))
