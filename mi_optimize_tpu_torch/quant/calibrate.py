"""Layer-streaming sequential calibration engine.

Port of mi_optimize_tpu/quant/calibrate.py (the reference toolbox's
llama_sequential driver, without its hooks):

  * the first block's inputs are the embedding of each calibration batch;
  * each block moves to the calibration device in its turn (the fp model may
    stay on the host), and `llama.block_apply(capture=True, fused=False)`
    returns the activation that enters each linear; the stats are reduced
    from them on that device;
  * the groups of GROUP_ORDER ([k, v, q], [o], [up, gate], [down]) are
    quantized in that order, each group's stats from one more forward of the
    block whose earlier groups are already quantized; a group shares one set
    of stats (same input);
  * block_sequential=True feeds the quantized block's outputs to the next
    block; False feeds the fp block's (computed before the block is
    quantized);
  * `journal=` (export.checkpoint.CalibrationJournal) makes the pass
    resumable: after each block the quantized block and the next block's
    inputs are written, and a new call skips the finished blocks and starts
    from the saved inputs.

The quantized blocks and the ping-pong activations stay on the calibration
device. Calibration batches may differ in length (the C-Eval, CMMLU and BOSS
sets give one [1, L] array per question): each batch takes the rope tables
and causal mask of its own length, where the JAX package's
sequential_quantize takes the first batch's for all and raises on the
others.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import llama
from ..models.llama import GROUP_ORDER, LlamaConfig
from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, init_stats, update_stats_device, update_stats_host
from .config import QuantConfig

log = logging.getLogger(__name__)


def _selected(cfg: QuantConfig, path: str) -> bool:
    """Regex include/exclude selection of the linears to quantize; paths look
    like 'layers.3.q_proj'."""
    return bool(re.search(cfg.include, path)) and not re.search(cfg.exclude, path)


def to_device(node, dev):
    """A params tree (dicts, lists, tensors, QuantizedLinears) on `dev`; a
    node already there is returned as it is."""
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    if isinstance(node, QuantizedLinear):
        moved = {f.name: getattr(node, f.name).to(dev) for f in dataclasses.fields(node)
                 if f.init and isinstance(getattr(node, f.name), torch.Tensor)
                 and getattr(node, f.name).device != dev}
        return node.replace(**moved) if moved else node
    if isinstance(node, dict):
        return {k: to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [to_device(v, dev) for v in node]
    return node


def _stats_forward(blk, x, cos, sin, mask, cfg: LlamaConfig, capture_name: str):
    """One block forward; the captured input of `capture_name`."""
    _, _, caps = llama.block_apply(blk, x, cos, sin, mask, cfg, capture=True, fused=False)
    return caps[capture_name]


def _block_forward(blk, x, cos, sin, mask, cfg: LlamaConfig):
    out, _, _ = llama.block_apply(blk, x, cos, sin, mask, cfg, capture=False, fused=False)
    return out


class _Rope:
    """(cos, sin, mask) of each sequence length, made once a length."""

    def __init__(self, cfg: LlamaConfig, dev):
        self.cfg, self.dev, self._by_len = cfg, dev, {}

    def __call__(self, x):
        S = x.shape[1]
        if S not in self._by_len:
            cos, sin = llama.rope_tables(self.cfg, torch.arange(S, device=self.dev))
            self._by_len[S] = (cos, sin, llama.causal_mask(S, self.dev))
        return self._by_len[S]


def _collect_group_stats(blk, batches, rope, cfg, name, kinds, in_features):
    """The calibration stats of one linear group's input over the batches."""
    if not kinds:
        return {}
    stats = init_stats(kinds, in_features, rope.dev)
    dev_kinds = tuple(k for k in kinds if k != "inputs")
    stats_dev = {k: v for k, v in stats.items() if k != "inputs"}
    for x in batches:
        cap = _stats_forward(blk, x, *rope(x), cfg, name)
        if dev_kinds:
            stats_dev = update_stats_device(dev_kinds, stats_dev, cap)
        stats = update_stats_host(kinds, stats, cap)
    stats.update(stats_dev)
    return stats


def _kinds(algo: BaseAlgo):
    return tuple(dict.fromkeys(tuple(algo.stats) + tuple(algo.act_stats())))


@torch.no_grad()
def quantize_blocks_dataless(params: Dict[str, Any], quant_cfg: QuantConfig, algo: BaseAlgo,
                             device=None) -> Dict[str, Any]:
    """Quantize every block without calibration forwards (weight-only
    dynamic configs of RTN need no stats), one block on `device` at a time."""
    dev = resolve_device(device)
    new_layers = []
    for i, fp_blk in enumerate(params["layers"]):
        blk = to_device(dict(fp_blk), dev)
        for group in GROUP_ORDER:
            for name in group:
                if _selected(quant_cfg, f"layers.{i}.{name}"):
                    blk[name] = algo.quantize_linear(blk[name], {})
        new_layers.append(blk)
    return dict(params, layers=new_layers)


@torch.no_grad()
def sequential_quantize(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    quant_cfg: QuantConfig,
    algo: BaseAlgo,
    calib_batches: List[np.ndarray],
    *,
    journal=None,
    device=None,
) -> Dict[str, Any]:
    """Quantize all transformer blocks layer-sequentially on `device`;
    returns the new params (the other entries as they were). With `journal`
    the pass resumes after the journal's last finished block."""
    dev = resolve_device(device)
    rope = _Rope(cfg, dev)

    emb = params["embed"].to(dev)
    xs = [emb[torch.as_tensor(np.asarray(b), device=dev)] for b in calib_batches]
    del emb

    kinds = _kinds(algo)
    new_layers = []
    resume_from = -1
    if journal is not None:
        resume_from = journal.last_completed()
        if resume_from >= 0:
            new_layers = [journal.load_block(i, device=dev) for i in range(resume_from + 1)]
            saved = journal.load_acts(device=dev)
            if saved is not None:
                xs = saved
            log.info("resuming calibration after block %d", resume_from)
    for i, fp_blk in enumerate(params["layers"]):
        if i <= resume_from:
            continue
        blk = to_device(dict(fp_blk), dev)
        if not quant_cfg.block_sequential:
            # fp propagation: the next block's inputs from the unquantized block
            fp_outs = [_block_forward(blk, x, *rope(x), cfg) for x in xs]

        for group in GROUP_ORDER:
            sel = [n for n in group if _selected(quant_cfg, f"layers.{i}.{n}")]
            if not sel:
                continue
            lead = group[0]
            stats = _collect_group_stats(blk, xs, rope, cfg, lead, kinds,
                                         blk[lead].in_features)
            for name in sel:
                blk[name] = algo.quantize_linear(blk[name], stats)
            del stats

        if quant_cfg.block_sequential:
            xs = [_block_forward(blk, x, *rope(x), cfg) for x in xs]
        else:
            xs = fp_outs
        new_layers.append(blk)
        if journal is not None:
            journal.save_block(i, blk, xs=xs)
        log.info("quantized block %d/%d", i + 1, len(params["layers"]))
    return dict(params, layers=new_layers)


def _full_forward_captures(params, cfg: LlamaConfig, ids):
    """One full-model forward; each block's captures of its groups' leads."""
    S = ids.shape[1]
    x = llama.embed(params, ids)
    cos, sin = llama.rope_tables(cfg, torch.arange(S, device=x.device))
    mask = llama.causal_mask(S, x.device)
    all_caps = []
    for blk in params["layers"]:
        x, _, caps = llama.block_apply(blk, x, cos, sin, mask, cfg, capture=True, fused=False)
        all_caps.append({g[0]: caps[g[0]] for g in GROUP_ORDER})
    return all_caps


@torch.no_grad()
def full_model_quantize(params: Dict[str, Any], cfg: LlamaConfig, quant_cfg: QuantConfig,
                        algo: BaseAlgo, calib_batches: List[np.ndarray],
                        device=None) -> Dict[str, Any]:
    """Non-layer-sequential calibration (the reference toolbox's
    quant_other_model): stats for every linear from full-model forwards
    with the ORIGINAL fp weights throughout, then quantize everything. The
    whole model moves to `device`."""
    dev = resolve_device(device)
    params = to_device(params, dev)
    kinds = _kinds(algo)
    dev_kinds = tuple(k for k in kinds if k != "inputs")
    nlayers = len(params["layers"])
    leads = [g[0] for g in GROUP_ORDER]
    stats = [{lead: init_stats(kinds, params["layers"][i][lead].in_features, dev)
              for lead in leads} for i in range(nlayers)]
    dev_stats = [{lead: {k: v for k, v in stats[i][lead].items() if k != "inputs"}
                  for lead in leads} for i in range(nlayers)]
    for b in calib_batches:
        all_caps = _full_forward_captures(params, cfg, torch.as_tensor(np.asarray(b), device=dev))
        for i in range(nlayers):
            for lead in leads:
                if dev_kinds:
                    dev_stats[i][lead] = update_stats_device(dev_kinds, dev_stats[i][lead],
                                                             all_caps[i][lead])
                stats[i][lead] = update_stats_host(kinds, stats[i][lead], all_caps[i][lead])
    for i in range(nlayers):
        for lead in leads:
            stats[i][lead].update(dev_stats[i][lead])

    new_layers = []
    for i, fp_blk in enumerate(params["layers"]):
        blk = dict(fp_blk)
        for group in GROUP_ORDER:
            for name in group:
                if _selected(quant_cfg, f"layers.{i}.{name}"):
                    blk[name] = algo.quantize_linear(blk[name], stats[i][group[0]])
        new_layers.append(blk)
    return dict(params, layers=new_layers)
