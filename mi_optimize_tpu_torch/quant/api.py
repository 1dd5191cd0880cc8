"""Public quantize() entry point: config normalization, calibration data, dispatch.

Port of mi_optimize_tpu/quant/api.py, with a `device=` argument: the
calibration forwards and the algorithm run there ("cuda" unless the caller
asks for the CPU), the fp model's blocks move there one at a time, and the
returned model's tensors live there. Both widths above 8 bits pass the model
through unchanged.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core.device import resolve_device
from ..models.model import Model
from .base import full_f32, get_algo
from .calibrate import (full_model_quantize, quantize_blocks_dataless, sequential_quantize,
                        to_device)
from .config import QuantConfig

log = logging.getLogger(__name__)

# families that use the llama-shaped sequential driver (block list + GROUP_ORDER)
_SEQUENTIAL_FAMILIES = ("llama", "qwen2", "baichuan", "mistral", "chatglm")


def quantize(
    model: Model,
    quant_config: Union[QuantConfig, Dict[str, Any], str],
    calib_data: Optional[List[np.ndarray]] = None,
    tokenizer=None,
    journal=None,
    device=None,
) -> Model:
    """Quantize `model` according to `quant_config` on `device`.

    quant_config may be a QuantConfig, a (possibly reference-style nested)
    dict, or a path to a YAML file. `calib_data` is a list of token-id arrays
    [batch, seqlen]; if omitted it is built from quant_config.calibrate by the
    datasets layer (text datasets need `tokenizer`)."""
    dev = resolve_device(device)
    if isinstance(quant_config, str):
        cfg = QuantConfig.from_yaml(quant_config)
    elif isinstance(quant_config, dict):
        cfg = QuantConfig.from_dict(quant_config)
    else:
        cfg = quant_config

    if not cfg.quantize_weights and not cfg.quantize_acts:
        log.info("wbit and abit are both high-precision; model passes through")
        return model

    algo = get_algo(cfg.algo, cfg)
    if calib_data is None:
        if cfg.quantization_type == "static" or algo.stats:
            from ..datasets.calibration import get_calibrate_loader

            calib_data = get_calibrate_loader(tokenizer, cfg.calibrate)
        else:
            calib_data = []

    log.info("quantizing family=%s algo=%s w=%s a=%s on %s", model.family, cfg.algo,
             cfg.wbit.name, cfg.abit.name, dev)
    if model.family not in _SEQUENTIAL_FAMILIES:
        raise NotImplementedError(f"family {model.family} not yet supported")
    with full_f32():
        if not calib_data:
            # algorithms with no stats (RTN weight-only dynamic) walk the
            # blocks with no forward pass
            params = quantize_blocks_dataless(model.params, cfg, algo, device=dev)
        elif cfg.layer_sequential:
            params = sequential_quantize(model.params, model.config, cfg, algo, calib_data,
                                         journal=journal, device=dev)
        else:
            params = full_model_quantize(model.params, model.config, cfg, algo, calib_data,
                                         device=dev)
    params = to_device(params, dev)
    return Model(config=model.config, params=params, family=model.family)
