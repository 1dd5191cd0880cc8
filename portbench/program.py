"""The system under test: the port's model, built with the port's own code.

Each linear's float weight comes from `weights` (the benchmark's inputs) and
goes to the port's `models.synthetic.quantized_linear`, which quantizes and
packs it on the device, one linear at a time. The serving cells take the
model through `serving.optimize.fuse_for_serving`; the evaluation cells take
it as `quant.api.quantize` hands it over, unfused.
"""
from __future__ import annotations

import torch

from . import weights


def llama_config(cfg: dict):
    """The port's LlamaConfig for a configuration file's keys."""
    from mi_optimize_tpu_torch.models.llama import LlamaConfig

    heads = cfg["num_attention_heads"]
    return LlamaConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                       intermediate_size=cfg["intermediate_size"],
                       num_layers=cfg["num_hidden_layers"], num_heads=heads,
                       num_kv_heads=cfg["num_key_value_heads"],
                       head_dim=cfg["hidden_size"] // heads, rms_eps=cfg["rms_norm_eps"],
                       rope_theta=cfg["rope_theta"], max_seq_len=cfg["max_position_embeddings"])


def build(cfg: dict, seed: int, device, fused: bool):
    """The port's Model with int4 g128 symmetric packed linears from the
    seed's floats; `fused` applies fuse_for_serving."""
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import quantized_linear

    q = cfg["quantization"]
    bits = q["wbit"]
    group, sym = q["group_size"], q["symmetric"]

    def lin(w):
        out = quantized_linear(w, bits, group, sym)
        del w
        return out

    layers = []
    for l in range(cfg["num_hidden_layers"]):
        blk = {"input_norm": weights.norm(cfg, seed, f"layers.{l}.input_norm", device),
               "post_norm": weights.norm(cfg, seed, f"layers.{l}.post_norm", device)}
        for name in weights.LINEARS:
            blk[name] = lin(weights.linear(cfg, seed, l, name, device))
        layers.append(blk)
    params = {"embed": weights.embed(cfg, seed, device), "layers": layers,
              "final_norm": weights.norm(cfg, seed, "final_norm", device),
              "lm_head": lin(weights.lm_head(cfg, seed, device))}
    model = Model(config=llama_config(cfg), params=params)
    if fused:
        from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

        model = fuse_for_serving(model)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return model
