"""HuggingFace checkpoint loading: safetensors llama-family -> the port's params.

Port of mi_optimize_tpu/models/loader.py: `config_from_hf` (llama, mistral,
qwen2's attention bias, tied embeddings and ChatGLM2/3's fused layout),
`load_llama_from_hf` (Baichuan's W_pack split at load) and `_load_chatglm`.
Every linear becomes a fp QuantizedLinear.

The shards are read by the port's own safetensors reader (`read_safetensors`,
no `safetensors` package): an 8-byte little-endian header length, a JSON
header {name: {dtype, shape, data_offsets}} (its `__metadata__` entry
skipped), then the raw little-endian buffers, offsets counted from the end of
the header. Each file is memory-mapped, so that a tensor is copied once, into
the loaded model's dtype and device. F32, F16 and BF16 are read; BF16 as
int16 bits viewed as torch.bfloat16. Shards load in file-name order and a
later shard's key wins.

    model = load_llama_from_hf(path)                     # on the card
    model = load_llama_from_hf(path, device="cpu")       # host copy: quantize
                                                         # streams its blocks
"""
from __future__ import annotations

import glob
import json
import logging
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..core.device import resolve_device
from .llama import LlamaConfig
from .model import Model
from .quant_linear import QuantizedLinear

log = logging.getLogger(__name__)

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype they view as)
_DTYPES = {"F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
           "BF16": (np.int16, torch.bfloat16)}


def config_from_hf(cfg: Dict[str, Any]) -> LlamaConfig:
    if cfg.get("model_type") == "chatglm":
        # ChatGLM2/3: fused qkv+mlp (split at load), MQA via
        # multi_query_group_num, interleaved rotary over half the head dim
        head_dim = cfg.get("kv_channels", cfg["hidden_size"] // cfg["num_attention_heads"])
        return LlamaConfig(
            vocab_size=cfg.get("padded_vocab_size", cfg.get("vocab_size")),
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["ffn_hidden_size"],
            num_layers=cfg["num_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("multi_query_group_num", cfg["num_attention_heads"]),
            head_dim=head_dim,
            rms_eps=cfg.get("layernorm_epsilon", 1e-5),
            rope_theta=10000.0 * cfg.get("rope_ratio", 1.0),
            max_seq_len=min(cfg.get("seq_length", 2048), 8192),
            attn_bias=cfg.get("add_qkv_bias", True),
            rotary_dim=head_dim // 2,
            rope_interleaved=True,
        )
    n_heads = cfg["num_attention_heads"]
    hidden = cfg["hidden_size"]
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=hidden,
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=n_heads,
        num_kv_heads=cfg.get("num_key_value_heads", n_heads),
        head_dim=cfg.get("head_dim", hidden // n_heads),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        max_seq_len=min(cfg.get("max_position_embeddings", 2048), 8192),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        attn_bias=cfg.get("model_type") == "qwen2" or cfg.get("attention_bias", False),
    )


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one .safetensors file, each a view of the
    file's private memory map (copy-on-write: nothing is read until used)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n) \
        if os.path.getsize(path) > 8 + n else np.zeros(0, np.uint8)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}; the reader "
                             f"takes {sorted(_DTYPES)}")
        bits, tdt = _DTYPES[meta["dtype"]]
        a, b = meta["data_offsets"]
        arr = data[a:b].view(np.dtype(bits).newbyteorder("<")).reshape(meta["shape"])
        out[name] = torch.from_numpy(arr).view(tdt)
    return out


def _open_shards(path: str) -> Dict[str, torch.Tensor]:
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    index = {}
    for f in files:
        index.update(read_safetensors(f))
    return index


def load_llama_from_hf(path: str, dtype=torch.float32, device=None) -> Model:
    """The checkpoint under `path` (config.json + *.safetensors) as a Model
    of fp QuantizedLinears, every tensor in `dtype` on `device` ("cuda"
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg)
    family = hf_cfg.get("model_type", "llama")
    idx = _open_shards(path)
    if family == "chatglm":
        return _load_chatglm(cfg, idx, dtype, dev)

    def get(name) -> torch.Tensor:
        return idx[name].to(device=dev, dtype=dtype, copy=True)

    def lin(name, bias_ok=False):
        w = get(f"{name}.weight")
        b = None
        if bias_ok and f"{name}.bias" in idx:
            b = get(f"{name}.bias")
        return QuantizedLinear.fp(w, b)

    params: Dict[str, Any] = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin("lm_head")
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        blk = {
            "input_norm": get(f"{p}.input_layernorm.weight"),
            "post_norm": get(f"{p}.post_attention_layernorm.weight"),
            "o_proj": lin(f"{p}.self_attn.o_proj"),
            "gate_proj": lin(f"{p}.mlp.gate_proj"),
            "up_proj": lin(f"{p}.mlp.up_proj"),
            "down_proj": lin(f"{p}.mlp.down_proj"),
        }
        if f"{p}.self_attn.W_pack.weight" in idx:
            # Baichuan fuses QKV into W_pack: split at load (per-output-row
            # quantizers are unaffected by the split)
            wp = get(f"{p}.self_attn.W_pack.weight")
            h = cfg.hidden_size
            blk["q_proj"] = QuantizedLinear.fp(wp[:h])
            blk["k_proj"] = QuantizedLinear.fp(wp[h:2 * h])
            blk["v_proj"] = QuantizedLinear.fp(wp[2 * h:])
        else:
            blk["q_proj"] = lin(f"{p}.self_attn.q_proj", bias_ok=True)
            blk["k_proj"] = lin(f"{p}.self_attn.k_proj", bias_ok=True)
            blk["v_proj"] = lin(f"{p}.self_attn.v_proj", bias_ok=True)
        params["layers"].append(blk)
        log.debug("loaded block %d/%d", i + 1, cfg.num_layers)
    return Model(config=cfg, params=params,
                 family=family if family in ("llama", "mistral", "qwen2", "baichuan") else "llama")


def _load_chatglm(cfg: LlamaConfig, idx, dtype, dev) -> Model:
    """ChatGLM2/3 checkpoint -> llama-shaped params: the fused
    query_key_value and dense_h_to_4h are split at load; dense_h_to_4h's
    halves map onto (gate, up), as chatglm computes silu(x0) * x1 over
    chunk(2)."""
    def get(name):
        return idx[name].to(device=dev, dtype=dtype, copy=True)

    kv_dim = cfg.num_kv_heads * cfg.head_dim
    q_dim = cfg.num_heads * cfg.head_dim
    params: Dict[str, Any] = {
        "embed": get("transformer.embedding.word_embeddings.weight"),
        "final_norm": get("transformer.encoder.final_layernorm.weight"),
        "lm_head": QuantizedLinear.fp(get("transformer.output_layer.weight")),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        p = f"transformer.encoder.layers.{i}"
        qkv_w = get(f"{p}.self_attention.query_key_value.weight")
        qkv_b = None
        if f"{p}.self_attention.query_key_value.bias" in idx:
            qkv_b = get(f"{p}.self_attention.query_key_value.bias")
        h4 = get(f"{p}.mlp.dense_h_to_4h.weight")
        inter = cfg.intermediate_size

        def sl(w, b, a, bnd):
            return QuantizedLinear.fp(w[a:bnd], None if b is None else b[a:bnd])

        params["layers"].append({
            "input_norm": get(f"{p}.input_layernorm.weight"),
            "post_norm": get(f"{p}.post_attention_layernorm.weight"),
            "q_proj": sl(qkv_w, qkv_b, 0, q_dim),
            "k_proj": sl(qkv_w, qkv_b, q_dim, q_dim + kv_dim),
            "v_proj": sl(qkv_w, qkv_b, q_dim + kv_dim, q_dim + 2 * kv_dim),
            "o_proj": QuantizedLinear.fp(get(f"{p}.self_attention.dense.weight")),
            "gate_proj": QuantizedLinear.fp(h4[:inter]),
            "up_proj": QuantizedLinear.fp(h4[inter:]),
            "down_proj": QuantizedLinear.fp(get(f"{p}.mlp.dense_4h_to_h.weight")),
        })
    return Model(config=cfg, params=params, family="chatglm")
