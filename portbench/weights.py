"""The model's float weights, drawn from the run's seed.

These are the benchmark's inputs: the harness hands them to the port, which
quantizes and packs them, and the reference draws the same floats again and
quantizes them itself. Every tensor has a generator of its own, seeded from
(seed, the tensor's name), so either side can draw any tensor alone and in
any order, and each tensor is one call on the device.
"""
from __future__ import annotations

import hashlib

import torch

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one tensor, from the run's seed and the tensor's name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _gen(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(leaf_seed(seed, name))


def shapes(cfg: dict) -> dict:
    """[out, in] of each decoder linear."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    d = h // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    return {"q_proj": (q, h), "k_proj": (kv, h), "v_proj": (kv, h), "o_proj": (h, q),
            "gate_proj": (inter, h), "up_proj": (inter, h), "down_proj": (h, inter)}


def linear(cfg: dict, seed: int, layer: int, name: str, device) -> torch.Tensor:
    """f32 [out, in]: a normal matrix scaled by in**-0.5."""
    out_f, in_f = shapes(cfg)[name]
    g = _gen(seed, f"layers.{layer}.{name}", device)
    return torch.randn(out_f, in_f, generator=g, device=device) * (in_f ** -0.5)


def norm(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """bf16 [hidden]: an RMSNorm weight, 1 + 0.1 x normal."""
    g = _gen(seed, name, device)
    w = 1.0 + 0.1 * torch.randn(cfg["hidden_size"], generator=g, device=device)
    return w.to(torch.bfloat16)


def embed(cfg: dict, seed: int, device) -> torch.Tensor:
    """bf16 [vocab, hidden], 0.02 x normal."""
    g = _gen(seed, "embed", device)
    e = torch.randn(cfg["vocab_size"], cfg["hidden_size"], generator=g, device=device)
    return (e * 0.02).to(torch.bfloat16)


def lm_head(cfg: dict, seed: int, device) -> torch.Tensor:
    """f32 [vocab, hidden]. With `norm_head` (Baichuan2's NormHead at
    inference) each row is divided by its L2 norm."""
    h = cfg["hidden_size"]
    g = _gen(seed, "lm_head", device)
    w = torch.randn(cfg["vocab_size"], h, generator=g, device=device) * (h ** -0.5)
    if cfg.get("norm_head"):
        w = w / w.norm(dim=1, keepdim=True)
    return w
