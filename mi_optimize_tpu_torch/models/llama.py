"""Functional Llama-family model over plain dicts of tensors.

Port of mi_optimize_tpu/models/llama.py: every linear is a QuantizedLinear,
the rotary embedding uses the HF split-half convention (or the ChatGLM-style
interleaved / partial one by config), GQA repeats kv heads, and the int8 KV
cache holds per-(token, head) absmax scales.

Differences from the reference:
  * caches are updated in place (the reference returns fresh functional
    arrays); `block_apply` still returns the cache it wrote;
  * the decode-attention (ops.decode_attention) and fused-MLP
    (ops.mlp_fused) branches, which the reference takes on a TPU backend,
    are taken where the block's tensors are on CUDA (`kernel_branches`);
    on CPU tensors the stock path runs, as the reference's does on a CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .quant_linear import QuantizedLinear, quant_linear_apply

ATTN_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_LINEARS = ("gate_proj", "up_proj", "down_proj")
ALL_LINEARS = ATTN_LINEARS + MLP_LINEARS
GROUP_ORDER: Tuple[Tuple[str, ...], ...] = (
    ("k_proj", "v_proj", "q_proj"),
    ("o_proj",),
    ("up_proj", "gate_proj"),
    ("down_proj",),
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    attn_bias: bool = False
    rotary_dim: int = -1     # -1 => full head_dim
    rope_interleaved: bool = False

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama2_7b(cls):
        return cls()


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random-init fp params with model-shaped tensors."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=dev, dtype=torch.float32)

    def lin(out_f, in_f, bias=False):
        w = (randn(out_f, in_f) * (in_f ** -0.5)).to(dtype)
        b = torch.zeros(out_f, dtype=dtype, device=dev) if bias else None
        return QuantizedLinear.fp(w, b)

    h, q_dim = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "input_norm": torch.ones(h, dtype=dtype, device=dev),
            "post_norm": torch.ones(h, dtype=dtype, device=dev),
            "q_proj": lin(q_dim, h, cfg.attn_bias),
            "k_proj": lin(kv_dim, h, cfg.attn_bias),
            "v_proj": lin(kv_dim, h, cfg.attn_bias),
            "o_proj": lin(h, q_dim),
            "gate_proj": lin(cfg.intermediate_size, h),
            "up_proj": lin(cfg.intermediate_size, h),
            "down_proj": lin(h, cfg.intermediate_size),
        })
    params = {
        "embed": (randn(cfg.vocab_size, h) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(cfg.vocab_size, h)
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*, rotary_dim] for the given positions (float32)."""
    rd = cfg.rotary_dim if cfg.rotary_dim > 0 else cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, rd, 2) / rd))
    inv = torch.as_tensor(inv_freq.astype(np.float32), device=positions.device)
    freqs = positions.to(torch.float32)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin, cfg: LlamaConfig):
    """x: [..., seq, heads, head_dim]; cos/sin: [seq, rotary_dim] (broadcast)."""
    rd = cfg.rotary_dim if cfg.rotary_dim > 0 else x.shape[-1]
    xr, x_pass = x[..., :rd], x[..., rd:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    half = rd // 2
    if cfg.rope_interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        ch, sh = c[..., :half], s[..., :half]
        rot = torch.stack([x1 * ch - x2 * sh, x2 * ch + x1 * sh], dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = xr * c + torch.cat([-x2, x1], dim=-1) * s
    if x_pass.shape[-1]:
        rot = torch.cat([rot.to(x.dtype), x_pass], dim=-1)
    return rot.to(x.dtype)


def attention(q, k, v, mask, cfg: LlamaConfig):
    """q:[B,S,Hq,D] k,v:[B,T,Hkv,D]; GQA by head repetition. mask bool,
    broadcast against scores [B,H,S,T]."""
    reps = cfg.num_heads // cfg.num_kv_heads
    if reps > 1:
        k = torch.repeat_interleave(k, reps, dim=2)
        v = torch.repeat_interleave(v, reps, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), k.to(torch.float32))
    scores = scores / np.sqrt(cfg.head_dim)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.to(torch.float32), v.to(torch.float32))
    return out.to(v.dtype)


# The int8 KV scale is amax * f32(1/127): the reference writes amax / 127.0,
# and XLA lowers a division by that constant to a multiply by its f32
# reciprocal (on the CPU, jitted and inside the interpret-mode kernels; one
# ulp off the true quotient for about 5% of heads).
KV_RCP = 1.0 / 127.0


def quantize_kv(x: torch.Tensor):
    """Per-(batch, token, head) symmetric int8 quantization of a K/V slab
    [B, S, H, D] -> (int8 values, f32 scales [B, S, H])."""
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1), min=1e-8)
    scale = amax * KV_RCP
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _upd(buf: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write `new` [B,S,...] into `buf` at time index `idx`, in place: a
    scalar writes every batch row at the same index; a vector [B] writes row
    b at idx[b] (the per-slot positions of continuous batching).

    As the reference's dynamic_update_slice, a start outside [0, T - S] is
    clamped into it (so the S rows always land inside the buffer)."""
    S, T = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if isinstance(idx, torch.Tensor) and idx.ndim > 0:
        start = torch.clamp(idx.reshape(-1).to(torch.long), 0, T - S)
        rows = start[:, None] + torch.arange(S, device=start.device)            # [B, S]
        buf[torch.arange(buf.shape[0], device=buf.device)[:, None], rows.to(buf.device)] = new
        return buf
    i = min(max(int(idx), 0), T - S)
    buf[:, i:i + S] = new
    return buf


def kernel_branches(x: torch.Tensor) -> bool:
    """Whether `block_apply` takes the reference's TPU-only branches (decode
    attention, fused MLP): on CUDA tensors. Tests force it to run the plain
    versions through the branches on the CPU."""
    return x.is_cuda


def block_apply(
    blk: Dict[str, Any],
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    cfg: LlamaConfig,
    kv_cache=None,
    cache_index=None,
    capture: bool = False,
    fused: bool = True,
):
    """One transformer block. Returns (out, kv_cache, captures); `captures`
    maps each linear name to the activation that enters it."""
    caps: Dict[str, torch.Tensor] = {}
    B, S, _ = x.shape
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim

    # decode megakernel: the whole block in one launch (ops/block_fused.py);
    # B = 1 with a scalar position only, as in the reference
    if (fused and not capture and "mega" in blk and B == 1 and S == 1
            and isinstance(kv_cache, dict)
            and kv_cache["k"].shape[1] % 128 == 0
            and not (isinstance(cache_index, torch.Tensor) and cache_index.ndim > 0)):
        from ..ops.block_fused import block_decode_mega

        x_out, new_cache = block_decode_mega(
            blk, blk["mega"], x, cos.reshape(-1)[-cfg.head_dim:],
            sin.reshape(-1)[-cfg.head_dim:], kv_cache, int(cache_index), cfg)
        return x_out, new_cache, caps

    h = rms_norm(x, blk["input_norm"], cfg.rms_eps)
    if capture:
        caps["q_proj"] = caps["k_proj"] = caps["v_proj"] = h
    if "qkv_proj" in blk:
        qkv = quant_linear_apply(blk["qkv_proj"], h, fused=fused)
        q = qkv[..., :q_dim]
        k = qkv[..., q_dim:q_dim + kv_dim]
        v = qkv[..., q_dim + kv_dim:]
    else:
        q = quant_linear_apply(blk["q_proj"], h, fused=fused)
        k = quant_linear_apply(blk["k_proj"], h, fused=fused)
        v = quant_linear_apply(blk["v_proj"], h, fused=fused)
    # decode attention of one token: rope, int8 cache append and attention in
    # one launch (ops/decode_attention.py)
    if (fused and not capture and S == 1 and B == 1 and isinstance(kv_cache, dict)
            and cfg.rotary_dim in (-1, cfg.head_dim) and not cfg.rope_interleaved
            and not (isinstance(cache_index, torch.Tensor) and cache_index.ndim > 0)
            and kernel_branches(x)):
        from ..ops.decode_attention import fused_decode_attention

        attn, _, _, _, _ = fused_decode_attention(
            q.reshape(1, -1), k.reshape(1, -1), v.reshape(1, -1), cos.reshape(-1)[-cfg.head_dim:],
            sin.reshape(-1)[-cfg.head_dim:], kv_cache["k"][0], kv_cache["v"][0],
            kv_cache["k_scale"][0], kv_cache["v_scale"][0], int(cache_index),
            n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            max_len=kv_cache["k"].shape[1])
        attn = attn.reshape(B, S, q_dim).to(x.dtype)
        x = x + quant_linear_apply(blk["o_proj"], attn, fused=fused)
        return _mlp_tail(blk, x, cfg, caps, capture, fused), kv_cache, caps

    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin, cfg)
    k = apply_rope(k, cos, sin, cfg)

    if isinstance(kv_cache, dict):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        _upd(kv_cache["k"], kq, cache_index)
        _upd(kv_cache["v"], vq, cache_index)
        _upd(kv_cache["k_scale"], ks, cache_index)
        _upd(kv_cache["v_scale"], vs, cache_index)
        k_all = (kv_cache["k"].to(torch.float32) * kv_cache["k_scale"][..., None]).to(q.dtype)
        v_all = (kv_cache["v"].to(torch.float32) * kv_cache["v_scale"][..., None]).to(q.dtype)
        new_cache = kv_cache
    elif kv_cache is not None:
        ck, cv = kv_cache
        _upd(ck, k, cache_index)
        _upd(cv, v, cache_index)
        k_all, v_all = ck, cv
        new_cache = (ck, cv)
    else:
        k_all, v_all = k, v
        new_cache = None

    attn = attention(q, k_all.to(q.dtype), v_all.to(q.dtype), mask, cfg)
    attn = attn.reshape(B, S, q_dim)
    if capture:
        caps["o_proj"] = attn
    x = x + quant_linear_apply(blk["o_proj"], attn, fused=fused)
    return _mlp_tail(blk, x, cfg, caps, capture, fused), new_cache, caps


def _mlp_tail(blk, x, cfg: LlamaConfig, caps, capture: bool, fused: bool):
    if fused and not capture and "gate_proj" in blk and kernel_branches(x):
        from ..ops.mlp_fused import mlp_apply_fused, mlp_supported

        gate, up, down = blk["gate_proj"], blk["up_proj"], blk["down_proj"]
        if mlp_supported(gate, up, down, cfg.hidden_size, cfg.intermediate_size):
            # the whole SwiGLU MLP in one launch (ops/mlp_fused.py)
            h = rms_norm(x, blk["post_norm"], cfg.rms_eps)
            return x + mlp_apply_fused(h, gate, up, down, cfg).to(x.dtype)
    h = rms_norm(x, blk["post_norm"], cfg.rms_eps)
    if capture:
        caps["gate_proj"] = caps["up_proj"] = h
    if "gateup_proj" in blk:
        gu = quant_linear_apply(blk["gateup_proj"], h, fused=fused)
        gate = gu[..., :cfg.intermediate_size]
        up = gu[..., cfg.intermediate_size:]
    else:
        gate = quant_linear_apply(blk["gate_proj"], h, fused=fused)
        up = quant_linear_apply(blk["up_proj"], h, fused=fused)
    act = torch.nn.functional.silu(gate) * up
    if capture:
        caps["down_proj"] = act
    return x + quant_linear_apply(blk["down_proj"], act, fused=fused)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool, device=device))


def embed(params, input_ids):
    return params["embed"][input_ids]


def unembed(params, cfg: LlamaConfig, h, fused=True):
    if cfg.tie_embeddings:
        return h @ params["embed"].t().to(h.dtype)
    return quant_linear_apply(params["lm_head"], h, fused=fused)


def forward(params, cfg: LlamaConfig, input_ids: torch.Tensor, fused: bool = True):
    """Full forward: input_ids [B,S] -> logits [B,S,V] (prefill / eval path)."""
    B, S = input_ids.shape
    x = embed(params, input_ids)
    cos, sin = rope_tables(cfg, torch.arange(S, device=x.device))
    mask = causal_mask(S, x.device)
    for blk in params["layers"]:
        x, _, _ = block_apply(blk, x, cos, sin, mask, cfg, fused=fused)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x, fused=fused)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -100):
    """Token-mean NLL over shifted (logits[:, :-1], labels[:, 1:]); returns
    (loss, count)."""
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = labels[:, 1:]
    valid = tgt != ignore
    tgt_safe = torch.where(valid, tgt, torch.zeros_like(tgt))
    nll = -torch.gather(lp, -1, tgt_safe[..., None].to(torch.long))[..., 0]
    count = valid.sum()
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / torch.clamp(count, min=1)
    return loss, count
