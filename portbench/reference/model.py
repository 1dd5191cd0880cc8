"""Plain PyTorch reference of the configurations' decoder, in float32.

A Llama-family decoder as the published models define it: RMSNorm, rotary
embeddings (HF's split-half form), grouped-query attention (multi-head when
the key/value heads equal the heads), a SwiGLU MLP, a final norm and an
untied lm_head. Every linear holds the seed's float weight (portbench.weights,
the inputs both sides are handed) quantized here to the configuration's
symmetric int4 grid with one scale a group of 128 inputs. Where the path
being judged keeps a cache (`kv_cache=True`: serving), the K and V rows go
through the configuration's int8 cache (one absmax scale a token and head)
before attention reads them; a whole-sequence evaluation keeps none.
Everything else is float32 with TF32 off.

This module imports nothing of the program under test. It runs layer by
layer over all the sequences it is given, drawing each layer's weights as it
reaches it, so that it fits beside what the run has left on the card.

`act="fp8"` or `act="int8"` is a control: the same model with every decoder
linear's input quantized to float8 e4m3 or to int8, one absmax scale a
token (the steps below the configuration's bfloat16 activations).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import weights
from .compare import served_gaps

QUERY_BLOCK = 512
LOGIT_ROWS = 512


def exact_matmul() -> None:
    """Float32 products in float32: no TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_weight(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Symmetric per-group fake-quantization of w [out, in]: scale = the
    group's absmax / (2**(bits-1) - 1), codes rounded half to even and
    clipped to [-2**(bits-1), 2**(bits-1) - 1]."""
    qmax = 2 ** (bits - 1) - 1
    g = w.reshape(-1, group)
    scale = torch.clamp(g.abs().amax(dim=1, keepdim=True) / qmax, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -qmax - 1, qmax)
    return (q * scale).reshape(w.shape)


def quantize_tokens(x: torch.Tensor, act: str) -> torch.Tensor:
    """Per-row fake-quantization of activations x [n, k], one absmax scale a
    row: symmetric int8, or float8 e4m3 (absmax at its largest value, 448)."""
    if act == "int8":
        scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127, min=1e-12)
        return torch.clamp(torch.round(x / scale), -128, 127) * scale
    if act == "fp8":
        scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 448, min=1e-12)
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"activations {act!r}: int8 or fp8")


def int8_cache(x: torch.Tensor) -> torch.Tensor:
    """The int8 cache's round trip of K or V rows [t, heads, d]: one absmax
    scale a (token, head), codes in [-127, 127]."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """HF rotary embedding of x [t, heads, d] at positions 0 .. t - 1; the
    angles in float64."""
    t, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos().to(x.dtype)[:, None], emb.sin().to(x.dtype)[:, None]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q [t, heads, d] over k, v [t, kv_heads, d], in
    blocks of queries; returns [t, heads * d]."""
    t, heads, d = q.shape
    reps = heads // k.shape[1]
    if reps > 1:
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    kt = k.permute(1, 2, 0)                      # [heads, d, t]
    vh = v.permute(1, 0, 2)                      # [heads, t, d]
    out = torch.empty(t, heads, d, dtype=q.dtype, device=q.device)
    for a in range(0, t, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, t)
        s = torch.matmul(q[a:b].permute(1, 0, 2), kt[:, :, :b]) / d ** 0.5   # [heads, b-a, b]
        mask = torch.arange(b, device=q.device)[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1), vh[:, :b]).permute(1, 0, 2)
    return out.reshape(t, heads * d)


class Reference:
    """The configuration's model from the seed, run over whole sequences."""

    def __init__(self, cfg: dict, seed: int, device, kv_cache: bool,
                 act: Optional[str] = None):
        self.cfg = cfg
        self.seed = seed
        self.device = torch.device(device)
        self.kv_cache = kv_cache
        self.act = act
        q = cfg["quantization"]
        self.bits, self.group = q["wbit"], q["group_size"]
        self.eps = cfg["rms_norm_eps"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.d = cfg["hidden_size"] // self.heads

    def _lin(self, x: torch.Tensor, w: torch.Tensor, quant_input: bool = True) -> torch.Tensor:
        """x @ w^T, the control's activations quantized first."""
        if self.act is not None and quant_input:
            x = quantize_tokens(x, self.act)
        return x @ w.t()

    def _layer_weights(self, l: int):
        dev = self.device
        w = {n: quantize_weight(weights.linear(self.cfg, self.seed, l, n, dev), self.bits,
                                self.group) for n in weights.LINEARS}
        w["input_norm"] = weights.norm(self.cfg, self.seed, f"layers.{l}.input_norm", dev).float()
        w["post_norm"] = weights.norm(self.cfg, self.seed, f"layers.{l}.post_norm", dev).float()
        return w

    @torch.no_grad()
    def hidden(self, seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The final-normed hidden rows [len, hidden] of each token-id
        sequence, each sequence from position 0."""
        exact_matmul()
        lens = [int(s.numel()) for s in seqs]
        ids = torch.cat([s.reshape(-1).to(self.device, torch.long) for s in seqs])
        x = weights.embed(self.cfg, self.seed, self.device)[ids].float()
        theta = self.cfg["rope_theta"]
        for l in range(self.cfg["num_hidden_layers"]):
            w = self._layer_weights(l)
            h = rms_norm(x, w["input_norm"], self.eps)
            q, k, v = self._lin(h, w["q_proj"]), self._lin(h, w["k_proj"]), self._lin(h, w["v_proj"])
            att = torch.empty_like(q)
            a = 0
            for n in lens:
                qs = rope(q[a:a + n].reshape(n, self.heads, self.d), theta)
                ks = rope(k[a:a + n].reshape(n, self.kv_heads, self.d), theta)
                vs = v[a:a + n].reshape(n, self.kv_heads, self.d)
                if self.kv_cache:
                    ks, vs = int8_cache(ks), int8_cache(vs)
                att[a:a + n] = attention(qs, ks, vs)
                a += n
            x = x + self._lin(att, w["o_proj"])
            h = rms_norm(x, w["post_norm"], self.eps)
            act = torch.nn.functional.silu(self._lin(h, w["gate_proj"])) * self._lin(h, w["up_proj"])
            x = x + self._lin(act, w["down_proj"])
            del w, h, q, k, v, att, act
        x = rms_norm(x, weights.norm(self.cfg, self.seed, "final_norm", self.device).float(),
                     self.eps)
        return list(torch.split(x, lens))

    def lm_head(self) -> torch.Tensor:
        """The quantized lm_head [vocab, hidden], f32 (weight-only in the
        control too, as calibrated models keep it)."""
        return quantize_weight(weights.lm_head(self.cfg, self.seed, self.device), self.bits,
                               self.group)

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor], starts: Sequence[int]) -> List[torch.Tensor]:
        """f32 logits [len - start, vocab] of each sequence from its `start`."""
        hs = self.hidden(seqs)
        head = self.lm_head()
        return [h[s:] @ head.t() for h, s in zip(hs, starts)]

    @torch.no_grad()
    def token_scores(self, seqs: Sequence[torch.Tensor], picks: Sequence[Sequence[torch.Tensor]] = ()
                     ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
        """Each sequence's per-token NLL [len - 1] of token i + 1 after
        tokens 0 .. i, f32, the logits taken in blocks of rows; and for each
        set in `picks` (one token [len - 1] a position of each sequence, such
        as another model's first choices) the gap of its token below the
        best logit at each position."""
        hs = self.hidden(seqs)
        head = self.lm_head()
        nll, gaps = [], [[] for _ in picks]
        for i, (h, s) in enumerate(zip(hs, seqs)):
            tgt = s.reshape(-1).to(self.device, torch.long)[1:]
            parts, gparts = [], [[] for _ in picks]
            for a in range(0, tgt.numel(), LOGIT_ROWS):
                z = h[a:a + LOGIT_ROWS][: tgt.numel() - a] @ head.t()
                t = tgt[a:a + z.shape[0]]
                parts.append(torch.logsumexp(z, dim=-1) - z.gather(1, t[:, None])[:, 0])
                for j, pk in enumerate(picks):
                    p = pk[i].reshape(-1)[a:a + z.shape[0]].to(self.device, torch.long)
                    gparts[j].append(served_gaps(z, p))
            nll.append(torch.cat(parts))
            for j in range(len(picks)):
                gaps[j].append(torch.cat(gparts[j]))
        return nll, gaps
