"""The benchmark's yardstick: operations and bytes of the work, and the peaks.

Counted from a configuration's shapes and the rows' positions, never read
from the program. Each input byte is counted once and each output byte once,
whatever an implementation reads again; attention counts the live rows a
query needs (causal), not a padded tile. The packed weights are as the
configuration states them: `wbit`-bit codes and one f32 scale a group (a
symmetric grid has no zero table).

Peaks: one NVIDIA H100 SXM, dense, at its full 700 W (NVIDIA's data sheet):
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Cost:
    flops: float
    bytes: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def seconds(self) -> float:
        """The least time the chip could take: the larger of the two bounds."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


class Shapes:
    """The widths of one configuration file (its published keys)."""

    def __init__(self, cfg: dict):
        q = cfg["quantization"]
        self.h = cfg["hidden_size"]
        self.inter = cfg["intermediate_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.d = self.h // self.heads
        self.vocab = cfg["vocab_size"]
        self.wbit = q["wbit"]
        self.group = q["group_size"]
        self.q_dim = self.heads * self.d
        self.kv_dim = self.kv_heads * self.d

    def weight_bytes(self, k: int, n: int) -> float:
        """Packed codes and f32 group scales of a [k -> n] linear."""
        return k * n * self.wbit / 8 + (k // self.group) * n * F32

    def layer_linears(self):
        """(k, n) of each decoder linear of one layer."""
        h, i = self.h, self.inter
        return [(h, self.q_dim), (h, self.kv_dim), (h, self.kv_dim), (self.q_dim, h),
                (h, i), (h, i), (i, h)]

    def layer_params(self) -> int:
        return sum(k * n for k, n in self.layer_linears())

    def decoder_weight_bytes(self) -> float:
        """Every layer's packed linears and its two bf16 norm weights."""
        per = sum(self.weight_bytes(k, n) for k, n in self.layer_linears()) + 2 * self.h * BF16
        return self.layers * per

    def lm_head_bytes(self) -> float:
        """The packed lm_head and the final norm."""
        return self.weight_bytes(self.h, self.vocab) + self.h * BF16

    def kv_row_bytes(self) -> float:
        """One token's int8 K and V rows and their f32 scales, all layers."""
        return self.layers * 2 * self.kv_heads * (self.d + F32)

    def attn_flops(self, n_keys: float) -> float:
        """QK^T and PV of one query over n_keys keys, all layers and heads."""
        return self.layers * 4.0 * self.heads * self.d * n_keys


def linear_cost(m: int, k: int, n: int, s: Shapes) -> Cost:
    """One [m, k] x [k -> n] product: bf16 x in, bf16 y out."""
    return Cost(2.0 * m * k * n, s.weight_bytes(k, n) + m * k * BF16 + m * n * BF16)


def mlp_cost(m: int, s: Shapes) -> Cost:
    """The whole SwiGLU MLP of one layer on m rows: x in, y out; the gate and
    up activations need not leave the chip."""
    w = 2 * s.weight_bytes(s.h, s.inter) + s.weight_bytes(s.inter, s.h)
    return Cost(6.0 * m * s.h * s.inter, w + 2 * m * s.h * BF16)


def batch_kernel_cost(positions: Sequence[int], s: Shapes) -> Cost:
    """One launch of the batched whole-model decode kernel (no lm_head): the
    decoder's weights once for all its rows; each distinct row reads its
    history (positions 0 .. p - 1) and writes its new row at p."""
    rows = len(positions)
    live = sum(p + 1 for p in positions)
    kv = live * s.kv_row_bytes()
    x = 2 * rows * s.h * BF16
    flops = 2.0 * rows * s.layers * s.layer_params() + s.attn_flops(live)
    return Cost(flops, s.decoder_weight_bytes() + kv + x)


def decode_step_cost(positions: Sequence[int], s: Shapes) -> Cost:
    """One scheduler step: every active row's next token, the weights and
    the lm_head once for all rows, whatever the number of launches."""
    rows = len(positions)
    k = batch_kernel_cost(positions, s)
    lm = Cost(2.0 * rows * s.h * s.vocab, s.lm_head_bytes() + rows * s.vocab * BF16)
    return k + lm


def prefill_cost(n: int, s: Shapes) -> Cost:
    """One prompt of n tokens: causal attention, the K/V rows written, the
    first token's logits."""
    flops = (2.0 * n * s.layers * s.layer_params() + s.attn_flops(n * (n + 1) / 2)
             + 2.0 * s.h * s.vocab)
    byts = (s.decoder_weight_bytes() + s.lm_head_bytes() + n * s.h * BF16
            + n * s.kv_row_bytes() + s.vocab * BF16)
    return Cost(flops, byts)


def prefill_gemms(n: int, s: Shapes) -> List[Cost]:
    """Each tensor-core product of one fused-model prefill of n tokens: per
    layer qkv, o, gate+up and down at m = n (the lm_head's single row takes
    another kernel)."""
    h, i = s.h, s.inter
    per = [linear_cost(n, h, s.q_dim + 2 * s.kv_dim, s), linear_cost(n, s.q_dim, h, s),
           linear_cost(n, h, 2 * i, s), linear_cost(n, i, h, s)]
    return per * s.layers


def ppl_gemms(batch: int, n: int, s: Shapes) -> List[Cost]:
    """Each tensor-core product of one unfused-model loss batch: per layer
    q, k, v, o and the fused MLP at m = batch * n, then the lm_head."""
    m, h = batch * n, s.h
    per = [linear_cost(m, h, s.q_dim, s), linear_cost(m, h, s.kv_dim, s),
           linear_cost(m, h, s.kv_dim, s), linear_cost(m, s.q_dim, h, s), mlp_cost(m, s)]
    return per * s.layers + [linear_cost(m, h, s.vocab, s)]


def ppl_batch_cost(batch: int, n: int, s: Shapes) -> Cost:
    """One loss batch of batch x n tokens: every product, causal attention,
    the logits over the whole vocabulary; the weights read once."""
    m = batch * n
    flops = (2.0 * m * (s.layers * s.layer_params() + s.h * s.vocab)
             + batch * s.attn_flops(n * (n + 1) / 2))
    byts = s.decoder_weight_bytes() + s.lm_head_bytes() + m * s.h * BF16 + m * 8
    return Cost(flops, byts)
