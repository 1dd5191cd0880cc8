"""AWQ: activation-aware weight quantization (grid-searched smoothing + clip).

Port of mi_optimize_tpu/quant/awq.py; the searches are in awq_impl.py.
"""
from __future__ import annotations

from ..models.quant_linear import QuantizedLinear
from .awq_impl import awq_quantize_linear
from .base import BaseAlgo, register_algo


@register_algo("awq")
class AWQAlgo(BaseAlgo):
    stats = ("inputs", "absmean")

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        return awq_quantize_linear(self.cfg, lin, stats)
