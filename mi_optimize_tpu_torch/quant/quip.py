"""QuIP: incoherence-processed quantization with LDL rounding.

Port of mi_optimize_tpu/quant/quip.py; the algorithm is in quip_impl.py.
"""
from __future__ import annotations

from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, register_algo
from .quip_impl import quip_quantize_linear


@register_algo("quip")
class QuIPAlgo(BaseAlgo):
    stats = ("xtx",)

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        return quip_quantize_linear(self.cfg, lin, stats)
