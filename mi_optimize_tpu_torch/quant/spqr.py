"""SpQR: GPTQ-style loop + unstructured fp outliers + double-quantized qparams.

Port of mi_optimize_tpu/quant/spqr.py; the algorithm is in spqr_impl.py.
"""
from __future__ import annotations

from ..models.quant_linear import QuantizedLinear
from .base import BaseAlgo, register_algo
from .spqr_impl import spqr_quantize_linear


@register_algo("spqr")
class SpQRAlgo(BaseAlgo):
    stats = ("xtx",)

    def quantize_linear(self, lin: QuantizedLinear, stats) -> QuantizedLinear:
        return spqr_quantize_linear(self.cfg, lin, stats)
