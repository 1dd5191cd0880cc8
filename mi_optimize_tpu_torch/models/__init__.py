from .llama import LlamaConfig
from .model import Model
from .quant_linear import QuantizedLinear, QuantSpec, quant_linear_apply

__all__ = ["LlamaConfig", "Model", "QuantizedLinear", "QuantSpec", "quant_linear_apply"]
