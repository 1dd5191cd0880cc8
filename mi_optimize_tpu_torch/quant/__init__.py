from .api import quantize  # noqa: F401
from .base import get_algo  # noqa: F401
from .config import CalibrationConfig, QuantConfig  # noqa: F401
# the algorithm modules register themselves on import, as in the reference
from . import awq, combos, fp8, gptq, quip, rtn, smoothquant, spqr, zeroquant  # noqa: F401,E402
