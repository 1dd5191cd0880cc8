from .api import quantize  # noqa: F401
from .base import get_algo  # noqa: F401
from .config import CalibrationConfig, QuantConfig  # noqa: F401
