from .device import resolve_device
from .qparams import QRange, qrange

__all__ = ["QRange", "qrange", "resolve_device"]
