"""Device policy shared by every entry point of the port.

Entry points take an explicit `device`. It defaults to "cuda"; the CPU is used
only when the caller asks for it (device="cpu", or by handing in CPU tensors).
With no GPU and no explicit CPU request an entry point raises: it never moves
to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
