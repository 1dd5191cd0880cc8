"""Memory/residency management: device <-> host <-> disk value placement.

Port of mi_optimize_tpu/memory.py: `clear_mem`, `live_device_bytes`,
`show_memory`, the `Memory` value wrapper with device / host / disk
residency and the `MEMORY_BANK` registry with its temporary spill directory.
"device" is the resolved device ("cuda" unless the caller asks for the CPU),
"host" a CPU tensor, "disk" an `.npy` spill. Every dtype round-trips bit for
bit: bf16 and fp8, which numpy lacks, spill as their integer bits and come
back as the dtype they were.
"""
from __future__ import annotations

import gc
import os
import tempfile
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from .core.device import resolve_device

# torch dtypes numpy lacks -> the integer dtype of the same width their bits
# spill as (here) and are stored as (export/checkpoint.py)
BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
        torch.float8_e5m2: torch.uint8}


def clear_mem(clear_jit_cache: bool = False) -> None:
    """Drop python garbage; with clear_jit_cache, also return the card's
    cached free blocks to CUDA (the name is the reference's)."""
    gc.collect()
    if clear_jit_cache and torch.cuda.is_available():
        torch.cuda.empty_cache()


def live_device_bytes(device=None) -> int:
    """Bytes of live tensors on the device (0 on the CPU)."""
    try:
        dev = resolve_device(device)
    except RuntimeError:
        return 0
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(dev))


def show_memory(prefix: str = "") -> str:
    s = f"{prefix}device bytes_in_use={live_device_bytes()/1e9:.2f}GB"
    return s


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


class Memory:
    """A value with explicit residency: 'device' | 'host' | 'disk'."""

    def __init__(self, value, desc: str = "host", spill_dir: Optional[str] = None, device=None):
        self._spill_dir = spill_dir or tempfile.gettempdir()
        self._device = device
        self._path: Optional[str] = None
        self._dtype: Optional[torch.dtype] = None
        self._value = None
        self.desc = "host"
        value = _as_tensor(value)
        self._set(value, "host" if value.device.type == "cpu" else "device")
        if desc != self.desc:
            self.to(desc)

    def _set(self, value, desc):
        self._value = value
        self.desc = desc

    @property
    def value(self):
        if self.desc == "disk":
            t = torch.from_numpy(np.load(self._path))
            return t.view(self._dtype) if self._dtype in BITS else t
        return self._value

    def to(self, desc: str) -> "Memory":
        if desc == self.desc:
            return self
        val = self.value
        if desc == "device":
            self._set(val.to(resolve_device(self._device)), "device")
        elif desc == "host":
            self._set(val.cpu(), "host")
        elif desc == "disk":
            path = os.path.join(self._spill_dir, f"mi_tpu_{uuid.uuid4().hex}.npy")
            t = val.detach().cpu().contiguous()
            self._dtype = t.dtype
            np.save(path, (t.view(BITS[t.dtype]) if t.dtype in BITS else t).numpy())
            self._path = path
            self._set(None, "disk")
        else:
            raise ValueError(f"unknown residency {desc!r}")
        if desc != "disk" and self._path:
            try:
                os.remove(self._path)
            except OSError:
                pass
            self._path = None
        return self

    def delete(self):
        if self._path:
            try:
                os.remove(self._path)
            except OSError:
                pass
        self._value = None


class MemoryBank:
    """Named registry of Memory values with a shared spill directory."""

    def __init__(self):
        self._dir = tempfile.mkdtemp(prefix="mi_tpu_bank_")
        self._values: Dict[str, Memory] = {}

    def add_value(self, name: str, value, desc: str = "host", device=None) -> Memory:
        m = Memory(value, desc=desc, spill_dir=self._dir, device=device)
        self._values[name] = m
        return m

    def get(self, name: str) -> Memory:
        return self._values[name]

    def pop(self, name: str):
        m = self._values.pop(name)
        m.delete()

    def clear(self):
        for m in self._values.values():
            m.delete()
        self._values.clear()


MEMORY_BANK = MemoryBank()
