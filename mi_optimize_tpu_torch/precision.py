"""Precision system: bit-width enum + string/int conversions.

A copy of mi_optimize_tpu/precision.py (stdlib only): the user-facing dtype
strings ('int4', 'float16', ...) map onto one enum whose value is the
bit-width used by every quantizer.
"""
from __future__ import annotations

import enum


class Precision(enum.IntEnum):
    """Bit-widths supported by the framework.

    The enum *value* is the bit-width (FP dtypes use their storage width).
    """

    BINARY = 1
    INT2 = 2
    INT3 = 3
    INT4 = 4
    INT5 = 5
    INT6 = 6
    INT7 = 7
    INT8 = 8
    FP8_E4M3 = 9   # distinct tags; bits() reports 8
    FP8_E5M2 = 10
    BF16 = 16
    FP16 = 17
    FP32 = 32

    @property
    def bits(self) -> int:
        if self in (Precision.FP8_E4M3, Precision.FP8_E5M2):
            return 8
        if self is Precision.FP16:
            return 16
        return int(self.value)

    @property
    def is_float(self) -> bool:
        return self in (
            Precision.FP8_E4M3,
            Precision.FP8_E5M2,
            Precision.BF16,
            Precision.FP16,
            Precision.FP32,
        )

    @property
    def is_int(self) -> bool:
        return not self.is_float


_STR_TO_PRECISION = {
    "binary": Precision.BINARY,
    "int2": Precision.INT2,
    "int3": Precision.INT3,
    "int4": Precision.INT4,
    "int5": Precision.INT5,
    "int6": Precision.INT6,
    "int7": Precision.INT7,
    "int8": Precision.INT8,
    "fp8": Precision.FP8_E4M3,
    "fp8_e4m3": Precision.FP8_E4M3,
    "fp8_e5m2": Precision.FP8_E5M2,
    "bfloat16": Precision.BF16,
    "float16": Precision.FP16,
    "float32": Precision.FP32,
}

_INT_TO_PRECISION = {
    1: Precision.BINARY,
    2: Precision.INT2,
    3: Precision.INT3,
    4: Precision.INT4,
    5: Precision.INT5,
    6: Precision.INT6,
    7: Precision.INT7,
    8: Precision.INT8,
    16: Precision.FP16,
    32: Precision.FP32,
}


def as_precision(p) -> Precision:
    """Normalize a user-facing dtype spec (str | int | Precision) to Precision."""
    if isinstance(p, Precision):
        return p
    if isinstance(p, str):
        key = p.lower()
        if key not in _STR_TO_PRECISION:
            raise ValueError(f"unknown precision {p!r}; one of {sorted(_STR_TO_PRECISION)}")
        return _STR_TO_PRECISION[key]
    if isinstance(p, int):
        if p not in _INT_TO_PRECISION:
            raise ValueError(f"unknown precision bit-width {p}")
        return _INT_TO_PRECISION[p]
    raise TypeError(f"cannot interpret {p!r} as a Precision")
