"""Typed, validated quantization config: one schema for the API and YAML.

Port of mi_optimize_tpu/quant/config.py, field for field. Unknown keys fail
loudly; `from_dict` takes the reference toolbox's nested form
({quant_config: {algo, kwargs{}, calibrate_config{}}}) and its
nsample/nsamples typo. `from_yaml` imports PyYAML only when it is called.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..precision import Precision, as_precision


@dataclasses.dataclass
class CalibrationConfig:
    """Calibration-set spec (reference: quant_config['calibrate_config'])."""

    name: str = "wikitext2"
    split: str = "train"
    nsamples: int = 128
    seqlen: int = 2048
    seed: int = 0
    # C-Eval/CMMLU subject filter for the OOD experiments ('all'|'hm'|'st'|'ss')
    subject: str = "all"


@dataclasses.dataclass
class QuantConfig:
    algo: str = "rtn"
    wbit: Any = "int4"
    abit: Any = "float16"
    w_qtype: str = "per_channel"
    a_qtype: str = "per_tensor"
    w_groupsize: int = -1
    a_groupsize: int = -1
    w_has_zero: bool = False      # asymmetric weight quant
    a_has_zero: bool = False
    w_unsign: bool = True
    a_unsign: bool = True
    quantization_type: str = "dynamic"   # activation quant: static|dynamic
    block_sequential: bool = False       # propagate quantized outputs block-to-block
    layer_sequential: bool = True
    pack: bool = True                    # produce packed-int weights (vs fake-quant)
    # GPTQ / SpQR / QuIP
    blocksize: int = 128
    percdamp: float = 0.01
    actorder: bool = True
    # GPTQ weight scheme: 'affine' (asymmetric — the reference's
    # torch.per_channel_affine observer default, GPTQQuantizer.py:13) or
    # 'symmetric'. GPTQ-family ignores w_has_zero, like the reference (its
    # **kwarg catch-all swallows it).
    w_qscheme: str = "affine"
    # SmoothQuant
    alpha: float = 0.5
    quant_out: bool = False
    # AWQ
    n_grid: int = 20
    max_shrink: float = 0.5
    clip_batch: int = 256
    # SpQR
    outlier_relative_threshold: float = 0.2
    qq_scale_bits: int = 3
    qq_zero_bits: int = 3
    qq_groupsize: int = 16
    # QuIP ('b' is the reference default, QuIPQuantizer.py:18)
    qfn: str = "b"
    # FP8
    fp8_format: str = "e4m3"
    # which linears to quantize (regex include/exclude like replace_module)
    include: str = r".*"
    exclude: str = r"$^"
    calibrate: CalibrationConfig = dataclasses.field(default_factory=CalibrationConfig)

    def __post_init__(self):
        self.wbit = as_precision(self.wbit)
        self.abit = as_precision(self.abit)
        if self.quantization_type not in ("static", "dynamic"):
            raise ValueError(f"quantization_type must be static|dynamic, got {self.quantization_type}")
        if self.w_qscheme not in ("affine", "symmetric"):
            raise ValueError(f"w_qscheme must be affine|symmetric, got {self.w_qscheme}")

    @property
    def quantize_weights(self) -> bool:
        return self.wbit not in (Precision.FP16, Precision.FP32, Precision.BF16)

    @property
    def quantize_acts(self) -> bool:
        return self.abit not in (Precision.FP16, Precision.FP32, Precision.BF16)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantConfig":
        d = dict(d)
        # accept the reference's nesting {quant_config: {algo, kwargs{}, calibrate_config{}}}
        if "quant_config" in d:
            d = dict(d["quant_config"])
        kwargs = d.pop("kwargs", {})
        calib = d.pop("calibrate_config", d.pop("calibrate", {}))
        merged = {**d, **kwargs}
        # tolerate the reference configs' nsample/nsamples typo (SURVEY.md §5.6)
        if isinstance(calib, dict) and "nsample" in calib:
            calib["nsamples"] = calib.pop("nsample")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(merged) - known - {"model_type"}
        if unknown:
            raise ValueError(f"unknown quant config keys: {sorted(unknown)}")
        merged.pop("model_type", None)
        cfg = cls(**{k: v for k, v in merged.items() if k != "calibrate"})
        if isinstance(calib, dict):
            ck = {f.name for f in dataclasses.fields(CalibrationConfig)}
            bad = set(calib) - ck
            if bad:
                raise ValueError(f"unknown calibrate_config keys: {sorted(bad)}")
            cfg.calibrate = CalibrationConfig(**calib)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "QuantConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))
