"""Model bundle: (family, config, params), the unit the public API passes around."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .llama import LlamaConfig


@dataclasses.dataclass
class Model:
    config: Any
    params: Dict[str, Any]
    family: str = "llama"

    def on(self, device=None) -> "Model":
        """This model with its tensors on `device` ("cuda" unless the caller
        asks for the CPU, core.device.resolve_device): itself when they are
        there, else a copy of its params tree moved there."""
        from ..core.device import resolve_device
        from ..quant.calibrate import to_device

        dev = resolve_device(device)
        if self.params["embed"].device == dev:
            return self
        return Model(config=self.config, params=to_device(self.params, dev), family=self.family)

    @classmethod
    def tiny_llama(cls, generator=None, device=None, **kw):
        from .llama import init_params

        cfg = LlamaConfig.tiny(**kw)
        return cls(config=cfg, params=init_params(cfg, generator, device=device),
                   family="llama")
