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

    @classmethod
    def tiny_llama(cls, generator=None, device=None, **kw):
        from .llama import init_params

        cfg = LlamaConfig.tiny(**kw)
        return cls(config=cfg, params=init_params(cfg, generator, device=device),
                   family="llama")
