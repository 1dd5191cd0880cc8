"""Parameters of the JAX package, as nested dicts of numpy arrays, to the port's.

`from_jax_params(tree, cfg)` takes the reference model's params pytree
exported to plain Python: dicts and lists as they are, arrays as numpy
arrays, and every QuantizedLinear leaf as a dict with `spec` (a dict of the
QuantSpec fields), `out_features`, `in_features`, `weight`, `packed`,
`w_scale`, `w_zero`, `bias`, `perm`, `smooth_factor`, `a_scale` and `a_zero`
(absent or None where unused). Packed uint32 words come over bit-identical,
as their int32 bit-view. A block's `"mega"` entry (the reference's TPU kernel
layout) is dropped: the port's serving.optimize.fuse_for_serving builds its
own.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .models.quant_linear import QuantizedLinear, QuantSpec

_ARRAY_FIELDS = ("weight", "packed", "w_scale", "w_zero", "bias", "perm", "smooth_factor",
                 "a_scale", "a_zero")


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def linear_from_jax(d, dev) -> QuantizedLinear:
    fields = {k: (None if d.get(k) is None else _tensor(d[k], dev)) for k in _ARRAY_FIELDS}
    return QuantizedLinear(spec=QuantSpec(**d["spec"]), out_features=int(d["out_features"]),
                           in_features=int(d["in_features"]), **fields)


def _convert(node, dev):
    if isinstance(node, dict):
        if "spec" in node and "out_features" in node:
            return linear_from_jax(node, dev)
        return {k: _convert(v, dev) for k, v in node.items() if k != "mega"}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dev) for v in node]
    return _tensor(node, dev)


def from_jax_params(tree, cfg, device=None):
    """The port's params dict for `cfg` on `device` (default "cuda")."""
    dev = resolve_device(device)
    params = _convert(tree, dev)
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} layers for a config of {cfg.num_layers}")
    return params
