"""JAX params -> port params (mi_optimize_tpu_torch.convert), and the helpers
the other port tests use to run one model through both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from mi_optimize_tpu.models.llama import LlamaConfig as JLlamaConfig
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.models.quant_linear import QuantizedLinear as JQuantizedLinear
from mi_optimize_tpu_torch.convert import from_jax_params
from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.model import Model
from tests.test_block_fused import _mk_cfg, _mk_params

_FIELDS = ("weight", "packed", "w_scale", "w_zero", "bias", "perm", "smooth_factor",
           "a_scale", "a_zero")


def jax_tree(node):
    """A JAX params pytree as nested dicts/lists of numpy arrays, each
    QuantizedLinear as the dict `from_jax_params` takes."""
    if isinstance(node, JQuantizedLinear):
        d = {k: (None if getattr(node, k) is None else np.asarray(getattr(node, k)))
             for k in _FIELDS}
        d["spec"] = {f.name: getattr(node.spec, f.name)
                     for f in dataclasses.fields(node.spec)}
        d["out_features"], d["in_features"] = node.out_features, node.in_features
        return d
    if isinstance(node, dict):
        return {k: jax_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [jax_tree(v) for v in node]
    return np.asarray(node)


def port_config(jcfg: JLlamaConfig) -> LlamaConfig:
    return LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def port_model(jmodel: JModel) -> Model:
    cfg = port_config(jmodel.config)
    params = from_jax_params(jax_tree(jmodel.params), cfg, device="cpu")
    return Model(config=cfg, params=params, family=jmodel.family)


def small_models(seed=0, bits=4, groupsize=128, **cfg_kw):
    """(JAX model, port model) of the reference tests' aligned small Llama:
    h=512, I=1024, 4 heads, 2 kv heads, D=128, 2 layers, V=128, f32."""
    cfg_kw.setdefault("max_seq_len", 512)
    jcfg = _mk_cfg(**cfg_kw)
    jm = JModel(config=jcfg, params=_mk_params(jcfg, bits=bits, groupsize=groupsize,
                                               seed=seed), family="llama")
    return jm, port_model(jm)


def test_packed_words_bit_identical():
    jm, pm = small_models(seed=1)
    jl = jm.params["layers"][1]["gate_proj"]
    pl = pm.params["layers"][1]["gate_proj"]
    assert pl.packed.dtype == torch.int32
    np.testing.assert_array_equal(pl.packed.numpy().view(np.uint32), np.asarray(jl.packed))
    np.testing.assert_array_equal(pl.w_scale.numpy(), np.asarray(jl.w_scale))
    assert pl.spec.wbit == 4 and pl.spec.w_groupsize == 128 and pl.spec.w_packed
    assert (pl.out_features, pl.in_features) == (jl.out_features, jl.in_features)


def test_layer_count_checked():
    jm, _ = small_models()
    with pytest.raises(ValueError):
        from_jax_params(jax_tree(jm.params), port_config(_mk_cfg(num_layers=3)),
                        device="cpu")


def test_mega_entries_dropped():
    from mi_optimize_tpu.serving import fuse_for_serving

    jm, _ = small_models()
    fused = fuse_for_serving(jm)
    assert "mega" in fused.params["layers"][0]
    params = from_jax_params(jax_tree(fused.params), port_config(jm.config), device="cpu")
    assert "mega" not in params["layers"][0]
    assert params["layers"][0]["qkv_proj"].out_features == 4 * 128 + 2 * 2 * 128
