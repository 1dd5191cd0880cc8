"""The port's fused MLP (ops/mlp_fused.py) against the JAX package's in
interpret mode, on the gate/up/down of a tiny Llama quantized by the JAX
package's RTN (int4, groups of 32), as tests/test_dequant_matmul.py holds the
JAX kernel against its separate path: the plain version `fused_mlp_ref` and
`mlp_apply_fused` for 3 and 280 rows, and `mlp_supported` equal to the
reference's predicate on supported and unsupported triples.

Tolerances: f32 on both sides with the sums in another order, so outputs to
1e-5 of their scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mi_optimize_tpu as mt
from mi_optimize_tpu.core.qparams import qrange
from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.ops import mlp_fused as jmf
from mi_optimize_tpu.quant.config import QuantConfig
from mi_optimize_tpu_torch.convert import linear_from_jax
from mi_optimize_tpu_torch.ops import mlp_fused as mf
from tests.test_torch_convert import jax_tree, port_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quantized():
    """(JAX cfg, JAX (gate, up, down), port cfg, port (gate, up, down))."""
    cfg = jllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=512, head_dim=32)
    m = JModel(config=cfg, params=jllama.init_params(cfg, jax.random.PRNGKey(0)),
               family="llama")
    qm = mt.quantize(m, QuantConfig(algo="rtn", wbit="int4", w_qtype="per_group",
                                    w_groupsize=32), calib_data=[])
    blk = qm.params["layers"][0]
    jl = tuple(blk[n] for n in ("gate_proj", "up_proj", "down_proj"))
    pl = tuple(linear_from_jax(jax_tree(l), "cpu") for l in jl)
    return cfg, jl, port_config(cfg), pl


def _kernel_args(lins, hidden, inter):
    """The fused_mlp operands in kernel layout, as numpy arrays."""
    gate, up, down = lins
    s = gate.spec
    gk = s.w_groupsize if s.w_qtype == "per_group" else hidden
    ik = down.spec.w_groupsize if down.spec.w_qtype == "per_group" else inter
    out = []
    for lin, n_out, ng in ((gate, inter, hidden // gk), (up, inter, hidden // gk),
                           (down, hidden, inter // ik)):
        sc = np.broadcast_to(np.asarray(lin.w_scale).reshape(-1, ng).T, (ng, n_out))
        z = np.broadcast_to(np.asarray(lin.w_zero).reshape(-1, ng).T, (ng, n_out))
        out += [np.asarray(lin.packed), np.ascontiguousarray(sc), np.ascontiguousarray(z)]
    qmin = qrange(s.wbit, s.w_unsigned).qmin
    return out, dict(bits=s.wbit, k_group=gk, i_group=ik, qmin=qmin, inter=inter, hidden=hidden)


def _port_args(arrays):
    return [torch.from_numpy(np.array(a).view(np.int32) if a.dtype == np.uint32 else np.array(a))
            for a in arrays]


@pytest.mark.parametrize("rows", [3, 280])
def test_fused_mlp_ref_matches_jax_kernel(quantized, rows):
    cfg, jl, _, _ = quantized
    arrays, kw = _kernel_args(jl, cfg.hidden_size, cfg.intermediate_size)
    x = np.random.default_rng(rows).normal(size=(rows, cfg.hidden_size)).astype(np.float32)
    xp = np.pad(x, ((0, (-rows) % 8), (0, 0)))  # the reference kernel takes rows in 8s
    ref = np.asarray(jmf.fused_mlp(jnp.asarray(xp), *(jnp.asarray(a) for a in arrays),
                                   interpret=True, **kw))[:rows]
    before = mf.launches
    got = mf.fused_mlp(torch.from_numpy(x), *_port_args(arrays), **kw)
    assert got.shape == (rows, cfg.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert mf.launches == before


@pytest.mark.parametrize("rows", [3, 280])
def test_mlp_apply_fused_matches_jax(quantized, rows):
    cfg, jl, pcfg, pl = quantized
    x = np.random.default_rng(10 + rows).normal(size=(1, rows, cfg.hidden_size))
    x = x.astype(np.float32)
    assert jmf.mlp_supported(*jl, cfg.hidden_size, cfg.intermediate_size)
    assert mf.mlp_supported(*pl, pcfg.hidden_size, pcfg.intermediate_size)
    ref = np.asarray(jmf.mlp_apply_fused(jnp.asarray(x), *jl, cfg))
    got = mf.mlp_apply_fused(torch.from_numpy(x), *pl, pcfg)
    assert got.shape == (1, rows, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _variants(lins):
    """{name: (gate, up, down)}, supported and not, built the same way on
    both sides."""
    gate, up, down = lins
    spec = lambda lin, **kw: lin.replace(spec=dataclasses.replace(lin.spec, **kw))
    return {
        "supported": (gate, up, down),
        "act quant": (spec(gate, abit=8), spec(up, abit=8), down),
        "mixed wbit": (gate, up, spec(down, wbit=8)),
        "per tensor": (spec(gate, w_qtype="per_tensor"), spec(up, w_qtype="per_tensor"), down),
        "down group 256": (gate, up, spec(down, w_groupsize=256)),
        "down group 48": (gate, up, spec(down, w_groupsize=48)),
        "gate != up": (gate, spec(up, w_unsigned=False), down),
        "unsigned differs": (spec(gate, w_unsigned=False), spec(up, w_unsigned=False), down),
        "per channel down": (gate, up, spec(down, w_qtype="per_channel")),
    }


@pytest.mark.parametrize("inter", [512, 320])
def test_mlp_supported_matches_jax(quantized, inter):
    cfg, jl, _, pl = quantized
    jv, pv = _variants(jl), _variants(pl)
    got = {k: mf.mlp_supported(*pv[k], cfg.hidden_size, inter) for k in pv}
    want = {k: jmf.mlp_supported(*jv[k], cfg.hidden_size, inter) for k in jv}
    assert got == want
    assert got["supported"] == (inter == 512) and not got["act quant"]
    # a bias or smooth factors also keep the triple off the fused path
    for field in ("bias", "smooth_factor"):
        g = pl[0].replace(**{field: torch.ones(pl[0].out_features)})
        assert not mf.mlp_supported(g, *pl[1:], cfg.hidden_size, 512)
