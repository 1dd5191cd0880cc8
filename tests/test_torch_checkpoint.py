"""The port's checkpoints (export/checkpoint.py), calibration journal,
memory residency (memory.py) and run manifests (utils/observability.py)
against the JAX package's, on its tiny Llama (vocab 256, h 64, f32).

- A checkpoint crosses both ways: JAX save_model -> port load_model, and
  port save_model -> JAX load_model, on RTN- and GPTQ-quantized models:
  every array equal (packed words as uint32), greedy tokens equal, PPL
  within 1e-5 relative. JAX's bf16 and native fp8 checkpoints load in the
  port bit for bit (JAX's own load_model refuses their '<V2' / '<V1'
  arrays); the port's bf16 and fp8 checkpoints round-trip bit for bit.
- export_packed gives JAX's packed words on RTN and GPTQ fake-quant models;
  SpQR stays fake-quant in both.
- The journal: a pass interrupted after a block, after a block's
  activations but before its rename, or after the rename but before the
  previous activations' removal resumes to the uninterrupted pass's words,
  scales and zeros bit for bit (also through quantize(journal=...)); bf16
  activations come back bit-equal.
- Memory round-trips f32, int32, bf16 and fp8 through device, host and
  disk bit for bit; MemoryBank; RunManifest; config_hash equals JAX's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mi_optimize_tpu as mt
import mi_optimize_tpu_torch as pt
from mi_optimize_tpu.eval.ppl import compute_ppl as jax_ppl
from mi_optimize_tpu.export import export_packed as jax_export_packed
from mi_optimize_tpu.export import load_model as jax_load_model
from mi_optimize_tpu.export import save_model as jax_save_model
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.quant.config import QuantConfig as JQuantConfig
from mi_optimize_tpu.serving import generate as jax_generate
from mi_optimize_tpu.utils import config_hash as jax_config_hash
from mi_optimize_tpu_torch.eval.ppl import compute_ppl
from mi_optimize_tpu_torch.export import (CalibrationJournal, export_packed, load_model,
                                          save_model)
from mi_optimize_tpu_torch.export import checkpoint as ckpt
from mi_optimize_tpu_torch.memory import MEMORY_BANK, Memory, MemoryBank, clear_mem, show_memory
from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear
from mi_optimize_tpu_torch.quant import QuantConfig, get_algo
from mi_optimize_tpu_torch.quant.calibrate import sequential_quantize
from mi_optimize_tpu_torch.serving import generate
from mi_optimize_tpu_torch.utils import RunManifest, config_hash, trace
from tests.test_torch_convert import port_model

FIELDS = ("weight", "packed", "w_scale", "w_zero", "bias", "smooth_factor", "a_scale",
          "a_zero", "perm")
ALGOS = {"rtn": dict(algo="rtn", wbit="int4", w_qtype="per_group", w_groupsize=16),
         "gptq": dict(algo="gptq", wbit="int4", w_qtype="per_group", w_groupsize=16,
                      blocksize=32, w_has_zero=True)}


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny Llama and two 32-token calibration batches (seed 0)."""
    rng = np.random.default_rng(0)
    return JModel.tiny_llama(), [rng.integers(0, 256, (1, 32)) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_quantized(tiny):
    jm, batches = tiny
    return {k: mt.quantize(jm, JQuantConfig(**kw), calib_data=batches) for k, kw in ALGOS.items()}


def _arrays(params):
    """{path: numpy array} of a params tree of either package: packed words
    as uint32, bf16 and fp8 as their bits."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}.{k}" if key else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}.{i}")
        elif hasattr(node, "spec"):
            for f in FIELDS:
                if getattr(node, f) is not None:
                    out[f"{key}.{f}"] = _bits(getattr(node, f), f)
        else:
            out[key] = _bits(node)
    walk(params, "")
    return out


def _bits(a, field=None):
    if isinstance(a, torch.Tensor):
        return ckpt._to_numpy(a, field)
    a = np.asarray(a)
    return a.view(f"V{a.itemsize}") if a.dtype.kind == "V" or a.dtype.name in (
        "bfloat16", "float8_e4m3fn", "float8_e5m2") else a


def _same_arrays(got, want):
    """Equal bits; an index array (GPTQ's perm) may be int64 on one side
    and int32 on the other, as JAX canonicalizes int64 to int32."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if k.endswith(".perm"):
            assert g.dtype.kind == w.dtype.kind == "i", k
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, k
        assert g.tobytes() == w.tobytes(), k
        if w.dtype.kind != "V":
            assert g.dtype == w.dtype, k


def _same_outputs(jm, pm, batches):
    prompt = np.random.default_rng(1).integers(0, 256, (1, 8))
    np.testing.assert_array_equal(generate(pm, prompt, max_new_tokens=6, fused=False),
                                  jax_generate(jm, prompt, max_new_tokens=6, fused=False))
    want = jax_ppl(jm, batches, fused=False)
    assert abs(compute_ppl(pm, batches, fused=False) - want) <= 1e-5 * want


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, tiny, jax_quantized, algo):
    jq = jax_quantized[algo]
    jax_save_model(jq, str(tmp_path))
    pm = load_model(str(tmp_path), device="cpu")
    assert pm.config == LlamaConfig(**json.load(open(tmp_path / "manifest.json"))["config"])
    assert pm.family == jq.family
    assert pm.params["layers"][0]["q_proj"].packed.dtype == torch.int32
    _same_arrays(_arrays(pm.params), _arrays(jq.params))
    _same_outputs(jq, pm, tiny[1])


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_port_checkpoint_loads_in_jax(tmp_path, tiny, algo):
    jm, batches = tiny
    pq = pt.quantize(port_model(jm), QuantConfig(**ALGOS[algo]), calib_data=batches,
                     device="cpu")
    save_model(pq, str(tmp_path))
    jq = jax_load_model(str(tmp_path))
    _same_arrays(_arrays(pq.params), _arrays(jq.params))
    _same_outputs(jq, pq, batches)
    # and back: the port reads its own checkpoint bit for bit
    _same_arrays(_arrays(load_model(str(tmp_path), device="cpu").params), _arrays(pq.params))


def test_bf16_and_fp8_checkpoints(tmp_path, tiny):
    jm, batches = tiny
    to_bf16 = lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a  # noqa: E731
    jb = JModel(config=jm.config, params=jax.tree_util.tree_map(to_bf16, jm.params))
    jf8 = mt.quantize(jm, JQuantConfig(algo="fp8", wbit="int8", fp8_format="e4m3"))
    for name, j in (("bf16", jb), ("fp8", jf8)):
        jax_save_model(j, str(tmp_path / name))
        with pytest.raises(TypeError):  # JAX cannot read its own void arrays back
            jax_load_model(str(tmp_path / name))
        pm = load_model(str(tmp_path / name), device="cpu")
        _same_arrays(_arrays(pm.params), _arrays(j.params))
        save_model(pm, str(tmp_path / f"{name}_port"))
        _same_arrays(_arrays(load_model(str(tmp_path / f"{name}_port"), device="cpu").params),
                     _arrays(pm.params))
    assert pm.params["layers"][0]["q_proj"].weight.dtype == torch.float8_e4m3fn
    assert torch.equal(load_model(str(tmp_path / "bf16"), device="cpu").params["embed"],
                       port_model(jm).params["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_export_packed_matches_jax(tiny, algo):
    """The same linears pack (RTN's all; GPTQ's g16 fake weights are off the
    grid of their stored qparams in the JAX package too, so none), with
    JAX's words."""
    jm, batches = tiny
    jq = mt.quantize(jm, JQuantConfig(pack=False, **ALGOS[algo]), calib_data=batches)
    assert jq.params["layers"][0]["q_proj"].packed is None
    want = jax_export_packed(jq)
    got = export_packed(port_model(jq))
    n_packed = 0
    for blk_g, blk_w in zip(got.params["layers"], want.params["layers"]):
        for name, lw in blk_w.items():
            if hasattr(lw, "spec"):
                assert blk_g[name].spec.__dict__ == lw.spec.__dict__
                assert (blk_g[name].packed is None) == (lw.packed is None)
                if lw.packed is not None:
                    n_packed += 1
                    assert blk_g[name].weight is None and lw.weight is None
                    np.testing.assert_array_equal(blk_g[name].packed.numpy().view(np.uint32),
                                                  np.asarray(lw.packed))
    assert n_packed == (14 if algo == "rtn" else 0)
    prompt = np.random.default_rng(3).integers(0, 256, (1, 8))
    np.testing.assert_array_equal(generate(got, prompt, max_new_tokens=6, fused=False),
                                  jax_generate(want, prompt, max_new_tokens=6, fused=False))


def test_export_packed_skips_spqr(tiny):
    jm, batches = tiny
    cfg = dict(algo="spqr", wbit="int4", w_groupsize=16, blocksize=32, qq_groupsize=8)
    jq = mt.quantize(jm, JQuantConfig(**cfg), calib_data=batches[:1])
    assert jax_export_packed(jq).params["layers"][0]["q_proj"].packed is None
    pq = pt.quantize(port_model(jm), QuantConfig(**cfg), calib_data=batches[:1], device="cpu")
    assert export_packed(pq).params["layers"][0]["q_proj"].packed is None


class _Interrupt(Exception):
    pass


def _codes(params):
    return {k: v for k, v in _arrays(params).items() if k.startswith("layers")}


@pytest.fixture(scope="module")
def journal_model(tiny):
    """A 3-layer tiny model, its batches (of two lengths), GPTQ's config and
    the uninterrupted pass."""
    jm3 = JModel.tiny_llama(num_layers=3)
    pm = port_model(jm3)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (1, 32)), rng.integers(0, 256, (1, 20))]
    qcfg = QuantConfig(algo="gptq", wbit="int4", blocksize=32, w_has_zero=True)
    full = sequential_quantize(pm.params, pm.config, qcfg, get_algo("gptq", qcfg), batches,
                               device="cpu")
    return pm, batches, qcfg, full


@pytest.mark.parametrize("where", ["after_block", "before_rename", "before_removal"])
def test_journal_resume(tmp_path, monkeypatch, journal_model, where):
    pm, batches, qcfg, full = journal_model
    algo = get_algo("gptq", qcfg)
    j = CalibrationJournal(str(tmp_path / "journal"))
    real_replace, real_remove = os.replace, os.remove

    def cut_replace(src, dst):
        if where == "before_rename" and dst.endswith("block_0001.npz"):
            raise _Interrupt
        real_replace(src, dst)

    def cut_remove(p):
        if where == "before_removal" and p.endswith("acts_0000.npz"):
            raise _Interrupt
        real_remove(p)

    save = CalibrationJournal.save_block

    def cut_save(self, i, blk, xs=None):
        save(self, i, blk, xs=xs)
        if where == "after_block" and i == 0:
            raise _Interrupt

    monkeypatch.setattr(ckpt.os, "replace", cut_replace)
    monkeypatch.setattr(ckpt.os, "remove", cut_remove)
    monkeypatch.setattr(CalibrationJournal, "save_block", cut_save)
    with pytest.raises(_Interrupt):
        sequential_quantize(pm.params, pm.config, qcfg, algo, batches, journal=j, device="cpu")
    monkeypatch.undo()
    assert j.last_completed() == {"after_block": 0, "before_rename": 0, "before_removal": 1}[where]
    resumed = pt.quantize(pm, qcfg, calib_data=batches, journal=j, device="cpu")
    assert j.last_completed() == 2
    assert sorted(os.listdir(j.path)) == ["acts_0002.npz"] + [f"block_000{i}.npz"
                                                               for i in range(3)]
    _same_arrays(_codes(resumed.params), _codes(full))
    # a finished journal skips every block and returns the same codes
    again = sequential_quantize(pm.params, pm.config, qcfg, algo, batches, journal=j,
                                device="cpu")
    _same_arrays(_codes(again), _codes(full))


def test_journal_keeps_bf16_and_fp8_bits(tmp_path):
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(1, 7, 16, generator=g).to(torch.bfloat16),
          torch.randn(1, 3, 16, generator=g).to(torch.bfloat16)]
    lin = QuantizedLinear.fp(torch.randn(8, 16, generator=g).to(torch.float8_e5m2))
    lin = lin.replace(spec=lin.spec.__class__(wbit=8, fp8_format="e5m2"),
                      w_scale=torch.rand(8, 1, generator=g))
    blk = {"input_norm": torch.randn(16, generator=g).to(torch.bfloat16), "q_proj": lin}
    j = CalibrationJournal(str(tmp_path))
    j.save_block(0, blk, xs=xs)
    back, acts = j.load_block(0, device="cpu"), j.load_acts(device="cpu")
    for a, b in zip(acts, xs):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(back["input_norm"], blk["input_norm"])
    assert back["q_proj"].weight.dtype == torch.float8_e5m2
    assert torch.equal(back["q_proj"].weight.view(torch.uint8), lin.weight.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_memory_residency_roundtrip(tmp_path, dtype):
    v = (torch.arange(12, dtype=torch.float32).reshape(3, 4) * 0.37 - 2).to(dtype)
    m = Memory(v, desc="host", spill_dir=str(tmp_path), device="cpu")
    m.to("disk")
    assert m.desc == "disk" and len(os.listdir(tmp_path)) == 1
    assert m.value.dtype == dtype
    assert torch.equal(m.value.view(torch.uint8), v.view(torch.uint8))
    m.to("device")
    assert m.desc == "device" and os.listdir(tmp_path) == []
    assert torch.equal(m.value.view(torch.uint8), v.view(torch.uint8))
    m.to("host")
    assert torch.equal(m.value.view(torch.uint8), v.view(torch.uint8))
    np_in = Memory(np.ones(4, np.float32), desc="disk", spill_dir=str(tmp_path))
    np.testing.assert_array_equal(np_in.value.numpy(), np.ones(4, np.float32))


def test_memory_bank():
    bank = MemoryBank()
    bank.add_value("a", np.ones(4), desc="disk")
    np.testing.assert_array_equal(bank.get("a").value.numpy(), np.ones(4))
    bank.pop("a")
    bank.add_value("b", torch.zeros(2), desc="host")
    bank.clear()
    clear_mem(clear_jit_cache=True)
    assert "bytes_in_use" in show_memory()
    assert isinstance(MEMORY_BANK, MemoryBank)


def test_run_manifest_and_config_hash(tmp_path):
    cfg = QuantConfig(algo="rtn", wbit="int4")
    m = RunManifest("test", config=cfg)
    with m.phase("calibrate"):
        pass
    m.metric("ppl", 5.47)
    data = json.loads(open(m.save(str(tmp_path / "run.json"))).read())
    assert data["metrics"]["ppl"] == 5.47 and "calibrate" in data["phases"]
    assert len(data["config_hash"]) == 16 and config_hash(cfg) == data["config_hash"]
    for kw in (dict(algo="rtn", wbit="int4"),
               dict(algo="gptq", wbit="int4", w_qtype="per_group", w_groupsize=128,
                    calibrate_config={"name": "ceval", "nsamples": 2})):
        assert config_hash(QuantConfig.from_dict(kw)) == jax_config_hash(JQuantConfig.from_dict(kw))
    assert config_hash(LlamaConfig()) == jax_config_hash(JModel.tiny_llama().config.__class__())
    with trace(str(tmp_path / "tr")) as d:
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(d))


def test_default_device_is_the_card(tmp_path, jax_quantized):
    jax_save_model(jax_quantized["rtn"], str(tmp_path))
    j = CalibrationJournal(str(tmp_path / "j"))
    j.save_block(0, {"input_norm": torch.ones(4)}, xs=[torch.ones(2)])
    if torch.cuda.is_available():
        assert load_model(str(tmp_path)).params["embed"].is_cuda
        assert j.load_acts()[0].is_cuda
    else:
        for fn in (lambda: load_model(str(tmp_path)), j.load_acts, lambda: j.load_block(0)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
