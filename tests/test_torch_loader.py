"""The port's HF checkpoint loader (models/loader.py) against the JAX
package's, on safetensors files written here from numpy seeds.

- The port's own safetensors reader gives safetensors.safe_open's tensors
  bit for bit on F32, F16 and BF16 files (metadata skipped, a header padded
  to 8 bytes, offsets from the end of the header), and refuses a dtype it
  does not read.
- load_llama_from_hf on llama (the reference test's checkpoint), qwen2
  (attention bias, GQA), tied embeddings, Baichuan (W_pack) and ChatGLM
  (fused qkv and h_to_4h, MQA, interleaved half rotary): every array equal
  to JAX's load_llama_from_hf, the same config and family, and the port's
  logits within rtol 1e-5 of JAX's llama.forward(fused=False).
- F16 and BF16 checkpoints in two shards (a key repeated in the later shard
  wins): every array equal to the stored values in f32; F16 also equal to
  JAX's load of the same files.
- device=None resolves to the card: here, with no card, it raises.
"""
import dataclasses
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models import llama as jllama
from mi_optimize_tpu.models.loader import load_llama_from_hf as jax_load
from mi_optimize_tpu_torch.models import llama
from mi_optimize_tpu_torch.models.loader import load_llama_from_hf, read_safetensors
from mi_optimize_tpu_torch.models.quant_linear import QuantizedLinear
from tests.test_loader import make_fake_hf_ckpt

safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file  # noqa: E402


def _draw(rng, shape):
    """Seeded normals: a matrix scaled by 1/sqrt(fan-in), a vector (a norm
    weight or a bias) as 1 + 0.1 N."""
    x = rng.normal(size=shape).astype(np.float32)
    return x * np.float32(shape[1] ** -0.5) if len(shape) == 2 else 1 + np.float32(0.1) * x


def _llama_tensors(rng, cfg, dtype=torch.float32):
    """HF llama-layout tensors for an HF config dict (q/k/v biases for
    qwen2, no lm_head when tied), seeded normals at model-like scales in
    `dtype`."""
    h, inter, vocab = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    heads = cfg["num_attention_heads"]
    kv = cfg.get("num_key_value_heads", heads)
    hd = h // heads

    def t(*shape):
        return torch.from_numpy(_draw(rng, shape)).to(dtype)

    out = {"model.embed_tokens.weight": t(vocab, h), "model.norm.weight": t(h)}
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = t(vocab, h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.update({f"{p}.input_layernorm.weight": t(h),
                    f"{p}.post_attention_layernorm.weight": t(h),
                    f"{p}.self_attn.o_proj.weight": t(h, heads * hd),
                    f"{p}.mlp.gate_proj.weight": t(inter, h),
                    f"{p}.mlp.up_proj.weight": t(inter, h),
                    f"{p}.mlp.down_proj.weight": t(h, inter)})
        if cfg["model_type"] == "baichuan":
            out[f"{p}.self_attn.W_pack.weight"] = t(3 * h, h)
            continue
        for n, rows in (("q", heads * hd), ("k", kv * hd), ("v", kv * hd)):
            out[f"{p}.self_attn.{n}_proj.weight"] = t(rows, h)
            if cfg["model_type"] == "qwen2":
                out[f"{p}.self_attn.{n}_proj.bias"] = t(rows)
    return out


def _chatglm_tensors(rng, cfg):
    h, heads, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["multi_query_group_num"]
    hd, inter, vocab = cfg["kv_channels"], cfg["ffn_hidden_size"], cfg["padded_vocab_size"]

    def t(*shape):
        return torch.from_numpy(_draw(rng, shape))

    qkv = heads * hd + 2 * kv * hd
    out = {"transformer.embedding.word_embeddings.weight": t(vocab, h),
           "transformer.encoder.final_layernorm.weight": t(h),
           "transformer.output_layer.weight": t(vocab, h)}
    for i in range(cfg["num_layers"]):
        p = f"transformer.encoder.layers.{i}"
        out.update({f"{p}.input_layernorm.weight": t(h),
                    f"{p}.post_attention_layernorm.weight": t(h),
                    f"{p}.self_attention.query_key_value.weight": t(qkv, h),
                    f"{p}.self_attention.query_key_value.bias": t(qkv),
                    f"{p}.self_attention.dense.weight": t(h, heads * hd),
                    f"{p}.mlp.dense_h_to_4h.weight": t(2 * inter, h),
                    f"{p}.mlp.dense_4h_to_h.weight": t(h, inter)})
    return out


_BASE = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 48, "num_hidden_layers": 2,
         "num_attention_heads": 4, "rms_norm_eps": 1e-5, "max_position_embeddings": 128}
CASES = {
    "qwen2_gqa_bias": dict(_BASE, model_type="qwen2", num_key_value_heads=2,
                           rope_theta=1e6),
    "llama_tied": dict(_BASE, model_type="llama", num_key_value_heads=4,
                       tie_word_embeddings=True),
    "mistral_gqa": dict(_BASE, model_type="mistral", num_key_value_heads=1),
    "baichuan_wpack": dict(_BASE, model_type="baichuan"),
    "chatglm": {"model_type": "chatglm", "padded_vocab_size": 64, "hidden_size": 32,
                "ffn_hidden_size": 48, "num_layers": 2, "num_attention_heads": 4,
                "multi_query_group_num": 2, "kv_channels": 8, "layernorm_epsilon": 1e-5,
                "seq_length": 128, "add_qkv_bias": True},
}


def _write(path, cfg, tensors, shards=1):
    (path / "config.json").write_text(json.dumps(cfg))
    names = sorted(tensors)
    for s in range(shards):
        save_file({n: tensors[n].contiguous() for n in names[s::shards]},
                  str(path / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))


def _leaves(params, prefix=""):
    """(path, numpy f32 array) of every tensor of a params tree, JAX's or
    the port's."""
    out = []
    if isinstance(params, dict):
        for k in sorted(params):
            out += _leaves(params[k], f"{prefix}{k}.")
    elif isinstance(params, list):
        for i, v in enumerate(params):
            out += _leaves(v, f"{prefix}{i}.")
    elif dataclasses.is_dataclass(params):
        for f in ("weight", "bias"):
            v = getattr(params, f)
            if v is not None:
                out.append((prefix + f, _np(v)))
        assert params.packed is None
    else:
        out.append((prefix[:-1], _np(params)))
    return out


def _np(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else np.asarray(a,
                                                                                   np.float32)


def _same_as_jax(path, dtype=torch.float32):
    jm = jax_load(str(path))
    pm = load_llama_from_hf(str(path), dtype=dtype, device="cpu")
    assert dataclasses.asdict(pm.config) == dataclasses.asdict(jm.config)
    assert pm.family == jm.family
    got, want = _leaves(pm.params), _leaves(jm.params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    return jm, pm


def _logits_close(jm, pm):
    ids = np.random.default_rng(1).integers(0, pm.config.vocab_size, (2, 12))
    want = np.asarray(jllama.forward(jm.params, jm.config, jnp.asarray(ids), fused=False))
    got = llama.forward(pm.params, pm.config, torch.as_tensor(ids), fused=False).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("st_dtype", ["F32", "F16", "BF16"])
def test_reader_matches_safe_open(tmp_path, st_dtype):
    dt = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[st_dtype]
    rng = np.random.default_rng(5)
    tensors = {"a": torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32)).to(dt),
               "b.c": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)).to(dt),
               "scalar": torch.tensor(2.5, dtype=dt), "empty": torch.zeros(0, 4, dtype=dt)}
    p = str(tmp_path / "x.safetensors")
    save_file(tensors, p, metadata={"format": "pt"})
    got = read_safetensors(p)
    with safe_open(p, framework="pt") as f:
        assert sorted(got) == sorted(f.keys())
        for k in f.keys():
            want = f.get_tensor(k)
            assert got[k].dtype == want.dtype == dt and got[k].shape == want.shape
            assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8))


def test_reader_hand_written_header(tmp_path):
    """A header padded with spaces, offsets from its end, out of order."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.array([1.5, -2.0], np.float16)
    header = {"b": {"dtype": "F16", "shape": [2], "data_offsets": [24, 28]},
              "__metadata__": {"note": "x"},
              "a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]}}
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    p = tmp_path / "h.safetensors"
    p.write_bytes(struct.pack("<Q", len(h)) + h + a.tobytes() + b.tobytes())
    got = read_safetensors(str(p))
    assert sorted(got) == ["a", "b"]
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    bad = tmp_path / "i.safetensors"
    hb = json.dumps({"c": {"dtype": "I64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(hb)) + hb + bytes(8))
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(str(bad))


def test_llama_checkpoint_matches_jax(tmp_path):
    """The reference test's llama checkpoint (GQA 4/2, untied)."""
    make_fake_hf_ckpt(tmp_path)
    jm, pm = _same_as_jax(tmp_path)
    assert pm.params["layers"][0]["q_proj"].weight.dtype == torch.float32
    assert isinstance(pm.params["lm_head"], QuantizedLinear)
    _logits_close(jm, pm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_families_match_jax(tmp_path, case):
    cfg = CASES[case]
    rng = np.random.default_rng(len(case))
    tensors = _chatglm_tensors(rng, cfg) if case == "chatglm" else _llama_tensors(rng, cfg)
    _write(tmp_path, cfg, tensors)
    jm, pm = _same_as_jax(tmp_path)
    if case == "qwen2_gqa_bias":
        assert pm.config.attn_bias and pm.params["layers"][1]["k_proj"].bias is not None
    if case == "llama_tied":
        assert pm.config.tie_embeddings and "lm_head" not in pm.params
    if case == "chatglm":
        assert pm.config.rope_interleaved and pm.config.rotary_dim == 4
    _logits_close(jm, pm)


@pytest.mark.parametrize("st_dtype", ["F16", "BF16"])
def test_half_precision_two_shards(tmp_path, st_dtype):
    dt = {"F16": torch.float16, "BF16": torch.bfloat16}[st_dtype]
    cfg = CASES["qwen2_gqa_bias"]
    tensors = _llama_tensors(np.random.default_rng(9), cfg, dt)
    _write(tmp_path, cfg, tensors, shards=2)
    # a third shard, later by name, repeats one key: its value wins
    late = {"model.norm.weight": torch.full((cfg["hidden_size"],), 3.0, dtype=dt)}
    save_file(late, str(tmp_path / "model-zzz.safetensors"))
    tensors.update(late)
    pm = load_llama_from_hf(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(pm.params["final_norm"].numpy(), np.full(32, 3.0, np.float32))
    blk = pm.params["layers"][1]
    for name, got in (("model.embed_tokens.weight", pm.params["embed"]),
                      ("lm_head.weight", pm.params["lm_head"].weight),
                      ("model.layers.1.self_attn.v_proj.bias", blk["v_proj"].bias),
                      ("model.layers.1.mlp.down_proj.weight", blk["down_proj"].weight)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), tensors[name].to(torch.float32).numpy())
    bf = load_llama_from_hf(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    assert bf.params["embed"].dtype == torch.bfloat16
    assert torch.equal(bf.params["embed"], tensors["model.embed_tokens.weight"].to(torch.bfloat16))
    if st_dtype == "F16":
        _same_as_jax(tmp_path)


def test_default_device_is_the_card(tmp_path):
    make_fake_hf_ckpt(tmp_path)
    if torch.cuda.is_available():
        assert load_llama_from_hf(str(tmp_path)).params["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_llama_from_hf(str(tmp_path))
