"""PyTorch / CUDA port of mi_optimize_tpu for NVIDIA Hopper (H100, sm_90a).

The JAX package `mi_optimize_tpu` is the reference; this package mirrors its
sub-packages and module names (`core/`, `models/`, `ops/`, `serving/`, `eval/`) and
never imports JAX or anything of the reference package. Every Pallas kernel
on the ported path is a hand-written CUDA kernel under `csrc/`, built with
nvcc at first use (`ops/_build.py`); on CPU tensors each wrapper runs its
plain PyTorch version instead.

It covers int4 (or int2/int8) packed Llama serving: prefill through
`ops.dequant_matmul`, per-layer decode through `ops.block_fused`, the
whole-model decodes through `ops.model_flat`, `ops.model_flat_seg` and
`ops.model_fused` (single stream, continuous batching, paged serving), the
paged flash decode (`ops.paged_attention`), speculative decoding
(`serving.speculative`, the speculative batchers) and planted-structure
models for exact token gates (`utils.planted`); and the unfused model that
quantization returns (separate q/k/v and gate/up), for `generate` and
`eval.ppl.compute_ppl`, through the decode attention (`ops.decode_attention`),
the fused MLP (`ops.mlp_fused`) and, with `MI_W4A8_INT=1`, the W4A8 integer
product (`ops.w4a8_matmul`), and the W8A8 integer product
(`ops.int8_matmul`, torch._int_mm). `quant.quantize` makes that model from
an fp one (RTN, GPTQ, AWQ, SmoothQuant, ZeroQuant, FP8, SpQR, QuIP,
AWQ+GPTQ, SmoothQuant+GPTQ; layer-sequential calibration on wikitext2 / PTB
/ C4 / C-Eval / CMMLU / BOSS from `datasets.calibration`, resumable through
`export.CalibrationJournal`), `eval.benchmark.Benchmark` measures its
perplexity and its C-Eval, CMMLU and BOSS scores, `models.loader` loads a
HuggingFace safetensors checkpoint, `export` saves and reloads the quantized
model in the JAX package's format, and `serving.beam.beam_search` serves it
with beam search on the paged batched kernel. `parallel` shards the model
over ranks (tensor and data parallelism on torch.distributed): the batched
kernel's tensor-parallel mode and the overlapped ring dequant matmul.
`eval.latency` times the forward and the decode against the HBM roofline,
`eval.lmeval` runs the lm-eval harness's request types over its task tables
(offline data from `datasets.lmdatasets`), and `cli/` holds command-line
twins of the JAX package's benchmark and example scripts.

The top-level exports mirror the reference package's: `quantize`,
`Benchmark`, `QuantizedLinear`, `Precision` and `as_precision`.
"""
from .precision import Precision, as_precision  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, so that `import mi_optimize_tpu_torch` stays light
    if name == "quantize":
        from .quant.api import quantize
        return quantize
    if name == "Benchmark":
        from .eval.benchmark import Benchmark
        return Benchmark
    if name == "QuantizedLinear":
        from .models.quant_linear import QuantizedLinear
        return QuantizedLinear
    raise AttributeError(name)
