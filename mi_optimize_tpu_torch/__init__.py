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
product (`ops.w4a8_matmul`).
"""

__version__ = "0.1.0"
