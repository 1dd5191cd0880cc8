"""Command-line twins of the JAX package's CLIs (benchmark/*.py and
examples/*.py), on the port: the same file names and flags, plus `--device`
(default "cuda"). Each runs as `python -m mi_optimize_tpu_torch.cli.<name>`
and has a `main(argv=None)` that returns what it prints.

  benchmark_ppl, benchmark_ceval, benchmark_cmmlu, benchmark_lm_eval,
  benchmark_latency        one Benchmark family on a checkpoint (common.py)
  quantize                 HF checkpoint -> quantize by a YAML config -> save
  quantization             the same from flags, then optional benchmarks
  quantize_eval            quantize -> save -> flag-gated evaluation -> JSON
  eval                     evaluate an fp or a quantized checkpoint
  inference                generate from a quantized checkpoint
  serve                    serve prompts: continuous batching, speculative,
                           paged (prefix cache, parallel samples), beam
"""
