"""Latency / throughput benchmark CLI (forward percentiles, decode
tokens/s against the HBM roofline):
the twin of the JAX package's benchmark/benchmark_latency.py.

    python -m mi_optimize_tpu_torch.cli.benchmark_latency --quantized-model CKPT [--device cpu]
"""
from .common import base_parser, emit, load


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seqlen", type=int, default=128)
    ap.add_argument("--hbm-bytes-per-s", type=float, default=None,
                    help="the device's HBM rate (eval.latency.HBM_BYTES_PER_S knows the H100's)")
    args = ap.parse_args(argv)
    model, tok = load(args)
    from ..eval.benchmark import Benchmark

    bench = Benchmark(device=args.device)
    res = bench.eval_latency(model, batch=args.batch, seqlen=args.seqlen,
                             hbm_bytes_per_s=args.hbm_bytes_per_s)
    return emit(args, res)


if __name__ == "__main__":
    main()
