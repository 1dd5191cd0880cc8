"""Perplexity benchmark CLI:
the twin of the JAX package's benchmark/benchmark_ppl.py.

    python -m mi_optimize_tpu_torch.cli.benchmark_ppl --quantized-model CKPT [--device cpu]
"""
from .common import base_parser, emit, load


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--datasets", default="wikitext2")
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--nsamples", type=int, default=40)
    args = ap.parse_args(argv)
    model, tok = load(args)
    from ..eval.benchmark import Benchmark

    bench = Benchmark(device=args.device)
    res = bench.eval_ppl(model, tok, args.datasets, seqlen=args.seqlen,
                         nsamples=args.nsamples)
    return emit(args, res)


if __name__ == "__main__":
    main()
