"""C-Eval MCQA benchmark CLI:
the twin of the JAX package's benchmark/benchmark_ceval.py.

    python -m mi_optimize_tpu_torch.cli.benchmark_ceval --quantized-model CKPT [--device cpu]
"""
from .common import base_parser, emit, load


def main(argv=None):
    ap = base_parser()
    ap.add_argument("--subject", default="all")
    ap.add_argument("--num-shot", type=int, default=0)
    args = ap.parse_args(argv)
    model, tok = load(args)
    from ..eval.benchmark import Benchmark

    bench = Benchmark(device=args.device)
    res = bench.eval_ceval(model, tok, subject=args.subject,
                           num_shot=args.num_shot)
    return emit(args, res)


if __name__ == "__main__":
    main()
