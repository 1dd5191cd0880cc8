"""Evaluation of an fp HF checkpoint or a saved quantized checkpoint: the
twin of the JAX package's examples/eval.py.

    python -m mi_optimize_tpu_torch.cli.eval --quantized-model CKPT --eval-ppl [--device cpu]
"""
import argparse
import json
import logging

from .common import add_device, get_tokenizer, load_checkpoint


def main(argv=None):
    from ..eval.benchmark import Benchmark

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", help="HF fp checkpoint dir")
    ap.add_argument("--quantized-model", help="saved quantized checkpoint dir")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--eval-ppl", action="store_true")
    ap.add_argument("--ppl-datasets", default="wikitext2")
    ap.add_argument("--eval-ceval", action="store_true")
    ap.add_argument("--eval-cmmlu", action="store_true")
    ap.add_argument("--num-shot", type=int, default=0)
    ap.add_argument("--subject", default="all")
    ap.add_argument("--output-json", default=None)
    add_device(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    model = load_checkpoint(args)
    tokenizer = get_tokenizer(args.tokenizer_path or args.model_path)

    bench = Benchmark(device=args.device)
    results = {}
    if args.eval_ppl:
        results["ppl"] = bench.eval_ppl(model, tokenizer, args.ppl_datasets)
    if args.eval_ceval:
        results["ceval"] = bench.eval_ceval(model, tokenizer, subject=args.subject,
                                            num_shot=args.num_shot)
    if args.eval_cmmlu:
        results["cmmlu"] = bench.eval_cmmlu(model, tokenizer, subject=args.subject,
                                            num_shot=args.num_shot)
    print(json.dumps(results, default=float))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
