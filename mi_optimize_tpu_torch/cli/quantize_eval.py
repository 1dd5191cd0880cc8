"""Full pipeline: quantize -> save -> flag-gated evaluation -> result JSON:
the twin of the JAX package's examples/quantize_eval.py.

    python -m mi_optimize_tpu_torch.cli.quantize_eval --model-path HF_DIR \
        --quant-config configs/rtn_quant_config.yaml --eval-ppl [--device cpu]
"""
import argparse
import json
import logging

from .common import add_device, get_tokenizer


def main(argv=None):
    from .. import quantize
    from ..eval.benchmark import Benchmark
    from ..export import save_model
    from ..models.loader import load_llama_from_hf

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--quant-config", required=True)
    ap.add_argument("--save", default="quantized_ckpt")
    ap.add_argument("--eval-ppl", action="store_true")
    ap.add_argument("--ppl-datasets", default="wikitext2")
    ap.add_argument("--eval-ceval", action="store_true")
    ap.add_argument("--eval-cmmlu", action="store_true")
    ap.add_argument("--eval-boss", action="store_true")
    ap.add_argument("--boss-dataset", default="QuestionAnswering_advqa")
    ap.add_argument("--eval-lmeval", default=None, help="comma-separated tasks")
    ap.add_argument("--eval-latency", action="store_true")
    ap.add_argument("--num-shot", type=int, default=0)
    ap.add_argument("--subject", default="all")
    ap.add_argument("--output-json", default="result.json")
    add_device(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    model = load_llama_from_hf(args.model_path, device=args.device)
    tokenizer = get_tokenizer(args.tokenizer_path or args.model_path)
    qmodel = quantize(model, args.quant_config, tokenizer=tokenizer, device=args.device)
    save_model(qmodel, args.save)

    bench = Benchmark(device=args.device)
    results = {"quant_config": args.quant_config}
    if args.eval_ppl:
        results["ppl"] = bench.eval_ppl(qmodel, tokenizer, args.ppl_datasets)
    if args.eval_ceval:
        results["ceval"] = bench.eval_ceval(qmodel, tokenizer, subject=args.subject,
                                            num_shot=args.num_shot)
    if args.eval_cmmlu:
        results["cmmlu"] = bench.eval_cmmlu(qmodel, tokenizer, subject=args.subject,
                                            num_shot=args.num_shot)
    if args.eval_boss:
        results["boss"] = bench.eval_boss(qmodel, tokenizer, args.boss_dataset,
                                          num_shot=args.num_shot)
    if args.eval_lmeval:
        results["lmeval"] = bench.eval_lmeval(qmodel, tokenizer, args.eval_lmeval.split(","),
                                              num_shot=args.num_shot)
    if args.eval_latency:
        results["latency"] = bench.eval_latency(qmodel)

    with open(args.output_json, "w") as f:
        json.dump(results, f, indent=2, default=float)
    logging.info("results: %s", json.dumps(results, default=float)[:2000])
    return results


if __name__ == "__main__":
    main()
