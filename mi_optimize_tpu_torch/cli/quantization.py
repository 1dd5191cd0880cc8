"""Flag-level quantization CLI: the twin of the JAX package's
examples/quantization.py (the family from the checkpoint's config.json).

    python -m mi_optimize_tpu_torch.cli.quantization --model-path /ckpts/llama2-7b \
        --algo gptq --wbit int4 --w-groupsize 128 --block-sequential \
        --calibrate-name wikitext2 --calibrate-nsamples 128 \
        --benchmark ppl --save ckpt_gptq [--device cpu]
"""
import argparse
import json
import logging

from .common import add_device, get_tokenizer

ALGOS = ["rtn", "gptq", "awq", "smoothquant", "zeroquant", "fp8", "spqr", "quip", "awq+gptq",
         "smoothquant+gptq"]


def main(argv=None):
    from .. import quantize
    from ..eval.benchmark import Benchmark
    from ..export import CalibrationJournal, save_model
    from ..models.loader import load_llama_from_hf
    from ..quant.config import CalibrationConfig, QuantConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--algo", default="rtn", choices=ALGOS)
    ap.add_argument("--wbit", default="int4")
    ap.add_argument("--abit", default="float16")
    ap.add_argument("--w-qtype", default="per_group")
    ap.add_argument("--a-qtype", default="per_tensor")
    ap.add_argument("--w-groupsize", type=int, default=128)
    ap.add_argument("--a-groupsize", type=int, default=-1)
    ap.add_argument("--w-has-zero", action="store_true")
    ap.add_argument("--quantization-type", default="dynamic", choices=["static", "dynamic"])
    ap.add_argument("--block-sequential", action="store_true")
    ap.add_argument("--layer-sequential", dest="layer_sequential", action="store_true",
                    default=True)
    ap.add_argument("--no-layer-sequential", dest="layer_sequential", action="store_false")
    ap.add_argument("--no-pack", dest="pack", action="store_false", default=True)
    ap.add_argument("--calibrate-name", default="wikitext2")
    ap.add_argument("--calibrate-subject", default="all")
    ap.add_argument("--calibrate-nsamples", type=int, default=128)
    ap.add_argument("--calibrate-seqlen", type=int, default=2048)
    ap.add_argument("--journal", default=None)
    ap.add_argument("--save", default="quantized_ckpt")
    ap.add_argument("--benchmark", default=None,
                    help="comma list of: ppl,ceval,cmmlu,boss,latency")
    ap.add_argument("--num-shot", type=int, default=0)
    add_device(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = QuantConfig(
        algo=args.algo, wbit=args.wbit, abit=args.abit,
        w_qtype=args.w_qtype, a_qtype=args.a_qtype,
        w_groupsize=args.w_groupsize, a_groupsize=args.a_groupsize,
        w_has_zero=args.w_has_zero, quantization_type=args.quantization_type,
        block_sequential=args.block_sequential,
        layer_sequential=args.layer_sequential, pack=args.pack,
        calibrate=CalibrationConfig(
            name=args.calibrate_name, subject=args.calibrate_subject,
            nsamples=args.calibrate_nsamples, seqlen=args.calibrate_seqlen,
            split="train",
        ),
    )
    model = load_llama_from_hf(args.model_path, device=args.device)
    tokenizer = get_tokenizer(args.tokenizer_path or args.model_path)
    journal = CalibrationJournal(args.journal) if args.journal else None
    qmodel = quantize(model, cfg, tokenizer=tokenizer, journal=journal, device=args.device)
    save_model(qmodel, args.save)

    results = {}
    if args.benchmark:
        bench = Benchmark(device=args.device)
        for fam in args.benchmark.split(","):
            if fam == "ppl":
                results["ppl"] = bench.eval_ppl(qmodel, tokenizer, "wikitext2")
            elif fam == "ceval":
                results["ceval"] = bench.eval_ceval(qmodel, tokenizer, num_shot=args.num_shot)
            elif fam == "cmmlu":
                results["cmmlu"] = bench.eval_cmmlu(qmodel, tokenizer, num_shot=args.num_shot)
            elif fam == "boss":
                results["boss"] = bench.eval_boss(qmodel, tokenizer)
            elif fam == "latency":
                results["latency"] = bench.eval_latency(qmodel)
        print(json.dumps(results, default=float))
    return results


if __name__ == "__main__":
    main()
