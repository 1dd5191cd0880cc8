"""Quantize a HF llama-family checkpoint by a YAML config and save it: the
twin of the JAX package's examples/quantize.py (load -> quantize -> save ->
a smoke generate).

    python -m mi_optimize_tpu_torch.cli.quantize --model-path /path/to/hf-llama \
        --quant-config configs/rtn_quant_config.yaml --save ckpt_out \
        [--tokenizer-path ...] [--journal journal_dir] [--device cpu]
"""
import argparse
import logging
import time

from .common import add_device, get_tokenizer


def main(argv=None):
    from .. import quantize
    from ..export import CalibrationJournal, save_model
    from ..models.loader import load_llama_from_hf
    from ..serving import generate

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--quant-config", required=True)
    ap.add_argument("--save", default="quantized_ckpt")
    ap.add_argument("--journal", default=None, help="resumable calibration dir")
    add_device(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    model = load_llama_from_hf(args.model_path, device=args.device)
    tokenizer = get_tokenizer(args.tokenizer_path or args.model_path)

    t0 = time.time()
    journal = CalibrationJournal(args.journal) if args.journal else None
    qmodel = quantize(model, args.quant_config, tokenizer=tokenizer, journal=journal,
                      device=args.device)
    logging.info("quantization took %.1fs", time.time() - t0)

    save_model(qmodel, args.save)
    logging.info("saved to %s", args.save)

    out = generate(qmodel, tokenizer("Llama is a")["input_ids"], max_new_tokens=16)
    logging.info("smoke generate: %s", tokenizer.decode(out[0]))
    return qmodel


if __name__ == "__main__":
    main()
