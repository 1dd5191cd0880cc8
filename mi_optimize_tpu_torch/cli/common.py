"""Shared CLI plumbing: checkpoint and tokenizer loading, the result JSON.

Port of the JAX package's benchmark/common.py (argparse, --quantized-model
loading, --output-json) and examples/quantize.py's `get_tokenizer`, with
`--device`: the model is loaded onto it ("cuda" unless the caller asks for
the CPU) and the evaluation runs there."""
import argparse
import json


def base_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", help="HF fp checkpoint dir")
    ap.add_argument("--quantized-model", help="saved quantized checkpoint dir")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--output-json", default=None)
    add_device(ap)
    return ap


def add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")


def get_tokenizer(path):
    """transformers' AutoTokenizer from `path`, or the ByteTokenizer with no
    path."""
    if path:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path)
    from ..datasets.tokenizer import ByteTokenizer

    return ByteTokenizer()


def load_checkpoint(args):
    """args.quantized_model (export.load_model) or args.model_path
    (models.loader.load_llama_from_hf) on args.device."""
    if getattr(args, "quantized_model", None):
        from ..export import load_model

        return load_model(args.quantized_model, device=args.device)
    from ..models.loader import load_llama_from_hf

    return load_llama_from_hf(args.model_path, device=args.device)


def load(args):
    """(model, tokenizer); the ByteTokenizer where no tokenizer path is given
    or transformers cannot load one (no transformers installed)."""
    model = load_checkpoint(args)
    tok_path = args.tokenizer_path or args.model_path
    try:
        tok = get_tokenizer(tok_path)
    except Exception:
        tok = get_tokenizer(None)
    return model, tok


def emit(args, results):
    print(json.dumps(results, default=float))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results
