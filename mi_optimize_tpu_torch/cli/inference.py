"""One-shot generation from a saved quantized checkpoint: the twin of the
JAX package's examples/inference.py.

    python -m mi_optimize_tpu_torch.cli.inference --quantized-model CKPT --prompt "Hello"
"""
import argparse
import time

from .common import add_device, get_tokenizer


def main(argv=None):
    from ..export import load_model
    from ..serving import generate

    ap = argparse.ArgumentParser()
    ap.add_argument("--quantized-model", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--prompt", default="Hello")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    add_device(ap)
    args = ap.parse_args(argv)

    model = load_model(args.quantized_model, device=args.device)
    tokenizer = get_tokenizer(args.tokenizer_path)
    ids = tokenizer(args.prompt)["input_ids"]
    t0 = time.time()
    out = generate(model, ids, max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature)
    dt = time.time() - t0
    n_new = out.shape[1] - len(ids[0])
    print(tokenizer.decode(out[0]))
    print(f"[{n_new} tokens in {dt:.2f}s = {n_new/dt:.1f} tok/s]")
    return out


if __name__ == "__main__":
    main()
