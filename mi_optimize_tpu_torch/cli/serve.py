"""Serving from a saved quantized checkpoint: the twin of the JAX package's
examples/serve.py.

By default the prompts go through continuous batching over an int8 KV cache
(ContinuousBatcher: one batched whole-model launch a step on the card).
`--speculative [--draft-model CKPT]` serves each prompt through
speculative_generate, or with `--slots > 1` through SpeculativeBatcher;
`--paged` serves over the shared KV page pool (PagedMegaBatcher, with
`--prefix-cache`, and `--n` / `--temperature` / `--top-p` / `--top-k`
parallel samples); `--paged --speculative` composes both
(PagedSpeculativeBatcher); `--beam W` serves each prompt by beam search.

    python -m mi_optimize_tpu_torch.cli.serve --quantized-model CKPT --prompts prompts.txt \
        --slots 8 --max-new-tokens 64 [--device cpu]

`main` returns the tokens of every request with the walls and the mode's
statistics.
"""
import argparse
import time

import torch

from .common import add_device, get_tokenizer


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantized-model", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--prompts", required=True, help="text file, one prompt per line")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--draft-model", default=None,
                    help="checkpoint of the speculative draft (e.g. int2 RTN of the same model)")
    ap.add_argument("--k", type=int, default=4, help="speculative proposal length")
    ap.add_argument("--paged", action="store_true",
                    help="serve over the shared KV page pool (PagedMegaBatcher)")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching on the paged path: full prompt pages are "
                         "shared across requests, only the suffix prefills")
    ap.add_argument("--pages", type=int, default=0, help="pool size (0 = full capacity)")
    ap.add_argument("--beam", type=int, default=0,
                    help="beam width: >1 serves each prompt by beam search")
    ap.add_argument("--n", type=int, default=1,
                    help="parallel samples per prompt (paged path; forks share prompt pages)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    add_device(ap)
    return ap


def _report(results, tokenizer, dt, **stats):
    n_tokens = sum(len(t) for t in results.values())
    for key in results:
        print(f"--- [{key}]")
        print(tokenizer.decode(results[key]))
    print(f"[{n_tokens} tokens in {dt:.2f}s = {n_tokens / max(dt, 1e-9):.1f} tok/s aggregate"
          + "".join(f", {k}={v}" for k, v in stats.items()) + "]")
    return {"requests": {str(k): [int(t) for t in v] for k, v in results.items()},
            "tokens": n_tokens, "seconds": dt, **stats}


def serve(args, ap):
    from ..export import load_model
    from ..serving.optimize import fuse_for_serving

    model = load_model(args.quantized_model, device=args.device)
    tokenizer = get_tokenizer(args.tokenizer_path)
    with open(args.prompts) as f:
        prompts = [p.strip() for p in f if p.strip()]
    ids = [tokenizer(p)["input_ids"] for p in prompts]

    def served_draft(target):
        """The draft checkpoint fused for serving, else the served target."""
        if args.draft_model:
            return fuse_for_serving(load_model(args.draft_model, device=args.device))
        return target

    if args.beam and args.beam > 1:
        from ..serving.beam import beam_search

        model = fuse_for_serving(model)
        out = {"mode": "beam", "prompts": {}}
        for i, p in enumerate(ids):
            t0 = time.time()
            hyps = beam_search(model, p, beam_width=args.beam,
                               max_new_tokens=args.max_new_tokens,
                               eos_token_id=tokenizer.eos_token_id, page_size=args.page_size,
                               max_len=args.max_len)
            dt = time.time() - t0
            print(f"--- {prompts[i]!r} ({dt:.2f}s)")
            for toks, score in hyps:
                print(f"  [{score:8.3f}] {tokenizer.decode(toks)}")
            out["prompts"][str(i)] = {"seconds": dt, "hypotheses": [
                {"tokens": [int(t) for t in toks], "score": float(score)} for toks, score in hyps]}
        return out

    if args.prefix_cache and not args.paged:
        ap.error("--prefix-cache requires --paged (the cache lives in the page pool)")

    if args.speculative and args.paged:
        from ..serving.paged import PagedSpeculativeBatcher

        model = fuse_for_serving(model)
        sb = PagedSpeculativeBatcher(model, served_draft(model), k=args.k, n_slots=args.slots,
                                     max_len=args.max_len, page_size=args.page_size,
                                     n_pages=args.pages or None)
        t0 = time.time()
        results = sb.run_all(ids, max_new_tokens=args.max_new_tokens)
        return dict(mode="paged_speculative", **_report(
            results, tokenizer, time.time() - t0, accept=sb.accepted / max(sb.proposed, 1)))

    if args.speculative and args.slots > 1:
        from ..serving.batching import SpeculativeBatcher

        model = fuse_for_serving(model)
        sb = SpeculativeBatcher(model, served_draft(model), k=args.k, n_slots=args.slots,
                                max_len=args.max_len, cache_dtype=torch.int8)
        t0 = time.time()
        results = sb.run_all(ids, max_new_tokens=args.max_new_tokens)
        return dict(mode="speculative_batcher", **_report(
            results, tokenizer, time.time() - t0, accept=sb.accepted / max(sb.proposed, 1)))

    if args.speculative:
        from ..serving.speculative import speculative_generate

        draft = load_model(args.draft_model, device=args.device) if args.draft_model else model
        results, accept, t0 = {}, {}, time.time()
        for i, p in enumerate(ids):
            out, stats = speculative_generate(model, draft, p, max_new_tokens=args.max_new_tokens,
                                              k=args.k, cache_dtype=torch.int8)
            results[i] = out[0, len(p[0]):].tolist()
            accept[str(i)] = stats["accept_rate"]
        return dict(mode="speculative", **_report(results, tokenizer, time.time() - t0,
                                                  accept=accept))

    model = fuse_for_serving(model)
    if args.paged:
        from ..serving.paged import PagedMegaBatcher

        batcher = PagedMegaBatcher(model, n_slots=args.slots, max_len=args.max_len,
                                   page_size=args.page_size, n_pages=args.pages or None,
                                   prefix_cache=args.prefix_cache)
    else:
        from ..serving.batching import ContinuousBatcher

        batcher = ContinuousBatcher(model, n_slots=args.slots, max_len=args.max_len,
                                    cache_dtype=torch.int8)
    sample_kw = {}
    if args.paged and (args.n > 1 or args.temperature > 0):
        sample_kw = dict(n=args.n, temperature=args.temperature, top_p=args.top_p,
                         top_k=args.top_k, seed=args.seed)
    pending = list(enumerate(ids))
    reqs = {}  # (prompt index, sample) -> Request (it keeps its tokens after completion)
    t0 = time.time()
    while pending or any(r is not None for r in batcher.slot_req):
        while pending:
            i, p = pending[0]
            rid = batcher.add_request(p, max_new_tokens=args.max_new_tokens,
                                      eos_token_id=tokenizer.eos_token_id, **sample_kw)
            if rid is None:
                break
            for j, r_ in enumerate(rid if isinstance(rid, list) else [rid]):
                reqs[(i, j)] = next(r for r in batcher.slot_req if r and r.rid == r_)
            pending.pop(0)
        batcher.step()
    dt = time.time() - t0
    results = {f"{i}.{j}" if args.n > 1 else str(i): reqs[(i, j)].tokens for i, j in sorted(reqs)}
    stats = {"slots": args.slots}
    if args.prefix_cache:
        stats["prefix_cache"] = batcher.prefix_cache_stats()
    return dict(mode="paged" if args.paged else "batcher",
                **_report(results, tokenizer, dt, **stats))


def main(argv=None):
    ap = _parser()
    return serve(ap.parse_args(argv), ap)


if __name__ == "__main__":
    main()
