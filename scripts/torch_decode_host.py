#!/usr/bin/env python3
"""Where the host's time goes in `engine.decode_loop` (one per-layer decode
launch a layer, 32 a token) at Llama-2-7B on one NVIDIA GPU.

    python3 scripts/torch_decode_host.py [--tree PATH] [--tokens N] [--top K]

Builds chip_smoke.py's random-weight Llama-2-7B (int4 g128, bf16, seed 0,
`fuse_for_serving`), prefills 128 seeded tokens into a T=512 int8 cache and
decodes `--tokens` tokens with `engine.decode_loop` as phase 5's
`decode_loop_block_8` window does: the wall a token (host clock around the
loop and a synchronize, best of 3), then the same loop under cProfile,
whose functions (self time and with callees, per token) say which host
code the card waits on. `--tree` runs the package of another checkout (a
parent commit unpacked with `git archive`) for a comparison in one call.
Prints one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="the checkout whose package to run")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_host: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.serving import engine
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    dev, S, T, n = "cuda", 128, 512, args.tokens
    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}  tree: {tree}")
    cfg = LlamaConfig.llama2_7b()
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device=dev)))
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(6))
    logits, cache = engine.prefill(model.params, cfg, prompt.to(dev),
                                   engine.init_cache(cfg, 1, T, torch.int8, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    run = lambda: engine.decode_loop(model.params, cfg, tok, cache, S, n)
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / n)
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = []
    for (fn, line, name), (_, calls, tt, ct, _) in st.stats.items():
        rows.append(dict(function=f"{os.path.relpath(fn, tree) if fn.startswith(tree) else fn}:"
                                  f"{line}({name})",
                         calls_per_token=calls / n, self_ms_per_token=tt * 1e3 / n,
                         total_ms_per_token=ct * 1e3 / n))
    rows.sort(key=lambda r: -r["self_ms_per_token"])
    chip_smoke.log(f"  decode_loop: {min(walls):.3f} ms/token wall (best of 3); under cProfile, "
                   f"per token:")
    for r in rows[:args.top]:
        chip_smoke.log(f"    self {r['self_ms_per_token']:8.3f}  total {r['total_ms_per_token']:8.3f}"
                       f"  calls {r['calls_per_token']:6.1f}  {r['function'][-100:]}")
    print(json.dumps({"tree": tree, "wall_ms_per_token": min(walls), "top": rows[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
