#!/usr/bin/env python3
"""Where the one-token whole-model kernel (`model_decode_mega`) and its plain
version round an int8 k/v code apart, on the card tests' small models.

    python3 scripts/torch_mega_ties.py [--seeds 8]

For every 4-bit row of tests/test_torch_cuda_kernels.py::WHOLE_MODEL (float32,
2 layers, 512 codes of k and 512 of v a launch), every position of
POSITIONS and `--seeds` seed offsets k (k = 0 gives the inputs of
`test_model_decode_mega`: weights from seed pos + bits, cache and x from
seed pos; k > 0 adds 100 k to both), it launches the kernel and runs the
plain version with its int8 quantizer recorded, and counts the codes that
differ. For each it prints the plain value before rounding (x / scale) and
its distance from the nearest .5 tie. Only the first layer with a flip
starts from the plain version's inputs: later layers see the kernel's own
flipped rows, so their distances say nothing about ties. Run it from two
trees in one call to compare their kernels on the same inputs. Prints one
JSON object as the last line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_mega_ties: no CUDA device", file=sys.stderr)
        return 2
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import block_fused, model_fused

    # the card tests' cases and helpers, loaded by path: an installed package
    # named `tests` may shadow this tree's
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(HERE, "tests", "test_torch_cuda_kernels.py"))
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    POSITIONS, T_MEGA, WHOLE_MODEL, _cache, _stacked, _to = (
        t.POSITIONS, t.T_MEGA, t.WHOLE_MODEL, t._cache, t._stacked, t._to)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    runs, codes, flips = 0, 0, []
    for row in [m for m in WHOLE_MODEL if m[0] == 4]:
        bits = row[0]
        for pos in POSITIONS:
            for k in range(args.seeds):
                seed = pos + 100 * k  # cache and x; the weights pos + bits + 100 k
                cfg, _, stack, meta = _stacked(dev, *row, seed + bits)
                cache = _to(_cache(cfg, T_MEGA, pos, layers=cfg.num_layers, seed=seed), dev)
                x = torch.randn(1, 1, cfg.hidden_size,
                                generator=torch.Generator().manual_seed(seed)).to(dev)
                cos, sin = llama.rope_tables(cfg, torch.tensor([pos], device=dev))
                a = (stack, x, cos.reshape(-1), sin.reshape(-1), cache, pos, cfg, meta)
                got = model_fused.model_decode_mega(*a)
                vals = []  # layer l's k values before rounding, then its v values

                def quantize(t):
                    q, s = llama.quantize_kv(t)
                    vals.append((t.float() / s[..., None]).reshape(-1).cpu())
                    return q, s

                with mock.patch.object(block_fused, "quantize_kv", quantize):
                    ref = model_fused.model_decode_mega_ref(*a)
                runs += 1
                first = None  # the first layer with a flip
                for layer in range(cfg.num_layers):
                    for i, name in ((1, "k"), (2, "v")):
                        g = got[i][layer].reshape(-1).cpu().to(torch.int32)
                        r = ref[i][layer].reshape(-1).cpu().to(torch.int32)
                        codes += g.numel()
                        for j in (g != r).nonzero().reshape(-1).tolist():
                            first = layer if first is None else first
                            v = float(vals[2 * layer + i - 1][j])
                            flips.append(dict(row=list(row), pos=pos, seed=seed, layer=layer,
                                              first=layer == first, kv=name, index=j,
                                              kernel=int(g[j]), plain=int(r[j]), value=v,
                                              from_tie=abs(v - (math.floor(v) + 0.5))))
                            print(f"flip: {flips[-1]}", flush=True)
    lead = [f for f in flips if f["first"]]
    out = dict(tree=HERE, runs=runs, codes=codes, flips=len(flips),
               cases=sorted({(tuple(f["row"]), f["pos"], f["seed"]) for f in flips}),
               first_layer_flips=len(lead),
               first_layer_max_from_tie=max((f["from_tie"] for f in lead), default=None))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
