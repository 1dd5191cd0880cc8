#!/usr/bin/env python3
"""Compare the PTX of the port's CUDA kernels between this tree and another
(a parent commit unpacked under build/), kernel by kernel.

    python3 scripts/torch_ptx_diff.py --tree build/parent [--sources model_flat model_mega4]

Compiles each csrc/<source>.cu of both trees to PTX with the build's nvcc
flags (one nvcc per file, all started together) under build/ptx_diff/, then
prints one line per kernel entry: "same" where the entry's PTX is line for
line the other tree's, else how many lines differ, or that one tree lacks
it. A shared header edited outside a kernel's own code paths leaves that
kernel "same". Needs nvcc (the card's machine).
"""
from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SOURCES = ("model_flat", "model_mega4", "model_fused", "block_fused", "dequant_matmul",
                   "mlp_fused", "decode_attention")


def entries(ptx: str) -> dict:
    """{mangled entry name: its PTX lines}, the anonymous namespace's hash
    (which follows the source's path) taken out of every name."""
    out, name, body = {}, None, []
    for line in re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", ptx).splitlines():
        m = re.match(r"\s*(?:\.visible\s+)?\.entry\s+(\w+)\(", line)
        if m:
            name, body = m.group(1), []
        if name is not None:
            body.append(line)
            if line.startswith("}"):
                out[name] = body
                name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="the other tree's root (holds mi_optimize_tpu_torch/)")
    ap.add_argument("--sources", nargs="*", default=list(DEFAULT_SOURCES))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from mi_optimize_tpu_torch.ops import _build

    drop = ("-gencode", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    flags = ["-arch=sm_90a" if f.startswith("arch=") else f for f in _build.FLAGS
             if f not in drop]
    out_dir = os.path.join(HERE, "build", "ptx_diff")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for src in args.sources:
        for tag, root in (("this", HERE), ("other", os.path.abspath(args.tree))):
            cu = os.path.join(root, "mi_optimize_tpu_torch", "csrc", f"{src}.cu")
            dst = os.path.join(out_dir, f"{src}.{tag}.ptx")
            cmd = [_build.nvcc_path(), *flags, "-ptx", "-o", dst, cu]
            jobs[(src, tag)] = (dst, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    ok = True
    for (src, tag), (dst, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{src} ({tag} tree): nvcc failed\n{log}")
            ok = False
    if not ok:
        return 1
    for src in args.sources:
        with open(os.path.join(out_dir, f"{src}.this.ptx")) as f:
            mine = entries(f.read())
        with open(os.path.join(out_dir, f"{src}.other.ptx")) as f:
            theirs = entries(f.read())
        for name in sorted(set(mine) | set(theirs)):
            if name not in theirs:
                print(f"{src}: {name}: only in this tree")
            elif name not in mine:
                print(f"{src}: {name}: only in the other tree")
            elif mine[name] == theirs[name]:
                print(f"{src}: {name}: same ({len(mine[name])} lines)")
            else:
                n = sum(1 for d in difflib.unified_diff(theirs[name], mine[name], n=0, lineterm="")
                        if d[:1] in "+-" and d[:3] not in ("+++", "---"))
                print(f"{src}: {name}: {n} lines differ ({len(theirs[name])} -> {len(mine[name])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
