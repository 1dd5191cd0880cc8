#!/usr/bin/env python3
"""Where one tensor-parallel rank's half-layer launch (B5(e), tp_kernel in
csrc/model_fused_tp.cu) spends its time, phase by phase, and what the
alternatives of its design cost, on one NVIDIA GPU.

    python3 scripts/torch_tp_phases.py [--reps N] [--items 64,128,512,1024] [--report PATH]

Copies mi_optimize_tpu_torch/csrc/ to build/tp_phases/<variant>/csrc/, where
thread 0 of every block of tp_kernel stamps %globaltimer: at entry (0),
after the prologue (1), before and after the first grid barrier (2, 3),
half 0 only before and after the second (4, 5, around the attention phase),
and at its end (6); its SM (7); and in half 0's attention item (the block's
last) at the phase's start (12), once it has found its item (13), before it
ropes its q heads (14), once its q heads (8), its new row (9) and its rows
(10) are made and its warps merged (11). Variants, each a copy with these
stamps:
  * "this": the package's kernel;
  * "no_barrier": no grid barrier after the prologue: every block sums the
    squares of all B rows of xin + add itself and the first GEMV stages its
    normed rows from xin + add, where "this" sums them from res after one
    barrier;
  * "shared_sums": a block writes its run of every row of res (a warp a
    row) with their sums of squares, and after the barrier each block adds
    the blocks' sums of a row in block order, where "this" has every block
    sum all B rows of res after the barrier;
  * "pipeline": a warp loads its next four rows while it multiplies the four
    before, where "this" loads each batch of four when it comes to it;
  * "ring": a warp's rows of a chunk stream through a ring of 8 rows in
    shared memory (cp.async), the first ones copied while the item makes
    its q heads and new row, where "this" loads its batches of four rows
    straight from the cache;
  * "merge_barrier": half 0's chunks are merged after one more grid barrier,
    one (slot, kv head, sub-group) a block, where "this" has the last item
    of each merge them as it arrives.
Every variant but "no_barrier" and "shared_sums" (whose sums of squares add
in other orders) must give the package's bits. On Llama-2-7B's rank 0 of 2
(int4 g128, bf16, seed 0; chip_smoke.check_mega_batch_tp's state at the
batched row's positions, dense and paged, and with one slot at 510 and
seven at 0), it prints for each variant and half (half 0 without and with
the reduced partial to add: layer 0's and the later layers' launch) the
package wrapper's time after an L2 flush (chip_smoke.time_ms), and from the
stamps each step's mean and slowest time over the blocks, from the first
block's entry; and the package's half 0 again with the split planned for
other budgets of items (--items). Prints one JSON list.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

STAMPS = 15  # 0-6 and 8-14 times, 7 the SM
ROPE_Q = ("    for (int d = threadIdx.x; d < D; d += NT) {\n"
          "      const float cd = cs[d], sd = sn[d];\n      for (int h = 0; h < nr; ++h) {")
ENTRY = "  constexpr int NB = 8;\n  extern __shared__ float smem[];\n"
# (a line of tp_kernel, the same line with its stamps)
STAMP_AT = [
    (ENTRY, ENTRY + "  PT_(0)\n  PT_SM(7)\n"),
    ("\n\n  if (a.half == 0) {", "\n  PT_(1)\n\n  if (a.half == 0) {"),
    ("    grid.sync();\n    // one q head an item",
     "    PT_(2)\n    grid.sync();\n    PT_(3)\n    // one q head an item"),
    ("      else attention_split<TG / 2, 2>(a, qkvb, attn, xs, red);\n    }\n    grid.sync();\n",
     "      else attention_split<TG / 2, 2>(a, qkvb, attn, xs, red);\n    }\n    PT_(4)\n"
     "    grid.sync();\n    PT_(5)\n"),
    ("          return 0.f;\n        });\n  } else {\n",
     "          return 0.f;\n        });\n    PT_(6)\n  } else {\n"),
    ("    grid.sync();\n    // the down_proj partial",
     "    PT_(2)\n    grid.sync();\n    PT_(3)\n    // the down_proj partial"),
    ("          return 0.f;\n        });\n  }\n}\n", "          return 0.f;\n        });\n    PT_(6)\n  }\n}\n"),
    # inside half 0's attention item (the block's last one)
    ("  for (int it = blockIdx.x; it < a.slot_item[B]; it += gridDim.x) {\n",
     "  PT_(12)\n  for (int it = blockIdx.x; it < a.slot_item[B]; it += gridDim.x) {\n"),
    ("    const int c = rem / per,", "    PT_(13)\n    const int c = rem / per,"),
    (ROPE_Q, "    PT_(14)\n" + ROPE_Q),
    ("    if (holds_new) {\n", "    PT_(8)\n    if (holds_new) {\n"),
    ("    // the warp's online softmax over its rows", "    PT_(9)\n    // the warp's online softmax over its rows"),
    ("    // the warps' states, merged in warp order", "    PT_(10)\n    // the warps' states, merged in warp order"),
    ("    float* out = attn + (long)b * qdim + (long)h0 * D;\n",
     "    PT_(11)\n    float* out = attn + (long)b * qdim + (long)h0 * D;\n"),
]
# The package's prologue: res = xin + add, a grid barrier, every block's
# rmsnorm sums of all B rows of res.
PROLOGUE = ("  // res = xin + add and the GEMV tile counters zeroed, then one grid",
            "  sum_rstd<NB>(rstd, a.res, B, h, f.eps, red);\n  __syncthreads();\n")
# "no_barrier": every block sums the squares of all B rows of xin + add
# itself, and the first GEMV stages its normed rows from xin + add (the GEMV
# tile counters zeroed before, by `rank_state`: every phase leaves them zero)
NO_BARRIER_PROLOGUE = """  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < (long)B * h; i += (long)gridDim.x * NT)
    a.res[i] = a.add ? a.xin[i] + a.add[i] : a.xin[i];
  sum_rstd_in<NB>(rstd, a.xin, a.add, B, h, f.eps, red);
  __syncthreads();
"""
NO_BARRIER_HELPERS = """template <int NB>
__device__ __forceinline__ void sum_rstd_in(float* rstd, const float* xin, const float* add, int B,
                                            int h, float eps, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) ss[m] = 0.f;
  for (int i = 4 * threadIdx.x; i < h; i += 4 * NT) {
    float4 v[NB];
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < B) {
        v[m] = __ldg(reinterpret_cast<const float4*>(xin + (long)m * h + i));
        if (add) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(add + (long)m * h + i));
          v[m] = make_float4(v[m].x + a.x, v[m].y + a.y, v[m].z + a.z, v[m].w + a.w);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
      ss[m] += (v[m].x * v[m].x + v[m].y * v[m].y) + (v[m].z * v[m].z + v[m].w * v[m].w);
  }
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const float t = warp_sum(ss[m]);
    if (lane == 0) red[warp * NB + m] = t;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += red[w * NB + threadIdx.x];
    rstd[threadIdx.x] = 1.f / sqrtf(t / (float)h + eps);
  }
}

template <class T>
struct RowsNormSum {
  const float* xin;
  const float* add;
  long ld;
  const T* w;
  const float* rstd;
  __device__ __forceinline__ float4 load4(int m, int k) const {
    float4 v = __ldg(reinterpret_cast<const float4*>(xin + m * ld + k));
    if (add) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(add + m * ld + k));
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    const float r = rstd[m];
    return make_float4(round_t<T>(round_t<T>(v.x * r) * to_f(w[k])),
                       round_t<T>(round_t<T>(v.y * r) * to_f(w[k + 1])),
                       round_t<T>(round_t<T>(v.z * r) * to_f(w[k + 2])),
                       round_t<T>(round_t<T>(v.w * r) * to_f(w[k + 3])));
  }
};

"""
# "shared_sums": a block writes its run of every row of res (a warp a row)
# with their sums of squares; after the barrier each block adds the blocks'
# sums of a row in block order
SHARED_SUMS_PROLOGUE = """  static_assert(NW == NB, "a warp a row");
  if constexpr (BITS == 4)
    for (int i = blockIdx.x * NT + threadIdx.x; i < f.n_counters; i += gridDim.x * NT)
      f.counters[i] = 0;
  {
    const int lane = threadIdx.x & 31, m = threadIdx.x >> 5, U = h / 4, G = gridDim.x;
    const int u0 = (int)((long)blockIdx.x * U / G), u1 = (int)((long)(blockIdx.x + 1) * U / G);
    float ss = 0.f;
    if (m < B)
      for (int u = u0 + lane; u < u1; u += 32) {
        float4 v = __ldg(reinterpret_cast<const float4*>(a.xin + (long)m * h) + u);
        if (a.add) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(a.add + (long)m * h) + u);
          v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
        }
        reinterpret_cast<float4*>(a.res + (long)m * h)[u] = v;
        ss += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
    ss = warp_sum(ss);
    if (lane == 0) g_rss[blockIdx.x * NB + m] = ss;
    grid.sync();
    float t = 0.f;
    for (int g = lane; g < G; g += 32) t += __ldcg(g_rss + g * NB + m);
    t = warp_sum(t);
    if (lane == 0 && m < B) rstd[m] = 1.f / sqrtf(t / (float)h + f.eps);
    __syncthreads();
  }
"""
# "ring": a warp's rows of the chunk stream through a ring of 8 rows in
# shared memory (cp.async, 4-byte pieces a lane, the scales by lane 0), the
# first ones copied while the item makes its q heads and new row
N_W = "    const int n_w = t1 - t0 > warp ? (t1 - t0 - warp + NW - 1) / NW : 0;  // the warp's rows\n"
RING_SETUP = N_W + """    const int rowb = 2 * D + 8;
    uint8_t* ring = reinterpret_cast<uint8_t*>(mrg) + warp * 8 * rowb;
    auto fetch = [&](int i) {
      const int t = t0 + warp + i * NW;
      if (i < n_w && t < p) {
        long r = t;
        if (hh.table) {
          const int j = t / hh.P;
          r = (long)__ldg(hh.table + j) * hh.page_rows + (t - j * hh.P);
        }
        uint8_t* slot = ring + (i % 8) * rowb;
        for (int bb = 4 * lane; bb < D; bb += 128) {
          cp_async4(slot + bb, hh.k + r * D + bb, true);
          cp_async4(slot + D + bb, hh.v + r * D + bb, true);
        }
        if (lane == 0) {
          cp_async4(slot + 2 * D, hh.ks + r, true);
          cp_async4(slot + 2 * D + 4, hh.vs + r, true);
        }
      }
      cp_async_commit();
    };
"""
ITEM_SYNC = "    __syncthreads();  // the previous item's reads of shared memory are done\n"
RING_PREFETCH = ITEM_SYNC + "#pragma unroll 1\n    for (int i = 0; i < 8; ++i) fetch(i);\n"
BATCH = ("    int kw[RB][MC], vw[RB][MC];\n    float ksr[RB], vsr[RB];\n",
         "      float s[RB][HG];\n")
# "pipeline": a warp loads its next four rows while it multiplies the four
# before (their codes and scales in a second set of registers)
LOADS = """    for (int i0 = 0; i0 < n_w; i0 += RB) {
      load(i0, kw, vw, ksr, vsr);
"""
PIPELINED_LOADS = """    load(0, kw, vw, ksr, vsr);
    for (int i0 = 0; i0 < n_w; i0 += RB) {
      int kn[RB][MC], vn[RB][MC];
      float ksn[RB], vsn[RB];
      load(i0 + RB, kn, vn, ksn, vsn);
"""
BATCH_END = """            for (int e = 0; e < 4; ++e) acc[h][j][e] = fmaf(pv, vf[e], acc[h][j][e]);
          }
        }
      }
"""
NEXT = BATCH_END + """#pragma unroll
      for (int i = 0; i < RB; ++i) {
        ksr[i] = ksn[i];
        vsr[i] = vsn[i];
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          kw[i][j] = kn[i][j];
          vw[i][j] = vn[i][j];
        }
      }
"""
RING_BATCH = """    for (int i0 = 0; i0 < n_w; i0 += RB) {
      cp_async_wait<4>();
      __syncwarp();
      int kw[RB][MC], vw[RB][MC];
      float ksr[RB], vsr[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int t = t0 + warp + (i0 + i) * NW;
        const bool live = i0 + i < n_w;
        const uint8_t* slot = ring + ((i0 + i) % 8) * rowb;
        const bool fresh = t == p;
        const int8_t* kr = fresh ? nk : reinterpret_cast<const int8_t*>(slot);
        const int8_t* vr = fresh ? nv : reinterpret_cast<const int8_t*>(slot + D);
        ksr[i] = !live ? 0.f : fresh ? nsc[0] : *reinterpret_cast<const float*>(slot + 2 * D);
        vsr[i] = !live ? 0.f : fresh ? nsc[1] : *reinterpret_cast<const float*>(slot + 2 * D + 4);
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          const int cc = lane + 32 * j;
          const bool on = live && cc < nw4;
          kw[i][j] = on ? reinterpret_cast<const int*>(kr)[cc] : 0;
          vw[i][j] = on ? reinterpret_cast<const int*>(vr)[cc] : 0;
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int i = 0; i < RB; ++i) fetch(i0 + 8 + i);
      float s[RB][HG];
"""
STATES = "    // the warps' states, merged in warp order; thread d < D takes column d\n"
KERNEL = "template <class T, int BITS, bool GEN>\n__global__"
# the variants' edits of the package's source: (the text, or (start, end) of a
# span, its replacement, the times it occurs)
VARIANTS = {
    "this": [],
    "no_barrier": [
        (PROLOGUE, NO_BARRIER_PROLOGUE, 1),
        ("RowsNorm<T>{a.res, h,", "RowsNormSum<T>{a.xin, a.add, h,", 2),
        (KERNEL, NO_BARRIER_HELPERS + KERNEL, 1)],
    "shared_sums": [
        (PROLOGUE, SHARED_SUMS_PROLOGUE, 1),
        (KERNEL, "__device__ float g_rss[1024 * 8];\n\n" + KERNEL, 1)],
    "pipeline": [(LOADS, PIPELINED_LOADS, 1), (BATCH_END, NEXT, 1)],
    "ring": [
        (N_W, RING_SETUP, 1), (ITEM_SYNC, RING_PREFETCH, 1), (BATCH, RING_BATCH, 1),
        (STATES, "    cp_async_wait<0>();\n    __syncthreads();\n" + STATES, 1)],
    "merge_barrier": [
        ("    __syncthreads();\n    __shared__ int is_last;\n",
         "    continue;\n    __shared__ int is_last;\n", 1),
        ("    merge_chunks(a, b, h0, nr, n_live, out, ml);\n  }\n}\n",
         "    merge_chunks(a, b, h0, nr, n_live, out, ml);\n  }\n"
         "  cg::this_grid().sync();\n"
         "  for (int it = blockIdx.x; it < B * per; it += gridDim.x) {\n"
         "    const int b = it / per, j = it - b * per, kvh = j / n_sub, sub = j - kvh * n_sub;\n"
         "    const int n_live = (a.slot_item[b + 1] - a.slot_item[b]) / per;\n"
         "    if (n_live == 1) continue;\n"
         "    const int h0 = kvh * reps + sub * grp, nr = min(grp, reps - sub * grp);\n"
         "    __syncthreads();\n"
         "    merge_chunks(a, b, h0, nr, n_live, attn + (long)b * qdim + (long)h0 * D, ml);\n"
         "  }\n}\n", 1)],
}
# the variants whose sums of squares add in another order than the package's
OTHER_SUMS = ("no_barrier", "shared_sums")


def variant_copy(name, edits):
    """build/tp_phases/<name>/csrc: the package's csrc/ with `edits` and the
    stamps applied to model_fused_tp.cu."""
    import torch_kernel_tools as tk
    from mi_optimize_tpu_torch.ops import _build

    src = os.path.join(HERE, "build", "tp_phases", name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = os.path.join(src, "model_fused_tp.cu")
    text = open(path).read()
    for old, new, n in edits:
        if isinstance(old, tuple):  # the span from old[0] through old[1]
            i = text.index(old[0])
            old = text[i:text.index(old[1], i) + len(old[1])]
        if text.count(old) != n:
            raise RuntimeError(f"model_fused_tp.cu changed: {old.strip()[:60]!r} is not there {n}x")
        text = text.replace(old, new)
    after = '#include "batch_common.cuh"\n'
    head, body = text.split(after, 1)
    for old, new in STAMP_AT:
        if body.count(old) != 1:
            raise RuntimeError(f"model_fused_tp.cu changed: no single line {old.strip()!r}")
        body = body.replace(old, new)
    with open(path, "w") as f:
        f.write(head + after + tk.stamp_prelude((STAMPS, tk.MAXB)) + body)
    return src


def rank_state(model, meta, cfg, positions, paged, dev="cuda"):
    """Rank 0 of 2's mode (e) launch state at `positions`, as
    chip_smoke.check_mega_batch_tp makes it: (prep, x32)."""
    import torch

    import chip_smoke
    from mi_optimize_tpu_torch.models import llama
    from mi_optimize_tpu_torch.ops import model_fused as mf
    from mi_optimize_tpu_torch.parallel.sharding import cache_shard
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving_tp

    B = len(positions)
    gen = torch.Generator(device=dev).manual_seed(8 + B)
    cache = chip_smoke.random_slot_cache(cfg, positions, 512, dev, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    x = llama.embed(model.params, toks)
    cos, sin = llama.rope_tables(cfg, torch.tensor(positions, device=dev)[:, None])
    st0, _, cfg_l = stack_serving_tp(model, 2, 0)
    table = None
    if paged:
        cache, table = chip_smoke.mirror_pool(cache, torch.Generator(device=dev).manual_seed(12))
    c0 = cache_shard(cache, 0, 2)
    prep = mf.tp_prepare(st0, x, cos.reshape(B, -1), sin.reshape(B, -1), c0, positions, cfg_l,
                         meta, table)
    prep.keep += [st0, c0]  # the launch block points into them
    for t in prep.keep:  # the "no_barrier" prologue cannot zero them itself
        if isinstance(t, torch.Tensor) and t.data_ptr() == prep.args.counters:
            t.zero_()
    return prep, x.reshape(B, -1).float().contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--report", help="also write the JSON list to this path")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="the variants to run")
    ap.add_argument("--items", default="64,128,512,1024",
                    help="other budgets of the attention split's items (model_fused.TP_ITEMS) at "
                         "which the package's half 0 is also timed")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_tp_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import torch_kernel_tools as tk
    from mi_optimize_tpu_torch.models.llama import LlamaConfig
    from mi_optimize_tpu_torch.models.model import Model
    from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
    from mi_optimize_tpu_torch.ops import _build
    from mi_optimize_tpu_torch.ops import model_fused as mf
    from mi_optimize_tpu_torch.serving.megadecode import stack_serving
    from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving

    chip_smoke.log(f"gpu: {chip_smoke.nvidia_smi_line()}")
    own = _build.load("model_fused_tp")
    libs = {}
    procs = {}
    for name in args.variants.split(","):
        src = variant_copy(name, VARIANTS[name])
        lib = os.path.join(os.path.dirname(src), f"lib{name}.so")
        procs[name] = (tk.start_build(src, "model_fused_tp.cu", lib), lib)
    for name, (proc, lib) in procs.items():
        log = tk.finish_build(proc, f"the {name} copy")
        for r in chip_smoke.ptxas_rows(log, r"tp_kernelI(f|13__nv_bfloat16)Li(\d)ELb(\d)E",
                                       lambda m: f"tp_kernel<{m.group(1)}, {m.group(2)}, "
                                                 f"GEN={m.group(3)}>"):
            if "13__nv_bfloat16, 4" in r["instance"]:
                chip_smoke.log(f"  {name}: {r['instance']}: {r.get('registers')} registers, "
                               f"{r['spill_stores']}/{r['spill_loads']} bytes spilled")
        libs[name] = ctypes.CDLL(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b()
    model = fuse_for_serving(Model(config=cfg, params=build_quantized_llama(
        cfg, bits=4, groupsize=128, dtype=torch.bfloat16, seed=0, device="cuda",
        symmetric=True)))
    _, meta = stack_serving(model)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    dense = [0, 17, 64, 127, 128, 200, 383, 510]
    out = []
    for row, positions, paged in (("dense", dense, False), ("paged", dense, True),
                                  ("one slot at 510", [510] + [0] * 7, False)):
        prep, x32 = rank_state(model, meta, cfg, positions, paged)
        res0, part0 = (t.clone() for t in mf.tp_launch(prep, 0, 0, x32, None))
        add0 = part0.clone()  # a reduced partial to add: the later layers' half 0
        # (layer, half, residual in, partial to add) of each launch timed
        launches = {"half 0": (0, 0, x32, None), "half 0 + add": (1, 0, res0, add0),
                    "half 1": (0, 1, res0, part0)}

        def written(layer, half, xin, add):
            """One launch and what it writes: its residual, its partial and,
            half 0, its layer's new rows."""
            out = [t.clone() for t in mf.tp_launch(prep, layer, half, xin, add)]
            return out + ([o[layer].clone() for o in prep.outs[1:]] if half == 0 else [])

        want = {k: written(*v) for k, v in launches.items()}
        for name, lib in libs.items():
            _build._libs["model_fused_tp"] = lib
            try:
                for k, v in launches.items():
                    fn = lambda v=v: mf.tp_launch(prep, *v)
                    same = all(torch.equal(a, b) for a, b in zip(written(*v), want[k]))
                    if not same and name not in OTHER_SUMS:
                        raise AssertionError(f"variant {name} {k}: other bits than the package's")
                    ms = chip_smoke.time_ms(fn, args.reps, flush)
                    tk.clear_stamps(lib)
                    flush.zero_()
                    torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
                    fn()
                    torch.cuda.synchronize()
                    t = tk.read_stamps(lib, (STAMPS, tk.MAXB))
                    live = t[7] > 0
                    t0 = int(t[0][live].min())
                    steps = {}
                    for k_ in (0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14):
                        at = t[k_][live]
                        at = at[at > 0]
                        if at.size:
                            us = (at.astype(np.int64) - t0) / 1e3
                            steps[str(k_)] = [float(us.mean()), float(us.max())]
                    res = dict(row=row, positions=positions, variant=name, launch=k, ms=ms,
                               blocks=int(live.sum()), stamps_us=steps)
                    chip_smoke.log(f"  {json.dumps(res)}")
                    out.append(res)
            finally:
                _build._libs["model_fused_tp"] = own
        budget = mf.TP_ITEMS
        for items in (int(v) for v in args.items.split(",") if v):
            mf.TP_ITEMS = items
            try:
                prep_i, _ = rank_state(model, meta, cfg, positions, paged)
            finally:
                mf.TP_ITEMS = budget
            ms = chip_smoke.time_ms(lambda: mf.tp_launch(prep_i, 0, 0, x32, None), args.reps,
                                    flush)
            res = dict(row=row, positions=positions, variant="this", launch="half 0",
                       items=items, split=list(prep_i.split), ms=ms)
            chip_smoke.log(f"  {json.dumps(res)}")
            out.append(res)
            del prep_i
        del prep
        torch.cuda.empty_cache()
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
