// The 4-bit one-row layer loop that the flat kernels (model_flat.cu: one
// token, or kseg tokens in one launch) and the one-token whole-model kernel
// (model_mega4.cu) share, and the flat kernels' argument block that it reads.
#pragma once

#include "decode_common.cuh"
#include "flat_gemv.cuh"

// Host-side argument block, mirrored field by field by the ctypes Structure
// in ops/model_flat.py. Stacked arrays carry a leading layer axis; the
// per-token arrays (cos, sin, token, kvrow, kvsc) a leading kseg axis in the
// multi-token kernel.
struct FlatArgs {
  const void* x;                     // model dtype [h] (embedding row of the first token)
  const void* n1; const void* n2;    // model dtype [L, h]
  const int32_t* qkv; const float* qs;   // [L, h/vpw, nqkv], [L, h/g, nqkv]
  const int32_t* o; const float* os;     // [L, qdim/vpw, h], [L, qdim/g, h]
  const int32_t* gu; const float* gus;   // [L, h/vpw, 2I], [L, h/g, 2I]
  const int32_t* dn; const float* ds;    // [L, I/vpw, h], [L, I/g, h]
  const int32_t* ue; const float* ues;   // [h/vpw, V], [h/g, V]
  const void* fnorm;                     // model dtype [h]
  const float* cos; const float* sin;    // [kseg, D]
  const int8_t* kv; const float* kvs;    // [L, T, 2, Hkv, D], [L, T, 2, Hkv]
  int* token; float* logits;             // [kseg], [V] (the last token's)
  int8_t* kvrow; float* kvsc;            // [kseg, L, 2, Hkv, D], [kseg, L, 2, Hkv]
  float* scratch;  // f32: xres h | qkv nqkv | attn qdim | xmid h | act inter | part_val
  int* part_idx;   // [max_blocks]
  const void* emb;  // model dtype [V, h]: the multi-token kernel's embedding table
  int n_layers, hidden, n_heads, n_kv_heads, head_dim, inter, vocab, max_len, pos;
  int g_qkv, g_o, g_gu, g_d, g_ue, max_blocks, kseg;
  float zc_qkv, zc_o, zc_gu, zc_d, zc_ue, eps;
  // The 4-bit flat kernels' plan (flat_gemv.cuh; ops/model_flat.py::
  // flat_plans): warp strips a tile and K splits of qkv, o_proj, gate/up,
  // down_proj and the lm_head, the staged window (k), and the f32 partials
  // [splits, columns] of qkv, o_proj, gate/up and down_proj (n_part floats,
  // in that order). The 2- and 8-bit instances ignore them.
  int plan_ws[mi::FG_GEMVS], plan_splits[mi::FG_GEMVS], plan_kc, n_part;
  float* part;
};

namespace mi {

// The flat kernel's X for flat4_model: the lm step, the merged cache, no
// bias tables, one token.
struct FgFlat {
  static constexpr bool kLm = true, kSeg = false;
};

// The multi-token flat kernel's X: FgFlat's loop for f.kseg greedy tokens
// (see flat4_model).
struct FgSeg {
  static constexpr bool kLm = true, kSeg = true;
};

// The lm phase's fold of a block: the lanes' (max, first index) over the
// warp, the warps' through sm.ysum, then thread 0's into part_val[block] and
// part_idx[block].
__device__ __forceinline__ void fg_fold(float best, int best_i, const FgSmem& sm,
                                        float* part_val, int* part_idx) {
  int* widx = reinterpret_cast<int*>(sm.ysum + NW);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
  __syncthreads();  // the GEMV's last reads of the warp sums are done
  if ((threadIdx.x & 31) == 0) {
    sm.ysum[threadIdx.x >> 5] = best;
    widx[threadIdx.x >> 5] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NW; ++w)
      if (sm.ysum[w] > best || (sm.ysum[w] == best && widx[w] < best_i)) {
        best = sm.ysum[w];
        best_i = widx[w];
      }
    part_val[blockIdx.x] = best;
    part_idx[blockIdx.x] = best_i;
  }
}

// The 4-bit one-row layer loop (flat_gemv.cuh) of model_flat_kernel<T, 4>
// (model_flat.cu) and mega4_kernel (model_mega4.cu): phases P1-P5 of
// decoder_layer as steps of one loop, step 4l + p the GEMV of phase p of
// layer l (qkv, o_proj, gate/up, down_proj) and, with an lm step, step 4L the
// lm_head, so that the kernel holds one copy of the GEMV. Each GEMV's first
// ring stages are issued before the grid barrier in front of its phase, and
// the residual stays in shared memory (each block adds the split partials
// itself). P2 computes attention_phase's arithmetic (fg_attention_phase); the
// rounding points are decoder_layer's; the lm phase folds (max, first index)
// a block and block 0 reduces them after one more barrier.
//
// X says what the kernel adds to the loop. FgFlat (the flat kernel): the lm
// step, the merged cache [L, T, 2, Hkv, D], one zero a linear. FgSeg (the
// multi-token flat kernel, X::kSeg): FgFlat's steps for tokens tk = 0 ..
// f.kseg - 1 in turn, the same GEMV phases, plan, rings and rounding
// points for each; token tk's input row is f.x at tk = 0, else the
// embedding row (f.emb) of token tk - 1's winner; its rope rows are f.cos /
// f.sin + tk*D at position f.pos + tk; its new rows and scales go to
// (tk*L + l) of f.kvrow / f.kvsc; P2 streams layer l's cache rows before
// f.pos through the one-token kernel's history ring, then the segment's own
// rows of layer l, which other blocks wrote earlier in this launch, as a
// SegHist tail by L2 loads, never through L1. The steps of token tk + 1
// follow token tk's lm step in the same loop, so that the instance holds
// one copy of each phase as the one-token kernel does: at the lm step each
// block folds its (max, first index), and after one barrier every block
// reduces all the blocks' pairs itself (the same total order, so the same
// winner in each), so that no second barrier passes the token on; block 0
// writes token[tk]; then the next token's first qkv stages are issued.
// Otherwise (mega4_kernel's view, X::kLm false): no lm step; x.table(st)
// is step st's bias table (a BIAS instance streams it, fg_gemv<T, true>),
// held in x.bt from the prime to the GEMV, with the block's bias ring
// x.bring; x.cache(l, a) points P2 at layer l's split cache and new rows;
// after the last down_proj and one more barrier x.finish<T>(sm, pd) writes
// the output row. B4's and the segment's differences sit in `if constexpr`
// branches, so that the flat kernel's instances get the PTX of the loop
// without them: ptxas's register budget moves with small edits here
// (chip_smoke.py phase 1 reports every instance's registers and spills).
template <class T, class X>
__device__ __forceinline__ void flat4_model(const FlatArgs& f, X& x, float* smem) {
  cg::grid_group grid = cg::this_grid();
  const int h = f.hidden, D = f.head_dim, I = f.inter, Hkv = f.n_kv_heads, L = f.n_layers;
  const int qdim = f.n_heads * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim;
  const FgSmem sm = fg_smem(smem, h, f.plan_kc);
  float* attn = f.scratch + h + nqkv;
  float* part_val = attn + qdim + h + I;
  float* pq = f.part;                               // qkv partials [splits, nqkv]
  float* po = pq + (long)f.plan_splits[0] * nqkv;   // o_proj partials [splits, h]
  float* pg = po + (long)f.plan_splits[1] * h;      // gate/up partials [splits, 2I]
  float* pd = pg + (long)f.plan_splits[2] * 2 * I;  // down_proj partials [splits, h]

  LayerArgs a{};
  a.attn_buf = attn;
  a.cos = f.cos; a.sin = f.sin;
  if constexpr (X::kLm) {
    a.kv_stride = 2L * kvdim;
    a.s_stride = 2L * Hkv;
  } else {  // the split cache [L, T, Hkv, D]
    a.kv_stride = kvdim;
    a.s_stride = Hkv;
  }
  a.n_heads = f.n_heads; a.n_kv_heads = Hkv; a.head_dim = D; a.pos = f.pos;

  // the GEMV of step st: phase st % 4 of layer st / 4, or the lm_head
  auto gemv = [&](int st) {
    const long l = st >> 2;
    const int p = st == 4 * L ? 4 : st & 3;
    const int32_t* W[4] = {f.qkv + l * (h / 8) * nqkv, f.o + l * (qdim / 8) * h,
                           f.gu + l * (h / 8) * 2 * I, f.dn + l * (I / 8) * h};
    const float* S[4] = {f.qs + l * (h / f.g_qkv) * nqkv, f.os + l * (qdim / f.g_o) * h,
                         f.gus + l * (h / f.g_gu) * 2 * I, f.ds + l * (I / f.g_d) * h};
    const int K[5] = {h, qdim, h, I, h}, G[5] = {f.g_qkv, f.g_o, f.g_gu, f.g_d, f.g_ue};
    const int N[5] = {nqkv, h, 2 * I, h, f.vocab};
    const float Z[5] = {f.zc_qkv, f.zc_o, f.zc_gu, f.zc_d, f.zc_ue};
    return FGemv{p == 4 ? f.ue : W[p], p == 4 ? f.ues : S[p], N[p], G[p], K[p] / G[p],
                 f.plan_ws[p], f.plan_splits[p], Z[p]};
  };

  FgCursor fc;
  if constexpr (X::kLm) {
    fg_prime(fc, gemv(0), sm);
  } else {
    x.bt = x.table(0);
    fg_prime<X::kBias>(fc, gemv(0), sm, x.bt, x.bring);
  }
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  // a segment's token tk ([0]) and token tk - 1's winner ([1]) live in shared
  // memory (red's last two slots, which no phase of this loop uses), not in
  // registers across the GEMVs: a register more there moved the loop's spills
  // and slowed every token (scripts/torch_flat_variants.py)
  volatile int* seg = reinterpret_cast<volatile int*>(sm.red + RED_FLOATS - 2);
  if constexpr (X::kSeg) {
    if (threadIdx.x == 0) seg[0] = 0;
    __syncthreads();
  }
  for (int st = 0; st <= 4 * L; ++st) {
    if constexpr (!X::kLm)
      if (st == 4 * L) break;
    const int l = st >> 2, p = st & 3;
    const bool lm = st == 4 * L;
    FgRow row{FG_SRC_L2, FG_PLANES, nullptr, attn, 0.f, 0, 0};
    if (p == 0 || p == 2) {
      // P1 (and the final norm): the residual, the input row or the last
      // layer's plus its down_proj partials; P4: plus the o_proj partials
      const T* x0 = st == 0 ? (const T*)f.x : nullptr;
      if constexpr (X::kSeg)
        if (st == 0 && seg[0] > 0) x0 = (const T*)f.emb + (long)seg[1] * h;
      const float ss = fg_residual<T>(sm.vec, x0, p ? po : pd, f.plan_splits[p ? 1 : 3], h, h,
                                      sm.red);
      row = FgRow{FG_SRC_NORM, FgNormPlanes<T>::n,
                  lm ? f.fnorm : (const T*)(p ? f.n2 : f.n1) + (long)l * h, sm.vec,
                  1.f / sqrtf(ss / (float)h + f.eps), 0, 0};
    } else if (p == 3) {
      row = FgRow{FG_SRC_ACT, FG_PLANES, nullptr, pg, 0.f, f.plan_splits[2], I};
    }
    float* out = lm ? f.logits : p == 0 ? pq : p == 1 ? po : p == 2 ? pg : pd;
    if constexpr (X::kLm) {
      fg_gemv<T>(fc, row, sm, lm ? FG_OUT_LOGITS : FG_OUT_PARTS, out, best, best_i);
    } else {
      fg_gemv<T, X::kBias>(fc, row, sm, FG_OUT_PARTS, out, best, best_i, x.bt, x.bring);
    }
    if constexpr (X::kSeg) {
      if (!lm) fg_prime(fc, gemv(st + 1), sm);
    } else {
      if (lm) break;
      if constexpr (X::kLm) {
        fg_prime(fc, gemv(st + 1), sm);
      } else if (st + 1 < 4 * L) {
        x.bt = x.table(st + 1);
        fg_prime<X::kBias>(fc, gemv(st + 1), sm, x.bt, x.bring);
      }
    }
    if constexpr (X::kSeg) {
      if (lm) {
        // every block: its (max, first index), then after one barrier the
        // greatest pair of all the blocks', a warp's lanes over blocks lane,
        // lane + 32, .. then folded: the same total order, so the same winner
        // in every block, and no second barrier passes the token on
        fg_fold(best, best_i, sm, part_val, f.part_idx);
        grid.sync();
        const int tk = seg[0];
        if (threadIdx.x < 32) {
          float bv = -INFINITY;
          int bi = 0x7fffffff;
          for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
            const float v = __ldcg(part_val + b);
            const int i = __ldcg(f.part_idx + b);
            if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
          }
          if (threadIdx.x == 0) {
            seg[1] = bi;  // the next token's input row, read at its first step
            if (blockIdx.x == 0) f.token[tk] = bi;
          }
        }
        if (tk + 1 == f.kseg) break;
        fg_prime(fc, gemv(0), sm);  // the next token's first qkv stages
        __syncthreads();  // every thread has read seg[0]
        if (threadIdx.x == 0) seg[0] = tk + 1;
        __syncthreads();
        best = -INFINITY;
        best_i = 0x7fffffff;
        st = -1;  // the next token's step 0
        continue;
      }
    }
    grid.sync();
    if (p == 0) {
      // P2: RoPE, the new int8 k/v rows, attention
      if constexpr (X::kSeg) {
        // token tk's rows of layer l; its history: the cache rows before
        // f.pos, then the segment's rows of layer l
        const int tk = seg[0];
        const int8_t* kvl = f.kv + (long)l * f.max_len * 2 * kvdim;
        const float* kvsl = f.kvs + (long)l * f.max_len * 2 * Hkv;
        a.ck = kvl; a.cv = kvl + kvdim;
        a.cks = kvsl; a.cvs = kvsl + Hkv;
        const long r = (long)tk * L + l;
        a.krow = f.kvrow + r * 2 * kvdim;
        a.vrow = a.krow + kvdim;
        a.ks_out = f.kvsc + r * 2 * Hkv;
        a.vs_out = a.ks_out + Hkv;
        a.cos = f.cos + (long)tk * D;
        a.sin = f.sin + (long)tk * D;
        a.pos = f.pos + tk;
        const int8_t* rows = f.kvrow + (long)l * 2 * kvdim;
        const float* scs = f.kvsc + (long)l * 2 * Hkv;
        fg_attention_phase(
            a, pq, f.plan_splits[0], nqkv, sm.win, sm.red,
            [&](int kvh) {
              HeadHist c = head_hist(a, kvh);  // written before the launch: the ring's
              c.pos = f.pos;
              return c;
            },
            [&](int kvh) {
              return SegHist{a.ck + (long)kvh * D, a.cks + kvh, rows + (long)kvh * D, scs + kvh,
                             kvdim, Hkv, L, f.pos, a.pos};
            });
      } else {
        if constexpr (X::kLm) {
          const int8_t* kvl = f.kv + (long)l * f.max_len * 2 * kvdim;
          const float* kvsl = f.kvs + (long)l * f.max_len * 2 * Hkv;
          a.ck = kvl; a.cv = kvl + kvdim;
          a.cks = kvsl; a.cvs = kvsl + Hkv;
          a.krow = f.kvrow + (long)l * 2 * kvdim;
          a.vrow = a.krow + kvdim;
          a.ks_out = f.kvsc + (long)l * 2 * Hkv;
          a.vs_out = a.ks_out + Hkv;
        } else {
          x.cache(l, a);
        }
        fg_attention_phase(a, pq, f.plan_splits[0], nqkv, sm.win, sm.red,
                           [&](int kvh) { return head_hist(a, kvh); });
      }
      grid.sync();
    }
  }

  if constexpr (!X::kLm) {
    x.template finish<T>(sm, pd);
  } else if constexpr (!X::kSeg) {
    fg_fold(best, best_i, sm, part_val, f.part_idx);
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int b = 0; b < (int)gridDim.x; ++b) {
        const float v = __ldcg(part_val + b);
        const int i = __ldcg(f.part_idx + b);
        if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
      }
      f.token[0] = bi;
    }
  }
}

}  // namespace mi
