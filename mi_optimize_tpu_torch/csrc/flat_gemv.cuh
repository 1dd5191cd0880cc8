// The one-row whole-model kernels' GEMV for 4-bit words, on the tensor cores:
// phases P1 qkv, P3 o_proj, P4 gate/up and P5 down_proj of every layer and
// the lm_head of model_flat_kernel<T, 4> and of each token of
// model_flat_seg_kernel<T, 4> (model_flat.cu), and the same four phases of
// mega4_kernel (model_mega4.cu), one row. The 2- and 8-bit instances keep
// decode_common.cuh's CUDA-core tile_dot.
//
// Replaces the `_qdot` calls of the TPU kernels
// mi_optimize_tpu/ops/model_flat.py::_kernel_flat and
// mi_optimize_tpu/ops/model_fused.py::_kernel (block_fused.py::_qdot):
// the grouped rescale. Per group of g k, D[g] = sum_k x[k] * (q[k,n] - 8) on
// the centered codes, then y[n] = sum_g s*D[g] + (b + 8s) * xsum[g], xsum the
// f32 sum of x over the group, as the plain version
// ops/dequant_matmul.py::qdot_ref computes it. b is -zc*s from one constant
// zero a linear, or, in the BIAS instances (fg_gemv<T, true>: an asymmetric
// grid's zero a group and column), the bias table's entry, copied beside
// the scales; b + 8s rounds once either way (8s is exact).
//
// What bounds it: the packed words and scales of the whole model plus the
// lm_head, read once a token: 3.56 GB at Llama-2-7B int4 g128, 1.06 ms at
// 3.35 TB/s. What the design does about it:
//   * The multiply-adds run on mma.m16n8k16 (bf16 in, f32 accumulators):
//     the weights are A (16 output columns x k16, centered codes from a word
//     by the exponent-bias trick of mma_common.cuh, exact in bf16), the row
//     is B, as exact bf16 planes in the n8 fragment's columns: one plane
//     where the row is a bf16 value already (a bf16 model's normed rows:
//     qkv, gate/up, lm_head), three (x = hi + mid + lo, each rounded to
//     nearest from what is left) where it is f32 (the attention output, SiLU
//     * up, every row of an f32 model); the other columns are zero, so one
//     mma serves every plane. Products are exact; only the order of the f32
//     additions differs from the plain version. A lane unpacks a word in 11
//     instructions (a shift, one lop3 with the mask and the bias exponent in
//     registers, one bf16x2 subtraction a pair), where the CUDA-core dot it
//     replaces issued about 36 a word and was issue-bound before it was
//     memory-bound.
//   * Every phase fills the cooperative grid: each GEMV is cut into (column
//     tile x K split) items by the host's plan (ops/model_flat.py::flat_plan,
//     from shapes only), K splits at whole groups; a tile is `ws` warp strips
//     of 32 columns and the 8 / ws warps of a strip split the item's chunks
//     again (a chunk is 8 word rows), adding their sums in warp order. The
//     splits' f32 partials go to scratch and are added, in split order, where
//     the next phase reads them after its grid barrier: P2 sums its head's q,
//     k and v, P4's rmsnorm the o_proj partials, P5's staging the gate and
//     up partials before SiLU(g) * u, the next P1's rmsnorm (or the final
//     norm) the down_proj partials. The lm_head takes no split and folds
//     (max, first index) a block. The same bits every launch: no float
//     atomics.
//   * Words stream through a per-warp shared-memory ring of FG_STAGES chunks
//     (cp.async; a chunk is 8 word rows, 32 bytes a lane: 3 in flight, 48 KB
//     an SM; deeper rings measured slower), a group's scales beside its first
//     chunk. The weights do not
//     depend on the activations, so before each grid barrier a block issues
//     the first ring stages of its next phase's item: the copies fly through
//     the barrier and, for o_proj, through the whole attention phase.
//   * One GEMV body serves every phase (the row's source, its planes and the
//     output are run-time switches outside the chunk loop), called from one
//     place in the kernel's phase loop, so that the code the SMs run stays
//     small.
//   * The residual stays in each block's shared memory across the layers:
//     a block adds the partials itself, so no phase writes or reads back a
//     residual row.
//
// Lane mapping (after gemv16_kernel's, dequant_matmul.cu): a warp owns a
// strip of 32 output columns, two m16 tiles. Lane (gq, t) copies word rows
// 8q + t and 8q + 4 + t of chunk q of a group at its 4 columns 4gq + {0..3}:
// tile i's rows gq and gq + 8 are its columns 2i and 2i + 1. It pairs fields
// (j, j+4) into the A operand; its B fragment is plane gq's 8 values under
// the same word row, permuted alike (prmt), zero for gq >= the planes; its
// accumulators hold planes 2t and 2t + 1.
#pragma once

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace mi {

constexpr int FG_STAGES = 4;      // a lane's ring of chunks: 3 in flight
constexpr int FG_ROWS = 8;        // word rows a chunk: a lane copies rows t and t + 4
constexpr int FG_STRIP = 32;      // output columns a warp strip
constexpr int FG_PLANES = 3;      // bf16 planes of an f32 row
constexpr int FG_GEMVS = 5;       // qkv, o_proj, gate/up, down_proj, lm_head
constexpr int FG_KC_MAX = 8192;   // k a staged window may hold
// The BIAS instances' ring of bias rows [NW][FG_STAGES][8] x 16 bytes, which
// they place after fg_smem_floats' regions and pass to fg_prime and fg_gemv
// beside the GEMV's bias table (FgSmem, FGemv and FgCursor leave both out, so
// that the other instances compile as they did without them).
constexpr int FG_BRING_FLOATS = NW * FG_STAGES * 8 * 4;

__host__ __device__ constexpr int fg_align4(int n) { return (n + 3) & ~3; }

// bf16 planes of rows normed in the model dtype: one for bf16 (the rows are
// bf16 values), three for f32.
template <class T> struct FgNormPlanes { static constexpr int n = FG_PLANES; };
template <> struct FgNormPlanes<__nv_bfloat16> { static constexpr int n = 1; };

// Shared memory of the 4-bit flat kernel, in floats: the reduction scratch,
// the residual [h], each warp's ring of words [NW][FG_STAGES][2][32] x 16
// bytes (a lane's two word rows of a chunk) and of scales [NW][FG_STAGES][8]
// x 16 bytes, the warps' strip sums [NW][32], and the staged window: planes
// [FG_PLANES][kc + 32] bf16 (+64 bytes a plane, so that the two planes a
// quarter warp reads fall on distinct banks) and word sums [kc / 8]; P2's
// attention buffers (attend_head's, the head's q, k and v rows, and each
// warp's ring of HIST_RING history rows) alias the window.
__host__ __device__ inline int fg_win_floats(int kc, int D) {
  const int w = FG_PLANES * (kc + 32) / 2 + kc / 8;
  const int att = 3 * D + NW * (D + 2) + 3 * D + NW * HIST_RING * HeadHist::ring_bytes(D) / 4;
  return fg_align4(w > att ? w : att);
}
__host__ __device__ inline int fg_smem_floats(int h, int kc, int D) {
  return RED_FLOATS + fg_align4(h) + NW * FG_STAGES * 2 * 32 * 4 + NW * FG_STAGES * 8 * 4 +
         NW * 32 + fg_win_floats(kc, D);
}
static_assert(RED_FLOATS % 4 == 0, "16-byte aligned regions");

struct FgSmem {
  float* red;
  float* vec;      // the residual [h]
  uint4* ring;     // [NW][FG_STAGES][2][32]
  float4* sring;   // [NW][FG_STAGES][8]
  float* ysum;     // [NW][32]
  float* win;      // planes, then word sums
  int kc;
};

__device__ __forceinline__ FgSmem fg_smem(float* smem, int h, int kc) {
  FgSmem s;
  s.red = smem;
  s.vec = smem + RED_FLOATS;
  s.ring = reinterpret_cast<uint4*>(s.vec + fg_align4(h));
  s.sring = reinterpret_cast<float4*>(s.ring + NW * FG_STAGES * 2 * 32);
  s.ysum = reinterpret_cast<float*>(s.sring + NW * FG_STAGES * 8);
  s.win = s.ysum + NW * 32;
  s.kc = kc;
  return s;
}

// One GEMV of a phase: words [K/8, N], scales [K/g, N] of N output
// columns; the plan's warp strips a tile and K splits.
struct FGemv {
  const int32_t* W;
  const float* S;
  int N, g, ng, ws, splits;
  float zc;
};

// A lane's 4 entries of a [rows, N] row `row` (words or scales) at columns
// lcol..lcol+3 into 16 bytes of shared memory, asynchronously: one 16-byte
// copy when `fast` (all 4 inside the matrix and aligned), else one 4-byte
// copy each, entries of columns >= N zero (and not read).
template <class E>
__device__ __forceinline__ void fg_copy_lane(void* dst, const E* base, const E* row, int lcol,
                                             int N, bool fast) {
  static_assert(sizeof(E) == 4, "32-bit entries");
  E* d = reinterpret_cast<E*>(dst);
  if (fast) {
    cp_async16(d, row + lcol, true);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool v = lcol + e < N;
    cp_async4(d + e, v ? row + lcol + e : base, v);
  }
}

// The chunks a warp streams in a phase, in order, and the ring stage of the
// next copy: item `item` of the block (blockIdx.x + m * gridDim.x), `left`
// chunks of the warp's range in it from chunk q of its group; `off` is this
// lane's first word of that chunk (word row gi*wpg + 8q + t of the group gi,
// column lcol) and `soff` the group's scales at lcol, both counted from W and
// S. A chunk is word rows gi*wpg + 8q .. +7; a lane copies rows t and t + 4
// of it, those past the group not at all (their B values are zero).
struct FgCursor {
  FGemv d;
  int wpg, cpg, ntiles, nitems;
  int item, left, q, lcol, off, soff, stage;
  bool sdue;   // the next chunk opens a group or the warp's range: copy the group's scales
  bool fast;   // the lane's 4 columns lie inside the matrix, 16-byte aligned
};

// A warp's strip, its share (split ksub of ks) and the chunk range of an
// item: the one arithmetic that both the copies and the sums follow.
struct FgItem {
  int sp, ga, gb, jlo, jhi, col;
  __device__ __forceinline__ FgItem(const FGemv& d, int cpg, int ntiles, int item) {
    const int warp = threadIdx.x >> 5, ks = NW / d.ws, strip = warp % d.ws, ksub = warp / d.ws;
    const int tile = item % ntiles;
    sp = item / ntiles;
    ga = sp * d.ng / d.splits;
    gb = (sp + 1) * d.ng / d.splits;
    const int L = (gb - ga) * cpg;
    jlo = ksub * L / ks;
    jhi = (ksub + 1) * L / ks;
    col = (tile * d.ws + strip) * FG_STRIP;
  }
};

// B: the GEMV's bias table [K/g, N] in a BIAS instance, or null.
template <bool BIAS>
__device__ __forceinline__ void fg_seek(FgCursor& c, int item, const float* B) {
  const int t = threadIdx.x & 3;
  for (; item < c.nitems; item += gridDim.x) {
    const FgItem it(c.d, c.cpg, c.ntiles, item);
    if (it.col >= c.d.N || it.jlo >= it.jhi) continue;
    const int gi = it.ga + it.jlo / c.cpg;
    c.item = item;
    c.left = it.jhi - it.jlo;
    c.q = it.jlo % c.cpg;
    c.lcol = it.col + 4 * ((threadIdx.x & 31) >> 2);
    c.off = (gi * c.wpg + FG_ROWS * c.q + t) * c.d.N + c.lcol;
    c.soff = gi * c.d.N + c.lcol;
    c.sdue = true;
    uintptr_t a = reinterpret_cast<uintptr_t>(c.d.W + c.lcol) |
                  reinterpret_cast<uintptr_t>(c.d.S + c.lcol);
    if (BIAS && B) a |= reinterpret_cast<uintptr_t>(B + c.lcol);
    c.fast = c.lcol + 3 < c.d.N && ((a | (uintptr_t)c.d.N * 4) & 15) == 0;
    return;
  }
  c.item = c.nitems;
  c.left = 0;
}

// Copy the cursor's next chunk (the lane's two word rows, and on the first
// chunk of a group or of the warp's range the group's scales, lane t = 0,
// and in a BIAS instance, where the GEMV has a bias table B, its biases,
// lane t = 1) into the next ring stage and commit; an empty group once the
// phase's chunks are all copied. `ring`: this lane's slot of stage 0 (stage
// s, row half u at + 64 s + 32 u); `sring` / `bring`: its quad's scale /
// bias slot of stage 0 (stage s at + 8 s).
template <bool BIAS>
__device__ __forceinline__ void fg_fetch(FgCursor& c, uint4* ring, float4* sring, float4* bring,
                                         const float* B) {
  if (c.left > 0) {
    const int t = threadIdx.x & 3, r = FG_ROWS * c.q + t;
    uint4* dst = ring + 64 * c.stage;
    if (r < c.wpg)
      fg_copy_lane(dst, c.d.W, c.d.W + (c.off - c.lcol), c.lcol, c.d.N, c.fast);
    if (r + 4 < c.wpg)
      fg_copy_lane(dst + 32, c.d.W, c.d.W + (c.off + 4 * c.d.N - c.lcol), c.lcol, c.d.N, c.fast);
    if (t == 0 && c.sdue)
      fg_copy_lane(sring + 8 * c.stage, c.d.S, c.d.S + (c.soff - c.lcol), c.lcol, c.d.N, c.fast);
    if (BIAS && t == 1 && c.sdue && B)
      fg_copy_lane(bring + 8 * c.stage, B, B + (c.soff - c.lcol), c.lcol, c.d.N, c.fast);
    c.sdue = false;
    c.off += FG_ROWS * c.d.N;
    if (++c.q == c.cpg) {  // the next group: its first word row, its scales
      c.q = 0;
      c.off -= (FG_ROWS * c.cpg - c.wpg) * c.d.N;
      c.soff += c.d.N;
      c.sdue = true;
    }
    if (--c.left == 0) fg_seek<BIAS>(c, c.item + gridDim.x, B);
  }
  cp_async_commit();
  c.stage = c.stage + 1 == FG_STAGES ? 0 : c.stage + 1;
}

__device__ __forceinline__ uint4* fg_ring_lane(const FgSmem& sm) {
  return sm.ring + (threadIdx.x >> 5) * FG_STAGES * 64 + (threadIdx.x & 31);
}
__device__ __forceinline__ float4* fg_sring_lane(const FgSmem& sm) {
  return sm.sring + (threadIdx.x >> 5) * FG_STAGES * 8 + ((threadIdx.x & 31) >> 2);
}
// The lane's quad's slot of stage 0 in a BIAS instance's ring `bring`.
__device__ __forceinline__ float4* fg_bring_lane(float4* bring) {
  return bring + (threadIdx.x >> 5) * FG_STAGES * 8 + ((threadIdx.x & 31) >> 2);
}

// Point the cursor at GEMV d and issue its first FG_STAGES - 1 chunks (the
// caller's grid barrier may follow: the copies need nothing of this phase).
// BIAS: B is d's bias table [K/g, N] or null, `bring` the block's bias ring;
// fg_gemv of d takes the same two.
template <bool BIAS = false>
__device__ __forceinline__ void fg_prime(FgCursor& c, const FGemv& d, const FgSmem& sm,
                                         const float* B = nullptr, float4* bring = nullptr) {
  c.d = d;
  c.wpg = d.g / 8;
  c.cpg = (c.wpg + FG_ROWS - 1) / FG_ROWS;
  c.ntiles = (d.N + d.ws * FG_STRIP - 1) / (d.ws * FG_STRIP);
  c.nitems = c.ntiles * d.splits;
  c.stage = 0;
  fg_seek<BIAS>(c, blockIdx.x, B);
  uint4* ring = fg_ring_lane(sm);
  float4* sring = fg_sring_lane(sm);
  float4* bq = BIAS ? fg_bring_lane(bring) : nullptr;
#pragma unroll 1
  for (int i = 0; i < FG_STAGES - 1; ++i) fg_fetch<BIAS>(c, ring, sring, bq, B);
}

// The last chunk (exclusive) of the staged window that starts at chunk jw0
// of a split of L chunks: whole groups up to kc k, or pieces of kc k (kc / 64
// chunks) of a longer group.
__device__ __forceinline__ int fg_window_end(int jw0, int L, int g, int cpg, int kc) {
  if (g <= kc) return min(L, jw0 + (kc / g) * cpg);
  return min((jw0 / cpg + 1) * cpg, jw0 + kc / (8 * FG_ROWS));
}

// The row a GEMV reads, staged a window at a time: FG_SRC_NORM, the residual
// in shared memory as the model-dtype rmsnorm rounds it, round(round(x *
// rstd) * w) (stage_rmsnorm's arithmetic); FG_SRC_L2, an f32 row that other
// blocks wrote in the previous phase, read through L2; FG_SRC_ACT, silu(g) *
// u of the gate/up GEMV's `splits` partials [splits, 2n] (gate column k, up
// column n + k), each added in split order (decoder_layer's activation).
// `np` bf16 planes a value (1: the values are bf16 already).
constexpr int FG_SRC_NORM = 0, FG_SRC_L2 = 1, FG_SRC_ACT = 2;
struct FgRow {
  int src, np;
  const void* w;     // norm weights, model dtype
  const float* x;    // the residual (shared), the row or the gate/up partials (global)
  float rstd;
  int splits, n;     // FG_SRC_ACT: the partials' splits and columns of each half
};

// The 8 values under word row k/8 of the row.
template <class T>
__device__ __forceinline__ void fg_load8(const FgRow& r, int k, float (&v)[8]) {
  if (r.src == FG_SRC_NORM) {
    const T* w = static_cast<const T*>(r.w);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = round_t<T>(round_t<T>(r.x[k + e] * r.rstd) * to_f(w[k + e]));
    return;
  }
  if (r.src == FG_SRC_L2) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(r.x + k));
    const float4 b = __ldcg(reinterpret_cast<const float4*>(r.x + k + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = r.x + k + 4 * i;
    float4 g = __ldcg(reinterpret_cast<const float4*>(p));
    float4 u = __ldcg(reinterpret_cast<const float4*>(p + r.n));
    for (int s = 1; s < r.splits; ++s) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p + (long)s * 2 * r.n));
      const float4 b = __ldcg(reinterpret_cast<const float4*>(p + (long)s * 2 * r.n + r.n));
      g.x += a.x; g.y += a.y; g.z += a.z; g.w += a.w;
      u.x += b.x; u.y += b.y; u.z += b.z; u.w += b.w;
    }
    v[4 * i] = g.x * (1.f / (1.f + expf(-g.x))) * u.x;
    v[4 * i + 1] = g.y * (1.f / (1.f + expf(-g.y))) * u.y;
    v[4 * i + 2] = g.z * (1.f / (1.f + expf(-g.z))) * u.z;
    v[4 * i + 3] = g.w * (1.f / (1.f + expf(-g.w))) * u.w;
  }
}

// Stage word rows [wa, wa + nw) of the row: unit j is the 8 values under word
// row wa + j, their f32 sum into sums[j] and r.np bf16 planes into
// planes[p * prow + 8j ..].
template <class T>
__device__ __forceinline__ void fg_stage(const FgRow& r, __nv_bfloat16* planes, float* sums,
                                         int prow, int wa, int nw) {
  for (int j = threadIdx.x; j < nw; j += NT) {
    float x[8];
    fg_load8<T>(r, (wa + j) * 8, x);
    sums[j] = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
    for (int p = 0; p < r.np; ++p) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        o[i] = bits_of(hb);
        x[2 * i] -= __low2float(hb);  // exact: what the planes so far leave
        x[2 * i + 1] -= __high2float(hb);
      }
      *reinterpret_cast<uint4*>(planes + p * prow + j * 8) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Fields j and j+4 of a 4-bit word as centered bf16x2, as centered_pair
// (mma_common.cuh) computes them, with the mask and the bias exponent in
// registers (`m` 0x000F000F, `e` 0x43004300) so that masking and biasing are
// one lop3.
__device__ __forceinline__ uint32_t fg_centered(uint32_t w, int j, uint32_t m, uint32_t e) {
  uint32_t p;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(p) : "r"(w >> (4 * j)), "r"(m), "r"(e));
  const uint32_t c = 0x43084308u;  // 136
  return bits_of(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                         *reinterpret_cast<const __nv_bfloat162*>(&c)));
}

// One half of a chunk (a lane's word row, its 4 words in wv) into the two
// m16n8k16 tiles: B is plane gq's 8 values under the same word row (zero for
// gq >= np and for a row past the group), permuted as A.
__device__ __forceinline__ void fg_mma_rows(float (&dacc)[2][4], const uint4& wv, const uint4& xv,
                                            uint32_t m, uint32_t e) {
  const uint32_t wd[2][2] = {{wv.x, wv.y}, {wv.z, wv.w}};
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    // k slots 2t, 2t+1 | 2t+8, 2t+9 of step st are fields (2st, 2st+4) |
    // (2st+1, 2st+5) of the lane's word row, in A and in B alike
    const uint32_t xl = st ? xv.y : xv.x, xh = st ? xv.w : xv.z;
    const uint32_t b0 = __byte_perm(xl, xh, 0x5410), b1 = __byte_perm(xl, xh, 0x7632);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t a[4] = {fg_centered(wd[i][0], 2 * st, m, e),
                             fg_centered(wd[i][1], 2 * st, m, e),
                             fg_centered(wd[i][0], 2 * st + 1, m, e),
                             fg_centered(wd[i][1], 2 * st + 1, m, e)};
      mma_bf16(dacc[i], a, b0, b1);
    }
  }
}

// What a phase does with a tile's sums: FG_OUT_PARTS, split sp's sums into
// part[sp, :] (the next phase adds the splits); FG_OUT_LOGITS, the logits
// into part[:] and the lane's (max, first index) (unsplit).
constexpr int FG_OUT_PARTS = 0, FG_OUT_LOGITS = 1;

// The phase of GEMV fc.d over the row r: every item of this block, its
// windows staged, the warps' chunks through the ring (fc refills it, and
// runs on into the block's next item), the grouped rescale at the end of
// each group and of each warp's range, the strip's warps added in warp
// order, then the output `out` in lane t = 0 of the strip's first warp: the
// lane's 4 columns lcol..lcol+3. Called by the whole block, after
// fg_prime<BIAS>(fc, d, sm, B, bring) with the same B and bring. BIAS: lane
// t = 1 holds its quad's biases where lane t = 0 holds the scales, and hands
// them over at each group's end; a null B takes -zc*s.
template <class T, bool BIAS = false>
__device__ __forceinline__ void fg_gemv(FgCursor& fc, const FgRow& r, const FgSmem& sm, int out,
                                        float* part, float& best, int& best_i,
                                        const float* B = nullptr, float4* bring = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, t = lane & 3;
  const FGemv d = fc.d;
  const int ks = NW / d.ws, strip = warp % d.ws, ksub = warp / d.ws;
  const int wpg = fc.wpg, cpg = fc.cpg, prow = sm.kc + 32, np = r.np;
  const int ntiles = fc.ntiles, nitems = fc.nitems;
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(sm.win);
  float* sums = sm.win + FG_PLANES * prow / 2;
  uint4* ring = fg_ring_lane(sm);
  float4* sring = fg_sring_lane(sm);
  float4* bq = BIAS ? fg_bring_lane(bring) : nullptr;
  // opaque to the compiler, so that each lop3 takes both as registers
  const uint32_t mask = __shfl_sync(0xffffffffu, 0x000F000Fu, 0);
  const uint32_t bias = __shfl_sync(0xffffffffu, 0x43004300u, 0);
  int ps = 0;  // ring stage of the chunk in hand
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    const FgItem it(d, cpg, ntiles, item);
    const int L = (it.gb - it.ga) * cpg;
    const int lcol = it.col + 4 * gq;
    const bool live = it.col < d.N;
    float y[4] = {0.f, 0.f, 0.f, 0.f};
    float dacc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[i][e] = 0.f;
    float xs = 0.f;
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jw0 = 0; jw0 < L;) {
      const int jw1 = fg_window_end(jw0, L, d.g, cpg, sm.kc);
      const int wa = (it.ga + jw0 / cpg) * wpg + FG_ROWS * (jw0 % cpg);
      const int gl = it.ga + (jw1 - 1) / cpg;
      const int wb = min(gl * wpg + FG_ROWS * ((jw1 - 1) % cpg) + FG_ROWS, (gl + 1) * wpg);
      __syncthreads();  // the previous window's (or item's) reads are done
      fg_stage<T>(r, planes, sums, prow, wa, wb - wa);
      __syncthreads();
      const int j1 = min(it.jhi, jw1);
      // the warp's segments in the window: its chunks [j, je) of one group
      for (int j = max(it.jlo, jw0); live && j < j1;) {
        const int g0 = j / cpg, q0 = j - g0 * cpg, je = min(j1, (g0 + 1) * cpg);
        // the chunk in hand brings the scales (and biases)
        bool want_s = (t == 0 || (BIAS && t == 1)) && (j == it.jlo || q0 == 0);
        int rel = (it.ga + g0) * wpg + FG_ROWS * q0 + t - wa;  // the lane's word row in the window
        int rg = FG_ROWS * q0 + t;                             // ... in its group
#pragma unroll 1
        for (int n = je - j; n > 0; --n, rel += FG_ROWS, rg += FG_ROWS) {
          cp_async_wait<FG_STAGES - 2>();  // this lane's copy of the chunk in hand has landed
          const uint4 w0 = ring[64 * ps], w1 = ring[64 * ps + 32];
          if (want_s) {
            sv = BIAS && t == 1 ? bq[8 * ps] : sring[8 * ps];
            want_s = false;
          }
          ps = ps + 1 == FG_STAGES ? 0 : ps + 1;
          fg_fetch<BIAS>(fc, ring, sring, bq, B);  // into the stage read one chunk ago
          uint4 xv = make_uint4(0u, 0u, 0u, 0u);
          if (rg < wpg) {
            if (gq < np) xv = *reinterpret_cast<const uint4*>(planes + gq * prow + rel * 8);
            xs += sums[rel];
          }
          fg_mma_rows(dacc, w0, xv, mask, bias);
          if (rg - t + 4 < wpg) {  // the chunk's second half holds rows of the group
            uint4 xw = make_uint4(0u, 0u, 0u, 0u);
            if (rg + 4 < wpg) {
              if (gq < np) xw = *reinterpret_cast<const uint4*>(planes + gq * prow + rel * 8 + 32);
              xs += sums[rel + 4];
            }
            fg_mma_rows(dacc, w1, xw, mask, bias);
          }
        }
        if (je == it.jhi || je == (g0 + 1) * cpg) {
          // a group (or the warp's part of one) ends: y += s*D + (b + 8s) * xsum,
          // D the planes' sums (plane 2 sits in lane t = 1), xsum over the
          // lane quad's word rows
          float v = xs;
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          xs = 0.f;
          const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
          float bt[4];  // lane t = 1's biases, in lane t = 0
          if (BIAS)
#pragma unroll
            for (int e = 0; e < 4; ++e) bt[e] = __shfl_down_sync(0xffffffffu, sc[e], 1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float dd[2] = {dacc[i][0], dacc[i][2]};
            const float p2[2] = {__shfl_down_sync(0xffffffffu, dacc[i][0], 1),
                                 __shfl_down_sync(0xffffffffu, dacc[i][2], 1)};
            if (np > 1) {
              dd[0] = (dd[0] + dacc[i][1]) + p2[0];
              dd[1] = (dd[1] + dacc[i][3]) + p2[1];
            }
            if (t == 0) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const float s = sc[2 * i + hh];
                const float cb = fmaf(8.f, s, BIAS && B ? bt[2 * i + hh] : -d.zc * s);
                y[2 * i + hh] += fmaf(s, dd[hh], cb * v);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[i][e] = 0.f;
          }
        }
        j = je;
      }
      jw0 = jw1;
    }
    if (ks > 1) {  // a strip's warps hand their sums to its first warp, which adds them in order
      if (t == 0)
        *reinterpret_cast<float4*>(sm.ysum + warp * 32 + 4 * gq) = make_float4(y[0], y[1], y[2],
                                                                                y[3]);
      __syncthreads();
      if (ksub == 0 && t == 0)
        for (int rr = 1; rr < ks; ++rr) {
          const float4 o = *reinterpret_cast<const float4*>(sm.ysum + (rr * d.ws + strip) * 32 +
                                                            4 * gq);
          y[0] += o.x; y[1] += o.y; y[2] += o.z; y[3] += o.w;
        }
    }
    if (ksub == 0 && t == 0 && live) {
      float* p = part + (long)it.sp * d.N;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = lcol + e;
        if (n < d.N) {
          p[n] = y[e];
          if (out == FG_OUT_LOGITS && (y[e] > best || (y[e] == best && n < best_i))) {
            best = y[e];
            best_i = n;
          }
        }
      }
    }
  }
}

// The residual row in shared memory, for the rmsnorm that follows: x0 (the
// model-dtype embedding row) when non-null, else vec[i] + the `splits`
// partials [splits, ld] of column i added in split order. A thread's loads
// of FG_RES_SLOTS float4 slots go out together, two splits at a time.
// Returns the sum of squares over the block; the caller's next
// __syncthreads is block_sum's.
constexpr int FG_RES_SLOTS = 4;
template <class T>
__device__ __forceinline__ float fg_residual(float* vec, const T* x0, const float* part, int splits,
                                             int ld, int h, float* red) {
  float ss = 0.f;
  if (x0) {
    for (int i = threadIdx.x; i < h; i += NT) {
      const float v = to_f(x0[i]);
      vec[i] = v;
      ss += v * v;
    }
    return block_sum(ss, red);
  }
  for (int base = 4 * threadIdx.x; base < h; base += 4 * NT * FG_RES_SLOTS) {
    float4 acc[FG_RES_SLOTS];
#pragma unroll
    for (int e = 0; e < FG_RES_SLOTS; ++e) {
      const int i = base + 4 * NT * e;
      acc[e] = i < h ? __ldcg(reinterpret_cast<const float4*>(part + i))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 1; s0 < splits; s0 += 2) {
      float4 v[FG_RES_SLOTS][2];
#pragma unroll
      for (int e = 0; e < FG_RES_SLOTS; ++e)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = base + 4 * NT * e;
          v[e][u] = i < h && s0 + u < splits
                        ? __ldcg(reinterpret_cast<const float4*>(part + (long)(s0 + u) * ld + i))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int e = 0; e < FG_RES_SLOTS; ++e)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (s0 + u < splits) {
            acc[e].x += v[e][u].x; acc[e].y += v[e][u].y;
            acc[e].z += v[e][u].z; acc[e].w += v[e][u].w;
          }
    }
#pragma unroll
    for (int e = 0; e < FG_RES_SLOTS; ++e) {
      const int i = base + 4 * NT * e;
      if (i < h) {
        float4 x = *reinterpret_cast<const float4*>(vec + i);
        x.x += acc[e].x; x.y += acc[e].y; x.z += acc[e].z; x.w += acc[e].w;
        *reinterpret_cast<float4*>(vec + i) = x;
        ss += x.x * x.x; ss += x.y * x.y; ss += x.z * x.z; ss += x.w * x.w;
      }
    }
  }
  return block_sum(ss, red);
}

// P2 of the 4-bit layer loop (flat_model.cuh): decode_common.cuh's
// attention_phase and attention_item, with each head's q, k and v rows first
// summed from the qkv GEMV's split partials [splits, ld] (in split order; a
// thread's loads of 8 splits go out together) into shared memory and the
// RoPE and the int8 row read from there, then attend_head over hist(kvh)
// (a HeadHist) through its history ring and, given `tail`, over the rows of
// tail(kvh) after them (a segment's SegHist): the same arithmetic on the
// same values. sm: attend_head's buffers, the q | k | v rows, the history
// ring.
template <class MkHist, class MkTail = NoTail (*)(int)>
__device__ __forceinline__ void fg_attention_phase(const LayerArgs& a, const float* part,
                                                   int splits, int ld, float* sm, float* red,
                                                   MkHist hist, MkTail tail = nullptr) {
  const int D = a.head_dim, reps = a.n_heads / a.n_kv_heads, half = D / 2;
  const int qdim = a.n_heads * D, kvdim = a.n_kv_heads * D;
  float* raw = sm + 3 * D + NW * (D + 2);
  uint8_t* pf = reinterpret_cast<uint8_t*>(raw + 3 * D);
  constexpr int E = 3, U = 8;  // 3D <= 768 rows' values a block: E a thread
  for (int hq = blockIdx.x; hq < a.n_heads; hq += gridDim.x) {
    const int kvh = hq / reps;
    long c[E];
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = threadIdx.x + e * NT;
      c[e] = i < D ? hq * D + i
                   : (i < 2 * D ? qdim + kvh * D + i - D : qdim + kvdim + kvh * D + i - 2 * D);
      acc[e] = 0.f;
    }
    for (int s0 = 0; s0 < splits; s0 += U) {
      float v[E][U];
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[e][u] = threadIdx.x + e * NT < 3 * D && s0 + u < splits
                        ? __ldcg(part + (long)(s0 + u) * ld + c[e]) : 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (s0 + u < splits) acc[e] = s0 + u == 0 ? v[e][u] : acc[e] + v[e][u];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (threadIdx.x + e * NT < 3 * D) raw[threadIdx.x + e * NT] = acc[e];
    __syncthreads();
    const auto hh = hist(kvh);
    const float* qs = raw;
    const float* ks = raw + D;
    const float* vs = raw + 2 * D;
    float kr = 0.f, vr = 0.f;
    const int d = threadIdx.x;
    if (d < D) {
      const float c = a.cos[d], s = a.sin[d];
      const float qrot = d < half ? -qs[d + half] : qs[d - half];
      const float krot = d < half ? -ks[d + half] : ks[d - half];
      sm[d] = qs[d] * c + qrot * s;
      kr = ks[d] * c + krot * s;
      vr = vs[d];
    }
    const float kam = fmaxf(block_max(d < D ? fabsf(kr) : 0.f, red), 1e-8f);
    const float vam = fmaxf(block_max(d < D ? fabsf(vr) : 0.f, red), 1e-8f);
    const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
    if (d < D) {
      const float kq = fminf(fmaxf(rintf(kr / ksc), -127.f), 127.f);
      const float vq = fminf(fmaxf(rintf(vr / vsc), -127.f), 127.f);
      sm[D + d] = kq * ksc;
      sm[2 * D + d] = vq * vsc;
      if (hq % reps == 0) {
        a.krow[(long)kvh * D + d] = (int8_t)kq;
        a.vrow[(long)kvh * D + d] = (int8_t)vq;
        if (d == 0) { a.ks_out[kvh] = ksc; a.vs_out[kvh] = vsc; }
      }
    }
    __syncthreads();
    if constexpr (std::is_same<MkTail, NoTail (*)(int)>::value)
      attend_head<decltype(hist(kvh)), true>(hh, D, a.attn_buf + (long)hq * D, sm, red, pf);
    else
      attend_head<decltype(hist(kvh)), true>(hh, D, a.attn_buf + (long)hq * D, sm, red, pf,
                                             tail(kvh));
  }
}

}  // namespace mi
