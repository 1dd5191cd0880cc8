// The batched whole-model kernel's GEMV for 4-bit words, on the tensor cores:
// phases P1 qkv, P3 o_proj, P4 gate/up and P5 down_proj of every layer and
// the terminal lm rows of batch_kernel (model_fused.cu), B <= 8 rows at once.
// Only model_fused.cu includes it; its 2- and 8-bit instances keep the
// CUDA-core tile_dot_b.
//
// Replaces the `_qdot` calls of the TPU kernel
// mi_optimize_tpu/ops/model_fused.py::_kernel_b (block_fused.py::_qdot):
// the grouped rescale. Per group of g k, D[g] = sum_k x[m,k] * (q[k,n] - 8)
// on the centered codes, then y[m,n] = sum_g s*D[g] + (b + 8s) * xsum[g,m],
// xsum the f32 sum of row m over the group, as the plain version
// ops/dequant_matmul.py::qdot_ref computes it.
//
// What bounds it: the bytes of the packed words and their scale (and bias)
// tables, read once a step for all B rows: 3.4 GB a step at Llama-2-7B int4
// g128, 1.0 ms at 3.35 TB/s. What the design does about it:
//   * The multiply-adds run on mma.m16n8k16 (bf16 in, f32 accumulators):
//     the weights are A (16 columns x k16, centered codes from a word by
//     the exponent-bias trick of mma_common.cuh, exact in bf16), the rows
//     are B (k16 x n8: the 8 row slots, rows past B zero). One mma does the
//     work of 256 values x 8 rows of CUDA-core FMAs, so a lane issues about
//     12 instructions a word to unpack it and the issue rate stays within
//     what the memory rate leaves (the CUDA-core GEMV it replaces was
//     issue-bound).
//   * The products are exact. A row that is a bf16 value already (the
//     normed rows of a bf16 model: qkv, gate/up, lm rows) is one bf16
//     plane; an f32 row (attention output, SiLU * up, every row of an f32
//     model) is three, x = hi + mid + lo, each bf16 rounded to nearest from
//     what is left, exact for every normal x; a code times a plane is exact
//     in f32. Only the order of the f32 additions differs from the plain
//     version.
//   * The rows are staged once a window (at most BG_KC k) into shared
//     memory as bf16 planes in the order the lanes read them, with the f32
//     sum of each row's 8 values under a word; a group's xsum is the sum of
//     its words' sums, added in a fixed order.
//   * Each GEMV is cut into items (column tile x K split) by the host's
//     plan (ops/model_fused.py::gemv_plan) so that they fill the 2 x 132
//     blocks (at most 5% of a wave idle) at N = 4096 as at N = 32000, with
//     few and small staged windows. K splits at whole groups; a tile's
//     warps may split its groups again (warp strips `ws` < 8), and add their
//     sums in warp order; the last block to finish a tile (an integer
//     counter) adds the splits' f32 partials in split order and runs the
//     phase's epilogue. The same bits every launch, no float atomics and no
//     grid barrier beyond the phase's own.
//   * Words stream through a ring of BG_STAGES chunks a lane in shared
//     memory (cp.async): three chunks in flight a lane while it multiplies
//     a fourth, without a register for any of them. A group's scales are
//     loaded at its first chunk, used at its last. The whole step is one
//     cooperative kernel held to 128 registers a thread (two blocks an SM),
//     so a warp keeps BG_TILES = 2 mma tiles' accumulators (4 tiles a warp
//     measured no faster on the H100: PERF.md).
//   * The rows' sums of squares for the next phase's rmsnorm come out of the
//     epilogue of the phase that writes them (per tile, in a fixed order),
//     so no block reads every row again to norm it.
//
// Lane mapping (after gemv16_kernel's, dequant_matmul.cu): a warp owns a
// strip of 32 output columns (NC = 2: 16 gate columns and the same 16 up
// columns), two m16 tiles. Lane (gq, t) copies word row 4q + t of chunk q
// of a group at its 4 columns 4gq + {0..3} (NC = 2: gate 2gq + {0, 1} and up
// I + 2gq + {0, 1}): tile i's rows gq and gq + 8 are its columns 2i and
// 2i + 1. It pairs fields (j, j+4) into the A operand; its B fragment is row
// gq's 8 values under the same word row, permuted alike (prmt); its
// accumulators hold its columns for rows 2t and 2t + 1.
#pragma once

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace mi {

constexpr int BG_KC = 1024;            // k a staged window holds at most
constexpr int BG_WR = BG_KC / 8;       // word rows a window
constexpr int BG_ROW = BG_KC + 32;     // bf16 a staged row: +64 bytes, so that the two rows a
                                       // quarter warp reads fall on distinct banks
constexpr int BG_SUM_ROW = BG_WR + 4;  // word sums a staged row: the 8 rows on distinct banks
constexpr int BG_PLANES = 3;           // bf16 planes of an f32 row
constexpr int BG_GEMVS = 5;            // qkv, o, gate/up, down, lm_head
constexpr int BG_TILES = 2;                 // m16 tiles a warp strip
constexpr int BG_STRIP = 16 * BG_TILES;     // output columns a strip (NC = 2: half gate, half up)
constexpr int BG_SLOTS = BG_TILES / 2;      // 16 bytes of words a lane a chunk
constexpr int BG_PART = 32 * 4 * BG_TILES;  // f32 sums of one warp strip: 4 a tile a lane
constexpr int BG_STAGES = 4;                // a lane's ring of chunks: 3 in flight
static_assert(BG_TILES == 2, "the lane mapping below is for two tiles a strip");

// Shared memory floats of the GEMV: the planes [BG_PLANES][8][BG_ROW] bf16,
// the word sums [8][BG_SUM_ROW] f32, each warp's output sums [NW][4 * BG_TILES][32]
// f32 (a lane's 4 a tile, lane-minor: kept out of the registers the chunk
// loop needs, and touched once a group), and each warp's ring of words in
// flight [NW][BG_STAGES][BG_SLOTS][32] x 16 bytes.
__host__ __device__ constexpr int bg_smem_floats() {
  return BG_PLANES * 8 * BG_ROW / 2 + 8 * BG_SUM_ROW + NW * BG_PART +
         NW * BG_STAGES * BG_SLOTS * 32 * 4;
}
static_assert((8 * BG_WR) % NT == 0, "a window is whole staging units a thread");

// A plan's scratch: the tiles of a GEMV over `ncols` output columns (NC = 2:
// gate columns) at `ws` warp strips a tile (one counter each), and the f32
// partials of its `splits` K splits. The wrapper sizes both from the host
// plan; dispatch refuses a plan whose scratch does not fit.
__host__ __device__ constexpr int bg_tiles(int ncols, int nc, int ws) {
  return (ncols + ws * (BG_STRIP / nc) - 1) / (ws * (BG_STRIP / nc));
}
__host__ __device__ constexpr long bg_part_floats(int ncols, int nc, int ws, int splits) {
  return splits > 1 ? (long)splits * bg_tiles(ncols, nc, ws) * ws * BG_PART : 0L;
}

// bf16 planes of rows normed in the model dtype: one for bf16 (the rows are
// bf16 values), three for f32.
template <class T> struct NormPlanes { static constexpr int n = BG_PLANES; };
template <> struct NormPlanes<__nv_bfloat16> { static constexpr int n = 1; };

// Four entries of row `row` of a [groups, ldw] table at columns col..col+3.
__device__ __forceinline__ float4 bg_tab4(const float* __restrict__ T, long row, int ldw,
                                          int col) {
  const float* p = T + row * ldw + col;
  if (((ldw | col) & 3) == 0 && col + 3 < ldw) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < ldw) v.x = __ldg(p);
  if (col + 1 < ldw) v.y = __ldg(p + 1);
  if (col + 2 < ldw) v.z = __ldg(p + 2);
  if (col + 3 < ldw) v.w = __ldg(p + 3);
  return v;
}

// Stage rows m < 8 (rows >= B as zeros) over word rows [w0, w0 + nw) of K:
// unit (m, j) is the 8 values under word row w0 + j, two float4 loads from
// `src`, all of a thread's loads in flight at once; it writes their sum to
// sums[m][j] and NP bf16 planes to planes[p][m][8j..8j+8).
template <int NP, class Src>
__device__ __forceinline__ void bg_stage(__nv_bfloat16* planes, float* sums, int B, const Src& src,
                                         int w0, int nw) {
  constexpr int PER = 8 * BG_WR / NT;
  float4 v[PER][2];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int u = threadIdx.x + r * NT, m = u / BG_WR, j = u % BG_WR;
    const bool ok = m < B && j < nw;
    const int k = (w0 + j) * 8;
    v[r][0] = ok ? src.load4(m, k) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[r][1] = ok ? src.load4(m, k + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int u = threadIdx.x + r * NT, m = u / BG_WR, j = u % BG_WR;
    if (j >= nw) continue;
    float x[8] = {v[r][0].x, v[r][0].y, v[r][0].z, v[r][0].w,
                  v[r][1].x, v[r][1].y, v[r][1].z, v[r][1].w};
    sums[m * BG_SUM_ROW + j] = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        o[i] = bits_of(hb);
        x[2 * i] -= __low2float(hb);  // exact: what the planes so far leave
        x[2 * i + 1] -= __high2float(hb);
      }
      *reinterpret_cast<uint4*>(planes + (p * 8 + m) * BG_ROW + j * 8) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// 8 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 8 : 0));
}

// Copy NW_ words of word row `wrow` at columns col.. (zeros past ldw; all
// zeros when !ok, the source then not read) into 4 * NW_ bytes of shared
// memory, asynchronously (cp.async: no register holds a word in flight).
template <int NW_>
__device__ __forceinline__ void bg_copy_words(void* dst, const int32_t* __restrict__ W, long wrow,
                                              int ldw, int col, bool ok) {
  const int32_t* p = W + wrow * ldw + col;
  if (((ldw | col) & (NW_ - 1)) == 0 && col + NW_ - 1 < ldw) {
    if constexpr (NW_ == 4) cp_async16(dst, ok ? p : W, ok);
    else cp_async8(dst, ok ? p : W, ok);
    return;
  }
  int32_t* d = reinterpret_cast<int32_t*>(dst);
#pragma unroll
  for (int i = 0; i < NW_; ++i) {
    const bool e = ok && col + i < ldw;
    cp_async4(d + i, e ? p + i : W, e);
  }
}

// Two entries of row `row` of a [groups, ldw] table at columns col, col + 1.
__device__ __forceinline__ float2 bg_tab2(const float* __restrict__ T, long row, int ldw,
                                          int col) {
  const float* p = T + row * ldw + col;
  if (((ldw | col) & 1) == 0 && col + 1 < ldw) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(col < ldw ? __ldg(p) : 0.f, col + 1 < ldw ? __ldg(p + 1) : 0.f);
}

// A lane's 4 columns of a table row, in the order of its words (bg_gemv's
// lane mapping): NC = 1 four neighbours from col; NC = 2 two gate columns
// from col, then the two up columns from col + cstride.
template <int NC>
__device__ __forceinline__ void bg_lane_tab(float4 (&out)[BG_SLOTS], const float* __restrict__ T,
                                            long row, int ldw, int col, int cstride) {
  if constexpr (NC == 1) {
    out[0] = bg_tab4(T, row, ldw, col);
  } else {
    const float2 g = bg_tab2(T, row, ldw, col), u = bg_tab2(T, row, ldw, col + cstride);
    out[0] = make_float4(g.x, g.y, u.x, u.y);
  }
}

// out = x @ W for rows m < B over the packed [K/8, ldw] words W with scales
// S and bias table Bt ([K/g, ldw]; a null Bt is -zc*s): r = epi(m, n, v) for
// every output column n < ncols, v[c] the product with column n + c *
// cstride (NC = 2: gate column n and up column I + n; NC = 1: cstride
// unused). `src.load4(m, k)` gives row m's f32 values k..k+3; NP bf16
// planes a row (1: they are bf16 values). The plan: `ws` warp strips a tile,
// `splits` K splits. `smem` holds bg_smem_floats(); `part` the splits'
// partials (splits x tiles x ws x BG_PART floats, when splits > 1) and
// `counters` one int a tile, zero on entry and left zero. With a non-null
// `ssq`, ssq[tile * 8 + m] is the sum over the tile's columns of the r that
// epi returns for row m (the rows it writes, squared: the next phase's
// rmsnorm), added in a fixed order. Called by the whole block; the caller's
// grid barrier follows.
template <int NP, int NC, class Src, class Epi>
__device__ __forceinline__ void bg_gemv(float* smem, int B, int K, const Src& src,
                                        const int32_t* __restrict__ W,
                                        const float* __restrict__ S,
                                        const float* __restrict__ Bt, float zc, int ldw, int g,
                                        int ncols, int cstride, int ws, int splits, float* part,
                                        int* counters, float* ssq, Epi epi) {
  __shared__ int last_block;
  __shared__ float ss_warp[NW * 8];
  constexpr int CW = 4 / NC;  // a lane's neighbouring columns: 4, or 2 gate and 2 up
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sums = smem + BG_PLANES * 8 * BG_ROW / 2;
  float* ysum = sums + 8 * BG_SUM_ROW;  // [NW][4 * BG_TILES][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, t = lane & 3;
  // this lane's ring: stage st, slot u at ring[(st * BG_SLOTS + u) * 32]
  uint4* ring =
      reinterpret_cast<uint4*>(ysum + NW * BG_PART) + warp * BG_STAGES * BG_SLOTS * 32 + lane;
  const int wpg = g / 8, cpg = (wpg + 3) / 4, ng = K / g;  // word rows, chunks a group
  const int ks = NW / ws, strip = warp % ws, ksub = warp / ws;
  const int sw = BG_STRIP / NC;                            // output columns a strip
  const int ntiles = bg_tiles(ncols, NC, ws);
  const long sstride = (long)ntiles * ws * BG_PART;        // partials a split
  float* ys = ysum + warp * BG_PART + lane;                // this lane's sums, stride 32
  for (int item = blockIdx.x; item < ntiles * splits; item += gridDim.x) {
    const int tile = item % ntiles, sp = item / ntiles;
    const int ga = (int)((long)sp * ng / splits), gb = (int)((long)(sp + 1) * ng / splits);
    const int wa = ga + ksub * (gb - ga) / ks, wb = ga + (ksub + 1) * (gb - ga) / ks;
    const int col = (tile * ws + strip) * sw;  // first output column of this warp's strip
    const int lcol = col + CW * gq;            // this lane's first column
    const bool live = col < ncols;
    __syncthreads();  // the last item's reads of the sums are done
#pragma unroll
    for (int j = 0; j < 4 * BG_TILES; ++j) ys[32 * j] = 0.f;
    float dacc[BG_TILES][4];
#pragma unroll
    for (int i = 0; i < BG_TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[i][e] = 0.f;
    float xs = 0.f;
    // windows over the item's word rows: whole groups, or 128-row pieces of a longer group
    for (int w0 = ga * wpg; w0 < gb * wpg;) {
      const int gw = w0 / wpg;
      const int w1 = g <= BG_KC ? min(gb, gw + BG_KC / g) * wpg : min(w0 + BG_WR, (gw + 1) * wpg);
      // this warp's chunks in the window: group pg, chunk pq onwards while below hi
      const int lo = max(w0, wa * wpg), hi = min(w1, wb * wpg);
      const bool mine = live && lo < hi;
      int pg = lo / wpg, pq = (lo - pg * wpg) >> 2;
      int lg = pg, lq = pq, ls = 0;  // the next chunk to copy, and its stage
      auto fetch = [&]() {
        const int base = lg * wpg + 4 * lq;
        if (base < hi) {
          const bool ok = 4 * lq + t < wpg;
          uint4* slot = ring + 32 * BG_SLOTS * ls;
          if constexpr (NC == 1) {
            bg_copy_words<4>(slot, W, base + t, ldw, lcol, ok);
          } else {
            bg_copy_words<2>(slot, W, base + t, ldw, lcol, ok);
            bg_copy_words<2>(reinterpret_cast<uint2*>(slot) + 1, W, base + t, ldw,
                             lcol + cstride, ok);
          }
          if (++lq == cpg) { lq = 0; ++lg; }
        }
        cp_async_commit();
        if (++ls == BG_STAGES) ls = 0;
      };
      if (mine)  // in flight while the rows are staged
#pragma unroll
        for (int i = 0; i < BG_STAGES - 1; ++i) fetch();
      __syncthreads();  // the previous window's (or item's) reads are done
      bg_stage<NP>(planes, sums, B, src, w0, w1 - w0);
      __syncthreads();
      if (mine) {
        int ps = 0;                        // stage of the chunk in hand
        float4 sv[BG_SLOTS], bv[BG_SLOTS];  // the group's scales (and biases), from its first chunk
        bool fresh = true;
        while (pg * wpg + 4 * pq < hi) {
          cp_async_wait<BG_STAGES - 2>();  // this lane's copy of the chunk in hand has landed
          uint4 wv[BG_SLOTS];
#pragma unroll
          for (int u = 0; u < BG_SLOTS; ++u) wv[u] = ring[32 * (BG_SLOTS * ps + u)];
          if (++ps == BG_STAGES) ps = 0;
          fetch();  // into the stage read one chunk ago
          if (pq == 0 || fresh) {
            fresh = false;
            bg_lane_tab<NC>(sv, S, pg, ldw, lcol, cstride);
            if (Bt) bg_lane_tab<NC>(bv, Bt, pg, ldw, lcol, cstride);
          }
          const int wr = pg * wpg + 4 * pq + t;  // this lane's word row
          const bool ok = 4 * pq + t < wpg;
          uint4 xv[NP];
#pragma unroll
          for (int p = 0; p < NP; ++p)
            xv[p] = ok ? *reinterpret_cast<const uint4*>(planes + (p * 8 + gq) * BG_ROW +
                                                         (wr - w0) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
          if (ok) xs += sums[gq * BG_SUM_ROW + wr - w0];
          uint32_t wd[BG_TILES][2];
#pragma unroll
          for (int u = 0; u < BG_SLOTS; ++u) {
            wd[2 * u][0] = wv[u].x; wd[2 * u][1] = wv[u].y;
            wd[2 * u + 1][0] = wv[u].z; wd[2 * u + 1][1] = wv[u].w;
          }
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            // k slots 2t, 2t+1 | 2t+8, 2t+9 of step st are fields (2st, 2st+4) |
            // (2st+1, 2st+5) of the lane's word row, in A and in B alike
            uint32_t b[NP][2];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint32_t xl = st ? xv[p].y : xv[p].x, xh = st ? xv[p].w : xv[p].z;
              b[p][0] = __byte_perm(xl, xh, 0x5410);
              b[p][1] = __byte_perm(xl, xh, 0x7632);
            }
#pragma unroll
            for (int i = 0; i < BG_TILES; ++i) {
              const uint32_t a[4] = {
                  centered_pair(wd[i][0], 2 * st), centered_pair(wd[i][1], 2 * st),
                  centered_pair(wd[i][0], 2 * st + 1), centered_pair(wd[i][1], 2 * st + 1)};
#pragma unroll
              for (int p = 0; p < NP; ++p) mma_bf16(dacc[i], a, b[p][0], b[p][1]);
            }
          }
          if (pq == cpg - 1) {  // group pg ends: y += s*D + (b + 8s) * xsum
            float v = xs;
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            const float xm[2] = {__shfl_sync(0xffffffffu, v, 8 * t),
                                 __shfl_sync(0xffffffffu, v, 8 * t + 4)};
            xs = 0.f;
            if (!Bt)
#pragma unroll
              for (int u = 0; u < BG_SLOTS; ++u)
                bv[u] = make_float4(-zc * sv[u].x, -zc * sv[u].y, -zc * sv[u].z, -zc * sv[u].w);
            float sc[BG_TILES][2], bc[BG_TILES][2];
#pragma unroll
            for (int u = 0; u < BG_SLOTS; ++u) {
              sc[2 * u][0] = sv[u].x; sc[2 * u][1] = sv[u].y;
              sc[2 * u + 1][0] = sv[u].z; sc[2 * u + 1][1] = sv[u].w;
              bc[2 * u][0] = bv[u].x; bc[2 * u][1] = bv[u].y;
              bc[2 * u + 1][0] = bv[u].z; bc[2 * u + 1][1] = bv[u].w;
            }
#pragma unroll
            for (int i = 0; i < BG_TILES; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float s = sc[i][h], cb = fmaf(8.f, s, bc[i][h]);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  ys[32 * (4 * i + 2 * h + e)] += fmaf(s, dacc[i][2 * h + e], cb * xm[e]);
                  dacc[i][2 * h + e] = 0.f;
                }
              }
          }
          if (++pq == cpg) { pq = 0; ++pg; }
        }
      }
      w0 = w1;
    }
    // a tile strip's warps hand their sums to its first warp, which adds them in order
    __syncthreads();
    if (ks > 1 && ksub == 0)
      for (int r = 1; r < ks; ++r)
#pragma unroll
        for (int j = 0; j < 4 * BG_TILES; ++j) ys[32 * j] += ys[32 * j + r * ws * BG_PART];
    float y[4 * BG_TILES];
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < 4 * BG_TILES; ++j) y[j] = ys[32 * j];
    } else {
      // every split writes its partials; the tile's last block adds them in split order
      float* P = part + ((long)tile * ws + strip) * BG_PART + lane * 4 * BG_TILES;
      if (ksub == 0)
#pragma unroll
        for (int i = 0; i < BG_TILES; ++i)
          __stcg(reinterpret_cast<float4*>(P + sp * sstride) + i,
                 make_float4(ys[32 * (4 * i)], ys[32 * (4 * i + 1)], ys[32 * (4 * i + 2)],
                             ys[32 * (4 * i + 3)]));
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
      __syncthreads();
      if (!last_block) continue;
      __threadfence();
      if (threadIdx.x == 0) counters[tile] = 0;
#pragma unroll
      for (int j = 0; j < 4 * BG_TILES; ++j) y[j] = 0.f;
      if (ksub == 0) {
#pragma unroll 4
        for (int q = 0; q < splits; ++q) {
          const float4* o = reinterpret_cast<const float4*>(P + q * sstride);
          float4 v[BG_TILES];
#pragma unroll
          for (int i = 0; i < BG_TILES; ++i) v[i] = __ldcg(o + i);
#pragma unroll
          for (int i = 0; i < BG_TILES; ++i) {
            y[4 * i] += v[i].x; y[4 * i + 1] += v[i].y; y[4 * i + 2] += v[i].z;
            y[4 * i + 3] += v[i].w;
          }
        }
      }
    }
    float ss[2] = {0.f, 0.f};  // this lane's rows 2t, 2t + 1
    if (ksub == 0 && live) {
#pragma unroll
      for (int i = 0; i < BG_TILES / NC; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // tile i's columns are the lane's words 2i + h (NC = 2: gate tile 0,
            // and up tile 1 the same column + I)
            const int n = lcol + 2 * i + h;
            const int m = 2 * t + e;
            float v[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) v[c] = y[4 * (i + c * BG_TILES / 2) + 2 * h + e];
            if (m < B && n < ncols) {
              const float r = epi(m, n, v);
              ss[e] = fmaf(r, r, ss[e]);
            }
          }
    }
    if (ssq) {  // the tile's sums of squares: over the lanes of a strip, then its strips in order
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) ss[e] += __shfl_xor_sync(0xffffffffu, ss[e], o);
        if (ksub == 0 && lane < 4) ss_warp[strip * 8 + 2 * lane + e] = ss[e];
      }
      __syncthreads();
      if (threadIdx.x < 8) {
        float tot = 0.f;
        for (int w = 0; w < ws; ++w) tot += ss_warp[w * 8 + threadIdx.x];
        ssq[tile * 8 + threadIdx.x] = tot;
      }
    }
  }
}

// rstd[m] = 1/sqrt(mean(x[m]^2) + eps) for rows m < B of an h-wide row set
// whose writing phase left per-tile sums of squares (bg_gemv's ssq over
// `ntiles` tiles), added in tile order. The caller syncs before use.
__device__ __forceinline__ void bg_rstd(float* rstd, const float* ssq, int ntiles, int B, int h,
                                        float eps) {
  if (threadIdx.x < B) {
    float ss = 0.f;
    for (int i = 0; i < ntiles; ++i) ss += __ldcg(ssq + i * 8 + threadIdx.x);
    rstd[threadIdx.x] = 1.f / sqrtf(ss / (float)h + eps);
  }
}

}  // namespace mi
