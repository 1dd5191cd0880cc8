// Device code shared by the decode kernels (block_fused.cu, model_flat.cu,
// model_fused.cu) and the dequant matmul (dequant_matmul.cu).
//
// Layout contract (core/packing.py): packed weights are words-major int32
// [K*BITS/32, N], little-endian fields within a word, stored unsigned
// (biased by -qmin). Scales s and dequant biases b are f32 [K/g, N]; the
// dequantized weight is q*s + b. With a null bias table the bias is -zc*s,
// zc being the constant (zero - qmin) of a symmetric grid.
//
// One decoder layer for one token (B = S = 1) runs in five phases separated
// by grid-wide barriers of a cooperative launch:
//   P1  rmsnorm (every block computes rstd itself) -> qkv dot    -> qkv_buf
//   P2  RoPE, new int8 k/v row + scales, attention per q head     -> attn_buf
//   P3  o_proj + residual                                         -> xmid_buf
//   P4  rmsnorm, gate/up dots, silu(g)*u                          -> act_buf
//   P5  down_proj + residual                                      -> xres (+ x_out)
// Scratch written inside a launch is read back with __ldcg (L2, not the
// SM's L1), so a block never sees a stale line from an earlier phase.
// Rounding points follow mi_optimize_tpu/ops/block_fused.py: the normed
// activation is rounded to the model dtype before and after the norm weight,
// qkv, attention, the residual and the MLP activation stay f32, and only the
// layer output is rounded. The int8 rows use rintf (round half to even, as
// jnp.round does), not roundf.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace mi {

namespace cg = cooperative_groups;

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int RED_FLOATS = NW * 33;  // tile_dot partials; block_sum uses the first NW
// Blocks per SM of a cooperative decode launch: coop_grid launches at most
// this many. The decode kernels declare it in __launch_bounds__ so that ptxas
// budgets registers for it (128 a thread); left to itself it may shrink a
// kernel to 80 registers for a third block the grid never launches and lose
// the GEMV loops' loads in flight.
constexpr int COOP_PER_SM = 2;
// The int8 KV scale is amax * KV_RCP: the reference writes amax / 127.0, which
// XLA lowers to a multiply by the f32 reciprocal (models/llama.py KV_RCP),
// 1/127 rounded to f32.
constexpr float KV_RCP = 0x1.020408p-7f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// float -> model dtype -> float (round to nearest even for bf16)
template <class T> __device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the total. `red` holds >= 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = lane < NW ? red[lane] : 0.f;
  return warp_sum(t);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = lane < NW ? red[lane] : -INFINITY;
  return warp_max(t);
}

// Partial dot of one warp over packed words [w0, w1) for column `col`:
// sum_k vec[k] * (q[k, col]*s + b). vec is in shared memory (every lane reads
// the same address: a broadcast); neighbouring lanes read neighbouring words.
template <int BITS>
__device__ __forceinline__ float warp_dot(const float* vec, const int32_t* __restrict__ W,
                                          const float* __restrict__ S,
                                          const float* __restrict__ Bt, float zc, long ldw,
                                          int g, long col, int w0, int w1) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int wpg = g / VPW;  // words per quantization group
  float acc = 0.f;
  int w = w0;
  while (w < w1) {
    const int gi = w / wpg;
    const int we = min(w1, (gi + 1) * wpg);
    const float s = __ldg(S + (long)gi * ldw + col);
    const float b = Bt ? __ldg(Bt + (long)gi * ldw + col) : -zc * s;
    for (; w + 4 <= we; w += 4) {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wd[j] = (uint32_t)__ldg(W + (long)(w + j) * ldw + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* v = vec + (w + j) * VPW;
#pragma unroll
        for (int i = 0; i < VPW; ++i)
          acc = fmaf(v[i], fmaf((float)((wd[j] >> (BITS * i)) & MASK), s, b), acc);
      }
    }
    for (; w < we; ++w) {
      const uint32_t wd = (uint32_t)__ldg(W + (long)w * ldw + col);
      const float* v = vec + w * VPW;
#pragma unroll
      for (int i = 0; i < VPW; ++i)
        acc = fmaf(v[i], fmaf((float)((wd >> (BITS * i)) & MASK), s, b), acc);
    }
  }
  return acc;
}

// Dot of the staged vector vec[K] with 32 columns [col0, col0+32) of a packed
// matrix: the block's warps split K, then warp 0 sums the partials. The result
// is valid in warp 0 (lane = column offset); columns >= ncols give 0.
template <int BITS>
__device__ __forceinline__ float tile_dot(const float* vec, int K, const int32_t* W,
                                          const float* S, const float* Bt, float zc, long ldw,
                                          int g, long col0, int lane_col, int ncols,
                                          float* red) {
  constexpr int VPW = 32 / BITS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KW = K / VPW;
  const int w0 = (int)((long)KW * warp / NW), w1 = (int)((long)KW * (warp + 1) / NW);
  float acc = 0.f;
  if (lane_col + lane < ncols) acc = warp_dot<BITS>(vec, W, S, Bt, zc, ldw, g, col0 + lane, w0, w1);
  __syncthreads();
  red[warp * 33 + lane] = acc;
  __syncthreads();
  float tot = 0.f;
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) tot += red[i * 33 + lane];
  }
  return tot;
}

// Per-layer pointers and sizes. Cache rows are addressed as
// base + t*stride + head*D (values) and base + t*sstride + head (scales), so
// one struct serves the split k/v caches of block_fused and the merged
// [T, 2, Hkv, D] cache of model_flat.
struct LayerArgs {
  const void* x_t;   // model-dtype residual input [h], or null: read xres
  float* xres;       // f32 residual [h]; P5 writes the layer output here
  void* x_out;       // model-dtype layer output [h], or null
  const void* n1;
  const void* n2;    // model-dtype norm weights [h]
  const int32_t* qkv; const float* qs; const float* qb;
  const int32_t* o;   const float* os; const float* ob;
  const int32_t* gu;  const float* gus; const float* gub;
  const int32_t* dn;  const float* ds; const float* db;
  const int8_t* ck; const int8_t* cv; const float* cks; const float* cvs;
  int8_t* krow; int8_t* vrow; float* ks_out; float* vs_out;
  const float* cos; const float* sin;
  float* qkv_buf; float* attn_buf; float* xmid_buf; float* act_buf;
  long kv_stride, s_stride;
  int hidden, n_heads, n_kv_heads, head_dim, inter, pos;
  int g_qkv, g_o, g_gu, g_d;
  float zc_qkv, zc_o, zc_gu, zc_d, eps;
};

// Stage round(round(x*rstd)*w) (the model-dtype rounding of rms_norm) as
// f32 into vec[0:h]. x comes from the model-dtype xt or, if null, from xf.
template <class T>
__device__ __forceinline__ void stage_rmsnorm(float* vec, const T* xt, const float* xf,
                                              const T* w, int h, float eps, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += NT) {
    const float v = xt ? to_f(xt[i]) : __ldcg(xf + i);
    vec[i] = v;
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float rstd = 1.f / sqrtf(ss / (float)h + eps);
  for (int i = threadIdx.x; i < h; i += NT)
    vec[i] = round_t<T>(round_t<T>(vec[i] * rstd) * to_f(w[i]));
  __syncthreads();
}

__device__ __forceinline__ void stage_copy(float* vec, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) vec[i] = __ldcg(src + i);
  __syncthreads();
}

// y[n] = epi(n, vec . W[:, col_off + n]) for n in [0, ncols), 32 columns per
// block-wide tile, tiles strided over the grid.
template <int BITS, class Epi>
__device__ __forceinline__ void gemv_phase(const float* vec, int K, const int32_t* W,
                                           const float* S, const float* Bt, float zc, long ldw,
                                           int g, long col_off, int ncols, float* red, Epi epi) {
  const int ntiles = (ncols + 31) / 32;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int c0 = t * 32;
    const float v = tile_dot<BITS>(vec, K, W, S, Bt, zc, ldw, g, col_off + c0, c0, ncols, red);
    const int n = c0 + (threadIdx.x & 31);
    if (threadIdx.x < 32 && n < ncols) epi(n, v);
  }
}

// The int8 history of one kv head: row t's codes at k + t*stride (v
// likewise) and its scales at ks[t*sstride] (vs likewise); rows t < pos are
// live. Serves the [T, Hkv, D] caches (stride Hkv*D) and the head-transposed
// [Hkv, T, D] slot caches of the batched kernel (stride D).
//
// With a history ring (attend_head<Hist, true>) a row lands in a slot of
// ring_bytes(D): the k codes, the v codes, then the two scales, copied by
// the warp's lanes together with 4-byte cp.async (fetch; the history was
// written before the launch, so the copies may allocate in L1).
struct HeadHist {
  const int8_t* k; const int8_t* v; const float* ks; const float* vs;
  long stride, sstride;
  int pos;
  __device__ __forceinline__ void row(int t, const int8_t*& kr, const int8_t*& vr, float& ksc,
                                      float& vsc) const {
    kr = k + (long)t * stride;
    vr = v + (long)t * stride;
    ksc = ks[(long)t * sstride];
    vsc = vs[(long)t * sstride];
  }
  static __device__ __forceinline__ int8_t ld(const int8_t* p) { return *p; }
  __host__ __device__ static constexpr int ring_bytes(int D) { return 2 * D + 8; }
  __device__ __forceinline__ void fetch(int t, uint8_t* s, int D, int lane) const {
    const int8_t* kr = k + (long)t * stride;
    const int8_t* vr = v + (long)t * stride;
    for (int b = 4 * lane; b < D; b += 128) {
      cp_async4(s + b, kr + b, true);
      cp_async4(s + D + b, vr + b, true);
    }
    if (lane == 0) {
      cp_async4(s + 2 * D, ks + (long)t * sstride, true);
      cp_async4(s + 2 * D + 4, vs + (long)t * sstride, true);
    }
  }
  __device__ __forceinline__ void scales(int, const uint8_t* s, int D, float& ksc,
                                         float& vsc) const {
    ksc = *reinterpret_cast<const float*>(s + 2 * D);
    vsc = *reinterpret_cast<const float*>(s + 2 * D + 4);
  }
};

// The cache history of kv head kvh for a one-token step's layer `a`.
__device__ __forceinline__ HeadHist head_hist(const LayerArgs& a, int kvh) {
  const int D = a.head_dim;
  return HeadHist{a.ck + (long)kvh * D, a.cv + (long)kvh * D, a.cks + kvh, a.cvs + kvh,
                  a.kv_stride, a.s_stride, a.pos};
}

// The history of one kv head in the batched kernel's paged and chunk modes
// (model_fused.cu, mode (b) and/or (c)). Rows t < prefix come from the
// slot's cache: dense, the head-transposed [T, D] slot rows at k + t*D; or,
// with a page table, row t % P of page table[t / P], i.e. pool row
// table[t / P] * page_rows + t % P of the [n_pages, Hkv, P] layout (k
// points at the layer's kv head). Rows prefix <= t < pos are the chunk's
// own new rows of this launch (t - prefix before the current one), at ck +
// (t - prefix)*cstride; they were written earlier in the same launch, so
// every load goes through L2 (__ldcg).
struct PagedChunkHist {
  const int8_t* k; const int8_t* v; const float* ks; const float* vs;
  const int* table;  // the slot's page-table row, or null: dense
  long page_rows;    // Hkv * P
  int P, D, prefix, pos;
  const int8_t* ck; const int8_t* cv; const float* cks; const float* cvs;
  long cstride, csstride;
  __device__ __forceinline__ void row(int t, const int8_t*& kr, const int8_t*& vr, float& ksc,
                                      float& vsc) const {
    if (t < prefix) {
      long r = t;
      if (table) {
        const int j = t / P;
        r = (long)__ldg(table + j) * page_rows + (t - j * P);
      }
      kr = k + r * D;
      vr = v + r * D;
      ksc = __ldcg(ks + r);
      vsc = __ldcg(vs + r);
    } else {
      const long j = t - prefix;
      kr = ck + j * cstride;
      vr = cv + j * cstride;
      ksc = __ldcg(cks + j * csstride);
      vsc = __ldcg(cvs + j * csstride);
    }
  }
  static __device__ __forceinline__ int8_t ld(const int8_t* p) { return __ldcg(p); }
};

// The history of one kv head for token t of a multi-token segment
// (model_flat.cu): rows t' < pos0 from the merged cache [T, 2, Hkv, D], then
// rows pos0 <= t' < pos of the segment's earlier tokens from the launch's
// own output rows [kseg, L, 2, Hkv, D] (scales [.., 2, Hkv] alike), which
// other blocks wrote earlier in the same launch: no load of those may
// allocate in L1, where a line read before another block wrote it would be
// stale, so every load goes through L2 (__ldcg). The 4-bit kernel streams
// the rows t' < pos0 through its history ring as a HeadHist and passes this
// history to attend_head as the tail.
struct SegHist {
  const int8_t* k; const float* ks;    // the cache's kv head: rows 2*kvdim apart, scales 2*Hkv
  const int8_t* sk; const float* sks;  // the segment's token 0: rows L*2*kvdim, scales L*2*Hkv
  int kvdim, Hkv, L, pos0, pos;        // v rows kvdim after k rows, v scales Hkv after k scales
  __device__ __forceinline__ void row(int t, const int8_t*& kr, const int8_t*& vr, float& ksc,
                                      float& vsc) const {
    const bool c = t < pos0;
    const long r = c ? t : (long)(t - pos0) * L;
    kr = (c ? k : sk) + r * 2 * kvdim;
    vr = kr + kvdim;
    const float* kp = (c ? ks : sks) + r * 2 * Hkv;
    ksc = __ldcg(kp);
    vsc = __ldcg(kp + Hkv);
  }
  static __device__ __forceinline__ int8_t ld(const int8_t* p) { return __ldcg(p); }
};

// No rows after the history's own: attend_head's default tail.
struct NoTail {
  int pos;
  __device__ __forceinline__ void row(int, const int8_t*&, const int8_t*&, float&, float&) const {}
  static __device__ __forceinline__ int8_t ld(const int8_t* p) { return *p; }
};

// History rows a warp's ring holds in attend_head<Hist, true> (HIST_RING - 1
// in flight).
constexpr int HIST_RING = 8;

// Attention for one query head over the int8 history `hh` (HeadHist,
// PagedChunkHist or SegHist), seeded with the new (dequantized) row: warps
// stream history rows t < hh.pos (warp w rows w, w + NW, ..) with an online
// softmax each, then merge. Writes out[0:D]. smem holds q[D], kd[D], vd[D]
// and NW*(D+2) merge floats. A warp's rows come either by direct loads as it
// reaches them (hh.row, Hist::ld) or, with RING, through a per-warp cp.async
// ring of HIST_RING rows in shared memory (`pf`: [NW][HIST_RING][
// Hist::ring_bytes(D)]; hh.fetch copies row t into a slot, hh.scales reads
// its scales there), HIST_RING - 1 of them in flight. A Tail other than
// NoTail adds its rows hh.pos <= t < tail.pos after them, by direct loads,
// in the same order (warp w's next rows). The arithmetic, its order and its
// rounding are the same whichever way a row comes.
template <class Hist, bool RING = false, class Tail = NoTail>
__device__ __forceinline__ void attend_head(const Hist& hh, int D, float* out, float* sm,
                                            float* red, uint8_t* pf = nullptr,
                                            const Tail& tail = Tail{}) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* q = sm;
  const float* kd = sm + D;
  const float* vd = sm + 2 * D;
  float* mrg = sm + 3 * D;  // [NW][D + 2]
  const float scale = 1.f / sqrtf((float)D);
  constexpr int MAXJ = 8;   // D <= 256
  const int nj = D / 32;
  uint8_t* ring = nullptr;
  int rowb = 0;
  if constexpr (RING) {
    rowb = Hist::ring_bytes(D);
    ring = pf + warp * HIST_RING * rowb;
  }
  auto fetch = [&](int i) {  // the warp's i-th row into slot i % HIST_RING
    if constexpr (RING) {
      const int t = warp + i * NW;
      if (t < hh.pos) hh.fetch(t, ring + (i % HIST_RING) * rowb, D, lane);
      cp_async_commit();
    }
  };
  if constexpr (RING) {
#pragma unroll 1
    for (int i = 0; i < HIST_RING - 1; ++i) fetch(i);
  }

  float sn = 0.f;
  for (int d = threadIdx.x; d < D; d += NT) sn += q[d] * kd[d];
  sn = block_sum(sn, red) * scale;

  float m, l, acc[MAXJ];
  if (warp == 0) {
    m = sn; l = 1.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[j] = j < nj ? vd[lane + 32 * j] : 0.f;
  } else {
    m = -INFINITY; l = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  }
  // row (kr, vr, ksc, vsc) into the warp's online softmax; ld loads a code
  auto update = [&](const int8_t* kr, const int8_t* vr, float ksc, float vsc, auto ld) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) p += q[lane + 32 * j] * ((float)ld(kr + lane + 32 * j) * ksc);
    const float s = warp_sum(p) * scale;
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);
    const float e = expf(s - mn);
    l = l * corr + e;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) acc[j] = acc[j] * corr + e * ((float)ld(vr + lane + 32 * j) * vsc);
    m = mn;
  };
  int t = warp, i = 0;
  for (; t < hh.pos; t += NW, ++i) {
    const int8_t* kr;
    const int8_t* vr;
    float ksc, vsc;
    if constexpr (RING) {
      cp_async_wait<HIST_RING - 2>();  // row i has landed (this lane's pieces)
      __syncwarp();                     // and every lane's
      const uint8_t* slot = ring + (i % HIST_RING) * rowb;
      kr = reinterpret_cast<const int8_t*>(slot);
      vr = kr + D;
      hh.scales(t, slot, D, ksc, vsc);
      update(kr, vr, ksc, vsc, [](const int8_t* p) { return *p; });
      fetch(i + HIST_RING - 1);  // into the slot every lane left one row ago
    } else {
      hh.row(t, kr, vr, ksc, vsc);
      update(kr, vr, ksc, vsc, [](const int8_t* p) { return Hist::ld(p); });
    }
  }
  if constexpr (!std::is_same<Tail, NoTail>::value) {
    for (; t < tail.pos; t += NW) {
      const int8_t* kr;
      const int8_t* vr;
      float ksc, vsc;
      tail.row(t, kr, vr, ksc, vsc);
      update(kr, vr, ksc, vsc, [](const int8_t* p) { return Tail::ld(p); });
    }
  }
  float* mine = mrg + warp * (D + 2);
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (j < nj) mine[lane + 32 * j] = acc[j];
  if (lane == 0) { mine[D] = m; mine[D + 1] = l; }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NT) {
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[w * (D + 2) + D]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(mrg[w * (D + 2) + D] - M);
      L += mrg[w * (D + 2) + D + 1] * c;
      A += mrg[w * (D + 2) + d] * c;
    }
    out[d] = A / L;
  }
  __syncthreads();
}

// RoPE on the f32 head vector x[0:D] (global scratch) for thread d < D:
// x[d]*cos[d] + rotate_half(x)[d]*sin[d].
__device__ __forceinline__ float rope_at(const float* x, const float* cos, const float* sin,
                                         int d, int half) {
  const float rot = d < half ? -__ldcg(x + d + half) : __ldcg(x + d - half);
  return __ldcg(x + d) * cos[d] + rot * sin[d];
}

// One (token, q head) work item of P2: RoPE on q head hq and kv head kvh of
// the token's f32 qkv vector (global scratch), the int8 k/v row of kv head
// kvh and its scales (stored when `store_row`: the first q head of the
// group), then attention over `hh` seeded with the new row, into out[0:D].
template <class Hist>
__device__ __forceinline__ void attention_item(const float* qkv, const float* cos,
                                               const float* sin, int hq, int kvh, int qdim,
                                               int kvdim, int D, const Hist& hh,
                                               bool store_row, int8_t* krow, int8_t* vrow,
                                               float* ks_out, float* vs_out, float* out,
                                               float* sm, float* red) {
  const int half = D / 2;
  const float* qs = qkv + (long)hq * D;
  const float* ks = qkv + qdim + (long)kvh * D;
  const float* vs = qkv + qdim + kvdim + (long)kvh * D;
  float kr = 0.f, vr = 0.f;
  const int d = threadIdx.x;
  if (d < D) {
    const float c = cos[d], s = sin[d];
    const float qrot = d < half ? -__ldcg(qs + d + half) : __ldcg(qs + d - half);
    const float krot = d < half ? -__ldcg(ks + d + half) : __ldcg(ks + d - half);
    sm[d] = __ldcg(qs + d) * c + qrot * s;
    kr = __ldcg(ks + d) * c + krot * s;
    vr = __ldcg(vs + d);
  }
  const float kam = fmaxf(block_max(d < D ? fabsf(kr) : 0.f, red), 1e-8f);
  const float vam = fmaxf(block_max(d < D ? fabsf(vr) : 0.f, red), 1e-8f);
  const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
  if (d < D) {
    const float kq = fminf(fmaxf(rintf(kr / ksc), -127.f), 127.f);
    const float vq = fminf(fmaxf(rintf(vr / vsc), -127.f), 127.f);
    sm[D + d] = kq * ksc;
    sm[2 * D + d] = vq * vsc;
    if (store_row) {
      krow[d] = (int8_t)kq;
      vrow[d] = (int8_t)vq;
      if (d == 0) { *ks_out = ksc; *vs_out = vsc; }
    }
  }
  __syncthreads();
  attend_head(hh, D, out, sm, red);
}

// Chunk mode, first half of P2: RoPE on kv head kvh of one row's f32 qkv
// vector and its int8 k/v row and scales, stored for every row's attention
// after the grid barrier (the same arithmetic as attention_item's row).
__device__ __forceinline__ void chunk_kv_row(const float* qkv, const float* cos,
                                             const float* sin, int kvh, int qdim, int kvdim,
                                             int D, int8_t* krow, int8_t* vrow, float* ks_out,
                                             float* vs_out, float* red) {
  const float* ks = qkv + qdim + (long)kvh * D;
  const float* vs = qkv + qdim + kvdim + (long)kvh * D;
  float kr = 0.f, vr = 0.f;
  const int d = threadIdx.x;
  if (d < D) {
    kr = rope_at(ks, cos, sin, d, D / 2);
    vr = __ldcg(vs + d);
  }
  const float kam = fmaxf(block_max(d < D ? fabsf(kr) : 0.f, red), 1e-8f);
  const float vam = fmaxf(block_max(d < D ? fabsf(vr) : 0.f, red), 1e-8f);
  const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
  if (d < D) {
    krow[d] = (int8_t)fminf(fmaxf(rintf(kr / ksc), -127.f), 127.f);
    vrow[d] = (int8_t)fminf(fmaxf(rintf(vr / vsc), -127.f), 127.f);
    if (d == 0) { *ks_out = ksc; *vs_out = vsc; }
  }
}

// Chunk mode, second half of P2: RoPE on q head hq of one row, its own int8
// row (stored by chunk_kv_row before the barrier) dequantized as the seed,
// then attention over the slot's history and the chunk's earlier rows.
__device__ __forceinline__ void chunk_attend(const float* qkv, const float* cos,
                                             const float* sin, int hq, int D,
                                             const PagedChunkHist& hh, const int8_t* krow,
                                             const int8_t* vrow, const float* ks,
                                             const float* vs, float* out, float* sm,
                                             float* red) {
  const int d = threadIdx.x;
  if (d < D) {
    sm[d] = rope_at(qkv + (long)hq * D, cos, sin, d, D / 2);
    sm[D + d] = (float)__ldcg(krow + d) * __ldcg(ks);
    sm[2 * D + d] = (float)__ldcg(vrow + d) * __ldcg(vs);
  }
  __syncthreads();
  attend_head(hh, D, out, sm, red);
}

// P2 of one token: every q head, its kv head's new row, then attention.
__device__ __forceinline__ void attention_phase(const LayerArgs& a, float* sm, float* red) {
  const int D = a.head_dim;
  const int reps = a.n_heads / a.n_kv_heads;
  const int qdim = a.n_heads * D, kvdim = a.n_kv_heads * D;
  for (int hq = blockIdx.x; hq < a.n_heads; hq += gridDim.x) {
    const int kvh = hq / reps;
    attention_item(a.qkv_buf, a.cos, a.sin, hq, kvh, qdim, kvdim, D, head_hist(a, kvh),
                   hq % reps == 0, a.krow + (long)kvh * D, a.vrow + (long)kvh * D,
                   a.ks_out + kvh, a.vs_out + kvh, a.attn_buf + (long)hq * D, sm, red);
  }
}

// The P2 of one token over the cache rows t < a.pos (attention_phase).
struct TokenAttention {
  __device__ __forceinline__ void operator()(const LayerArgs& a, float* sm, float* red) const {
    attention_phase(a, sm, red);
  }
};

// One decoder layer, phases P1-P5, with a grid barrier after each of P1-P4.
// `attn(a, sm, red)` runs P2 (model_flat.cu's multi-token kernel passes its
// own history). The caller syncs after P5 when another phase follows.
template <class T, int BITS, class Attn = TokenAttention>
__device__ void decoder_layer(const LayerArgs& a, float* vec, float* red, Attn attn = Attn()) {
  cg::grid_group grid = cg::this_grid();
  const int h = a.hidden, D = a.head_dim;
  const int qdim = a.n_heads * D, nqkv = qdim + 2 * a.n_kv_heads * D;
  const T* xt = (const T*)a.x_t;

  // P1
  stage_rmsnorm<T>(vec, xt, a.xres, (const T*)a.n1, h, a.eps, red);
  float* qkv_buf = a.qkv_buf;
  gemv_phase<BITS>(vec, h, a.qkv, a.qs, a.qb, a.zc_qkv, nqkv, a.g_qkv, 0, nqkv, red,
                   [&](int n, float v) { qkv_buf[n] = v; });
  grid.sync();

  // P2
  attn(a, vec, red);
  grid.sync();

  // P3
  stage_copy(vec, a.attn_buf, qdim);
  float* xmid = a.xmid_buf;
  const float* xres = a.xres;
  gemv_phase<BITS>(vec, qdim, a.o, a.os, a.ob, a.zc_o, h, a.g_o, 0, h, red,
                   [&](int n, float v) { xmid[n] = (xt ? to_f(xt[n]) : __ldcg(xres + n)) + v; });
  grid.sync();

  // P4: gate and up columns n and inter + n of the fused gate/up matrix
  stage_rmsnorm<T>(vec, nullptr, xmid, (const T*)a.n2, h, a.eps, red);
  const int I = a.inter;
  const int ntiles = (I + 31) / 32;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int c0 = t * 32;
    const float gt = tile_dot<BITS>(vec, h, a.gu, a.gus, a.gub, a.zc_gu, 2L * I, a.g_gu, c0,
                                    c0, I, red);
    const float up = tile_dot<BITS>(vec, h, a.gu, a.gus, a.gub, a.zc_gu, 2L * I, a.g_gu,
                                    (long)I + c0, c0, I, red);
    const int n = c0 + (threadIdx.x & 31);
    if (threadIdx.x < 32 && n < I) a.act_buf[n] = gt * (1.f / (1.f + expf(-gt))) * up;
  }
  grid.sync();

  // P5
  stage_copy(vec, a.act_buf, I);
  float* xo = a.xres;
  T* x_out = (T*)a.x_out;
  gemv_phase<BITS>(vec, I, a.dn, a.ds, a.db, a.zc_d, h, a.g_d, 0, h, red,
                   [&](int n, float v) {
                     const float r = __ldcg(xmid + n) + v;
                     xo[n] = r;
                     if (x_out) x_out[n] = from_f<T>(r);
                   });
}

// Shared memory floats a decode kernel needs: the staged vector (or the
// attention buffers) plus the reduction scratch.
inline int decode_smem_floats(int hidden, int qdim, int inter, int head_dim) {
  int v = hidden;
  if (qdim > v) v = qdim;
  if (inter > v) v = inter;
  const int att = 3 * head_dim + NW * (head_dim + 2);
  if (att > v) v = att;
  return v + RED_FLOATS;
}

// Blocks for a cooperative launch: co-resident blocks per SM (at most
// COOP_PER_SM) times the SM count, capped at `cap` when cap > 0.
template <class K>
inline cudaError_t coop_grid(K kernel, size_t smem, int cap, int* grid) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int g = sms * (per_sm < COOP_PER_SM ? per_sm : COOP_PER_SM);
  if (cap > 0 && g > cap) g = cap;
  *grid = g;
  return cudaSuccess;
}

}  // namespace mi
