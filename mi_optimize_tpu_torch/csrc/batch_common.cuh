// The batched whole-model kernel's argument block and the device code that
// its instances share: model_fused.cu's batch_kernel (modes (a)-(d)) and
// model_fused_tp.cu's tp_kernel (mode (e)), moved here unchanged from
// model_fused.cu so that both sources compile it.
#pragma once

#include "batch_gemv.cuh"
#include "decode_common.cuh"
#include "mega_args.cuh"

// Host-side argument blocks (MegaArgs: mega_args.cuh), mirrored field by
// field by the ctypes Structures in ops/model_fused.py. Stacked arrays carry
// a leading layer axis; a null bias table means "use -zc*s".
struct BatchArgs {
  const void* x;                                          // model dtype [B, h]
  const void* n1; const void* n2;
  const int32_t* qkv; const float* qs; const float* qb;
  const int32_t* o; const float* os; const float* ob;
  const int32_t* gu; const float* gus; const float* gub;
  const int32_t* dn; const float* ds; const float* db;
  const float* cos; const float* sin;                     // [B, D]
  const int* pos;                                         // [B]
  const int8_t* ck; const int8_t* cv;                     // [L, B, Hkv, T, D]
  const float* cks; const float* cvs;                     // [L, B, Hkv, T]
  void* x_out;                                            // model dtype [B, h]
  int8_t* krow; int8_t* vrow; float* ks; float* vs;       // [L, B, Hkv, D], [L, B, Hkv]
  float* scratch;  // f32: xres B*h | qkv B*nqkv | attn B*qdim | xmid B*h | act B*inter
  int batch, n_layers, hidden, n_heads, n_kv_heads, head_dim, inter, max_len;
  int g_qkv, g_o, g_gu, g_d;
  float zc_qkv, zc_o, zc_gu, zc_d, eps;
  // paged and chunk modes: with a table, ck/cv/cks/cvs are the page pool
  // [L, n_pages, Hkv, P(, D)] and max_len is unused; the dense cache has
  // batch / chunk slots
  const int* table;                                       // [batch / chunk, pps], or null
  int chunk, page_size, pps, n_pages;
  // terminal lm rows (mode d), with a non-null ue
  const int32_t* ue; const float* ues;                    // [h/vpw, V], [h/g_ue, V]
  const void* fnorm;                                      // model dtype [h]
  float* logits; int* tokens;                             // [B, V], [B]
  float* part_val; int* part_idx;                         // [max_blocks, 8] (block, row)
  int vocab, g_ue, max_blocks;                            // max_blocks caps the grid
  float zc_ue;
  // 4-bit words (batch_gemv.cuh): the plan of the GEMVs qkv, o, gate/up,
  // down, lm_head (warp strips a tile, K splits), the splits' f32 partials
  // (n_part floats), one counter a tile (n_counters; the kernel zeroes them)
  // and the tiles' row sums of squares [n_counters, 8]
  int plan_ws[mi::BG_GEMVS], plan_splits[mi::BG_GEMVS];
  float* part; int* counters;
  int n_counters, n_part;
  float* ssq;
};

namespace {

using namespace mi;

template <int BITS>
__device__ __forceinline__ long words(long k) { return k / (32 / BITS); }

__device__ __forceinline__ const float* layer_tab(const float* t, long per_layer, int l) {
  return t ? t + (long)l * per_layer : nullptr;
}

// ---------------------------------------------------------------------------
// model_decode_mega_batch: B slots, one token each
// ---------------------------------------------------------------------------

constexpr int KC = 1024;  // activation columns staged in shared memory per chunk

constexpr int MAX_NC = 2;  // weight columns a lane computes from one staging (gate and up)

// Shared memory floats of the batched kernel: the staged rows (4-bit: the
// tensor-core GEMV's planes and word sums; else the NB x KC chunk) or the
// attention buffers, the reductions' floats (4-bit: block sums and the lm
// rows' argmax; else the warps' MAX_NC x NB x 32 partial sums), NB row norms.
__host__ __device__ inline int batch_xs_floats(int bits, int nb, int head_dim) {
  int v = bits == 4 ? bg_smem_floats() : nb * KC;
  const int att = 3 * head_dim + NW * (head_dim + 2);
  if (att > v) v = att;
  return (v + 3) & ~3;
}
__host__ __device__ inline int batch_red_floats(int bits, int nb) {
  return bits == 4 ? RED_FLOATS : NW * MAX_NC * nb * 33;
}
__host__ __device__ inline int batch_smem_floats(int bits, int nb, int head_dim) {
  return batch_xs_floats(bits, nb, head_dim) + batch_red_floats(bits, nb) + nb;
}

// rstd[m] = 1/sqrt(mean(x[m]^2) + eps) for rows m < B of x [B, h] (f32 scratch).
__device__ __forceinline__ void row_rstd(float* rstd, const float* x, int B, int h, float eps,
                                         float* red) {
  for (int m = 0; m < B; ++m) {
    float ss = 0.f;
    for (int i = threadIdx.x; i < h; i += NT) {
      const float v = __ldcg(x + (long)m * h + i);
      ss += v * v;
    }
    ss = block_sum(ss, red);
    if (threadIdx.x == 0) rstd[m] = 1.f / sqrtf(ss / (float)h + eps);
  }
}

// The tiles of plan p's GEMV over an h-wide output (o_proj, down_proj): the
// tiles of its sums of squares.
__device__ __forceinline__ int plan_tiles(const BatchArgs& f, int p) {
  return bg_tiles(f.hidden, 1, f.plan_ws[p]);
}

// Sources of the activation rows a batched GEMV stages: row m, columns
// [k, k+4) as a float4 (every K is a multiple of 4, every row 16-byte aligned).
// RowsCopy reads f32 rows of scratch; RowsNorm applies the rmsnorm with the
// model-dtype rounding points of stage_rmsnorm.
struct RowsCopy {
  const float* x;
  long ld;
  __device__ __forceinline__ float4 load4(int m, int k) const {
    return __ldcg(reinterpret_cast<const float4*>(x + m * ld + k));
  }
};

template <class T>
struct RowsNorm {
  const float* x;
  long ld;
  const T* w;
  const float* rstd;
  __device__ __forceinline__ float4 load4(int m, int k) const {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(x + m * ld + k));
    const float r = rstd[m];
    return make_float4(round_t<T>(round_t<T>(v.x * r) * to_f(w[k])),
                       round_t<T>(round_t<T>(v.y * r) * to_f(w[k + 1])),
                       round_t<T>(round_t<T>(v.z * r) * to_f(w[k + 2])),
                       round_t<T>(round_t<T>(v.w * r) * to_f(w[k + 3])));
  }
};

static_assert(KC == 4 * NT, "a chunk is one float4 per thread and row");

// out[c][m] (valid in warp 0, lane = column) = sum_k src(m, k) * W[k, col +
// c * cstride] for the NC columns c and the rows m < NB; rows m >= B are
// staged as zeros. The activation rows are staged KC columns at a time into
// xs [NB][KC], one float4 per thread and row with all NB loads in flight, and
// serve all NC columns; the block's warps split each chunk's words; every
// word is loaded once and applied to all NB rows. `live` is false on lanes
// past the matrix's last column: they stage but load nothing.
template <int BITS, int NB, int NC, class Src>
__device__ __forceinline__ void tile_dot_b(float* xs, int B, int K, const Src& src,
                                           const int32_t* __restrict__ W,
                                           const float* __restrict__ S,
                                           const float* __restrict__ Bt, float zc, long ldw,
                                           int g, long col, long cstride, bool live, float* red,
                                           float (&out)[NC][NB]) {
  static_assert(NC <= MAX_NC, "the partial sums are sized for MAX_NC columns");
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpg = g / VPW;
  float acc[NC][NB];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < NB; ++m) acc[c][m] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    const int k4 = 4 * threadIdx.x;
    if (k4 < kc) {
      float4 v[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m)
        v[m] = m < B ? src.load4(m, k0 + k4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < NB; ++m) *reinterpret_cast<float4*>(xs + m * KC + k4) = v[m];
    }
    __syncthreads();
    if (!live) continue;
    const int cw = kc / VPW, base = k0 / VPW;
    int w = base + cw * warp / NW;
    const int w1 = base + cw * (warp + 1) / NW;
    while (w < w1) {
      const int gi = w / wpg;
      const int we = min(w1, (gi + 1) * wpg);
      float s[NC], b[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const long at = (long)gi * ldw + col + c * cstride;
        s[c] = __ldg(S + at);
        b[c] = Bt ? __ldg(Bt + at) : -zc * s[c];
      }
      while (w < we) {
        const int nw = min(4, we - w);  // up to 4 words a column in flight
        uint32_t wd[NC][4];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wd[c][j] =
                j < nw ? (uint32_t)__ldg(W + (long)(w + j) * ldw + col + c * cstride) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nw) break;
          const float* xw = xs + (w + j - base) * VPW;
#pragma unroll
          for (int i = 0; i < VPW; i += 4) {
            float wv[NC][4];
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                wv[c][e] = fmaf((float)((wd[c][j] >> (BITS * (i + e))) & MASK), s[c], b[c]);
#pragma unroll
            for (int m = 0; m < NB; ++m) {
              const float4 xv = *reinterpret_cast<const float4*>(xw + m * KC + i);
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                acc[c][m] = fmaf(xv.x, wv[c][0], acc[c][m]);
                acc[c][m] = fmaf(xv.y, wv[c][1], acc[c][m]);
                acc[c][m] = fmaf(xv.z, wv[c][2], acc[c][m]);
                acc[c][m] = fmaf(xv.w, wv[c][3], acc[c][m]);
              }
            }
          }
        }
        w += nw;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < NB; ++m) red[((warp * NC + c) * NB + m) * 33 + lane] = acc[c][m];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) t += red[((w * NC + c) * NB + m) * 33 + lane];
        out[c][m] = t;
      }
  }
}

// epi(m, n, v) for rows m < B and columns n < ncols, v[c] the product with
// column n + c * cstride of W for the NC columns; 32 columns n per
// block-wide tile, tiles strided over the grid.
template <int BITS, int NB, int NC, class Src, class Epi>
__device__ __forceinline__ void gemv_b(float* xs, int B, int K, const Src& src, const int32_t* W,
                                       const float* S, const float* Bt, float zc, long ldw,
                                       int g, int ncols, long cstride, float* red, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int ntiles = (ncols + 31) / 32;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n = t * 32 + lane;
    float out[NC][NB];
    tile_dot_b<BITS, NB, NC>(xs, B, K, src, W, S, Bt, zc, ldw, g, n, cstride, n < ncols, red,
                             out);
    if (threadIdx.x < 32 && n < ncols) {
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m >= B) continue;
        float v[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) v[c] = out[c][m];
        epi(m, n, v);
      }
    }
  }
}

// The history of kv head kvh of slot s in layer l for the paged and chunk
// modes: `prefix` cache rows, then the chunk rows from its first row c0
// (index into the [L, B, Hkv] rows) up to `pos`.
__device__ __forceinline__ PagedChunkHist chunk_hist(const BatchArgs& f, int l, int s, int kvh,
                                                     int prefix, int pos, long c0) {
  const int D = f.head_dim, Hkv = f.n_kv_heads;
  PagedChunkHist h;
  long base;  // first cache row of (layer, slot or pool, kv head)
  if (f.table) {
    base = ((long)l * f.n_pages * Hkv + kvh) * f.page_size;
    h.table = f.table + (long)s * f.pps;
  } else {
    base = (((long)l * (f.batch / f.chunk) + s) * Hkv + kvh) * f.max_len;
    h.table = nullptr;
  }
  h.k = f.ck + base * D; h.v = f.cv + base * D; h.ks = f.cks + base; h.vs = f.cvs + base;
  h.page_rows = (long)Hkv * f.page_size;
  h.P = f.page_size; h.D = D; h.prefix = prefix; h.pos = pos;
  h.ck = f.krow + c0 * D; h.cv = f.vrow + c0 * D; h.cks = f.ks + c0; h.cvs = f.vs + c0;
  h.cstride = (long)Hkv * D; h.csstride = Hkv;
  return h;
}

// A GEMV phase of batch_kernel: with 4-bit words the tensor-core GEMV (NP
// bf16 planes a row, plan `p` of f), else the CUDA-core gemv_b. Static: a
// 4-bit instance never compiles gemv_b.
template <int BITS, int NB, int NP, int NC, class Src, class Epi>
__device__ __forceinline__ void phase_gemv(const BatchArgs& f, int p, float* xs, float* red,
                                           int B, int K, const Src& src, const int32_t* W,
                                           const float* S, const float* Bt, float zc, int ldw,
                                           int g, int ncols, int cstride, float* ssq, Epi epi) {
  if constexpr (BITS == 4)
    bg_gemv<NP, NC>(xs, B, K, src, W, S, Bt, zc, ldw, g, ncols, cstride, f.plan_ws[p],
                    f.plan_splits[p], f.part, f.counters, ssq, epi);
  else
    gemv_b<BITS, NB, NC>(xs, B, K, src, W, S, Bt, zc, ldw, g, ncols, cstride, red, epi);
}

// The 4-bit words' tensor-core GEMV plan of a launch (qkv, o, gate/up, down,
// lm_head), and its scratch against the plan's needs.
inline cudaError_t check_bg_plan(const BatchArgs& f) {
  if (!f.part || !f.counters || !f.ssq || f.n_counters < 1 || f.n_part < 0)
    return cudaErrorInvalidValue;
  const int qdim = f.n_heads * f.head_dim, nqkv = qdim + 2 * f.n_kv_heads * f.head_dim;
  // (output columns, columns a pair, K, group) of qkv, o, gate/up, down, lm_head
  const int shape[BG_GEMVS][4] = {{nqkv, 1, f.hidden, f.g_qkv}, {f.hidden, 1, qdim, f.g_o},
                                  {f.inter, 2, f.hidden, f.g_gu}, {f.hidden, 1, f.inter, f.g_d},
                                  {f.ue ? f.vocab : 0, 1, f.hidden, f.g_ue}};
  for (int p = 0; p < BG_GEMVS; ++p) {
    const int ws = f.plan_ws[p], sp = f.plan_splits[p], n = shape[p][0], nc = shape[p][1];
    if (sp < 1 || (ws != 1 && ws != 2 && ws != 4 && ws != 8)) return cudaErrorInvalidValue;
    if (n == 0) continue;
    if (sp > shape[p][2] / shape[p][3] || bg_tiles(n, nc, ws) > f.n_counters ||
        bg_part_floats(n, nc, ws, sp) > f.n_part)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace
