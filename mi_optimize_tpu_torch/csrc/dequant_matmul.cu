// y[M, N] = x[M, K] @ dequant(packed)^T for words-major packed int2/4/8.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/dequant_matmul.py::_kernel.
// Four kernels; ops/dequant_matmul.py::route picks one from M, x's dtype,
// the width and the group.
//
// bf16 x with 4-bit words (every served linear), on the tensor cores:
//   * M <= 16 (decode, the lm_head in generate, the unfused model's linears):
//     gemv16_kernel. Bound by the bytes of the packed words. It computes the
//     reference's grouped rescale over centered codes (block_fused._qdot):
//     per group d = sum_k x[m,k] * (q[k,n] - 8) by mma.m16n8k16 with the
//     weights as the A operand (16 columns n) and x^T as B (8 rows m), then
//     y += s*d + (b + 8s) * sum(x_g). Each lane loads 16 bytes of words a
//     time (4 neighbouring columns x 8 k of one word row) and turns field
//     pairs (j, j+4) into bf16x2 (q - 8) by the exponent-bias trick (one
//     shift, one lop3, one sub a pair; no I2F); the k order inside a word is
//     permuted alike in x's fragments (prmt), so no shuffles are needed. A
//     warp owns 64 columns and loads its next chunk while it multiplies the
//     current one; blocks split K at group boundaries so that N = 4096 still
//     fills the card, each split writes f32 partials and the last block of a
//     column range to arrive (an integer counter) adds them in split order:
//     the same bits every run, no float atomics.
//   * M > 16, or a group that is not a multiple of 32: mma_kernel. Bound by
//     2*M*N*K operations at the PPL batch (M = 2048), by the bytes at M =
//     128. A block computes a [BM, BN] tile; each word tile is dequantized
//     once a block to bf16 in shared memory (q*s, then + b, each rounded in
//     f32, then rounded to bf16: the plain version's non-grouped weights bit
//     for bit), and mma.m16n8k16 sums the exact products in f32. x tiles
//     and word tiles come through a 3-stage cp.async ring. Tiles of 128
//     columns keep the reads of x from L2 few (x is read once a column
//     tile): [128, 128] on 8 warps, [64, 128] on 4 warps up to 64 rows.
//     Where the tiles alone give fewer blocks than SMs (M = 128, N = 4096:
//     32), K is split in whole 64-k steps and a second kernel adds the f32
//     partials in split order. No atomics: the same bits every run.
//
// f32 x, and 2- or 8-bit words (CUDA cores):
//   * M <= 8: gemv_kernel. The x rows are staged in shared memory a chunk of
//     K at a time; each lane owns one output column and walks its warp's
//     share of the chunk a word at a time; the block's 8 warps split each
//     chunk and warp 0 sums them at the end. The weight is dequantized in
//     registers (q*s + b) and never stored.
//   * M > 8: tiled_kernel. A block dequantizes a [32, 64] weight tile into
//     shared memory once and reuses it for a 64-row x tile; each thread
//     accumulates a 4 x 4 output block in f32 registers. The dequantized
//     weight is rounded to x's dtype before the product, as the reference's
//     non-grouped path does.
#include <algorithm>

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace mi;

constexpr int GEMV_MAXM = 8;
constexpr int KC = 1024;  // k values of x staged in shared memory per chunk

template <class T, int BITS>
__global__ void __launch_bounds__(NT)
gemv_kernel(const T* __restrict__ x, const int32_t* __restrict__ W, const float* __restrict__ S,
            const float* __restrict__ Bt, T* __restrict__ y, int M, int N, int K, int g) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float xs[GEMV_MAXM][KC];
  __shared__ float red[NW][GEMV_MAXM][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int wpg = g / VPW;
  float acc[GEMV_MAXM];
#pragma unroll
  for (int m = 0; m < GEMV_MAXM; ++m) acc[m] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * kc; i += NT)
      xs[i / kc][i % kc] = to_f(x[(long)(i / kc) * K + k0 + i % kc]);
    __syncthreads();
    if (n >= N) continue;
    // this warp's words of the chunk, as global word indices [w0, w1)
    const int cw = kc / VPW, base = k0 / VPW;
    int w = base + cw * warp / NW;
    const int w1 = base + cw * (warp + 1) / NW;
    while (w < w1) {
      const int gi = w / wpg;
      const int we = min(w1, (gi + 1) * wpg);
      const float s = __ldg(S + (long)gi * N + n);
      const float b = __ldg(Bt + (long)gi * N + n);
      for (; w < we; ++w) {
        const uint32_t wd = (uint32_t)__ldg(W + (long)w * N + n);
        const int kk = w * VPW - k0;
#pragma unroll
        for (int i = 0; i < VPW; ++i) {
          const float wv = fmaf((float)((wd >> (BITS * i)) & MASK), s, b);
#pragma unroll
          for (int m = 0; m < GEMV_MAXM; ++m)
            if (m < M) acc[m] = fmaf(xs[m][kk + i], wv, acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GEMV_MAXM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  if (warp == 0 && n < N) {
    for (int m = 0; m < M; ++m) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) t += red[w][m][lane];
      y[(long)m * N + n] = from_f<T>(t);
    }
  }
}

constexpr int TM = 64, TN = 64, TK = 32;

template <class T, int BITS>
__global__ void __launch_bounds__(NT)
tiled_kernel(const T* __restrict__ x, const int32_t* __restrict__ W, const float* __restrict__ S,
             const float* __restrict__ Bt, T* __restrict__ y, int M, int N, int K, int g) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  __shared__ float Xs[TK][TM + 4];
  __shared__ float Ws[TK][TN + 4];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int KW = K / VPW;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK; i += NT) {
      const int m = i / TK, kk = i % TK;
      const int gm = m0 + m, gk = k0 + kk;
      Xs[kk][m] = (gm < M && gk < K) ? to_f(x[(long)gm * K + gk]) : 0.f;
    }
    for (int i = threadIdx.x; i < (TK / VPW) * TN; i += NT) {
      const int wr = i / TN, c = i % TN;
      const int gw = k0 / VPW + wr, gn = n0 + c;
      if (gw < KW && gn < N) {
        const uint32_t wd = (uint32_t)__ldg(W + (long)gw * N + gn);
        const int gi = gw * VPW / g;
        const float s = __ldg(S + (long)gi * N + gn), b = __ldg(Bt + (long)gi * N + gn);
#pragma unroll
        for (int v = 0; v < VPW; ++v)
          Ws[wr * VPW + v][c] = round_t<T>(fmaf((float)((wd >> (BITS * v)) & MASK), s, b));
      } else {
#pragma unroll
        for (int v = 0; v < VPW; ++v) Ws[wr * VPW + v][c] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(long)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <class T, int BITS>
void launch(const void* x, const int32_t* W, const float* S, const float* B, void* y, int M,
            int N, int K, int g, cudaStream_t st) {
  if (M <= GEMV_MAXM) {
    gemv_kernel<T, BITS><<<(N + 31) / 32, NT, 0, st>>>((const T*)x, W, S, B, (T*)y, M, N, K, g);
  } else {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    tiled_kernel<T, BITS><<<grid, NT, 0, st>>>((const T*)x, W, S, B, (T*)y, M, N, K, g);
  }
}

template <class T>
int dispatch_bits(const void* x, const int32_t* W, const float* S, const float* B, void* y,
                  int M, int N, int K, int bits, int g, cudaStream_t st) {
  switch (bits) {
    case 2: launch<T, 2>(x, W, S, B, y, M, N, K, g, st); return 0;
    case 4: launch<T, 4>(x, W, S, B, y, M, N, K, g, st); return 0;
    case 8: launch<T, 8>(x, W, S, B, y, M, N, K, g, st); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 x, 4-bit words: tensor-core kernels
// ---------------------------------------------------------------------------

// A 4-bit field as an exact float: 2^23 + q has q in its low mantissa bits.
__device__ __forceinline__ float field_f(uint32_t w, int i) {
  return __int_as_float(((w >> (4 * i)) & 15u) | 0x4B000000u) - 8388608.f;
}

constexpr int GV_WARPS = 4;             // warps a gemv16 block, 64 columns each
constexpr int GV_COLS = GV_WARPS * 64;  // columns a gemv16 block

// Four words of one word row: columns col..col+3 (zeros past N), as a
// streaming load (the words are read once; x and the tables stay cached).
__device__ __forceinline__ uint4 ld_words4(const int32_t* __restrict__ W, long row, int N,
                                           int col) {
  const int32_t* p = W + row * N + col;
  if ((N & 3) == 0 && col + 3 < N) return __ldcs((const uint4*)p);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (col < N) v.x = (uint32_t)__ldg(p);
  if (col + 1 < N) v.y = (uint32_t)__ldg(p + 1);
  if (col + 2 < N) v.z = (uint32_t)__ldg(p + 2);
  if (col + 3 < N) v.w = (uint32_t)__ldg(p + 3);
  return v;
}

__device__ __forceinline__ float4 ld_tab4(const float* __restrict__ T, long row, int N, int col) {
  const float* p = T + row * N + col;
  if ((N & 3) == 0 && col + 3 < N) return __ldg((const float4*)p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < N) v.x = __ldg(p);
  if (col + 1 < N) v.y = __ldg(p + 1);
  if (col + 2 < N) v.z = __ldg(p + 2);
  if (col + 3 < N) v.w = __ldg(p + 3);
  return v;
}

// One k32 chunk of a lane: word row (chunk*4 + t) at its 8 columns, and 8 k
// of x rows gq (and gq + 8) from that word row.
template <int MT>
struct Chunk {
  uint4 w[2];
  uint4 x[MT];
};

template <int MT>
__device__ __forceinline__ Chunk<MT> load_chunk(const __nv_bfloat16* __restrict__ x,
                                                const int32_t* __restrict__ W, int M, int N,
                                                int K, int col0, int c, int gq, int t) {
  Chunk<MT> ch;
  const long wrow = (long)c * 4 + t;
  ch.w[0] = ld_words4(W, wrow, N, col0 + 4 * gq);
  ch.w[1] = ld_words4(W, wrow, N, col0 + 32 + 4 * gq);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = mt * 8 + gq;
    ch.x[mt] = m < M ? __ldg((const uint4*)(x + (long)m * K + wrow * 8))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  return ch;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// sum_{q < ns} part[q * stride + i], added in q order, eight loads in flight
// at a time.
__device__ __forceinline__ float sum_splits(const float* part, long stride, long i, int ns) {
  float v = 0.f;
  int q = 0;
  for (; q + 8 <= ns; q += 8) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = __ldcg(part + (q + j) * stride + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) v += t[j];
  }
  for (; q < ns; ++q) v += __ldcg(part + q * stride + i);
  return v;
}

// M <= 8 * MT rows. Grid: (ceil(N / GV_COLS), splits); split s covers groups
// [s*ng/S, (s+1)*ng/S). Lane (gq, t) of a warp loads columns col0 + 32j +
// 4gq + {0..3} (j = 0, 1), which are rows gq and gq+8 of its mma tiles 2j and
// 2j+1, and holds their outputs for rows m = 8mt + 2t + {0, 1}.
template <int MT>
__global__ void __launch_bounds__(GV_WARPS * 32)
gemv16_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ W,
              const float* __restrict__ S, const float* __restrict__ Bt,
              __nv_bfloat16* __restrict__ y, float* __restrict__ part, int* __restrict__ counters,
              int M, int N, int K, int g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * GV_COLS + warp * 64;
  const int ng = K / g, ns = gridDim.y, sp = blockIdx.y;
  const int cpg = g / 32;
  const int cbeg = (int)((long)sp * ng / ns) * cpg, cend = (int)((long)(sp + 1) * ng / ns) * cpg;
  float yacc[4][MT][4], dacc[4][MT][4], xs[MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[i][mt][e] = dacc[i][mt][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) xs[mt] = 0.f;

  Chunk<MT> cur = load_chunk<MT>(x, W, M, N, K, col0, cbeg, gq, t), nxt = cur;
  for (int c = cbeg; c < cend; ++c) {
    if (c + 1 < cend) nxt = load_chunk<MT>(x, W, M, N, K, col0, c + 1, gq, t);
    const uint32_t wd[4][2] = {{cur.w[0].x, cur.w[0].y}, {cur.w[0].z, cur.w[0].w},
                               {cur.w[1].x, cur.w[1].y}, {cur.w[1].z, cur.w[1].w}};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 v = cur.x[mt];
      xs[mt] += ((bf_lo(v.x) + bf_hi(v.x)) + (bf_lo(v.y) + bf_hi(v.y))) +
                ((bf_lo(v.z) + bf_hi(v.z)) + (bf_lo(v.w) + bf_hi(v.w)));
    }
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      // k slots 2t, 2t+1 | 2t+8, 2t+9 of step st are fields (2st, 2st+4) |
      // (2st+1, 2st+5) of the lane's word row, in A and in B alike
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t lo = st ? cur.x[mt].y : cur.x[mt].x;
      const uint32_t hi = st ? cur.x[mt].w : cur.x[mt].z;
        b[mt][0] = __byte_perm(lo, hi, 0x5410);
        b[mt][1] = __byte_perm(lo, hi, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a[4] = {
            centered_pair(wd[i][0], 2 * st), centered_pair(wd[i][1], 2 * st),
            centered_pair(wd[i][0], 2 * st + 1), centered_pair(wd[i][1], 2 * st + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(dacc[i][mt], a, b[mt][0], b[mt][1]);
      }
    }
    if ((c + 1) % cpg == 0) {  // the group ends: y += s*d + (b + 8s) * sum(x_g)
      const long gi = c / cpg;
      float xm[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float v = xs[mt];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        xm[mt][0] = __shfl_sync(0xffffffffu, v, 8 * t);
        xm[mt][1] = __shfl_sync(0xffffffffu, v, 8 * t + 4);
        xs[mt] = 0.f;
      }
      const float4 s0 = ld_tab4(S, gi, N, col0 + 4 * gq),
                   s1 = ld_tab4(S, gi, N, col0 + 32 + 4 * gq);
      const float4 b0 = ld_tab4(Bt, gi, N, col0 + 4 * gq),
                   b1 = ld_tab4(Bt, gi, N, col0 + 32 + 4 * gq);
      const float sc[4][2] = {{s0.x, s0.y}, {s0.z, s0.w}, {s1.x, s1.y}, {s1.z, s1.w}};
      const float bc[4][2] = {{b0.x, b0.y}, {b0.z, b0.w}, {b1.x, b1.y}, {b1.z, b1.w}};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = sc[i][h], cb = bc[i][h] + 8.f * s;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              yacc[i][mt][2 * h + e] += fmaf(s, dacc[i][mt][2 * h + e], cb * xm[mt][e]);
              dacc[i][mt][2 * h + e] = 0.f;
            }
        }
    }
    cur = nxt;
  }

  float* P = ns > 1 ? part + (long)sp * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + 32 * (i >> 1) + 4 * gq + 2 * (i & 1) + h;
      if (n >= N) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mt * 8 + 2 * t + e;
          if (m >= M) continue;
          if (P) P[(long)m * N + n] = yacc[i][mt][2 * h + e];
          else y[(long)m * N + n] = __float2bfloat16(yacc[i][mt][2 * h + e]);
        }
    }
  if (ns == 1) return;
  // the last split of this column range to finish adds the partials in
  // split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.x, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int c0 = blockIdx.x * GV_COLS;
  for (int i = threadIdx.x; i < M * GV_COLS; i += blockDim.x) {
    const int m = i / GV_COLS, n = c0 + i % GV_COLS;
    if (n >= N) continue;
    y[(long)m * N + n] = __float2bfloat16(sum_splits(part, (long)M * N, (long)m * N + n, ns));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

using MmaBig = TileCfg<128, 128, 2, 4, 8>;  // M > 64: 16 x 32 blocks at M = 2048, N = 4096
using MmaMid = TileCfg<64, 128, 2, 2, 8>;   // M <= 64

// Grid: (ceil(N / BN), ceil(M / BM), splits); split z covers the 64-k
// steps [z*KT/S, (z+1)*KT/S). A stage holds 64 k: x [BM, 64] bf16 and 8 word
// rows; the word tile is dequantized into `wt` [BN, 64] bf16 (the B
// operand's rows are columns n), then 4 k16 mma steps run on it. One split
// writes y in bf16; more write f32 partials [S, M, N] that splitk_sum adds.
template <class C>
__global__ void __launch_bounds__(C::NT)
mma_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ W,
           const float* __restrict__ S, const float* __restrict__ Bt,
           __nv_bfloat16* __restrict__ y, float* __restrict__ part, int M, int N, int K, int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wt = smem + C::STAGES * C::STAGE_BYTES;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int KW = K / 8, KT = (K + 63) / 64, ns = gridDim.z;
  const int kt0 = (int)((long)blockIdx.z * KT / ns), kt1 = (int)((long)(blockIdx.z + 1) * KT / ns);
  float acc[C::FM][C::FN][4];
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < C::FN; ++fn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[fm][fn][e] = 0.f;
  auto stage = [&](int kt) { return smem + ((kt - kt0) % C::STAGES) * C::STAGE_BYTES; };
  auto load = [&](int kt) {
    load_stage<C>(stage(kt), (const uint8_t*)x, 2L * K, M, 2L * K, m0, kt * 128L, W, N, KW, n0,
                  kt * 8);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    // this stage's scales and biases, fetched while its copies land
    float sv[C::WPT], bv[C::WPT];
#pragma unroll
    for (int j = 0; j < C::WPT; ++j) {
      const int idx = threadIdx.x + j * C::NT, gw = kt * 8 + idx / C::BN, n = n0 + idx % C::BN;
      const bool ok = gw < KW && n < N;
      const long o = ok ? (long)(gw * 8 / g) * N + n : 0;
      sv[j] = ok ? __ldg(S + o) : 0.f;
      bv[j] = ok ? __ldg(Bt + o) : 0.f;
    }
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is past kt - 1's products
    const int32_t* ws = (const int32_t*)(stage(kt) + C::X_BYTES);
#pragma unroll
    for (int j = 0; j < C::WPT; ++j) {
      const int idx = threadIdx.x + j * C::NT, r = idx / C::BN, n = idx % C::BN;
      const uint32_t w = (uint32_t)ws[r * C::BN + n];
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = bits_of(__floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(field_f(w, 2 * i), sv[j]), bv[j]),
            __fadd_rn(__fmul_rn(field_f(w, 2 * i + 1), sv[j]), bv[j])));
      *(uint4*)(wt + n * C::ROW + r * 16) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    if (kt + C::STAGES - 1 < kt1) load(kt + C::STAGES - 1);
    cp_async_commit();
    __syncthreads();  // the weight tile is complete
    const uint8_t* xs = stage(kt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[C::FM][4], b[C::FN][2];
      load_frags<C>(a, b, xs, wt, wm, wn, kk);
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn) mma_bf16(acc[fm][fn], a[fm], b[fn][0], b[fn][1]);
    }
  }
  const int gq = lane >> 2, t = lane & 3;
  float* P = ns > 1 ? part + (long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * C::TM + fm * 16 + gq + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int fn = 0; fn < C::FN; ++fn) {
        const int n = n0 + wn * C::TN + fn * 8 + 2 * t;
        const float v0 = acc[fm][fn][2 * h], v1 = acc[fm][fn][2 * h + 1];
        const bool pair = (N & 1) == 0 && n + 1 < N;
        if (P) {
          float* p = P + (long)m * N + n;
          if (pair) {
            *(float2*)p = make_float2(v0, v1);
          } else {
            if (n < N) p[0] = v0;
            if (n + 1 < N) p[1] = v1;
          }
        } else {
          __nv_bfloat16* p = y + (long)m * N + n;
          if (pair) {
            *(__nv_bfloat162*)p = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) p[0] = __float2bfloat16(v0);
            if (n + 1 < N) p[1] = __float2bfloat16(v1);
          }
        }
      }
    }
}

// y[i] = sum of the ns split partials part[q * count + i], in split order.
__global__ void __launch_bounds__(256)
splitk_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ y, long count, int ns) {
  for (long i = blockIdx.x * 256L + threadIdx.x; i < count; i += (long)gridDim.x * 256)
    y[i] = __float2bfloat16(sum_splits(part, count, i, ns));
}

template <class C>
int launch_mma(const void* x, const int32_t* W, const float* S, const float* B, void* y,
               float* part, int M, int N, int K, int g, int splits, cudaStream_t st) {
  if (C::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  mma_kernel<C><<<grid, C::NT, C::SMEM, st>>>((const __nv_bfloat16*)x, W, S, B,
                                              (__nv_bfloat16*)y, part, M, N, K, g);
  if (splits > 1) {
    const long count = (long)M * N;
    const int blocks = (int)std::min<long>((count + 255) / 256, 4096);
    splitk_sum<<<blocks, 256, 0, st>>>(part, (__nv_bfloat16*)y, count, splits);
  }
  return 0;
}
}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int mi_dequant_matmul(const void* x, const void* packed, const void* scale,
                                 const void* bias, void* y, int M, int N, int K, int bits,
                                 int group, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* W = (const int32_t*)packed;
  const float* S = (const float*)scale;
  const float* B = (const float*)bias;
  int r = dtype == 0   ? dispatch_bits<float>(x, W, S, B, y, M, N, K, bits, group, st)
          : dtype == 1 ? dispatch_bits<__nv_bfloat16>(x, W, S, B, y, M, N, K, bits, group, st)
                       : (int)cudaErrorInvalidValue;
  if (r != 0) return r;
  return (int)cudaGetLastError();
}

// bf16 x, 4-bit words, M <= 16 rows, group % 32 == 0: gemv16_kernel on a
// (ceil(N / 256), splits) grid. With splits > 1, `part` holds splits * M * N
// f32 and `counters` ceil(N / 256) zeroed ints (the kernel leaves them zero).
extern "C" int mi_dequant_matmul_gemv16(const void* x, const void* packed, const void* scale,
                                        const void* bias, void* y, void* part, void* counters,
                                        int M, int N, int K, int group, int splits,
                                        void* stream) {
  cudaGetLastError();
  if (M < 1 || M > 16 || group % 32 || K % group || splits < 1 || splits > K / group)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + GV_COLS - 1) / GV_COLS, splits);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const int32_t* W = (const int32_t*)packed;
  const float *S = (const float*)scale, *B = (const float*)bias;
  if (M <= 8)
    gemv16_kernel<1><<<grid, GV_WARPS * 32, 0, st>>>(xb, W, S, B, (__nv_bfloat16*)y,
                                                     (float*)part, (int*)counters, M, N, K, group);
  else
    gemv16_kernel<2><<<grid, GV_WARPS * 32, 0, st>>>(xb, W, S, B, (__nv_bfloat16*)y,
                                                     (float*)part, (int*)counters, M, N, K, group);
  return (int)cudaGetLastError();
}

// bf16 x, 4-bit words, any M: mma_kernel with the [128, 128] tile (big = 1)
// or the [64, 128] one (big = 0), K in `splits` splits of whole 64-k steps;
// with splits > 1 `part` holds splits * M * N f32 and splitk_sum adds them.
extern "C" int mi_dequant_matmul_mma(const void* x, const void* packed, const void* scale,
                                     const void* bias, void* y, void* part, int M, int N, int K,
                                     int group, int big, int splits, void* stream) {
  cudaGetLastError();
  if (M < 1 || K % 8 || group % 8 || K % group || splits < 1 || splits > (K + 63) / 64)
    return (int)cudaErrorInvalidValue;
  const int32_t* W = (const int32_t*)packed;
  const float* S = (const float*)scale;
  const float* B = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  const int r = big ? launch_mma<MmaBig>(x, W, S, B, y, (float*)part, M, N, K, group, splits, st)
                    : launch_mma<MmaMid>(x, W, S, B, y, (float*)part, M, N, K, group, splits, st);
  if (r != 0) return r;
  return (int)cudaGetLastError();
}
