// One ring step of the overlapped row-parallel dequant matmul: a column
// window of one rank's chunk,
//
//   y[M, nc] = add[M, nc] + x[M, K] @ W[K, col0 : col0 + nc],
//   W[k, n] = (q[k, n] - zq[k / g, n]) * s[k / g, n],
//
// over the rank's K slice of a words-major packed matrix [K / vpw, N] (q the
// unsigned codes, zq = zero - qmin and s its f32 [K / g, N] tables), in f32
// whatever x's dtype, `add` being the partial received from the ring's right
// neighbour at the step before (null at the first step).
//
// Replaces the TPU kernel mi_optimize_tpu/parallel/overlap.py::_ring_kernel:
// its chunk product (`_dequant_chunk` and the f32 dot of each ring step) and
// the add of the received partial. The ring's transfers themselves are
// torch.distributed isend/irecv outside the kernel (parallel/overlap.py),
// posted as soon as a window's launch is enqueued, so that a window's
// transfer runs while the next window computes.
//
// Three kernels; parallel/overlap.py::ring_route picks one from M, x's dtype,
// the width and the group.
//
// bf16 x with 4-bit words and groups of whole k32 (every served window), on
// the tensor cores. x is exact in bf16 and so is every code, so the product
// of the two is exact in f32. Both kernels take the grouped rescale of
// mi_optimize_tpu/ops/block_fused.py::_qdot on centered codes: per group,
// D = sum_k x[m,k] * (q[k,n] - 8) and xsum = sum_k x[m,k] in f32, then
// y += s*D + (8 - zq)*s * xsum, in f32. Only the order of the f32 sums and
// the rounding points of the rescale differ from the plain version, which
// dequantizes W in f32 first.
//   * M <= 16 (the shortest prompts; decode-like steps): ring_gemv_kernel, a
//     split-K GEMV over the whole card, bound by the window's packed words
//     (1.3 MB for o_proj at D = 2: under a microsecond at 3.35 TB/s, so the
//     launch and a few memory latencies are what it costs). The items are
//     (64 output columns x a K split of whole groups), from the host plan
//     (`gemv_plan`), one block of four warps each; its warps take whole
//     groups of the split and add their sums in warp order. A warp follows
//     gemv16_kernel's lane mapping (dequant_matmul.cu): the words are the
//     mma's A operand (16 columns x k16), the rows of x its n8 columns, so
//     a lane streams 16 bytes of two word columns a k32 chunk and 16 bytes
//     of x a row tile, through a ring of RG_STAGES chunks a lane in shared
//     memory (cp.async, RG_STAGES - 1 in flight), and a group's tables are
//     loaded at its first chunk. Every split writes its f32 partials; the
//     last block of a column tile (an integer counter) adds them in split
//     order and adds the received partial in that epilogue.
//   * M > 16 (path t's prompts of 16-256 tokens, M = 2048): ring_mma_kernel,
//     bound by 2*M*K*nc operations at M = 2048. B7's P2 tile
//     (mlp_fused.cu): a [64, 128] tile on 2 x 4 warps of [32, 32] (two
//     blocks an SM), or above 128 rows [128, 128] on 4 x 4 warps (one block
//     an SM), over a 4-stage cp.async ring of 64 k: x the A operand
//     (ldmatrix), the stage's words turned into centered bf16 codes once a
//     block as B (two code tiles, so one barrier a stage), the scale and zq
//     rows of the groups that end in the stage riding in it. Each warp also
//     multiplies its A fragments by a column of ones, so its accumulators
//     hold xsum for exactly the rows they scale. K is split at whole groups
//     only as far as the tiles need to fill the card (`mma_plan`); the last
//     block of a tile adds the splits' f32 partials in split order, and the
//     received partial.
// No float atomics: the same bits on every run.
//
// f32 x, and 2- or 8-bit words: ring_chunk_kernel, the first port's tiles
// on the CUDA cores (f32 inputs stay off the tensor cores: the reference
// sums in f32). A block dequantizes a [32, 64] weight tile into shared
// memory once (in f32, (q - zq) * s as the reference writes it) and reuses
// it for a 64-row x tile; each thread keeps a 4 x 4 output block in f32
// registers; the epilogue adds the received partial. No served path feeds
// it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_common.cuh"

namespace {

using namespace mi;

constexpr int NT = 256, TM = 64, TN = 64, TK = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T, int BITS>
__global__ void __launch_bounds__(NT)
ring_chunk_kernel(const T* __restrict__ x, const int32_t* __restrict__ W,
                  const float* __restrict__ S, const float* __restrict__ Z,
                  const float* __restrict__ add, float* __restrict__ y, int M, int N, int K, int g,
                  int col0, int nc) {
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
      const int gw = k0 / VPW + wr, n = n0 + c;
      if (gw < KW && n < nc) {
        const long col = (long)col0 + n;
        const uint32_t wd = (uint32_t)__ldg(W + (long)gw * N + col);
        const int gi = gw * VPW / g;
        const float s = __ldg(S + (long)gi * N + col), z = __ldg(Z + (long)gi * N + col);
#pragma unroll
        for (int v = 0; v < VPW; ++v)
          Ws[wr * VPW + v][c] = ((float)((wd >> (BITS * v)) & MASK) - z) * s;
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
      const int n = n0 + tx * 4 + j;
      if (n >= nc) continue;
      const long at = (long)gm * nc + n;
      y[at] = add ? add[at] + acc[i][j] : acc[i][j];
    }
  }
}

template <class T>
cudaError_t dispatch(const void* x, const int32_t* W, const float* S, const float* Z,
                     const float* add, float* y, int M, int N, int K, int bits, int g, int col0,
                     int nc, cudaStream_t st) {
  const dim3 grid((nc + TN - 1) / TN, (M + TM - 1) / TM);
  const T* xt = (const T*)x;
  switch (bits) {
    case 2:
      ring_chunk_kernel<T, 2><<<grid, NT, 0, st>>>(xt, W, S, Z, add, y, M, N, K, g, col0, nc);
      return cudaSuccess;
    case 4:
      ring_chunk_kernel<T, 4><<<grid, NT, 0, st>>>(xt, W, S, Z, add, y, M, N, K, g, col0, nc);
      return cudaSuccess;
    case 8:
      ring_chunk_kernel<T, 8><<<grid, NT, 0, st>>>(xt, W, S, Z, add, y, M, N, K, g, col0, nc);
      return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 x, 4-bit words: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr uint32_t BF16_ONES = 0x3F803F80u;  // bf16x2 (1, 1)

// 16 bytes of shared memory from 4 entries of row `row` of a [rows, N]
// matrix at window columns c..c+3 (base + row * N + col0 + c), asynchronously;
// entries at or past nc are zero-filled and not read. `wide`: every such
// piece starts on 16 bytes.
__device__ __forceinline__ void copy4(void* dst, const void* base, long row, int N, int col0,
                                      int c, int nc, bool wide) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(base) + 4 * (row * N + col0 + c);
  if (wide) {
    cp_async16(dst, c < nc ? p : base, c < nc);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cp_async4(reinterpret_cast<uint8_t*>(dst) + 4 * i, c + i < nc ? p + 4 * i : base, c + i < nc);
}

// Four entries of row `row` of a [rows, N] table at window columns c..c+3
// (zeros at or past nc).
__device__ __forceinline__ float4 tab4(const float* __restrict__ T, long row, int N, int col0,
                                       int c, int nc, bool wide) {
  const float* p = T + row * N + col0 + c;
  if (wide && c + 3 < nc) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(c < nc ? __ldg(p) : 0.f, c + 1 < nc ? __ldg(p + 1) : 0.f,
                     c + 2 < nc ? __ldg(p + 2) : 0.f, c + 3 < nc ? __ldg(p + 3) : 0.f);
}

constexpr int RG_WARPS = 4;             // warps a ring_gemv block: one column tile, one split
constexpr int RG_COLS = 64;             // output columns of a tile (a warp's, gemv16's mapping)
constexpr int RG_STAGES = 4;            // a lane's ring of k32 chunks: 3 in flight
constexpr int RG_MAXM = 16;

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// M <= 8 * MT rows. Grid: (ceil(nc / 64), splits); split sp covers groups
// [sp*ng/S, (sp+1)*ng/S), its warp w the groups [w*n/4, (w+1)*n/4) of them.
// Lane (gq, t) copies word row 4c + t of chunk c at window columns
// c0 + 32j + 4gq + {0..3} (j = 0, 1), the rows gq and gq+8 of its mma tiles
// 2j and 2j+1, and row m = 8mt + gq's 8 values of x under that word row; it
// holds the outputs of rows 8mt + 2t + {0, 1}. `part` holds S * M * nc f32
// and `counters` one zero int a column tile (left zero) when S > 1.
template <int MT>
__global__ void __launch_bounds__(RG_WARPS * 32)
ring_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ W,
                 const float* __restrict__ S, const float* __restrict__ Z,
                 const float* __restrict__ add, float* __restrict__ y, float* __restrict__ part,
                 int* __restrict__ counters, int M, int N, int K, int g, int col0, int nc) {
  constexpr int SLOTS = 2 + MT;  // 16-byte pieces a lane a chunk: two of words, MT of x
  __shared__ __align__(16) uint4 ring[RG_WARPS][RG_STAGES][SLOTS][32];
  __shared__ int last;
  float* red = reinterpret_cast<float*>(ring);  // [RG_WARPS][8 * MT][RG_COLS], after the ring
  static_assert(RG_STAGES * SLOTS * 32 * 4 >= 8 * MT * RG_COLS, "the sums fit the ring");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * RG_COLS;
  const int ng = K / g, ns = gridDim.y, sp = blockIdx.y, cpg = g / 32;
  const int ga = (int)((long)sp * ng / ns), gb = (int)((long)(sp + 1) * ng / ns);
  const int wa = ga + warp * (gb - ga) / RG_WARPS, wb = ga + (warp + 1) * (gb - ga) / RG_WARPS;
  const int nch = (wb - wa) * cpg;  // the warp's chunks, from chunk wa * cpg on
  const bool wide = ((N | col0) & 3) == 0;
  uint4(*lr)[SLOTS][32] = ring[warp];
  auto fetch = [&](int i) {
    if (i < nch) {
      const long wrow = (long)(wa * cpg + i) * 4 + t;
      uint4* s = &lr[i % RG_STAGES][0][lane];
      copy4(s, W, wrow, N, col0, c0 + 4 * gq, nc, wide);
      copy4(s + 32, W, wrow, N, col0, c0 + 32 + 4 * gq, nc, wide);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + gq;
        cp_async16(s + 32 * (2 + mt), m < M ? x + (long)m * K + wrow * 8 : x, m < M);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < RG_STAGES - 1; ++i) fetch(i);

  float yacc[4][MT][4], dacc[4][MT][4], xs[MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[i][mt][e] = dacc[i][mt][e] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) xs[mt] = 0.f;
  float4 sv[2], zv[2];  // the group's tables at the lane's 8 columns

  for (int i = 0; i < nch; ++i) {
    cp_async_wait<RG_STAGES - 2>();  // this lane's pieces of chunk i have landed
    const uint4* s = &lr[i % RG_STAGES][0][lane];
    const uint4 w0 = s[0], w1 = s[32];
    uint4 xv[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) xv[mt] = s[32 * (2 + mt)];
    fetch(i + RG_STAGES - 1);  // into the stage of chunk i - 1, which this lane has read
    const int q = i % cpg, gi = wa + i / cpg;
    if (q == 0) {
      sv[0] = tab4(S, gi, N, col0, c0 + 4 * gq, nc, wide);
      sv[1] = tab4(S, gi, N, col0, c0 + 32 + 4 * gq, nc, wide);
      zv[0] = tab4(Z, gi, N, col0, c0 + 4 * gq, nc, wide);
      zv[1] = tab4(Z, gi, N, col0, c0 + 32 + 4 * gq, nc, wide);
    }
    const uint32_t wd[4][2] = {{w0.x, w0.y}, {w0.z, w0.w}, {w1.x, w1.y}, {w1.z, w1.w}};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 v = xv[mt];
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
        const uint32_t lo = st ? xv[mt].y : xv[mt].x, hi = st ? xv[mt].w : xv[mt].z;
        b[mt][0] = __byte_perm(lo, hi, 0x5410);
        b[mt][1] = __byte_perm(lo, hi, 0x7632);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {
            centered_pair(wd[j][0], 2 * st), centered_pair(wd[j][1], 2 * st),
            centered_pair(wd[j][0], 2 * st + 1), centered_pair(wd[j][1], 2 * st + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(dacc[j][mt], a, b[mt][0], b[mt][1]);
      }
    }
    if (q == cpg - 1) {  // the group ends: y += s*D + (8 - zq)*s * xsum
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
      const float sc[4][2] = {{sv[0].x, sv[0].y}, {sv[0].z, sv[0].w},
                              {sv[1].x, sv[1].y}, {sv[1].z, sv[1].w}};
      const float zc[4][2] = {{zv[0].x, zv[0].y}, {zv[0].z, zv[0].w},
                              {zv[1].x, zv[1].y}, {zv[1].z, zv[1].w}};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s_ = sc[j][h], cb = (8.f - zc[j][h]) * s_;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              yacc[j][mt][2 * h + e] += fmaf(s_, dacc[j][mt][2 * h + e], cb * xm[mt][e]);
              dacc[j][mt][2 * h + e] = 0.f;
            }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: its memory takes the warps' sums
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 32 * (j >> 1) + 4 * gq + 2 * (j & 1) + h;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(warp * 8 * MT + mt * 8 + 2 * t + e) * RG_COLS + n] = yacc[j][mt][2 * h + e];
    }
  __syncthreads();
  // the warps' sums in warp order: thread i takes 4 neighbouring columns of a row
  const int rows = min(M, 8 * MT);
  float* P = ns > 1 ? part + (long)sp * M * nc : nullptr;
  for (int i = threadIdx.x; i < rows * (RG_COLS / 4); i += RG_WARPS * 32) {
    const int m = i / (RG_COLS / 4), n = 4 * (i % (RG_COLS / 4));
    if (c0 + n >= nc) continue;
    float4 v = *reinterpret_cast<const float4*>(red + m * RG_COLS + n);
#pragma unroll
    for (int w = 1; w < RG_WARPS; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(red + (w * 8 * MT + m) * RG_COLS + n);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const long at = (long)m * nc + c0 + n;
    if (P) {
      __stcg(reinterpret_cast<float4*>(P + at), v);
    } else {
      if (add) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(add + at));
        v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
      }
      *reinterpret_cast<float4*>(y + at) = v;
    }
  }
  if (ns == 1) return;
  // the last split of this column tile to finish adds the partials in split
  // order, then the received partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.x, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long count = (long)M * nc;
  for (int i = threadIdx.x; i < rows * (RG_COLS / 4); i += RG_WARPS * 32) {
    const int m = i / (RG_COLS / 4), n = 4 * (i % (RG_COLS / 4));
    if (c0 + n >= nc) continue;
    const long at = (long)m * nc + c0 + n;
    float4 v = __ldcg(reinterpret_cast<const float4*>(part + at));
    for (int q = 1; q < ns; ++q) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(part + q * count + at));
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (add) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(add + at));
      v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
    }
    *reinterpret_cast<float4*>(y + at) = v;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// A tile of ring_mma_kernel: [BM, 128] outputs on WM x WN warps of [32, 32]
// (B7's P2 tile, mlp_fused.cu, with one plane of x). A stage of the ring
// holds 64 k: BM rows of x (padded to 144 bytes, as mma_common.cuh's
// TileCfg), 8 word rows of the 128 columns, and the scale and zq rows
// [2][2][128] f32 of the groups that end at each of its two k32 halves.
template <int BM_, int WM_, int WN_, int MINB_>
struct RingTile {
  static constexpr int BM = BM_, BN = 128, WM = WM_, WN = WN_;
  static constexpr int STAGES = 4, MINB = MINB_;  // ring depth, blocks an SM
  static constexpr int NT = WM * WN * 32;
  static constexpr int ROW = 144;
  static constexpr int X_BYTES = BM * ROW;
  static constexpr int W_BYTES = 8 * BN * 4;
  static constexpr int T_BYTES = 2 * 2 * BN * 4;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + T_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * BN * ROW;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int FM = TM / 16, FN = TN / 8;   // mma tiles a warp
  static constexpr int WPT = 8 * BN / NT;           // words a thread turns into codes a stage
  static_assert(TN % 16 == 0 && FN % 2 == 0 && (8 * BN) % NT == 0, "tile shape");
  static_assert(MINB * SMEM <= 232448, "shared memory of an SM");
};

using RingMid = RingTile<64, 2, 4, 2>;   // M <= 128
using RingBig = RingTile<128, 4, 4, 1>;  // above

// Grid: (ceil(nc / 128), ceil(M / BM), splits); split z covers the groups
// [z*ng/S, (z+1)*ng/S) of K. One split writes y = add + the tile; more
// write f32 partials [S][M][nc] to `part` and the tile's last block (one
// zero int of `counters` a tile, left zero) adds them in split order, then
// `add`.
template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
ring_mma_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ W,
                const float* __restrict__ S, const float* __restrict__ Z,
                const float* __restrict__ add, float* __restrict__ y, float* __restrict__ part,
                int* __restrict__ counters, int M, int N, int K, int g, int col0, int nc) {
  extern __shared__ __align__(16) uint8_t tsmem[];
  __shared__ int last;
  uint8_t* wts = tsmem + C::STAGES * C::STAGE_BYTES;  // two code tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.y * C::BM, c0 = blockIdx.x * C::BN;
  const int ng = K / g, ns = gridDim.z, z = blockIdx.z;
  const int ka = (int)((long)z * ng / ns) * g, kend = (int)((long)(z + 1) * ng / ns) * g;
  const int nst = (kend - ka + 63) / 64;
  const bool wide = ((N | col0) & 3) == 0;

  auto stage = [&](int s) { return tsmem + (s % C::STAGES) * C::STAGE_BYTES; };
  auto load = [&](int s) {
    if (s >= nst) return;
    uint8_t* st = stage(s);
    const int k0 = ka + 64 * s;
    for (int c = threadIdx.x; c < C::BM * 8; c += C::NT) {
      const int r = c >> 3, cc = c & 7;
      const int k = k0 + cc * 8;
      const bool ok = m0 + r < M && k < kend;
      cp_async16(st + r * C::ROW + cc * 16, ok ? x + (long)(m0 + r) * K + k : x, ok);
    }
    int32_t* ws = reinterpret_cast<int32_t*>(st + C::X_BYTES);
    const int w0 = k0 / 8, wend = kend / 8;
    for (int c = threadIdx.x; c < 8 * (C::BN / 4); c += C::NT) {
      const int r = c / (C::BN / 4), v = (c % (C::BN / 4)) * 4;
      if (w0 + r < wend) copy4(ws + r * C::BN + v, W, w0 + r, N, col0, c0 + v, nc, wide);
      else cp_async16(ws + r * C::BN + v, W, false);
    }
    float* ts = reinterpret_cast<float*>(st + C::X_BYTES + C::W_BYTES);
    for (int c = threadIdx.x; c < 2 * 2 * (C::BN / 4); c += C::NT) {
      const int hf = c / (C::BN / 2), tb = (c / (C::BN / 4)) & 1, v = (c % (C::BN / 4)) * 4;
      const int k_end = k0 + 32 * (hf + 1);
      if (k_end % g || k_end > kend) continue;  // no group ends at this k32 half
      copy4(ts + (2 * hf + tb) * C::BN + v, tb ? Z : S, k_end / g - 1, N, col0, c0 + v, nc,
            wide);
    }
  };
  // the centered codes of stage s's words, fields 0..7 of a word in k order
  auto codes = [&](int s, uint8_t* wt) {
    const int32_t* ws = reinterpret_cast<const int32_t*>(stage(s) + C::X_BYTES);
#pragma unroll
    for (int j = 0; j < C::WPT; ++j) {
      const int idx = threadIdx.x + j * C::NT, r = idx / C::BN, n = idx % C::BN;
      const uint32_t w = (uint32_t)ws[r * C::BN + n];
      const uint32_t p0 = centered_pair(w, 0), p1 = centered_pair(w, 1);
      const uint32_t p2 = centered_pair(w, 2), p3 = centered_pair(w, 3);
      *reinterpret_cast<uint4*>(wt + n * C::ROW + r * 16) =
          make_uint4(__byte_perm(p0, p1, 0x5410), __byte_perm(p2, p3, 0x5410),
                     __byte_perm(p0, p1, 0x7632), __byte_perm(p2, p3, 0x7632));
    }
  };

  float dacc[C::FM][C::FN][4], yacc[C::FM][C::FN][4], xacc[C::FM][4];
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm) {
#pragma unroll
    for (int e = 0; e < 4; ++e) xacc[fm][e] = 0.f;
#pragma unroll
    for (int fn = 0; fn < C::FN; ++fn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[fm][fn][e] = yacc[fm][fn][e] = 0.f;
  }
  // a group ends at k32 half hf of the stage whose tables are `ts`:
  // y += s*D + (8 - zq)*s * xsum for the warp's outputs
  auto rescale = [&](const float* ts, int hf) {
#pragma unroll
    for (int fn = 0; fn < C::FN; ++fn) {
      const int v = wn * C::TN + fn * 8 + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(ts + 2 * hf * C::BN + v);
      const float2 zq = *reinterpret_cast<const float2*>(ts + (2 * hf + 1) * C::BN + v);
      const float sc[2] = {s.x, s.y}, cb[2] = {(8.f - zq.x) * s.x, (8.f - zq.y) * s.y};
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            yacc[fm][fn][2 * h + e] +=
                fmaf(sc[e], dacc[fm][fn][2 * h + e], cb[e] * xacc[fm][2 * h]);
            dacc[fm][fn][2 * h + e] = 0.f;
          }
    }
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[fm][e] = 0.f;
  };

  // one barrier a stage: stage s + 1's codes are made while stage s is
  // multiplied, and stage s + 3's copies fly meanwhile
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  cp_async_wait<C::STAGES - 3>();  // stages 0 and 1 have landed
  __syncthreads();
  if (nst > 0) codes(0, wts);
  __syncthreads();
  int next_end = ka + g;  // where the current group ends
  for (int s = 0; s < nst; ++s) {
    load(s + C::STAGES - 1);  // into the slot of stage s - 1, which every warp is done with
    cp_async_commit();
    if (s + 1 < nst) codes(s + 1, wts + ((s + 1) & 1) * C::BN * C::ROW);
    const uint8_t* xs = stage(s);
    const uint8_t* wt = wts + (s & 1) * C::BN * C::ROW;
    const float* ts = reinterpret_cast<const float*>(xs + C::X_BYTES + C::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bf[C::FN][2];
#pragma unroll
      for (int f2 = 0; f2 < C::FN / 2; ++f2) {
        uint32_t r[4];
        ldmatrix_x4(r, wt + (wn * C::TN + f2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::ROW +
                           kk * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * f2][0] = r[0];
        bf[2 * f2][1] = r[1];
        bf[2 * f2 + 1][0] = r[2];
        bf[2 * f2 + 1][1] = r[3];
      }
      uint32_t af[C::FM][4];
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm)
        ldmatrix_x4(af[fm], xs + (wm * C::TM + fm * 16 + (lane & 15)) * C::ROW + kk * 32 +
                                (lane >> 4) * 16);
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm) {
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn) mma_bf16(dacc[fm][fn], af[fm], bf[fn][0], bf[fn][1]);
        mma_bf16(xacc[fm], af[fm], BF16_ONES, BF16_ONES);  // the rows' sums
      }
      const int k_end = ka + 64 * s + 16 * (kk + 1);
      if ((kk & 1) && k_end == next_end) {
        rescale(ts, kk >> 1);
        next_end += g;
      }
    }
    cp_async_wait<C::STAGES - 3>();  // stage s + 2 has landed
    __syncthreads();
  }

  float* P = ns > 1 ? part + (long)z * M * nc : nullptr;
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * C::TM + fm * 16 + gq + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int fn = 0; fn < C::FN; ++fn) {
        const int n = c0 + wn * C::TN + fn * 8 + 2 * t;  // nc is a multiple of 8
        if (n >= nc) continue;
        const long at = (long)m * nc + n;
        float2 v = make_float2(yacc[fm][fn][2 * h], yacc[fm][fn][2 * h + 1]);
        if (P) {
          __stcg(reinterpret_cast<float2*>(P + at), v);
        } else {
          if (add) {
            const float2 a = __ldg(reinterpret_cast<const float2*>(add + at));
            v = make_float2(a.x + v.x, a.y + v.y);
          }
          *reinterpret_cast<float2*>(y + at) = v;
        }
      }
    }
  if (ns == 1) return;
  // the tile's last split to finish adds the partials in split order, then `add`
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counters + tile, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long count = (long)M * nc;
  for (int i = threadIdx.x; i < C::BM * (C::BN / 4); i += C::NT) {
    const int m = m0 + i / (C::BN / 4), n = c0 + 4 * (i % (C::BN / 4));
    if (m >= M || n >= nc) continue;
    const long at = (long)m * nc + n;
    float4 v = __ldcg(reinterpret_cast<const float4*>(part + at));
#pragma unroll 4
    for (int q = 1; q < ns; ++q) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(part + q * count + at));
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (add) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(add + at));
      v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
    }
    *reinterpret_cast<float4*>(y + at) = v;
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <class C>
cudaError_t launch_mma(const __nv_bfloat16* x, const int32_t* W, const float* S, const float* Z,
                       const float* add, float* y, float* part, int* counters, int M, int N,
                       int K, int g, int col0, int nc, int splits, cudaStream_t st) {
  auto kern = ring_mma_kernel<C>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nc + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  kern<<<grid, C::NT, C::SMEM, st>>>(x, W, S, Z, add, y, part, counters, M, N, K, g, col0, nc);
  return cudaSuccess;
}

// The window's shape against the tensor-core kernels' contract.
bool tc_shape_ok(int M, int N, int K, int group, int col0, int nc, int splits, const void* x,
                 const void* add, const void* y) {
  return M >= 1 && group % 32 == 0 && K % group == 0 && col0 >= 0 && nc >= 1 && nc % 8 == 0 &&
         col0 + nc <= N && splits >= 1 && splits <= K / group && (uintptr_t)x % 16 == 0 &&
         (uintptr_t)add % 16 == 0 && (uintptr_t)y % 16 == 0;
}

}  // namespace

// x [M, K] (dtype 0 float32, 1 bfloat16); packed [K * bits / 32, N] int32
// words; scale and zq [K / g, N] f32; add and y [M, nc] f32 (add may be
// null). The CUDA-core tiles (ring_chunk_kernel). Returns cudaGetLastError()
// after the launch.
extern "C" int mi_ring_chunk(const void* x, const void* packed, const void* scale, const void* zq,
                             const void* add, void* y, int M, int N, int K, int bits, int group,
                             int col0, int nc, int dtype, void* stream) {
  cudaGetLastError();
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  if (M < 1 || K < 1 || group < 1 || K % group || group % (32 / bits) || col0 < 0 || nc < 1 ||
      col0 + nc > N)
    return (int)cudaErrorInvalidValue;
  const int32_t* W = (const int32_t*)packed;
  const float *S = (const float*)scale, *Z = (const float*)zq, *A = (const float*)add;
  float* Y = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      dtype == 0   ? dispatch<float>(x, W, S, Z, A, Y, M, N, K, bits, group, col0, nc, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(x, W, S, Z, A, Y, M, N, K, bits, group, col0, nc, st)
                   : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// bf16 x, 4-bit words, M <= 16, groups of whole k32, nc a multiple of 8:
// ring_gemv_kernel on a (ceil(nc / 64), splits) grid. With splits > 1,
// `part` holds splits * M * nc f32 and `counters` ceil(nc / 64) zero ints
// (left zero).
extern "C" int mi_ring_chunk_gemv(const void* x, const void* packed, const void* scale,
                                  const void* zq, const void* add, void* y, void* part,
                                  void* counters, int M, int N, int K, int group, int col0,
                                  int nc, int splits, void* stream) {
  cudaGetLastError();
  if (M > RG_MAXM || !tc_shape_ok(M, N, K, group, col0, nc, splits, x, add, y) ||
      (splits > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nc + RG_COLS - 1) / RG_COLS, splits);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const int32_t* W = (const int32_t*)packed;
  const float *S = (const float*)scale, *Z = (const float*)zq, *A = (const float*)add;
  if (M <= 8)
    ring_gemv_kernel<1><<<grid, RG_WARPS * 32, 0, st>>>(xb, W, S, Z, A, (float*)y, (float*)part,
                                                         (int*)counters, M, N, K, group, col0,
                                                         nc);
  else
    ring_gemv_kernel<2><<<grid, RG_WARPS * 32, 0, st>>>(xb, W, S, Z, A, (float*)y, (float*)part,
                                                         (int*)counters, M, N, K, group, col0,
                                                         nc);
  return (int)cudaGetLastError();
}

// bf16 x, 4-bit words, any M, groups of whole k32, nc a multiple of 8:
// ring_mma_kernel with the [128, 128] tile (big = 1) or the [64, 128] one
// (big = 0), K in `splits` splits of whole groups; with splits > 1 `part`
// holds splits * M * nc f32 and `counters` one zero int a tile (left zero).
extern "C" int mi_ring_chunk_mma(const void* x, const void* packed, const void* scale,
                                 const void* zq, const void* add, void* y, void* part,
                                 void* counters, int M, int N, int K, int group, int col0,
                                 int nc, int big, int splits, void* stream) {
  cudaGetLastError();
  if (!tc_shape_ok(M, N, K, group, col0, nc, splits, x, add, y) ||
      (splits > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const int32_t* W = (const int32_t*)packed;
  const float *S = (const float*)scale, *Z = (const float*)zq, *A = (const float*)add;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      big ? launch_mma<RingBig>(xb, W, S, Z, A, (float*)y, (float*)part, (int*)counters, M, N, K,
                                group, col0, nc, splits, st)
          : launch_mma<RingMid>(xb, W, S, Z, A, (float*)y, (float*)part, (int*)counters, M, N, K,
                                group, col0, nc, splits, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
