// Fused quantized SwiGLU MLP: y = down . (silu(x . gate) * (x . up)) over
// packed int2/4/8 gate, up and down weights, in one launch; the [M, I]
// activation is never written to device memory.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/mlp_fused.py::_kernel
// (fused_mlp).
//
// Layout (core/packing.py): gate/up words [K*b/32, I], down words
// [I*b/32, N], int32 words-major, fields stored unsigned. Scales and zeros
// are f32 [groups, out]; the zeros arrive with qmin already subtracted, so a
// weight is (q - z) * s, as the reference dequantizes it. The math is f32:
// gate and up in f32, act = gate * (1 / (1 + exp(-gate))) * up, the down
// product accumulated in f32, the output rounded to x's dtype (f32 or bf16)
// at the end.
//
// The reference's grid walks the intermediate tiles in order and carries the
// [M, N] sum from one step to the next. Blocks here run in no order, so each
// work item writes a partial sum of its own and a fixed-order reduction
// follows: a cooperative launch, items (row tile, split of the intermediate
// tiles) spread over a co-resident grid, one grid barrier, then the grid
// sums the partials of [M, N] in a fixed order. No atomics: the result is
// the same bits on every run.
//
// Two kernels, chosen by M:
//   * M <= 8 (decode): bound by the bytes of the packed weights, scales and
//     zeros (76 MB a layer for Llama-2-7B). x is staged in shared memory once
//     per block. An item is one intermediate tile of TI columns: the block's
//     warps split K for the tile's TI gate and TI up columns (a lane reads
//     neighbouring words of a words-major row, so loads coalesce), the warps'
//     sums meet in shared memory, the activation tile stays there, and every
//     thread then reads the tile's down word rows for its output columns.
//     One partial [M, N] per tile.
//   * M > 8 (prefill, perplexity): bound by 2*M*I*(2K + N) operations on
//     CUDA cores. An item is a TM-row tile and a run of intermediate tiles;
//     for each tile the block computes gate and up for [TM, TI] from
//     dequantized [TK, TI] weight chunks in shared memory (4 x 4 outputs a
//     thread), keeps the activation tile in shared memory, multiplies it
//     with dequantized [TI, TN] down chunks and adds the result to the
//     item's own partial rows. The splits are few (a bounded scratch), so
//     the partials cost little next to the product. Tensor cores are later
//     work.
#include "decode_common.cuh"

struct MlpArgs {
  const void* x;  // [M, K]
  const int32_t* gw; const float* gs; const float* gz;  // gate [K*b/32, I], [K/gk, I]
  const int32_t* uw; const float* us; const float* uz;  // up, the same
  const int32_t* dw; const float* ds; const float* dz;  // down [I*b/32, N], [I/ik, N]
  float* part;    // [S, M, N] partial sums
  void* y;        // [M, N]
  int M, K, I, N, gk, ik, S;
};

namespace {

using namespace mi;

constexpr int TI = 64;      // intermediate columns a tile
constexpr int GEMV_MAXM = 8;
constexpr int TM = 64, TK = 32, TN = 64;  // the tiled kernel's tiles

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// After the grid barrier: y[m, n] = the sum over s of part[s, m, n]. P
// consecutive lanes share an output: lane p sums s = p, p + P, ... in order
// and the P sums meet in a fixed butterfly, so the bits never vary (P = 8
// for the GEMV kernel's many tile partials, 1 for the tiled kernel's few).
template <class T, int P>
__device__ __forceinline__ void reduce_partials(const MlpArgs& a) {
  const long total = (long)a.M * a.N;
  const long stride = (long)gridDim.x * NT;
  const int lane = threadIdx.x & 31, p = lane % P;
  T* y = (T*)a.y;
  for (long g0 = (long)blockIdx.x * NT + (threadIdx.x & ~31); g0 / P < total; g0 += stride) {
    const long i = (g0 + lane) / P;
    const bool on = i < total;
    float t = 0.f;
    if (on) {
#pragma unroll 8
      for (int s = p; s < a.S; s += P) t += __ldcg(a.part + s * total + i);
    }
#pragma unroll
    for (int o = 1; o < P; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (on && p == 0) y[i] = from_f<T>(t);
  }
}

template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) mlp_gemv_kernel(MlpArgs a) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ float sm[];  // xs[M][K] | red[NW][M][2*TI] | act[M][TI]
  const int M = a.M, K = a.K, I = a.I, N = a.N;
  float* xs = sm;
  float* red = xs + (long)M * K;
  float* act = red + NW * M * 2 * TI;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* x = (const T*)a.x;
  for (long i = threadIdx.x; i < (long)M * K; i += NT) xs[i] = to_f(x[i]);
  __syncthreads();

  const int KW = K / VPW, wpg = a.gk / VPW;
  const int w0 = KW * warp / NW, w1 = KW * (warp + 1) / NW;
  const int n_tiles = I / TI;
  for (int j = blockIdx.x; j < n_tiles; j += gridDim.x) {
    // gate columns j*TI + lane + 32q (q < 2) and up columns (q >= 2)
    float acc[4][GEMV_MAXM];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < GEMV_MAXM; ++m) acc[q][m] = 0.f;
    int w = w0;
    while (w < w1) {
      const int gi = w / wpg;
      const int we = min(w1, (gi + 1) * wpg);
      float s[4], z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long c = (long)gi * I + (long)j * TI + lane + 32 * (q & 1);
        s[q] = __ldg((q < 2 ? a.gs : a.us) + c);
        z[q] = __ldg((q < 2 ? a.gz : a.uz) + c);
      }
#pragma unroll 4
      for (; w < we; ++w) {
        uint32_t wd[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wd[q] = (uint32_t)__ldg((q < 2 ? a.gw : a.uw) + (long)w * I + (long)j * TI + lane +
                                  32 * (q & 1));
        const float* xk = xs + w * VPW;
#pragma unroll
        for (int i = 0; i < VPW; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float wv = ((float)((wd[q] >> (BITS * i)) & MASK) - z[q]) * s[q];
#pragma unroll
            for (int m = 0; m < GEMV_MAXM; ++m)
              if (m < M) acc[q][m] = fmaf(xk[(long)m * K + i], wv, acc[q][m]);
          }
        }
      }
    }
    __syncthreads();  // the previous tile's act is no longer read
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int m = 0; m < GEMV_MAXM; ++m)
        if (m < M) red[(warp * M + m) * 2 * TI + (q >> 1) * TI + lane + 32 * (q & 1)] = acc[q][m];
    __syncthreads();
    for (int i = threadIdx.x; i < M * TI; i += NT) {
      const int m = i / TI, c = i % TI;
      float g = 0.f, u = 0.f;
      for (int ww = 0; ww < NW; ++ww) {
        g += red[(ww * M + m) * 2 * TI + c];
        u += red[(ww * M + m) * 2 * TI + TI + c];
      }
      act[m * TI + c] = silu_mul(g, u);
    }
    __syncthreads();
    // the tile's down rows i in [j*TI, (j+1)*TI) for every output column
    for (int n = threadIdx.x; n < N; n += NT) {
      float o[GEMV_MAXM];
#pragma unroll
      for (int m = 0; m < GEMV_MAXM; ++m) o[m] = 0.f;
      int gcur = -1;
      float s = 0.f, z = 0.f;
#pragma unroll 4
      for (int wr = 0; wr < TI / VPW; ++wr) {
        const int i0 = j * TI + wr * VPW;
        const int gi = i0 / a.ik;
        if (gi != gcur) {  // the tile's rows share one group unless ik < TI
          s = __ldg(a.ds + (long)gi * N + n);
          z = __ldg(a.dz + (long)gi * N + n);
          gcur = gi;
        }
        const uint32_t wd = (uint32_t)__ldg(a.dw + (long)(i0 / VPW) * N + n);
#pragma unroll
        for (int e = 0; e < VPW; ++e) {
          const float wv = ((float)((wd >> (BITS * e)) & MASK) - z) * s;
#pragma unroll
          for (int m = 0; m < GEMV_MAXM; ++m)
            if (m < M) o[m] = fmaf(act[m * TI + wr * VPW + e], wv, o[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < GEMV_MAXM; ++m)
        if (m < M) a.part[((long)j * M + m) * N + n] = o[m];
    }
  }
  cg::this_grid().sync();
  reduce_partials<T, 8>(a);
}

template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) mlp_tiled_kernel(MlpArgs a) {
  constexpr int VPW = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ float sm[];
  float (*Xs)[TM + 4] = reinterpret_cast<float (*)[TM + 4]>(sm);              // [TK][TM+4]
  float (*Wg)[TI + 4] = reinterpret_cast<float (*)[TI + 4]>(sm + TK * (TM + 4));  // [TK][TI+4]
  float (*Wu)[TI + 4] = Wg + TK;                                                  // [TK][TI+4]
  float (*Act)[TI + 4] = Wu + TK;                                                 // [TM][TI+4]
  float (*Wd)[TN + 4] = reinterpret_cast<float (*)[TN + 4]>(Act + TM);           // [TI][TN+4]
  const int M = a.M, K = a.K, I = a.I, N = a.N;
  const T* x = (const T*)a.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_tiles = I / TI, R = (M + TM - 1) / TM;
  for (int item = blockIdx.x; item < R * a.S; item += gridDim.x) {
    const int r = item / a.S, sp = item - r * a.S;
    const int m0 = r * TM;
    const int j0 = (int)((long)n_tiles * sp / a.S), j1 = (int)((long)n_tiles * (sp + 1) / a.S);
    float* part = a.part + (long)sp * M * N;
    for (int j = j0; j < j1; ++j) {
      float ag[4][4], au[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) ag[i][c] = au[i][c] = 0.f;
      for (int k0 = 0; k0 < K; k0 += TK) {
        for (int i = threadIdx.x; i < TM * TK; i += NT) {
          const int m = i / TK, kk = i % TK;
          Xs[kk][m] = m0 + m < M ? to_f(x[(long)(m0 + m) * K + k0 + kk]) : 0.f;
        }
        for (int i = threadIdx.x; i < (TK / VPW) * TI; i += NT) {
          const int wr = i / TI, c = i % TI;
          const long col = (long)j * TI + c;
          const long gi = (long)(k0 + wr * VPW) / a.gk;
          const long wi = (long)(k0 / VPW + wr) * I + col;
          const uint32_t gwd = (uint32_t)__ldg(a.gw + wi), uwd = (uint32_t)__ldg(a.uw + wi);
          const float gsc = __ldg(a.gs + gi * I + col), gzc = __ldg(a.gz + gi * I + col);
          const float usc = __ldg(a.us + gi * I + col), uzc = __ldg(a.uz + gi * I + col);
#pragma unroll
          for (int e = 0; e < VPW; ++e) {
            Wg[wr * VPW + e][c] = ((float)((gwd >> (BITS * e)) & MASK) - gzc) * gsc;
            Wu[wr * VPW + e][c] = ((float)((uwd >> (BITS * e)) & MASK) - uzc) * usc;
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          float xa[4], bg[4], bu[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xa[i] = Xs[kk][ty + 16 * i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            bg[c] = Wg[kk][tx + 16 * c];
            bu[c] = Wu[kk][tx + 16 * c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ag[i][c] = fmaf(xa[i], bg[c], ag[i][c]);
              au[i][c] = fmaf(xa[i], bu[c], au[i][c]);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) Act[ty + 16 * i][tx + 16 * c] = silu_mul(ag[i][c], au[i][c]);
      __syncthreads();
      for (int n0 = 0; n0 < N; n0 += TN) {
        for (int i = threadIdx.x; i < (TI / VPW) * TN; i += NT) {
          const int wr = i / TN, c = i % TN;
          const int n = n0 + c;
          if (n < N) {
            const int i0 = j * TI + wr * VPW;
            const long gi = i0 / a.ik;
            const uint32_t wd = (uint32_t)__ldg(a.dw + (long)(i0 / VPW) * N + n);
            const float s = __ldg(a.ds + gi * N + n), z = __ldg(a.dz + gi * N + n);
#pragma unroll
            for (int e = 0; e < VPW; ++e)
              Wd[wr * VPW + e][c] = ((float)((wd >> (BITS * e)) & MASK) - z) * s;
          } else {
#pragma unroll
            for (int e = 0; e < VPW; ++e) Wd[wr * VPW + e][c] = 0.f;
          }
        }
        __syncthreads();
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
#pragma unroll 8
        for (int ii = 0; ii < TI; ++ii) {
          float xa[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xa[i] = Act[ty + 16 * i][ii];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = Wd[ii][tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[i][c] = fmaf(xa[i], b[c], o[i][c]);
        }
        // the item's own partial rows: only this thread ever touches these
        // elements, so the first tile stores and the later ones add
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + ty + 16 * i;
          if (m >= M) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + tx + 16 * c;
            if (n >= N) continue;
            float* p = part + (long)m * N + n;
            *p = j == j0 ? o[i][c] : *p + o[i][c];
          }
        }
        __syncthreads();
      }
    }
  }
  cg::this_grid().sync();
  reduce_partials<T, 1>(a);
}

template <class K>
cudaError_t coop_launch(K kern, const MlpArgs& a, size_t smem, int items, cudaStream_t st) {
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, items, &grid);
  if (e != cudaSuccess) return e;
  MlpArgs args = a;
  void* p[] = {&args};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), p, smem, st);
}

template <class T, int BITS>
cudaError_t launch(const MlpArgs& a, cudaStream_t st) {
  constexpr int VPW = 32 / BITS;
  if (a.M < 1 || a.I % TI || a.K % TK || a.gk % VPW || a.ik % VPW || a.K % a.gk ||
      a.I % a.ik || a.S < 1 || a.S > a.I / TI)
    return cudaErrorInvalidValue;
  if (a.M <= GEMV_MAXM) {
    if (a.S != a.I / TI) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((size_t)a.M * a.K + NW * a.M * 2 * TI + a.M * TI);
    return coop_launch(mlp_gemv_kernel<T, BITS>, a, smem, a.I / TI, st);
  }
  const size_t smem =
      sizeof(float) * ((size_t)TK * (TM + 4) + 2 * TK * (TI + 4) + TM * (TI + 4) + TI * (TN + 4));
  const int items = (a.M + TM - 1) / TM * a.S;
  return coop_launch(mlp_tiled_kernel<T, BITS>, a, smem, items, st);
}

template <class T>
cudaError_t dispatch_bits(const MlpArgs& a, int bits, cudaStream_t st) {
  switch (bits) {
    case 2: return launch<T, 2>(a, st);
    case 4: return launch<T, 4>(a, st);
    case 8: return launch<T, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x and y): 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_mlp_fused(const MlpArgs* a, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_bits<float>(*a, bits, st)
                  : dtype == 1 ? dispatch_bits<__nv_bfloat16>(*a, bits, st)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
