// y[M, N] = x[M, K] @ dequant(packed)^T for words-major packed int2/4/8.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/dequant_matmul.py::_kernel.
// Two kernels, chosen by M:
//   * M <= 8 (decode, the lm_head in generate): GEMV. Bound by the bytes of
//     the packed words and scales. The x rows are staged in shared memory a
//     chunk of K at a time; each lane owns one output column and walks its
//     warp's share of the chunk a word at a time, so a warp reads 128
//     contiguous bytes per word row; the block's 8 warps split each chunk and
//     warp 0 sums them at the end. The weight is dequantized in registers
//     (q*s + b) and never stored.
//   * M > 8 (prefill, M = 128): tiled. Bound by 2*M*N*K operations. A block
//     dequantizes a [32, 64] weight tile into shared memory once and reuses
//     it for a 64-row x tile; each thread accumulates a 4 x 4 output block in
//     f32 registers. The dequantized weight is rounded to x's dtype before
//     the product, as the reference's non-grouped path does. CUDA-core FMA;
//     tensor cores are later work.
#include "decode_common.cuh"

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
