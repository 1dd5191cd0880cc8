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
// What bounds it on an H100: at decode shapes (M = 8) the window's packed
// words, read once; at prefill shapes (M = 2048) the f32 multiply-adds,
// 2*M*K*nc of them on the CUDA cores (f32 inputs stay off the tensor cores:
// the reference sums in f32). Design: a block dequantizes a [32, 64] weight
// tile into shared memory once (in f32, (q - zq) * s as the reference
// writes it) and reuses it for a 64-row x tile; each thread keeps a 4 x 4
// output block in f32 registers; the epilogue adds the received partial.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

}  // namespace

// x [M, K] (dtype 0 float32, 1 bfloat16); packed [K * bits / 32, N] int32
// words; scale and zq [K / g, N] f32; add and y [M, nc] f32 (add may be
// null). Returns cudaGetLastError() after the launch.
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
