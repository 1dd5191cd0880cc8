// W4A8 integer matmul: acc[M, N] = sum_g s[g, n] * sum_{k in g} xi[m, k] *
// (q[k, n] - z[g, n]), the inner sum exact in int32, before the activation
// scale (the caller multiplies by it).
//
// Replaces the TPU kernel mi_optimize_tpu/ops/w4a8_matmul.py::_kernel
// (w4a8_matmul_int).
//
// Layout: xi [M, K] int8 (row starts 4-byte aligned: K % 4 == 0); packed
// int4 words [K/8, N] int32 words-major (core/packing.py), fields stored
// unsigned; scales s and zeros z [K/g, N] f32, the zeros integral and with
// qmin already subtracted, so q - z lies in int8 range. out [M, N] f32.
//
// Numbers: as the reference, each group's dot is accumulated exactly in
// int32 (|sum| <= 128 * 15 * K, far below 2^31), converted to f32 and
// multiplied by its scale, and the f32 sum runs over the groups in order;
// the product and the add are rounded each on its own (__fmul_rn /
// __fadd_rn, never contracted into an FMA), so the result is the same bits
// as the plain version's in-order f32 sum of exact group sums.
//
// What bounds it on an H100: 2*M*N*K int8 operations against the bytes of x,
// the words and the tables; at M = 128 the bytes of the words (8 MB for a
// 4096 x 4096 weight) weigh the most. Design (the simple one): a block
// computes a [64, 64] tile, 4 x 4 outputs a thread, stepping over K in
// chunks of 32 that never straddle a group. Each chunk stages x's int8
// codes and the weights' int8 (q - z) codes in shared memory as words of 4
// k values, and each thread's 16 int32 sums take one __dp4a a word; at a
// group's end they are scaled into the f32 sums. Tensor-core int8 mma and
// wgmma are later work.
#include "decode_common.cuh"

namespace {

using namespace mi;

constexpr int TM = 64, TN = 64, TK = 32, K4 = TK / 4;

__global__ void __launch_bounds__(NT) w4a8_kernel(const int8_t* __restrict__ xi,
                                                  const int32_t* __restrict__ W,
                                                  const float* __restrict__ S,
                                                  const float* __restrict__ Z,
                                                  float* __restrict__ out, int M, int N, int K,
                                                  int g) {
  __shared__ int xs[K4][TM + 1];  // 4 k values of row m a word
  __shared__ int ws[K4][TN + 1];  // 4 k values of column n a word, q - z
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc[4][4];
  float accf[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc[i][j] = 0; accf[i][j] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += TK) {
    // x: TM rows x 8 words of 4 codes
    for (int i = threadIdx.x; i < TM * K4; i += NT) {
      const int m = i / K4, w = i % K4;
      xs[w][m] = m0 + m < M ? __ldg((const int*)(xi + (long)(m0 + m) * K + k0) + w) : 0;
    }
    // weights: 4 word rows (8 k each) x TN columns; every word gives two
    // words of four int8 codes q - z
    const int gi = k0 / g;
    for (int i = threadIdx.x; i < (TK / 8) * TN; i += NT) {
      const int wr = i / TN, c = i % TN, n = n0 + c;
      int lo = 0, hi = 0;
      if (n < N) {
        const uint32_t wd = (uint32_t)__ldg(W + (long)(k0 / 8 + wr) * N + n);
        const int z = (int)__ldg(Z + (long)gi * N + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo |= (((int)((wd >> (4 * e)) & 15u) - z) & 0xff) << (8 * e);
          hi |= (((int)((wd >> (4 * (e + 4))) & 15u) - z) & 0xff) << (8 * e);
        }
      }
      ws[2 * wr][c] = lo;
      ws[2 * wr + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < K4; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if ((k0 + TK) % g == 0) {  // the group ends: scale its exact sums into f32
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        const float s = n < N ? __ldg(S + (long)gi * N + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          accf[i][j] = __fadd_rn(accf[i][j], __fmul_rn((float)acc[i][j], s));
          acc[i][j] = 0;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long)m * N + n] = accf[i][j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int mi_w4a8_matmul(const void* xi, const void* packed, const void* scales,
                              const void* zeros, void* out, int M, int N, int K, int group,
                              void* stream) {
  cudaGetLastError();
  if (M < 1 || N < 1 || K % TK || group % TK || K % group) return (int)cudaErrorInvalidValue;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  w4a8_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xi, (const int32_t*)packed, (const float*)scales, (const float*)zeros,
      (float*)out, M, N, K, group);
  return (int)cudaGetLastError();
}
