// W4A8 integer matmul: acc[M, N] = sum_g s[g, n] * sum_{k in g} xi[m, k] *
// (q[k, n] - z[g, n]), the inner sum exact in int32, before the activation
// scale (the caller multiplies by it).
//
// Replaces the TPU kernel mi_optimize_tpu/ops/w4a8_matmul.py::_kernel
// (w4a8_matmul_int).
//
// Layout: xi [M, K] int8 (K % 32 == 0); packed int4 words [K/8, N] int32
// words-major (core/packing.py), fields stored unsigned; scales s and zeros
// z [K/g, N] f32, the zeros integral and with qmin already subtracted, so
// q - z lies in int8 range. out [M, N] f32.
//
// Numbers: as the reference, each group's dot is accumulated exactly in
// int32 (|sum| <= 128 * 15 * K, far below 2^31), converted to f32 and
// multiplied by its scale, and the f32 sum runs over the groups in order;
// the product and the add are rounded each on its own (__fmul_rn /
// __fadd_rn, never contracted into an FMA), so the result is the same bits
// as the plain version's in-order f32 sum of exact group sums. Every block
// walks all of K in order (no split-K), so no split can reorder that sum.
//
// What bounds it on an H100: 2*M*N*K int8 operations against the bytes of x,
// the words and the tables; at M = 128 the bytes of the words (8 MB for a
// 4096 x 4096 weight) weigh the most, at M = 2048 the operations. Design:
// int8 tensor cores, mma.m16n8k32 with s32 accumulators. A block computes a
// [BM, BN] tile over a 3-stage cp.async ring of x tiles (128 k of int8) and
// raw word tiles (16 word rows); each word tile is turned once a block into
// int8 codes q - z in shared memory (per-byte subtract and byte permutes, no
// conversions), and each warp's int32 fragments accumulate one group (4
// k32 steps at g128, all of K per channel); at a group's end they are scaled
// into the f32 fragments. Three tile shapes, the largest that gives two
// blocks an SM: [128, 64] on 8 warps, [64, 64] and [64, 32] on 4 warps
// (M = 128, N = 4096: 256 blocks).
#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace mi;

using Big = TileCfg<128, 64, 4, 2, 16>;
using Mid = TileCfg<64, 64, 2, 2, 16>;
using Small = TileCfg<64, 32, 2, 2, 16>;

template <class C>
__global__ void __launch_bounds__(C::NT)
w4a8_kernel(const int8_t* __restrict__ xi, const int32_t* __restrict__ W,
            const float* __restrict__ S, const float* __restrict__ Z, float* __restrict__ out,
            int M, int N, int K, int g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wt = smem + C::STAGES * C::STAGE_BYTES;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int KW = K / 8, KT = (K + 127) / 128;
  int acc[C::FM][C::FN][4];
  float accf[C::FM][C::FN][4];
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < C::FN; ++fn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[fm][fn][e] = 0;
        accf[fm][fn][e] = 0.f;
      }
  auto stage = [&](int kt) { return smem + (kt % C::STAGES) * C::STAGE_BYTES; };
  auto load = [&](int kt) {
    load_stage<C>(stage(kt), (const uint8_t*)xi, K, M, K, m0, kt * 128L, W, N, KW, n0, kt * 16);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // this stage's zeros, fetched while its copies land
    uint32_t zz[C::WPT];
#pragma unroll
    for (int j = 0; j < C::WPT; ++j) {
      const int idx = threadIdx.x + j * C::NT, gw = kt * 16 + idx / C::BN, n = n0 + idx % C::BN;
      const bool ok = gw < KW && n < N;
      zz[j] = ok ? ((uint32_t)(int)__ldg(Z + (long)(gw * 8 / g) * N + n) & 0xFFu) * 0x01010101u
                 : 0u;
    }
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is past kt - 1's products
    const int32_t* ws = (const int32_t*)(stage(kt) + C::X_BYTES);
#pragma unroll
    for (int j = 0; j < C::WPT; ++j) {
      const int idx = threadIdx.x + j * C::NT, r = idx / C::BN, n = idx % C::BN;
      const uint32_t w = (uint32_t)ws[r * C::BN + n];
      // fields 0,2,4,6 and 1,3,5,7 as bytes, minus z in every byte (mod 256:
      // the int8 code q - z), then interleaved back into k order
      const uint32_t lo = __vsub4(w & 0x0F0F0F0Fu, zz[j]);
      const uint32_t hi = __vsub4((w >> 4) & 0x0F0F0F0Fu, zz[j]);
      *(uint2*)(wt + n * C::ROW + r * 8) =
          make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
    }
    if (kt + C::STAGES - 1 < KT) load(kt + C::STAGES - 1);
    cp_async_commit();
    __syncthreads();  // the code tile is complete
    const uint8_t* xs = stage(kt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kt * 128 + kk * 32;
      if (k >= K) break;
      uint32_t a[C::FM][4], b[C::FN][2];
      load_frags<C>(a, b, xs, wt, wm, wn, kk);
#pragma unroll
      for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn) mma_s8(acc[fm][fn], a[fm], b[fn][0], b[fn][1]);
      if ((k + 32) % g == 0) {  // the group ends: scale its exact sums into f32
        const long gi = k / g;
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn) {
          const int n = n0 + wn * C::TN + fn * 8 + 2 * t;
          const float s0 = n < N ? __ldg(S + gi * N + n) : 0.f;
          const float s1 = n + 1 < N ? __ldg(S + gi * N + n + 1) : 0.f;
#pragma unroll
          for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              accf[fm][fn][e] = __fadd_rn(
                  accf[fm][fn][e], __fmul_rn(__int2float_rn(acc[fm][fn][e]), (e & 1) ? s1 : s0));
              acc[fm][fn][e] = 0;
            }
        }
      }
    }
  }
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * C::TM + fm * 16 + gq + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int fn = 0; fn < C::FN; ++fn) {
        const int n = n0 + wn * C::TN + fn * 8 + 2 * t;
        float* p = out + (long)m * N + n;
        if ((N & 1) == 0 && n + 1 < N) {
          *(float2*)p = make_float2(accf[fm][fn][2 * h], accf[fm][fn][2 * h + 1]);
        } else {
          if (n < N) p[0] = accf[fm][fn][2 * h];
          if (n + 1 < N) p[1] = accf[fm][fn][2 * h + 1];
        }
      }
    }
}

template <class C>
int launch(const void* xi, const void* packed, const void* scales, const void* zeros, void* out,
           int M, int N, int K, int g, cudaStream_t st) {
  if (C::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(w4a8_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  w4a8_kernel<C><<<grid, C::NT, C::SMEM, st>>>((const int8_t*)xi, (const int32_t*)packed,
                                               (const float*)scales, (const float*)zeros,
                                               (float*)out, M, N, K, g);
  return 0;
}

}  // namespace

// tile 0: [128, 64], 1: [64, 64], 2: [64, 32]. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_w4a8_matmul(const void* xi, const void* packed, const void* scales,
                              const void* zeros, void* out, int M, int N, int K, int group,
                              int tile, void* stream) {
  cudaGetLastError();
  if (M < 1 || N < 1 || K % 32 || group % 32 || K % group || tile < 0 || tile > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int r = tile == 0   ? launch<Big>(xi, packed, scales, zeros, out, M, N, K, group, st)
                : tile == 1 ? launch<Mid>(xi, packed, scales, zeros, out, M, N, K, group, st)
                            : launch<Small>(xi, packed, scales, zeros, out, M, N, K, group, st);
  if (r != 0) return r;
  return (int)cudaGetLastError();
}
