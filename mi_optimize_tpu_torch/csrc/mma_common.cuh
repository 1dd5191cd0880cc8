// Tensor-core building blocks shared by the packed-int4 kernels
// (dequant_matmul.cu, w4a8_matmul.cu, and the batched whole-model kernel's
// GEMV in batch_gemv.cuh): cp.async copies into a shared-memory ring,
// ldmatrix fragment loads, 4-bit fields as centered bf16 pairs and
// mma.sync on sm_90a.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32, lane = 4*gq + t):
//   A (16 x k, row):  a0 (row gq,   k slots 2t..), a1 (row gq+8, same),
//                     a2 (row gq,   upper k half), a3 (row gq+8, upper half)
//   B (k x 8, col):   b0 (column gq, lower k half), b1 (column gq, upper half)
//   C (16 x 8):       c0, c1 (row gq, columns 2t, 2t+1), c2, c3 (row gq+8)
// A lower k half is slots 2t, 2t+1 of 16 bf16 (4t..4t+3 of 32 int8).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mi {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (rows of 16 bytes) from shared memory;
// lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 h) { return *(uint32_t*)&h; }

// Fields j and j+4 of a 4-bit word as bf16x2 (q_j - 8, q_{j+4} - 8): the
// fields sit 16 bits apart, so one mask lays both into the mantissas of
// bf16 128.0 (0x4300 | q = 128 + q, exact), and one sub removes 136.
__device__ __forceinline__ uint32_t centered_pair(uint32_t w, int j) {
  const uint32_t p = ((w >> (4 * j)) & 0x000F000Fu) | 0x43004300u, c = 0x43084308u;  // 136
  return bits_of(__hsub2(*(const __nv_bfloat162*)&p, *(const __nv_bfloat162*)&c));
}

// d += a * b, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, int8 inputs, exact int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ring geometry of the tiled kernels: a stage holds BM rows of x and WR rows
// of packed words (BN columns); the dequantized weight tile is BN rows of the
// same 128 bytes of k. Rows are padded to 144 bytes, so the 8 rows an
// ldmatrix phase reads (and the 16-byte stores of a quarter warp) fall on
// distinct banks.
template <int BM_, int BN_, int WM_, int WN_, int WR_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, WR = WR_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int ROW = 144;                    // bytes a padded row
  static constexpr int STAGES = 3;
  static constexpr int X_BYTES = BM * ROW;
  static constexpr int W_BYTES = WR * BN * 4;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + BN * ROW;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  static constexpr int FM = TM / 16, FN = TN / 8;    // mma tiles a warp
  static constexpr int WPT = WR * BN / NT;           // packed words a thread dequantizes
  static_assert(FN % 2 == 0 && (WR * BN) % NT == 0, "tile shape");
};

// One stage of the ring: x rows [m0, m0+BM) x 128 bytes of k from byte k0b
// (row stride ldx bytes, kbytes valid), and packed word rows [w0, w0+WR) x
// columns [n0, n0+BN) (row stride N words, KW rows). Out-of-range pieces are
// zero-filled.
template <class C>
__device__ __forceinline__ void load_stage(uint8_t* stage, const uint8_t* x, long ldx, int M,
                                           long kbytes, int m0, long k0b, const int32_t* W,
                                           int N, int KW, int n0, int w0) {
  uint8_t* xs = stage;
  int32_t* ws = (int32_t*)(stage + C::X_BYTES);
  for (int c = threadIdx.x; c < C::BM * 8; c += C::NT) {
    const int r = c >> 3, cc = c & 7;
    const long kb = k0b + cc * 16;
    const bool ok = m0 + r < M && kb < kbytes;
    cp_async16(xs + r * C::ROW + cc * 16, ok ? x + (long)(m0 + r) * ldx + kb : x, ok);
  }
  if ((N & 3) == 0) {
    for (int c = threadIdx.x; c < C::WR * (C::BN / 4); c += C::NT) {
      const int r = c / (C::BN / 4), n = (c % (C::BN / 4)) * 4;
      const bool ok = w0 + r < KW && n0 + n < N;
      cp_async16(ws + r * C::BN + n, ok ? W + (long)(w0 + r) * N + n0 + n : W, ok);
    }
  } else {
    for (int c = threadIdx.x; c < C::WR * C::BN; c += C::NT) {
      const int r = c / C::BN, n = c % C::BN;
      const bool ok = w0 + r < KW && n0 + n < N;
      cp_async4(ws + r * C::BN + n, ok ? W + (long)(w0 + r) * N + n0 + n : W, ok);
    }
  }
}

// The warp's A fragments (x, rows wm*TM + 16*fm) and B fragments (the
// dequantized weight, rows = columns n) for the 32-byte k step kk of a stage,
// from the padded rows of the ring and the weight tile.
template <class C>
__device__ __forceinline__ void load_frags(uint32_t (&a)[C::FM][4], uint32_t (&b)[C::FN][2],
                                           const uint8_t* xs, const uint8_t* wt, int wm, int wn,
                                           int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int fm = 0; fm < C::FM; ++fm)
    ldmatrix_x4(a[fm], xs + (wm * C::TM + fm * 16 + (lane & 15)) * C::ROW + kk * 32 +
                           (lane >> 4) * 16);
#pragma unroll
  for (int f2 = 0; f2 < C::FN / 2; ++f2) {
    uint32_t r[4];
    ldmatrix_x4(r, wt + (wn * C::TN + f2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::ROW +
                       kk * 32 + ((lane >> 3) & 1) * 16);
    b[2 * f2][0] = r[0];
    b[2 * f2][1] = r[1];
    b[2 * f2 + 1][0] = r[2];
    b[2 * f2 + 1][1] = r[3];
  }
}

}  // namespace mi
