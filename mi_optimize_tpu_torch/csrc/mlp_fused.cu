// Fused quantized SwiGLU MLP: y = down . (silu(x . gate) * (x . up)) over
// packed int2/4/8 gate, up and down weights.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/mlp_fused.py::_kernel
// (fused_mlp).
//
// Layout (core/packing.py): gate/up words [K*b/32, I], down words
// [I*b/32, N], int32 words-major, fields stored unsigned. Tables are f32
// [groups, out]: a weight is (q - z) * s = q*s + b, as the reference
// dequantizes it. act = gate * (1 / (1 + exp(-gate))) * up in f32, the down
// product summed in f32, the output rounded to x's dtype at the end.
//
// Two routes; ops/mlp_fused.py::route picks one from M, x's dtype, the
// bits and the groups.
//
// bf16 x with 4-bit words and groups of whole k32 (every served MLP), on
// the tensor cores: mi_mlp_fused_mma. The reference's grid walks the
// intermediate tiles in order and carries one [TM, N] f32 sum from step to
// step. Blocks here run in no order, so the work is cut in two phases
// instead: P1, gate and up with silu(g) * u in its epilogue, writes act to
// a scratch in device memory; P2, down, reads it back. act is the one
// departure from the reference's "act never in HBM": 90 MB at M = 2048
// (the first port's tiled kernel wrote and read 268 MB of split partials
// at M = 128), at most 352 KB at M <= 8, which stays in L2. Both phases
// compute the reference's grouped rescale (block_fused._qdot, the plain
// ops/dequant_matmul.py::qdot_ref): per group D[g] = x . (q - 8) on the
// centered codes (centered_pair, exact in bf16) by mma.m16n8k16 (bf16 in,
// f32 accumulators), then y += s*D[g] + (b + 8s) * xsum[g], xsum the f32
// sum of the row over the group, b = -z*s the linears' bias tables. The
// products are exact; only the order of the f32 sums differs from the
// plain version.
//   * M <= 8 (decode): one cooperative launch (mlp_gemv_mma_kernel), bound
//     by the bytes of the words and tables (76 MB a layer at Llama-2-7B).
//     Both phases run mg_gemv, after gemv16_kernel's lane mapping
//     (dequant_matmul.cu): the weights are the mma's A operand (16 output
//     columns x k16), the rows its n8 columns; a lane streams 16 bytes of
//     two word columns a chunk, double-buffered in registers. P1's warp
//     holds 32 gate columns and the same 32 up columns, so the split that
//     finishes a column block writes act = silu(g) * u in f32 [M, I]; a
//     grid barrier; P2 reads act as two bf16 planes (hi, lo: within 2^-17
//     of act). Items are (512 columns, K split at whole groups) over the
//     grid (ops/mlp_fused.py::gemv_plans), the splits' f32 partials added
//     in split order by each column block's last item. The batched
//     kernel's GEMV (batch_gemv.cuh bg_gemv, two NC = 1 calls for gate and
//     up) was tried here first and was slower at M = 1 on the H100
//     (PERF.md): its staged 8-row windows suit B = 8 slots.
//   * M > 8 (prefill, perplexity): two launches on one stream
//     (mlp_mma_kernel<.., true>, then <.., false>), bound by 2*M*I*(2K + N)
//     operations. A cooperative grid would add nothing the stream order
//     does not give. A block computes a [64, 128] tile on 8 warps of
//     [32, 32] (two blocks an SM), or above 128 rows a [128, 128] tile on
//     16 (one block an SM), at 128 registers: the grouped rescale keeps two
//     accumulators, D and y, for every output. It runs over a cp.async ring
//     of 64 k a stage: the x planes as the A operand
//     (ldmatrix), the stage's word rows turned into centered bf16 codes
//     once a block as B, into one of two code tiles, so that one barrier a
//     stage suffices and a stage's codes are made while the one before is
//     multiplied. The group's scale and bias rows ride in the stage. Each
//     warp also multiplies its A fragments by a column of ones, so its
//     accumulators hold xsum for exactly the rows they scale: no pass over
//     the rows. P1's tile is 64 gate and the same 64 up columns,
//     interleaved by 8, so a thread holds g and u of the same outputs and
//     writes act as two bf16 planes (hi, lo). P2 reads the planes as two A
//     operands (K = I), splits I at whole groups only as far as its tiles
//     need to fill the card (ops/mlp_fused.py::mma_plan), and the last
//     block of a tile adds the splits' f32 partials in split order.
// No float atomics: the result is the same bits on every run.
//
// f32 x, 2- and 8-bit words (CUDA cores): mi_mlp_fused, the kernels of the
// first port, in one cooperative launch. An item is one intermediate tile
// (M <= 8) or a TM-row tile and a run of intermediate tiles (M > 8); its
// partial [M, N] sum lands in scratch and the grid adds the partials in a
// fixed order after a grid barrier.
#include "batch_gemv.cuh"
#include "decode_common.cuh"
#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// bf16 x, 4-bit words: the tensor-core route
// ---------------------------------------------------------------------------

struct MlpMmaArgs {
  const void* x;                                          // [M, K] bf16
  const int32_t* gw; const float* gs; const float* gb;    // gate [K/8, I], [K/gk, I]
  const int32_t* uw; const float* us; const float* ub;    // up, the same
  const int32_t* dw; const float* ds; const float* db;    // down [I/8, N], [I/ik, N]
  void* act;       // M <= 8: f32 act [M, I]; else bf16 planes of act [2][M][I]
  float* part;     // the splits' f32 partials
  int* counters;   // one a tile, zero on entry and left zero
  void* y;         // [M, N] bf16
  long n_part;     // floats of part
  int n_counters;  // ints of counters
  int M, K, I, N, gk, ik;
  int splits1, splits2;  // K splits of P1 (M <= 8) and P2
  int big;               // M > 8: the [128, 128] tiles (else [64, 128])
};

namespace {

using namespace mi;

constexpr int MG_COLS = NW * 64;  // virtual columns an item of the M <= 8 GEMV (64 a warp)

// 4 words of row `row` of a [rows, ldw] matrix at columns col..col+3, zeros
// past ldw, as a streaming load (each word is read once).
__device__ __forceinline__ uint4 mg_words4(const int32_t* __restrict__ W, long row, int ldw,
                                           int col) {
  const int32_t* p = W + row * ldw + col;
  if ((ldw & 3) == 0 && col + 3 < ldw) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (col < ldw) v.x = (uint32_t)__ldg(p);
  if (col + 1 < ldw) v.y = (uint32_t)__ldg(p + 1);
  if (col + 2 < ldw) v.z = (uint32_t)__ldg(p + 2);
  if (col + 3 < ldw) v.w = (uint32_t)__ldg(p + 3);
  return v;
}

// bf16 x rows: a lane's 8 values of row gq under one word row; f32 act rows:
// the same 8 values as two float4 (L2 loads: another SM wrote them in this
// launch).
struct MgChunk {
  uint4 w[2];
  float4 x[2];
};

// One GEMV phase of the M <= 8 kernel, after gemv16_kernel's (dequant_matmul.cu)
// lane mapping. GU (P1): virtual columns [0, 2I), a warp's 64 are gate
// columns j0..j0+31 and the same up columns (j0 = v0 / 2), x the bf16 rows
// (one plane); the epilogue writes act = silu(g) * u, f32 [M, I]. !GU (P2):
// the N down columns, x = act as two bf16 planes (hi, lo); the epilogue
// writes y. Items are (block of MG_COLS virtual columns, K split at whole
// groups); with splits, each writes f32 partials [splits][M][virtual
// columns] and the column block's last item adds them in split order.
template <bool GU>
__device__ __forceinline__ void mg_gemv(const MlpMmaArgs& a, int splits) {
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int M = a.M, I = a.I;
  const int K = GU ? a.K : I, g = GU ? a.gk : a.ik, ldw = GU ? I : a.N;
  const int nv = GU ? 2 * I : a.N, nblk = (nv + MG_COLS - 1) / MG_COLS;
  const int ng = K / g, cpg = g / 32;
  const int32_t* W0 = GU ? a.gw : a.dw;
  const int32_t* W1 = GU ? a.uw : a.dw;
  const float* S0 = GU ? a.gs : a.ds;
  const float* S1 = GU ? a.us : a.ds;
  const float* B0 = GU ? a.gb : a.db;
  const float* B1 = GU ? a.ub : a.db;
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(a.x);
  float* act = reinterpret_cast<float*>(a.act);
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(a.y);
  for (int item = blockIdx.x; item < nblk * splits; item += gridDim.x) {
    const int cb = item % nblk, sp = item / nblk;
    const int v0 = cb * MG_COLS + warp * 64;  // the warp's first virtual column
    // the lane's word columns: 4 from c0 (tiles 0, 1) and 4 from c1 (tiles 2, 3)
    const int c0 = (GU ? v0 / 2 : v0) + 4 * gq, c1 = GU ? c0 : c0 + 32;
    const int cbeg = (int)((long)sp * ng / splits) * cpg;
    const int cend = (int)((long)(sp + 1) * ng / splits) * cpg;
    float yacc[4][4], dacc[4][4], xs = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[i][e] = dacc[i][e] = 0.f;
    auto load = [&](int c) {
      MgChunk ch;
      const long wrow = (long)c * 4 + t;
      ch.w[0] = mg_words4(W0, wrow, ldw, c0);
      ch.w[1] = mg_words4(W1, wrow, ldw, c1);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (GU) {
        const uint4 v = gq < M ? __ldg(reinterpret_cast<const uint4*>(x + (long)gq * K + wrow * 8))
                               : make_uint4(0u, 0u, 0u, 0u);
        ch.x[0] = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                              __uint_as_float(v.w));
        ch.x[1] = z;
      } else {
        const float4* p = reinterpret_cast<const float4*>(act + (long)gq * K + wrow * 8);
        ch.x[0] = gq < M ? __ldcg(p) : z;
        ch.x[1] = gq < M ? __ldcg(p + 1) : z;
      }
      return ch;
    };
    if (v0 < nv && cbeg < cend) {
      MgChunk cur = load(cbeg), nxt = cur;
      for (int c = cbeg; c < cend; ++c) {
        if (c + 1 < cend) nxt = load(c + 1);
        const uint32_t wd[4][2] = {{cur.w[0].x, cur.w[0].y}, {cur.w[0].z, cur.w[0].w},
                                   {cur.w[1].x, cur.w[1].y}, {cur.w[1].z, cur.w[1].w}};
        // the lane's 8 values as bf16 pairs in k order: one plane, or (hi, lo)
        constexpr int NP = GU ? 1 : 2;
        uint32_t pl[NP][4];
        if constexpr (GU) {
          const uint32_t v[4] = {__float_as_uint(cur.x[0].x), __float_as_uint(cur.x[0].y),
                                 __float_as_uint(cur.x[0].z), __float_as_uint(cur.x[0].w)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pl[0][j] = v[j];
            xs += __uint_as_float(v[j] << 16) + __uint_as_float(v[j] & 0xFFFF0000u);
          }
        } else {
          const float f[8] = {cur.x[0].x, cur.x[0].y, cur.x[0].z, cur.x[0].w,
                              cur.x[1].x, cur.x[1].y, cur.x[1].z, cur.x[1].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
            pl[0][j] = bits_of(hi);
            pl[NP - 1][j] = bits_of(__floats2bfloat162_rn(f[2 * j] - __low2float(hi),
                                                          f[2 * j + 1] - __high2float(hi)));
            xs += f[2 * j] + f[2 * j + 1];
          }
        }
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          // k slots 2t, 2t+1 | 2t+8, 2t+9 of step st are fields (2st, 2st+4) |
          // (2st+1, 2st+5) of the lane's word row, in A and in B alike
          uint32_t b[NP][2];
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint32_t lo = pl[p][st], hi = pl[p][st + 2];
            b[p][0] = __byte_perm(lo, hi, 0x5410);
            b[p][1] = __byte_perm(lo, hi, 0x7632);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t af[4] = {
                centered_pair(wd[i][0], 2 * st), centered_pair(wd[i][1], 2 * st),
                centered_pair(wd[i][0], 2 * st + 1), centered_pair(wd[i][1], 2 * st + 1)};
#pragma unroll
            for (int p = 0; p < NP; ++p) mma_bf16(dacc[i], af, b[p][0], b[p][1]);
          }
        }
        if ((c + 1) % cpg == 0) {  // the group ends: y += s*D + (b + 8s) * xsum
          const long gi = c / cpg;
          float v = xs;
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const float xm[2] = {__shfl_sync(0xffffffffu, v, 8 * t),
                               __shfl_sync(0xffffffffu, v, 8 * t + 4)};
          xs = 0.f;
          const float4 s0 = bg_tab4(S0, gi, ldw, c0), s1 = bg_tab4(S1, gi, ldw, c1);
          const float4 b0 = bg_tab4(B0, gi, ldw, c0), b1 = bg_tab4(B1, gi, ldw, c1);
          const float sc[4][2] = {{s0.x, s0.y}, {s0.z, s0.w}, {s1.x, s1.y}, {s1.z, s1.w}};
          const float bc[4][2] = {{b0.x, b0.y}, {b0.z, b0.w}, {b1.x, b1.y}, {b1.z, b1.w}};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float s = sc[i][h], cbias = fmaf(8.f, s, bc[i][h]);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                yacc[i][2 * h + e] += fmaf(s, dacc[i][2 * h + e], cbias * xm[e]);
                dacc[i][2 * h + e] = 0.f;
              }
            }
        }
        cur = nxt;
      }
    }
    // the lane's outputs: tile i, half h is virtual column v0 + 32 (i >> 1) +
    // 4gq + 2 (i & 1) + h (GU: gate for i < 2, the same column's up for i >= 2),
    // rows m = 2t + e
    if (splits == 1) {
      if (v0 >= nv) continue;
#pragma unroll
      for (int i = 0; i < (GU ? 2 : 4); ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 2 * t + e, col = (i < 2 ? c0 : c1) + 2 * (i & 1) + h;
            if (m >= M || col >= ldw) continue;
            if constexpr (GU)
              act[(long)m * I + col] = silu_mul(yacc[i][2 * h + e], yacc[i + 2][2 * h + e]);
            else
              y[(long)m * ldw + col] = __float2bfloat16(yacc[i][2 * h + e]);
          }
      continue;
    }
    float* P = a.part + (long)sp * M * nv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * t + e, v = v0 + 32 * (i >> 1) + 4 * gq + 2 * (i & 1) + h;
          if (m < M && v < nv) __stcg(P + (long)m * nv + v, yacc[i][2 * h + e]);
        }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.counters + cb, 1) == splits - 1;
    __syncthreads();
    if (!last) continue;
    __threadfence();
    const long stride = (long)M * nv;
    auto sum = [&](long o) {
      float r = 0.f;
      for (int q = 0; q < splits; ++q) r += __ldcg(a.part + q * stride + o);
      return r;
    };
    if constexpr (GU) {
      for (int i = threadIdx.x; i < M * (MG_COLS / 2); i += NT) {
        const int m = i / (MG_COLS / 2), r = i % (MG_COLS / 2);
        const int vg = cb * MG_COLS + (r / 32) * 64 + r % 32;  // gate; its up at vg + 32
        if (vg < nv)
          act[(long)m * I + vg / 64 * 32 + r % 32] =
              silu_mul(sum((long)m * nv + vg), sum((long)m * nv + vg + 32));
      }
    } else {
      for (int i = threadIdx.x; i < M * MG_COLS; i += NT) {
        const int m = i / MG_COLS, n = cb * MG_COLS + i % MG_COLS;
        if (n < nv) y[(long)m * nv + n] = __float2bfloat16(sum((long)m * nv + n));
      }
    }
    if (threadIdx.x == 0) a.counters[cb] = 0;
  }
}

// M <= 8: P1 gate and up (act = silu(g) * u in f32), a grid barrier, P2 down.
__global__ void __launch_bounds__(NT, COOP_PER_SM) mlp_gemv_mma_kernel(MlpMmaArgs a) {
  mg_gemv<true>(a, a.splits1);
  cg::this_grid().sync();
  mg_gemv<false>(a, a.splits2);
}

// A tile of the M > 8 kernels: [BM, BN] outputs on WM x WN warps. A stage of
// the ring holds 64 k: NP bf16 planes of BM rows (rows padded to 144 bytes,
// as mma_common.cuh's TileCfg), 8 word rows of the BN columns, and the
// scale and bias rows [2][2][BN] f32 of the groups that end at each of its
// two k32 halves (groups are whole k32). The stage's centered codes go to
// one of two [BN, 64] bf16 tiles, so that a stage's codes are made while
// the one before is multiplied.
template <int BM_, int WM_, int WN_, int NP_, int STAGES_, int MINB_>
struct MlpTile {
  static constexpr int BM = BM_, BN = 128, WM = WM_, WN = WN_, NP = NP_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;  // ring depth, blocks an SM
  static constexpr int NT = WM * WN * 32;
  static constexpr int ROW = 144;
  static constexpr int X_BYTES = NP * BM * ROW;
  static constexpr int W_BYTES = 8 * BN * 4;
  static constexpr int T_BYTES = 2 * 2 * BN * 4;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + T_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * BN * ROW;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int FM = TM / 16, FN = TN / 8;   // mma tiles a warp
  static constexpr int WPT = 8 * BN / NT;           // words a thread turns into codes a stage
  static_assert(TN % 16 == 0 && FN % 2 == 0 && (8 * BN) % NT == 0, "tile shape");
  static_assert(STAGES >= 3 && MINB * SMEM <= 232448, "shared memory of an SM");
};

// Warps of [32, 32] at 128 registers: [64, 128] tiles on 2 x 4 warps, two
// blocks an SM, up to 128 rows; [128, 128] on 4 x 4 warps, one block an SM,
// above (half the code-making a stage per output: faster at M = 2048,
// slower at 128 on the H100). [128, 128] tiles on 8 warps and [64, 128] on
// 4, at about 235 registers and one block an SM, were slower at both.
using P1Tile = MlpTile<64, 2, 4, 1, 4, 2>;
using P2Tile = MlpTile<64, 2, 4, 2, 3, 2>;
using P1Big = MlpTile<128, 4, 4, 1, 4, 1>;
using P2Big = MlpTile<128, 4, 4, 2, 3, 1>;

constexpr uint32_t BF16_ONES = 0x3F803F80u;  // bf16x2 (1, 1)

// GU (P1): the tile's 128 columns are gate and up columns [c0, c0 + 64),
// interleaved by 8 (virtual column v is up when bit 3 of v is set), over all
// of K; it writes act = silu(g) * u as bf16 planes (hi, lo) [2][M][I].
// !GU (P2): down columns [c0, c0 + 128) over the groups of split blockIdx.z
// of I, from the act planes; one split writes y, more write f32 partials
// [S][M][N] and the tile's last block adds them in split order.
template <class C, bool GU>
__global__ void __launch_bounds__(C::NT, C::MINB) mlp_mma_kernel(MlpMmaArgs a) {
  extern __shared__ __align__(16) uint8_t tsmem[];
  uint8_t* wts = tsmem + C::STAGES * C::STAGE_BYTES;  // two code tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int M = a.M, m0 = blockIdx.y * C::BM;
  const int c0 = blockIdx.x * (GU ? C::BN / 2 : C::BN);
  const int ldw = GU ? a.I : a.N;  // words' and tables' row length
  const int g = GU ? a.gk : a.ik;
  const int Kt = GU ? a.K : a.I;
  int ka = 0, kend = Kt;
  if (!GU) {
    const int ng = Kt / g, S = gridDim.z, z = blockIdx.z;
    ka = (int)((long)z * ng / S) * g;
    kend = (int)((long)(z + 1) * ng / S) * g;
  }
  const __nv_bfloat16* X = reinterpret_cast<const __nv_bfloat16*>(GU ? a.x : a.act);
  const int32_t* W0 = GU ? a.gw : a.dw;
  const float* S0 = GU ? a.gs : a.ds;
  const float* B0 = GU ? a.gb : a.db;
  const int nst = (kend - ka + 63) / 64;

  // virtual column v of the tile: its matrix (0 gate or down, 1 up) and column
  auto column = [&](int v, int& col) -> int {
    if constexpr (GU) {
      col = c0 + ((v >> 4) << 3) + (v & 7);
      return (v >> 3) & 1;
    } else {
      col = c0 + v;
      return 0;
    }
  };
  auto stage = [&](int s) { return tsmem + (s % C::STAGES) * C::STAGE_BYTES; };
  // 4 entries of row `row` of a [rows, ldw] matrix at col.. into 16 bytes of
  // shared memory (zeros past ldw, which is then not read)
  auto copy4 = [&](void* dst, const void* base, long row, int col) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(base) + 4 * (row * ldw + col);
    if ((ldw & 3) == 0) {
      cp_async16(dst, col < ldw ? p : base, col < ldw);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async4(reinterpret_cast<uint8_t*>(dst) + 4 * i, col + i < ldw ? p + 4 * i : base,
                  col + i < ldw);
    }
  };
  auto load = [&](int s) {
    if (s >= nst) return;
    uint8_t* st = stage(s);
    const int k0 = ka + 64 * s;
    for (int c = threadIdx.x; c < C::NP * C::BM * 8; c += C::NT) {
      const int p = c / (C::BM * 8), r = (c >> 3) % C::BM, cc = c & 7;
      const int k = k0 + cc * 8;
      const bool ok = m0 + r < M && k < kend;
      cp_async16(st + (p * C::BM + r) * C::ROW + cc * 16,
                 ok ? X + ((long)p * M + m0 + r) * Kt + k : X, ok);
    }
    int32_t* ws = reinterpret_cast<int32_t*>(st + C::X_BYTES);
    const int w0 = k0 / 8, wend = kend / 8;
    for (int c = threadIdx.x; c < 8 * (C::BN / 4); c += C::NT) {
      const int r = c / (C::BN / 4), v = (c % (C::BN / 4)) * 4;
      int col;
      const int32_t* W = column(v, col) ? a.uw : W0;
      if (w0 + r < wend) copy4(ws + r * C::BN + v, W, w0 + r, col);
      else cp_async16(ws + r * C::BN + v, W, false);
    }
    float* ts = reinterpret_cast<float*>(st + C::X_BYTES + C::W_BYTES);
    for (int c = threadIdx.x; c < 2 * 2 * (C::BN / 4); c += C::NT) {
      const int hf = c / (C::BN / 2), tb = (c / (C::BN / 4)) & 1, v = (c % (C::BN / 4)) * 4;
      const int k_end = k0 + 32 * (hf + 1);
      if (k_end % g || k_end > kend) continue;  // no group ends at this k32 half
      int col;
      const int mat = column(v, col);
      copy4(ts + (2 * hf + tb) * C::BN + v, tb ? (mat ? a.ub : B0) : (mat ? a.us : S0),
            k_end / g - 1, col);
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
  // y += s*D + (b + 8s) * xsum for the warp's outputs
  auto rescale = [&](const float* ts, int hf) {
#pragma unroll
    for (int fn = 0; fn < C::FN; ++fn) {
      const int v = wn * C::TN + fn * 8 + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(ts + 2 * hf * C::BN + v);
      const float2 b = *reinterpret_cast<const float2*>(ts + (2 * hf + 1) * C::BN + v);
      const float sc[2] = {s.x, s.y}, cb[2] = {fmaf(8.f, s.x, b.x), fmaf(8.f, s.y, b.y)};
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
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        uint32_t af[C::FM][4];
#pragma unroll
        for (int fm = 0; fm < C::FM; ++fm)
          ldmatrix_x4(af[fm], xs + (p * C::BM + wm * C::TM + fm * 16 + (lane & 15)) * C::ROW +
                                  kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int fm = 0; fm < C::FM; ++fm) {
#pragma unroll
          for (int fn = 0; fn < C::FN; ++fn) mma_bf16(dacc[fm][fn], af[fm], bf[fn][0], bf[fn][1]);
          mma_bf16(xacc[fm], af[fm], BF16_ONES, BF16_ONES);  // the rows' sums
        }
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

  if constexpr (GU) {
    __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(a.act);
    const int I = a.I;
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::TM + fm * 16 + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int q = 0; q < C::FN / 2; ++q) {  // gate tile 2q, up tile 2q + 1: the same columns
          const int col = c0 + (wn * C::TN / 16 + q) * 8 + 2 * t;
          const float v0 = silu_mul(yacc[fm][2 * q][2 * h], yacc[fm][2 * q + 1][2 * h]);
          const float v1 = silu_mul(yacc[fm][2 * q][2 * h + 1], yacc[fm][2 * q + 1][2 * h + 1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
          *reinterpret_cast<__nv_bfloat162*>(planes + (long)m * I + col) = hi;
          *reinterpret_cast<__nv_bfloat162*>(planes + ((long)M + m) * I + col) = lo;
        }
      }
  } else {
    const int N = a.N, S = gridDim.z;
    __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(a.y);
    float* P = a.part + (long)blockIdx.z * M * N;
#pragma unroll
    for (int fm = 0; fm < C::FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::TM + fm * 16 + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int fn = 0; fn < C::FN; ++fn) {
          const int n = c0 + wn * C::TN + fn * 8 + 2 * t;
          const float v0 = yacc[fm][fn][2 * h], v1 = yacc[fm][fn][2 * h + 1];
          const bool pair = (N & 1) == 0 && n + 1 < N;
          if (S > 1) {
            float* p = P + (long)m * N + n;
            if (pair) {
              __stcg(reinterpret_cast<float2*>(p), make_float2(v0, v1));
            } else {
              if (n < N) p[0] = v0;
              if (n + 1 < N) p[1] = v1;
            }
          } else {
            __nv_bfloat16* p = y + (long)m * N + n;
            if (pair) {
              *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
            } else {
              if (n < N) p[0] = __float2bfloat16(v0);
              if (n + 1 < N) p[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    if (S == 1) return;
    // the tile's last split to finish adds the partials in split order
    __shared__ int last;
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(a.counters + tile, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const long count = (long)M * N;
    for (int i = threadIdx.x; i < C::BM * C::BN; i += C::NT) {
      const int m = m0 + i / C::BN, n = c0 + i % C::BN;
      if (m >= M || n >= N) continue;
      const long o = (long)m * N + n;
      float v = 0.f;
      for (int q = 0; q < S; ++q) v += __ldcg(a.part + q * count + o);
      y[o] = __float2bfloat16(v);
    }
    if (threadIdx.x == 0) a.counters[tile] = 0;
  }
}

template <class C, bool GU>
cudaError_t launch_tile(const MlpMmaArgs& a, dim3 grid, cudaStream_t st) {
  auto kern = mlp_mma_kernel<C, GU>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, C::NT, C::SMEM, st>>>(a);
  return cudaGetLastError();
}

// P1, then P2 (C1's and C2's tiles)
template <class C1, class C2>
cudaError_t launch_tiled_t(const MlpMmaArgs& a, cudaStream_t st) {
  const int S = a.splits2;
  const int tiles_m = (a.M + C2::BM - 1) / C2::BM, tiles_n = (a.N + C2::BN - 1) / C2::BN;
  if (S < 1 || S > a.I / a.ik ||
      S > 1 && (a.n_part < (long)S * a.M * a.N || a.n_counters < tiles_m * tiles_n))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      launch_tile<C1, true>(a, dim3(a.I / (C1::BN / 2), (a.M + C1::BM - 1) / C1::BM), st);
  if (e != cudaSuccess) return e;
  return launch_tile<C2, false>(a, dim3(tiles_n, tiles_m, S), st);
}

cudaError_t launch_tiled(const MlpMmaArgs& a, cudaStream_t st) {
  return a.big ? launch_tiled_t<P1Big, P2Big>(a, st) : launch_tiled_t<P1Tile, P2Tile>(a, st);
}

cudaError_t launch_gemv(const MlpMmaArgs& a, cudaStream_t st) {
  const int nv[2] = {2 * a.I, a.N}, ng[2] = {a.K / a.gk, a.I / a.ik};
  const int S[2] = {a.splits1, a.splits2};
  for (int i = 0; i < 2; ++i) {
    const int nblk = (nv[i] + MG_COLS - 1) / MG_COLS;
    if (S[i] < 1 || S[i] > ng[i] ||
        S[i] > 1 && (a.n_part < (long)S[i] * a.M * nv[i] || a.n_counters < nblk))
      return cudaErrorInvalidValue;
  }
  int grid = 0;
  cudaError_t e = coop_grid(mlp_gemv_mma_kernel, 0, 0, &grid);
  if (e != cudaSuccess) return e;
  MlpMmaArgs args = a;
  void* p[] = {&args};
  return cudaLaunchCooperativeKernel((const void*)mlp_gemv_mma_kernel, dim3(grid), dim3(NT), p, 0,
                                     st);
}

}  // namespace

// bf16 x, 4-bit words, groups of whole k32: M <= 8 one cooperative launch,
// above P1 and P2 on `stream`. The host's plans arrive in splits1/splits2,
// the scratch in act/part/counters (sized by ops/mlp_fused.py, checked here).
// Returns cudaGetLastError() after the launch.
extern "C" int mi_mlp_fused_mma(const MlpMmaArgs* a, void* stream) {
  cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (a->M < 1 || a->K % 32 || a->I % 64 || a->N < 1 || a->gk % 32 || a->ik % 32 ||
      a->K % a->gk || a->I % a->ik)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = a->M <= 8 ? launch_gemv(*a, st) : launch_tiled(*a, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
