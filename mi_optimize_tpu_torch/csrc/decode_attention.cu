// Decode attention of one token: RoPE on the new q and k rows, per-head int8
// quantization of the new k and v rows, their in-place append to the int8
// cache, and masked GQA softmax attention over the live rows.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/decode_attention.py::_kernel
// (fused_decode_attention).
//
// Layout: q [Hq*D], k/v [Hkv*D] (f32 or bf16), cos/sin [D] f32 (split-half
// tables), cache ck/cv [T, Hkv, D] int8 and scales ks/vs [T, Hkv] f32,
// written at row `pos`; out [Hq*D] f32.
//
// What bounds it on an H100: the live history, rows t <= pos of the int8
// cache and its scales, each read once from device memory (for Llama-2-7B
// at pos 200, 1.70 MB a layer), over the memory rate. The TPU kernel reads
// all T rows and masks them; exp(finfo.min - m) is exactly 0, so reading
// only the live rows gives the same result.
//
// Design (the simple one): one block per q head (GQA: q head h reads kv
// head h / reps; the group's first q head stores the row). Each block ropes
// and quantizes its kv head's new row itself, the same arithmetic in every
// block of the group, and seeds its softmax with that row dequantized from
// its int8 codes, as the reference reads the row back after the write; the
// history rows t < pos are streamed by the block's warps, a row's codes as
// one 4-byte load a lane (4 of D values), R rows' loads in flight a warp,
// with an online softmax in f32; the warps merge at the end. Nothing
// crosses blocks, so there is no grid barrier.
//
// Bitwise contract with the plain version (ops/decode_attention.py): the
// new row's codes and scales are computed with the same IEEE operations in
// the same order, those XLA's CPU backend runs for the reference kernel:
// RoPE as fma(x, cos, rot*sin) with rot*sin rounded first (explicit
// intrinsics, so nothing else is contracted), scale = amax * f32(1/127)
// (the reference's amax / 127.0 as XLA lowers it: a multiply by the f32
// reciprocal), code = rint(x/scale) as a correctly rounded division, rintf
// (round half to even, as torch.round and jnp.round).
#include "decode_common.cuh"

struct DecodeAttnArgs {
  const void* q; const void* k; const void* v;  // [Hq*D], [Hkv*D], [Hkv*D]
  const float* cos; const float* sin;           // [D]
  int8_t* ck; int8_t* cv;                       // [T, Hkv, D]
  float* ks; float* vs;                         // [T, Hkv]
  float* out;                                   // [Hq*D]
  int n_heads, n_kv_heads, head_dim, max_len, pos;
};

namespace {

using namespace mi;

constexpr int R = 8;     // history rows in flight a warp
constexpr int MAXC = 2;  // 4-value chunks a lane: D <= 4 * 32 * MAXC = 256

// value e (0..3) of four int8 codes packed little-endian in one word
template <int E>
__device__ __forceinline__ float code(int w) { return (float)(int8_t)(w >> (8 * E)); }

// x*c + xr*s as the reference's kernel runs on XLA's CPU backend: xr*s
// rounded, then one fused multiply-add
__device__ __forceinline__ float rope_rn(float x, float xr, float c, float s) {
  return __fmaf_rn(x, c, __fmul_rn(xr, s));
}

template <class T>
__global__ void __launch_bounds__(NT) decode_attention_kernel(DecodeAttnArgs a) {
  extern __shared__ float sm[];  // q[D] | kd[D] | vd[D] | merge [NW][D + 2] | red[NW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.head_dim, half = D / 2, Hkv = a.n_kv_heads;
  const int reps = a.n_heads / Hkv;
  const int hq = blockIdx.x, kvh = hq / reps;
  const int pos = a.pos;
  float* q = sm;
  float* kd = sm + D;
  float* vd = sm + 2 * D;
  float* mrg = sm + 3 * D;
  float* red = mrg + NW * (D + 2);

  const T* qh = (const T*)a.q + (long)hq * D;
  const T* kh = (const T*)a.k + (long)kvh * D;
  const T* vh = (const T*)a.v + (long)kvh * D;
  const int d = threadIdx.x;
  float kr = 0.f, vr = 0.f;
  if (d < D) {
    const float c = a.cos[d], s = a.sin[d];
    const float qrot = d < half ? -to_f(qh[d + half]) : to_f(qh[d - half]);
    const float krot = d < half ? -to_f(kh[d + half]) : to_f(kh[d - half]);
    q[d] = rope_rn(to_f(qh[d]), qrot, c, s);
    kr = rope_rn(to_f(kh[d]), krot, c, s);
    vr = to_f(vh[d]);
  }
  const float kam = fmaxf(block_max(d < D ? fabsf(kr) : 0.f, red), 1e-8f);
  const float vam = fmaxf(block_max(d < D ? fabsf(vr) : 0.f, red), 1e-8f);
  const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
  if (d < D) {
    const float kq = fminf(fmaxf(rintf(__fdiv_rn(kr, ksc)), -127.f), 127.f);
    const float vq = fminf(fmaxf(rintf(__fdiv_rn(vr, vsc)), -127.f), 127.f);
    kd[d] = kq * ksc;
    vd[d] = vq * vsc;
    if (hq % reps == 0) {
      const long row = ((long)pos * Hkv + kvh) * D;
      a.ck[row + d] = (int8_t)kq;
      a.cv[row + d] = (int8_t)vq;
      if (d == 0) {
        a.ks[(long)pos * Hkv + kvh] = ksc;
        a.vs[(long)pos * Hkv + kvh] = vsc;
      }
    }
  }
  __syncthreads();

  const float scale = 1.f / sqrtf((float)D);
  // the new row seeds warp 0's online softmax
  float sn = 0.f;
  for (int i = threadIdx.x; i < D; i += NT) sn += q[i] * kd[i];
  sn = block_sum(sn, red) * scale;

  // lane owns values 4c..4c+3 for chunks c = lane + 32*j < D/4
  const int nc = D / 4;
  float qv[MAXC][4], acc[MAXC][4];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qv[j][e] = c < nc ? q[4 * c + e] : 0.f;
      acc[j][e] = (warp == 0 && c < nc) ? vd[4 * c + e] : 0.f;
    }
  }
  float m = warp == 0 ? sn : -INFINITY, l = warp == 0 ? 1.f : 0.f;

  const int8_t* kbase = a.ck + (long)kvh * D;
  const int8_t* vbase = a.cv + (long)kvh * D;
  const long stride = (long)Hkv * D;
  for (int t0 = warp; t0 < pos; t0 += NW * R) {
    int kw[R][MAXC], vw[R][MAXC];
    float ksr[R], vsr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * NW;
      const bool live = t < pos;
      const long row = live ? (long)t * stride : 0;
      ksr[r] = live ? __ldg(a.ks + (long)t * Hkv + kvh) : 0.f;
      vsr[r] = live ? __ldg(a.vs + (long)t * Hkv + kvh) : 0.f;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = lane + 32 * j;
        const bool on = live && c < nc;
        kw[r][j] = on ? __ldg((const int*)(kbase + row) + c) : 0;
        vw[r][j] = on ? __ldg((const int*)(vbase + row) + c) : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t0 + r * NW >= pos) continue;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int w = kw[r][j];
        p += qv[j][0] * (code<0>(w) * ksr[r]) + qv[j][1] * (code<1>(w) * ksr[r]) +
             qv[j][2] * (code<2>(w) * ksr[r]) + qv[j][3] * (code<3>(w) * ksr[r]);
      }
      const float s = warp_sum(p) * scale;
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn);
      const float e = expf(s - mn);
      l = l * corr + e;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int w = vw[r][j];
        acc[j][0] = acc[j][0] * corr + e * (code<0>(w) * vsr[r]);
        acc[j][1] = acc[j][1] * corr + e * (code<1>(w) * vsr[r]);
        acc[j][2] = acc[j][2] * corr + e * (code<2>(w) * vsr[r]);
        acc[j][3] = acc[j][3] * corr + e * (code<3>(w) * vsr[r]);
      }
      m = mn;
    }
  }
  float* mine = mrg + warp * (D + 2);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int c = lane + 32 * j;
    if (c < nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 * c + e] = acc[j][e];
    }
  }
  if (lane == 0) { mine[D] = m; mine[D + 1] = l; }
  __syncthreads();
  float* out = a.out + (long)hq * D;
  for (int i = threadIdx.x; i < D; i += NT) {
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[w * (D + 2) + D]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = mrg[w * (D + 2) + D];
      if (mw == -INFINITY) continue;  // a warp with no row
      const float c = expf(mw - M);
      L += mrg[w * (D + 2) + D + 1] * c;
      A += mrg[w * (D + 2) + i] * c;
    }
    out[i] = A / L;
  }
}

template <class T>
cudaError_t launch(const DecodeAttnArgs& a, cudaStream_t stream) {
  if (a.head_dim % 4 || a.head_dim > 4 * 32 * MAXC || a.head_dim > NT || a.head_dim < 2 ||
      a.n_kv_heads < 1 || a.n_heads % a.n_kv_heads || a.pos < 0 || a.pos >= a.max_len)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(3 * a.head_dim + NW * (a.head_dim + 2) + NW);
  decode_attention_kernel<T><<<dim3(a.n_heads), dim3(NT), smem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

// dtype (of q, k, v): 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_decode_attention(const DecodeAttnArgs* a, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? launch<float>(*a, s)
                  : dtype == 1 ? launch<__nv_bfloat16>(*a, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
