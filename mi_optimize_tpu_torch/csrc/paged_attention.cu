// Paged flash decode: attention of one new token a slot over a float page
// pool, read through the page table (paged_flash_attention).
//
// Replaces the TPU kernel mi_optimize_tpu/ops/paged_attention.py::_kernel.
//
// Layout: q [B, H*D] (f32 or bf16), pk/pv [n_pages, P, Hkv, D] (f32 or
// bf16), table [B, pps] int32, pos [B] int32; out [B, H*D] in q's dtype.
// Slot b's row t is row t % P of page table[b][t / P]; rows t <= pos[b] are
// attended (the new row is already written), so only the live pages
// j <= pos[b] / P are ever read, as the reference's live-page clamp does.
//
// What bounds it on an H100: the live k/v rows, each read once from device
// memory (a q head of a GQA group reads its kv head's rows again, from L2),
// over the memory rate. The design is the simple one: one pass over the
// pages, no split over pages. One block per (slot, q head); each warp takes
// every NW-th live row (a lane holds D/32 elements of q and of the output),
// with the loads of R = 4 such rows in flight at once (one row's dependent
// loads at a time left the card idle: latency, not bytes, bounded it),
// keeps an online softmax in f32, and the warps merge at the end, as the
// decode kernels' attend_head does.
#include "decode_common.cuh"

struct PagedArgs {
  const void* q;                  // [B, H*D]
  const void* pk; const void* pv; // [n_pages, P, Hkv, D]
  const int* table;               // [B, pps]
  const int* pos;                 // [B]
  void* out;                      // [B, H*D]
  int batch, n_heads, n_kv_heads, head_dim, page_size, pps;
};

namespace {

using namespace mi;

template <class TQ, class TKV>
__global__ void __launch_bounds__(NT) paged_attention_kernel(PagedArgs a) {
  extern __shared__ float sm[];  // q[D] | merge [NW][D + 2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = a.n_heads, Hkv = a.n_kv_heads, D = a.head_dim, P = a.page_size;
  const int b = blockIdx.x / H, hq = blockIdx.x - b * H, kvh = hq / (H / Hkv);
  constexpr int MAXJ = 8;  // D <= 256
  const int nj = D / 32;
  const float scale = 1.f / sqrtf((float)D);
  float* q = sm;
  float* mrg = sm + D;

  const TQ* qb = (const TQ*)a.q + ((long)b * H + hq) * D;
  for (int d = threadIdx.x; d < D; d += NT) q[d] = to_f(qb[d]);
  __syncthreads();

  const TKV* pk = (const TKV*)a.pk;
  const TKV* pv = (const TKV*)a.pv;
  const int* tbl = a.table + (long)b * a.pps;
  const int last = a.pos[b];  // the last live row
  float m = -INFINITY, l = 0.f, acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  // each warp keeps R rows' loads in flight (rows t0, t0 + NW, ...) before
  // it folds them into its online softmax in row order
  constexpr int R = 4;
  for (int t0 = warp; t0 <= last; t0 += NW * R) {
    float kr[R][MAXJ], vr[R][MAXJ];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r * NW;
      const long row = t <= last ? (((long)__ldg(tbl + t / P) * P + t % P) * Hkv + kvh) * D : 0;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const bool on = t <= last && j < nj;
        kr[r][j] = on ? to_f(pk[row + lane + 32 * j]) : 0.f;
        vr[r][j] = on ? to_f(pv[row + lane + 32 * j]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t0 + r * NW > last) continue;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j)
        if (j < nj) p += q[lane + 32 * j] * kr[r][j];
      const float s = warp_sum(p) * scale;
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn);
      const float e = expf(s - mn);
      l = l * corr + e;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j)
        if (j < nj) acc[j] = acc[j] * corr + e * vr[r][j];
      m = mn;
    }
  }
  float* mine = mrg + warp * (D + 2);
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
    if (j < nj) mine[lane + 32 * j] = acc[j];
  if (lane == 0) { mine[D] = m; mine[D + 1] = l; }
  __syncthreads();
  TQ* out = (TQ*)a.out + ((long)b * H + hq) * D;
  for (int d = threadIdx.x; d < D; d += NT) {
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[w * (D + 2) + D]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = mrg[w * (D + 2) + D];
      if (mw == -INFINITY) continue;  // a warp with no live row
      const float c = expf(mw - M);
      L += mrg[w * (D + 2) + D + 1] * c;
      A += mrg[w * (D + 2) + d] * c;
    }
    out[d] = from_f<TQ>(A / L);
  }
}

template <class TQ, class TKV>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  if (a.batch < 1 || a.head_dim % 32 || a.head_dim > 256 || a.n_kv_heads < 1 ||
      a.n_heads % a.n_kv_heads || a.page_size < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(a.head_dim + NW * (a.head_dim + 2));
  paged_attention_kernel<TQ, TKV>
      <<<dim3(a.batch * a.n_heads), dim3(NT), smem, stream>>>(a);
  return cudaSuccess;
}

template <class TQ>
cudaError_t dispatch_kv(const PagedArgs& a, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(a, s);
    case 1: return launch<TQ, __nv_bfloat16>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype / kv_dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_paged_attention(const PagedArgs* a, int q_dtype, int kv_dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = q_dtype == 0   ? dispatch_kv<float>(*a, kv_dtype, s)
                  : q_dtype == 1 ? dispatch_kv<__nv_bfloat16>(*a, kv_dtype, s)
                                 : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
