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
// memory, over the memory rate (3.35 TB/s). The design does three things
// about it:
// - Split each slot's live rows across the card (flash decoding). A work
//   item is (slot, kv head, sub-group of at most 8 of its q heads, chunk of
//   chunk_pages pages); the grid holds every chunk of pps pages, sized on the
//   host from the table's shape, and items past a slot's last live row exit
//   at once (the positions stay on the card). One slot at a long position
//   thus runs on the whole card, not on H blocks.
// - Read each kv row once for its whole GQA group: one item computes every q
//   head of its sub-group from the same staged rows (the TPU kernel reads a
//   page once for all the slot's heads).
// - Keep bytes in flight: the chunk's live rows stream as slabs (sr rows of
//   one page and kv head, k and v) through a ring of RING stages in shared
//   memory by 16-byte cp.async, RING - 1 slabs in flight while one is
//   computed; rows past pos are neither copied nor summed (a whole-page
//   copy would bring them in, and 0 * NaN is NaN).
// Each warp of an item keeps an online softmax (m, l, acc) per q head in
// f32 on the CUDA cores (M = 1 work: 4 flops a kv row and head) over its
// rows of each slab, four rows at a time, so that a slab costs one barrier;
// the warps merge in warp order, the item writes its partial to the
// workspace, and the last item of its (slot, kv head, sub-group) to arrive
// merges the chunks' partials in chunk order (eight chunks' loads at once),
// so every launch gives the same bits. A slot whose live rows fit in one chunk writes its output
// directly (the merge of one partial is the same division).
#include "decode_common.cuh"

struct PagedArgs {
  const void* q;                  // [B, H*D]
  const void* pk; const void* pv; // [n_pages, P, Hkv, D]
  const int* table;               // [B, pps]
  const int* pos;                 // [B]
  void* out;                      // [B, H*D]
  float* part;                    // [B*H, n_chunks, D] acc | [B*H, n_chunks, 2] (m, l)
  int* count;                     // [B, Hkv, n_sub] arrivals, 0 between launches
  int batch, n_heads, n_kv_heads, head_dim, page_size, pps;
  int chunk_pages, n_chunks, slab_rows, n_sub;  // the split (ops/paged_attention.py::split_plan)
};

namespace {

using namespace mi;

constexpr int D = 128;          // head_dim: thread d owns column d of the PV sum
constexpr int PT = D;           // threads a block
constexpr int PW = PT / 32;     // warps a block
constexpr int RING = 4;         // slab stages; RING - 1 in flight during a slab's compute
constexpr int SR_MAX = 32;      // rows a slab

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *(const float4*)p;
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&v.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&v.y);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// The warps' (m, l) and acc of each head at the end of an item, in the
// ring's shared memory once the ring is drained.
template <int HG>
__host__ __device__ constexpr int merge_floats() { return PW * HG * (D + 2); }

// HG: q heads an item holds (a power of two >= the sub-group's, at most 8).
template <class TQ, class TKV, int HG>
__global__ void __launch_bounds__(PT) paged_split_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ring = (TKV*)smem;
  float* red = (float*)smem;  // after the ring: [PW][HG][D + 2]

  const int c = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.n_sub, sub = blockIdx.y - kvh * a.n_sub;
  const int P = a.page_size, sr = a.slab_rows, Hkv = a.n_kv_heads, H = a.n_heads;
  const int last = __ldg(a.pos + b);    // the slot's last live row
  const int crows = a.chunk_pages * P;
  const int T0 = c * crows;
  if (T0 > last) return;                // a chunk past the live rows: nothing to read
  const int n_live = last / crows + 1;  // the slot's live chunks
  const int n_units = (min(T0 + crows, last + 1) - T0 + sr - 1) / sr;
  const int R = H / Hkv;
  const int h0 = kvh * R + sub * HG;    // the item's first q head
  const int nr = min(HG, R - sub * HG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = 1.f / sqrtf((float)D);
  const size_t slab = (size_t)sr * D;   // elements of one k (or v) slab
  const TKV* pk = (const TKV*)a.pk;
  const TKV* pv = (const TKV*)a.pv;
  const int* tbl = a.table + (long)b * a.pps;

  // slab u of the chunk (rows T0 + u*sr ..., inside one page) into stage u % RING;
  // rows past `last` are not fetched. One commit group a call, empty or not.
  auto fetch = [&](int u) {
    if (u < n_units) {
      constexpr int CPR = D * (int)sizeof(TKV) / 16;  // 16-byte pieces a row
      constexpr int EPC = 16 / (int)sizeof(TKV);      // elements a piece
      const int t0 = T0 + u * sr;
      const long row0 = (long)__ldg(tbl + t0 / P) * P + t0 % P;
      const int nrow = min(sr, last + 1 - t0);
      TKV* st = ring + (size_t)(u % RING) * 2 * slab;
      for (int i = tid; i < 2 * nrow * CPR; i += PT) {
        const int kv = i >= nrow * CPR, rem = i - kv * nrow * CPR;
        const int r = rem / CPR, p = rem - r * CPR;
        const TKV* src = (kv ? pv : pk) + ((row0 + r) * Hkv + kvh) * D + p * EPC;
        cp_async16(st + kv * slab + (size_t)r * D + p * EPC, src, true);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < RING - 1; ++u) fetch(u);

  // q of the item's heads: lane holds elements 4*lane .. 4*lane + 3
  float q[HG][4];
  const TQ* qb = (const TQ*)a.q + ((long)b * H + h0) * D;
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) q[h][i] = h < nr ? to_f(qb[(long)h * D + 4 * lane + i]) : 0.f;
  float m[HG], l[HG], acc[HG][4];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[h][i] = 0.f;
  }

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<RING - 2>();  // slab u has landed (this thread's pieces)
    __syncthreads();            // ... every thread's; every warp is done with slab u - 1
    fetch(u + RING - 1);        // into the stage slab u - 1 left
    const TKV* ks = ring + (size_t)(u % RING) * 2 * slab;
    const TKV* vs = ks + slab;
    const int nrow = min(sr, last + 1 - (T0 + u * sr));
    // warp w takes the slab's rows w, w + PW, ..., four at a time (the
    // first of the four is live); lanes split D
    for (int r0 = warp; r0 < nrow; r0 += 4 * PW) {
      float s[4][HG], v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i * PW;
        float kf[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < nrow) {
          load4(ks + (size_t)r * D + 4 * lane, kf);
          load4(vs + (size_t)r * D + 4 * lane, v[i]);
        }
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          float p = q[h][0] * kf[0];
          p = fmaf(q[h][1], kf[1], p);
          p = fmaf(q[h][2], kf[2], p);
          s[i][h] = fmaf(q[h][3], kf[3], p);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < HG; ++h) s[i][h] = warp_sum(s[i][h]) * scale;
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float mx = s[0][h];
#pragma unroll
        for (int i = 1; i < 4; ++i)
          if (r0 + i * PW < nrow) mx = fmaxf(mx, s[i][h]);
        const float mn = fmaxf(m[h], mx);
        const float corr = expf(m[h] - mn);
        l[h] *= corr;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][e] *= corr;
        // rows past the slab's live rows are skipped, never multiplied by 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r0 + i * PW >= nrow) break;
          const float p = expf(s[i][h] - mn);
          l[h] += p;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(p, v[i][e], acc[h][e]);
        }
        m[h] = mn;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory holds the warps' states

  // the warps merge in warp order; thread tid takes column tid of each head
  float* wst = red + (size_t)warp * HG * (D + 2);
#pragma unroll
  for (int h = 0; h < HG; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) wst[h * (D + 2) + 4 * lane + e] = acc[h][e];
    if (lane == 0) { wst[h * (D + 2) + D] = m[h]; wst[h * (D + 2) + D + 1] = l[h]; }
  }
  __syncthreads();
  float bm[HG], bl[HG], ba[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < PW; ++w) M = fmaxf(M, red[(w * HG + h) * (D + 2) + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      const float* st = red + (w * HG + h) * (D + 2);
      if (st[D] == -INFINITY) continue;  // a warp with no live row
      const float x = expf(st[D] - M);
      L = fmaf(st[D + 1], x, L);
      A = fmaf(st[tid], x, A);
    }
    bm[h] = M;
    bl[h] = L;
    ba[h] = A;
  }

  const long bh0 = (long)b * H + h0;
  TQ* out = (TQ*)a.out;
  if (n_live == 1) {
#pragma unroll
    for (int h = 0; h < HG; ++h)
      if (h < nr) out[(bh0 + h) * D + tid] = from_f<TQ>(ba[h] / bl[h]);
    return;
  }
  const int nc = a.n_chunks;
  float* part = a.part;
  float* ml = a.part + (size_t)a.batch * H * nc * D;
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (h >= nr) break;
    part[((bh0 + h) * nc + c) * D + tid] = ba[h];
    if (tid == 0) {
      ml[((bh0 + h) * nc + c) * 2] = bm[h];
      ml[((bh0 + h) * nc + c) * 2 + 1] = bl[h];
    }
  }
  // arrival: the block's writes, then one release by thread 0 (as a grid
  // barrier does); the last to arrive merges
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) {
    __threadfence();
    int* cnt = a.count + ((long)b * Hkv + kvh) * a.n_sub + sub;
    is_last = atomicAdd(cnt, 1) == n_live - 1;
    if (is_last) *cnt = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last item merges the slot-head's chunks in chunk order, each thread
  // its column of each head: the (m, l) and acc of MB chunks loaded at once,
  // rescaled by the running max between batches of MB
  constexpr int MB = 8;
  for (int h = 0; h < nr; ++h) {
    const float* mlh = ml + (bh0 + h) * nc * 2;
    const float* ph = part + (bh0 + h) * nc * D + tid;
    float M = -INFINITY, L = 0.f, A = 0.f;
    for (int k0 = 0; k0 < n_live; k0 += MB) {
      float mk[MB], lk[MB], xk[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const bool on = k0 + j < n_live;
        mk[j] = on ? __ldcg(mlh + 2 * (k0 + j)) : -INFINITY;
        lk[j] = on ? __ldcg(mlh + 2 * (k0 + j) + 1) : 0.f;
        xk[j] = on ? __ldcg(ph + (long)(k0 + j) * D) : 0.f;
      }
      float Mn = M;
#pragma unroll
      for (int j = 0; j < MB; ++j) Mn = fmaxf(Mn, mk[j]);
      const float r = expf(M - Mn);  // 0 for the first batch
      L *= r;
      A *= r;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (k0 + j >= n_live) break;
        const float x = expf(mk[j] - Mn);
        L = fmaf(lk[j], x, L);
        A = fmaf(xk[j], x, A);
      }
      M = Mn;
    }
    out[(bh0 + h) * D + tid] = from_f<TQ>(A / L);
  }
}

template <class TQ, class TKV, int HG>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  const int R = a.n_heads / a.n_kv_heads;
  const int max_units = a.chunk_pages * a.page_size / a.slab_rows;
  const size_t ring = (size_t)(max_units < RING ? max_units : RING) * 2 * a.slab_rows * D *
                      sizeof(TKV);
  const size_t merge = sizeof(float) * merge_floats<HG>();
  const size_t smem = ring > merge ? ring : merge;
  if (a.n_sub != (R + HG - 1) / HG || a.n_chunks != (a.pps + a.chunk_pages - 1) / a.chunk_pages)
    return cudaErrorInvalidValue;
  if (smem > 40 * 1024) {  // the static is_last counts against the 48 KB default too
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<TQ, TKV, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_split_kernel<TQ, TKV, HG>
      <<<dim3(a.n_chunks, a.n_kv_heads * a.n_sub, a.batch), dim3(PT), smem, stream>>>(a);
  return cudaSuccess;
}

template <class TQ, class TKV>
cudaError_t dispatch_group(const PagedArgs& a, cudaStream_t s) {
  const int R = a.n_heads / a.n_kv_heads;
  const int hg = a.n_sub == 1 ? R : 8;  // the item's heads, at most 8
  if (hg <= 1) return launch<TQ, TKV, 1>(a, s);
  if (hg <= 2) return launch<TQ, TKV, 2>(a, s);
  if (hg <= 4) return launch<TQ, TKV, 4>(a, s);
  return launch<TQ, TKV, 8>(a, s);
}

template <class TQ>
cudaError_t dispatch_kv(const PagedArgs& a, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_group<TQ, float>(a, s);
    case 1: return dispatch_group<TQ, __nv_bfloat16>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype / kv_dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_paged_attention(const PagedArgs* a, int q_dtype, int kv_dtype, void* stream) {
  cudaGetLastError();
  if (a->batch < 1 || a->head_dim != D || a->n_kv_heads < 1 || a->n_heads % a->n_kv_heads ||
      a->page_size < 1 || a->pps < 1 || a->chunk_pages < 1 || a->slab_rows < 1 ||
      a->slab_rows > SR_MAX || a->page_size % a->slab_rows || a->n_sub < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = q_dtype == 0   ? dispatch_kv<float>(*a, kv_dtype, s)
                  : q_dtype == 1 ? dispatch_kv<__nv_bfloat16>(*a, kv_dtype, s)
                                 : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
