// Mode (e) of the batched whole-model decode: one tensor-parallel rank's
// half of a decoder layer for B rows, over the rank's head and intermediate
// shard of the stack and of the cache (model_decode_mega_batch with tp > 1,
// in modes (a) dense and (b) paged).
//
// Replaces the TPU kernel mi_optimize_tpu/ops/model_fused.py::_kernel_b with
// tp > 1 (its in-kernel one-shot exchange of the o_proj and down_proj
// partials between chips, ops/model_fused.py:611-694, consumed at :922-930
// and :985-995).
//
// On the TPU the exchange happens inside the one launch a step: each chip
// sends every column chunk of its partial to its peers by remote DMA and
// adds theirs before the next rmsnorm. Here the reduction is a collective
// outside the kernel (torch.distributed all_reduce, NCCL between cards), so
// a step is two launches a layer: half 0 (the residual plus the reduced
// down_proj partial of the layer before, its rmsnorm, the rank's q/k/v
// columns, RoPE, its new int8 k/v rows and attention over its kv heads,
// and the o_proj partial over its q features) and half 1 (the residual plus
// the reduced o_proj partial, rmsnorm, the rank's gate/up columns, SiLU and
// the down_proj partial over its intermediate features). The residual and
// both rmsnorms are taken from the reduced rows, as the TPU kernel does
// (xmid = x + sum of partials; x_new = xmid + sum of partials), so the
// partials leave the kernel without a residual in their epilogue and the
// norms sum their rows' squares from the rows themselves.
//
// What bounds it on an H100: the rank's share of the stacked packed weights
// (half of a layer's words at tp = 2) and its kv heads' live history, read
// once a launch, as batch_kernel. The GEMV phases are batch_kernel's (the
// device code of batch_common.cuh: the tensor-core GEMV for 4-bit words,
// the CUDA-core one for 2 and 8 bits); the rows are at most 8 (NB = 8
// instances only). What the design does about the fixed costs a half-layer
// pays on top of its bytes:
// - The prologue writes res = xin + add, and after its grid barrier every
//   block sums the squares of all B rows of it in one pass, every load of a
//   column in flight at once (not a block reduction a row).
//   Without the barrier, each block summing xin + add itself, and with the
//   sums shared out (a block's run of the rows, added after the barrier),
//   the launch was slower on the H100 (PERF.md).
// - Half 0's attention is split over the live rows, as the decode
//   attention's (decode_attention.cu): a work item is (slot, kv head,
//   sub-group of at most TG of its q heads, chunk of chunk_rows live rows),
//   from the host plan on the shapes and the positions
//   (ops/model_fused.py::tp_split_plan), so the slot at the longest
//   position no longer walks its history on one block while the rest of the
//   grid waits at the next barrier; the item's q heads read each kv row
//   once. The slots' positions and first items ride in the argument block.
//   A warp takes rows w, w + 8, ... of the chunk, four at a time (their k
//   and v words and scales loaded together), in an online softmax a head in
//   base 2; the warps merge in warp order. The new row is made once, by the
//   items of the chunk that holds pos[b], with attention_item's arithmetic
//   (and the plain version's), stored by sub-group 0 and taken as the
//   chunk's last row from shared memory. A slot whose live rows fit one
//   chunk writes its output directly; otherwise each item writes its
//   partial (m, l, acc[D]) and the last item of its (slot, kv head,
//   sub-group) to arrive (an integer counter, left zero) merges the chunks
//   in chunk order (merging after one more grid barrier instead was no
//   faster on the H100: PERF.md). Dense and paged modes take the same
//   chunks and the same order, so their outputs are the same bits.
#include "batch_common.cuh"

// The launch's argument block, mirrored by ops/model_fused.py's _TpArgs.
struct TpArgs {
  BatchArgs b;         // the rank's stack, cache, rows and plan (no lm rows, one token a slot)
  const float* xin;    // f32 [B, h]: the residual before this half
  const float* add;    // f32 [B, h]: the reduced partial to add to it first, or null
  float* res;          // f32 [B, h]: xin + add, the next half's residual
  float* partial;      // f32 [B, h]: the rank's o_proj (half 0) or down_proj (half 1) partial
  // half 0's attention split (ops/model_fused.py::tp_split_plan): the
  // chunks' partials [B, H, n_chunks, D] acc then [B, H, n_chunks, 2] (m, l),
  // and one arrival counter a (slot, kv head, sub-group), zero on entry and
  // left zero
  float* apart;
  int* acount;
  int layer, half;
  int chunk_rows, n_chunks, group;  // rows a chunk; chunks a slot's workspace; q heads an item
  int slot_pos[8];                  // each slot's position (its new row's index)
  int slot_item[9];                 // slot b's items are [slot_item[b], slot_item[b + 1])
};

namespace {

using namespace mi;

constexpr int TG = 4;  // q heads an attention item holds at the most (2 above head_dim 128)

// The four int8 codes packed little-endian in w, as exact floats: each byte,
// offset by 128 (w ^ 0x80808080), under the exponent of 2^23 by one byte
// permute, then 2^23 + 128 taken off (decode_attention.cu's codes4).
__device__ __forceinline__ void codes4(int w, float* f) {
  const unsigned u = (unsigned)w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// rstd[m] = 1/sqrt(mean(x[m]^2) + eps) of the rows m < B <= NB of x [B, h]
// (h a multiple of 4, written earlier in the launch: read through L2), in
// one pass: a thread sums the squares of its float4 columns of every row,
// all its loads of a column in flight together, then the block adds the
// threads' sums in a fixed order. The caller syncs before rstd is read.
template <int NB>
__device__ __forceinline__ void sum_rstd(float* rstd, const float* x, int B, int h, float eps,
                                         float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ss[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) ss[m] = 0.f;
  for (int i = 4 * threadIdx.x; i < h; i += 4 * NT) {
    float4 v[NB];
#pragma unroll
    for (int m = 0; m < NB; ++m)
      v[m] = m < B ? __ldcg(reinterpret_cast<const float4*>(x + (long)m * h + i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < NB; ++m)
      ss[m] += (v[m].x * v[m].x + v[m].y * v[m].y) + (v[m].z * v[m].z + v[m].w * v[m].w);
  }
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const float t = warp_sum(ss[m]);
    if (lane == 0) red[warp * NB + m] = t;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += red[w * NB + threadIdx.x];
    rstd[threadIdx.x] = 1.f / sqrtf(t / (float)h + eps);
  }
}

// The chunks' partials of q heads h0 .. h0 + nr - 1 of slot b merged into
// out [nr, D]: every head's max over the n_live chunks first, then the
// weighted sums in chunk order (a.apart: acc [B, H, n_chunks, D], then (m,
// l) [B, H, n_chunks, 2]; written by other blocks of the launch, read
// through L2). Thread d < D takes column d; `ml` holds 2 * nr * n_live
// shared floats.
__device__ __forceinline__ void merge_chunks(const TpArgs& a, int b, int h0, int nr, int n_live,
                                             float* out, float* ml) {
  const BatchArgs& f = a.b;
  const int D = f.head_dim, nch = a.n_chunks, d = threadIdx.x;
  const long hq0 = (long)b * f.n_heads + h0;
  const float* pacc = a.apart;
  const float* pml = a.apart + (long)f.batch * f.n_heads * nch * D;
  for (int i = threadIdx.x; i < nr * n_live; i += NT) {
    const int h = i / n_live, k = i - h * n_live;
    ml[2 * i] = __ldcg(pml + ((hq0 + h) * nch + k) * 2);
    ml[2 * i + 1] = __ldcg(pml + ((hq0 + h) * nch + k) * 2 + 1);
  }
  __syncthreads();
  for (int h = 0; h < nr; ++h) {
    float M = -INFINITY;
    for (int k = 0; k < n_live; ++k) M = fmaxf(M, ml[2 * (h * n_live + k)]);
    float L = 0.f, A = 0.f;
    for (int k = 0; k < n_live; ++k) {
      const float x = exp2f(ml[2 * (h * n_live + k)] - M);
      L = fmaf(ml[2 * (h * n_live + k) + 1], x, L);
      if (d < D) A = fmaf(__ldcg(pacc + ((hq0 + h) * nch + k) * D + d), x, A);
    }
    if (d < D) out[(long)h * D + d] = A / L;
  }
}

// Shared floats of half 0's attention phase (attention_split<HG, MC>): the
// item's roped q heads [HG][D], the new row's codes and scales, the warps'
// states [NW][HG][D + 2] (then the last item's (m, l) of each chunk).
__host__ __device__ constexpr int tp_attn_floats(int HG, int D) {
  return HG * D + D / 2 + 2 + NW * HG * (D + 2);
}

// Half 0's attention, split over the live rows: every (slot b, chunk c of
// a.chunk_rows rows of 0..p_b, kv head, sub-group of a.group q heads) item,
// strided over the grid; p_b = a.slot_pos[b] is the new row's index.
// HG >= a.group bounds the heads an item holds; a lane holds MC words of 4
// codes of a row (D <= 128 * MC). A warp loads the codes and scales of its
// next four rows at once, straight from the cache (loading them while it
// multiplies the four before, or through a history ring in shared memory
// whose first rows are copied while the item makes its q heads and new
// row, was slower on the H100: PERF.md). Writes attn [B, H * D]; `sm` holds
// tp_attn_floats(HG, D) floats, `red` block_max's.
template <int HG, int MC>
__device__ __forceinline__ void attention_split(const TpArgs& a, const float* qkvb, float* attn,
                                                float* sm, float* red) {
  constexpr int RB = 4;  // rows a warp takes at once
  const BatchArgs& f = a.b;
  const int B = f.batch, D = f.head_dim, H = f.n_heads, Hkv = f.n_kv_heads, reps = H / Hkv;
  const int qdim = H * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim, half = D / 2;
  const int grp = a.group, n_sub = (reps + grp - 1) / grp, per = Hkv * n_sub;
  const int cr = a.chunk_rows, nch = a.n_chunks, l = a.layer;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw4 = D / 4;
  float* qs = sm;                                      // [HG][D]: the item's roped q heads
  int8_t* nk = reinterpret_cast<int8_t*>(qs + HG * D);  // [D]: the new row's k codes
  int8_t* nv = nk + D;                                  // [D]: its v codes
  float* nsc = qs + HG * D + D / 2;                     // its k and v scales
  float* mrg = nsc + 2;   // [NW][HG][D + 2]: the warps' states
  float* ml = mrg;        // the last item's (m, l) of each chunk, after the warps' states
  const float scale2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(D)
  // the items of slot b are [slot_item[b], slot_item[b + 1]), from the host
  // plan in the argument block (no load from memory on the way to an item)
  for (int it = blockIdx.x; it < a.slot_item[B]; it += gridDim.x) {
    int b = 0;
#pragma unroll
    for (int s = 1; s < 8; ++s) b += s < B && it >= a.slot_item[s];
    int rem = it, p = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      if (s == b) { rem -= a.slot_item[s]; p = a.slot_pos[s]; }
    const int n_live = p / cr + 1;
    const int c = rem / per, kvh = (rem - c * per) / n_sub, sub = rem - c * per - kvh * n_sub;
    const int t0 = c * cr, t1 = min(t0 + cr, p + 1);
    const bool holds_new = c == n_live - 1;  // row p is this chunk's last row
    const int h0 = kvh * reps + sub * grp, nr = min(grp, reps - sub * grp);
    const long ci = ((long)l * B + b) * Hkv + kvh;  // (layer, slot, kv head)
    const float* qkv = qkvb + (long)b * nqkv;
    const float* cs = f.cos + (long)b * D;
    const float* sn = f.sin + (long)b * D;
    const PagedChunkHist hh = chunk_hist(f, l, b, kvh, p, p, ci);
    const int n_w = t1 - t0 > warp ? (t1 - t0 - warp + NW - 1) / NW : 0;  // the warp's rows
    __syncthreads();  // the previous item's reads of shared memory are done
    for (int d = threadIdx.x; d < D; d += NT) {
      const float cd = cs[d], sd = sn[d];
      for (int h = 0; h < nr; ++h) {
        const float* qh = qkv + (long)(h0 + h) * D;
        const float qrot = d < half ? -__ldcg(qh + d + half) : __ldcg(qh + d - half);
        qs[h * D + d] = __ldcg(qh + d) * cd + qrot * sd;
      }
    }
    if (holds_new) {
      // RoPE on the kv head's new k row, its int8 codes and scales
      // (attention_item's arithmetic), stored by sub-group 0
      const float* kh = qkv + qdim + (long)kvh * D;
      const float* vh = qkv + qdim + kvdim + (long)kvh * D;
      const int d = threadIdx.x;
      float kr = 0.f, vr = 0.f;
      if (d < D) {
        const float cd = cs[d], sd = sn[d];
        const float krot = d < half ? -__ldcg(kh + d + half) : __ldcg(kh + d - half);
        kr = __ldcg(kh + d) * cd + krot * sd;
        vr = __ldcg(vh + d);
      }
      const float kam = fmaxf(block_max(d < D ? fabsf(kr) : 0.f, red), 1e-8f);
      const float vam = fmaxf(block_max(d < D ? fabsf(vr) : 0.f, red), 1e-8f);
      const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
      if (d < D) {
        const float kq = fminf(fmaxf(rintf(kr / ksc), -127.f), 127.f);
        const float vq = fminf(fmaxf(rintf(vr / vsc), -127.f), 127.f);
        nk[d] = (int8_t)kq;
        nv[d] = (int8_t)vq;
        if (sub == 0) {
          f.krow[ci * D + d] = (int8_t)kq;
          f.vrow[ci * D + d] = (int8_t)vq;
          if (d == 0) { f.ks[ci] = ksc; f.vs[ci] = vsc; }
        }
      }
      if (d == 0) { nsc[0] = ksc; nsc[1] = vsc; }
    }
    __syncthreads();

    // the warp's online softmax over its rows, RB at a time; q stays in
    // shared memory
    float m[HG], ls[HG], acc[HG][MC][4];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      m[h] = -INFINITY;
      ls[h] = 0.f;
#pragma unroll
      for (int j = 0; j < MC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
    }
    // the warp's rows i0 .. i0 + RB - 1 (rows past its n_w load nothing): a
    // lane's words of their codes, and their scales
    auto load = [&](int i0, int (&kw)[RB][MC], int (&vw)[RB][MC], float (&ksr)[RB],
                    float (&vsr)[RB]) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int t = t0 + warp + (i0 + i) * NW;
        const bool live = i0 + i < n_w;
        const int8_t* kr = nk;
        const int8_t* vr = nv;
        ksr[i] = vsr[i] = 0.f;
        if (live && t < p) hh.row(t, kr, vr, ksr[i], vsr[i]);
        else if (live) { ksr[i] = nsc[0]; vsr[i] = nsc[1]; }
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          const int cc = lane + 32 * j;
          const bool on = live && cc < nw4;
          kw[i][j] = on ? reinterpret_cast<const int*>(kr)[cc] : 0;
          vw[i][j] = on ? reinterpret_cast<const int*>(vr)[cc] : 0;
        }
      }
    };
    int kw[RB][MC], vw[RB][MC];
    float ksr[RB], vsr[RB];
    for (int i0 = 0; i0 < n_w; i0 += RB) {
      load(i0, kw, vw, ksr, vsr);
      float s[RB][HG];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float kf[MC][4];
#pragma unroll
        for (int j = 0; j < MC; ++j) codes4(kw[i][j], kf[j]);
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          float pp = 0.f;
          if (h < nr) {
#pragma unroll
            for (int j = 0; j < MC; ++j) {
              const int cc = min(lane + 32 * j, nw4 - 1);
              const float4 qv = *reinterpret_cast<const float4*>(qs + h * D + 4 * cc);
              pp = fmaf(qv.x, kf[j][0], pp);
              pp = fmaf(qv.y, kf[j][1], pp);
              pp = fmaf(qv.z, kf[j][2], pp);
              pp = fmaf(qv.w, kf[j][3], pp);
            }
            pp = warp_sum(pp) * ksr[i] * scale2;
          }
          s[i][h] = pp;
        }
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        if (h >= nr) break;
        float mx = s[0][h];
#pragma unroll
        for (int i = 1; i < RB; ++i)
          if (i0 + i < n_w) mx = fmaxf(mx, s[i][h]);
        mx = fmaxf(mx, m[h]);
        const float corr = exp2f(m[h] - mx);
        ls[h] *= corr;
#pragma unroll
        for (int j = 0; j < MC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][j][e] *= corr;
        m[h] = mx;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (i0 + i >= n_w) break;
          const float pe = exp2f(s[i][h] - mx);
          ls[h] += pe;
          const float pv = pe * vsr[i];
#pragma unroll
          for (int j = 0; j < MC; ++j) {
            float vf[4];
            codes4(vw[i][j], vf);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][j][e] = fmaf(pv, vf[e], acc[h][j][e]);
          }
        }
      }
    }
    // the warps' states, merged in warp order; thread d < D takes column d
    float* mine = mrg + warp * HG * (D + 2);
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      if (h >= nr) break;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int cc = lane + 32 * j;
        if (cc < nw4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[h * (D + 2) + 4 * cc + e] = acc[h][j][e];
        }
      }
      if (lane == 0) { mine[h * (D + 2) + D] = m[h]; mine[h * (D + 2) + D + 1] = ls[h]; }
    }
    __syncthreads();
    const int d = threadIdx.x;
    float bm[HG], bl[HG], ba[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      bm[h] = -INFINITY;
      bl[h] = ba[h] = 0.f;
      if (h >= nr) continue;
#pragma unroll
      for (int w = 0; w < NW; ++w) bm[h] = fmaxf(bm[h], mrg[(w * HG + h) * (D + 2) + D]);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* ws = mrg + (w * HG + h) * (D + 2);
        if (ws[D] == -INFINITY) continue;  // a warp with no row of the chunk
        const float x = exp2f(ws[D] - bm[h]);
        bl[h] = fmaf(ws[D + 1], x, bl[h]);
        if (d < D) ba[h] = fmaf(ws[d], x, ba[h]);
      }
    }
    float* out = attn + (long)b * qdim + (long)h0 * D;
    if (n_live == 1) {
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (h < nr && d < D) out[(long)h * D + d] = ba[h] / bl[h];
      continue;
    }
    // the item's partial, then its arrival; the last of its chunks merges them
    const long hq0 = (long)b * H + h0;  // the item's first q head of the [B, H] partials
    float* pacc = a.apart;
    float* pml = a.apart + (long)B * H * nch * D;
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      if (h >= nr) break;
      if (d < D) pacc[((hq0 + h) * nch + c) * D + d] = ba[h];
      if (d == 0) {
        pml[((hq0 + h) * nch + c) * 2] = bm[h];
        pml[((hq0 + h) * nch + c) * 2 + 1] = bl[h];
      }
    }
    __syncthreads();
    __shared__ int is_last;
    if (threadIdx.x == 0) {
      __threadfence();
      int* cnt = a.acount + ((long)b * Hkv + kvh) * n_sub + sub;
      is_last = atomicAdd(cnt, 1) == n_live - 1;
      if (is_last) *cnt = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!is_last) continue;
    __threadfence();
    merge_chunks(a, b, h0, nr, n_live, out, ml);
  }
}

template <class T, int BITS, bool GEN>
__global__ void __launch_bounds__(NT, COOP_PER_SM) tp_kernel(TpArgs a) {
  constexpr int NB = 8;
  extern __shared__ float smem[];
  const BatchArgs& f = a.b;
  const int D = f.head_dim;
  float* xs = smem;
  float* red = smem + batch_xs_floats(BITS, NB, D);
  float* rstd = red + batch_red_floats(BITS, NB);
  constexpr int NPN = NormPlanes<T>::n;
  cg::grid_group grid = cg::this_grid();

  const int B = f.batch, h = f.hidden, I = f.inter, l = a.layer;
  const int H = f.n_heads, Hkv = f.n_kv_heads;
  const int qdim = H * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim;
  float* qkvb = f.scratch;                // [B, nqkv]
  float* attn = qkvb + (long)B * nqkv;    // [B, qdim]
  float* act = attn + (long)B * qdim;     // [B, I]

  // res = xin + add and the GEMV tile counters zeroed, then one grid
  // barrier and every block's rmsnorm sums of all B rows of res, in one pass
  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < (long)B * h; i += (long)gridDim.x * NT)
    a.res[i] = a.add ? a.xin[i] + a.add[i] : a.xin[i];
  if constexpr (BITS == 4)
    for (int i = blockIdx.x * NT + threadIdx.x; i < f.n_counters; i += gridDim.x * NT)
      f.counters[i] = 0;
  grid.sync();
  sum_rstd<NB>(rstd, a.res, B, h, f.eps, red);
  __syncthreads();

  if (a.half == 0) {
    const long tq = (long)(h / f.g_qkv) * nqkv, to = (long)(qdim / f.g_o) * h;
    const T* n1 = (const T*)f.n1 + (long)l * h;
    phase_gemv<BITS, NB, NPN, 1>(
        f, 0, xs, red, B, h, RowsNorm<T>{a.res, h, n1, rstd},
        f.qkv + (long)l * words<BITS>(h) * nqkv, f.qs + l * tq, layer_tab(f.qb, tq, l),
        f.zc_qkv, nqkv, f.g_qkv, nqkv, 0, nullptr,
        [&](int m, int n, const float* v) {
          qkvb[(long)m * nqkv + n] = v[0];
          return 0.f;
        });
    grid.sync();
    // one q head an item (no GQA groups, Llama-2-7B) in the leanest registers
    if (D <= 128) {
      if (a.group == 1) attention_split<1, 1>(a, qkvb, attn, xs, red);
      else attention_split<TG, 1>(a, qkvb, attn, xs, red);
    } else {
      if (a.group == 1) attention_split<1, 2>(a, qkvb, attn, xs, red);
      else attention_split<TG / 2, 2>(a, qkvb, attn, xs, red);
    }
    grid.sync();
    // the o_proj partial over the rank's q features
    phase_gemv<BITS, NB, BG_PLANES, 1>(
        f, 1, xs, red, B, qdim, RowsCopy{attn, qdim},
        f.o + (long)l * words<BITS>(qdim) * h, f.os + l * to, layer_tab(f.ob, to, l), f.zc_o,
        h, f.g_o, h, 0, nullptr,
        [&](int m, int n, const float* v) {
          a.partial[(long)m * h + n] = v[0];
          return 0.f;
        });
  } else {
    const long tgu = (long)(h / f.g_gu) * 2 * I, td = (long)(I / f.g_d) * h;
    const T* n2 = (const T*)f.n2 + (long)l * h;
    phase_gemv<BITS, NB, NPN, 2>(
        f, 2, xs, red, B, h, RowsNorm<T>{a.res, h, n2, rstd},
        f.gu + (long)l * words<BITS>(h) * 2 * I, f.gus + l * tgu, layer_tab(f.gub, tgu, l),
        f.zc_gu, 2 * I, f.g_gu, I, I, nullptr,
        [&](int m, int n, const float* v) {
          act[(long)m * I + n] = v[0] * (1.f / (1.f + expf(-v[0]))) * v[1];
          return 0.f;
        });
    grid.sync();
    // the down_proj partial over the rank's intermediate features
    phase_gemv<BITS, NB, BG_PLANES, 1>(
        f, 3, xs, red, B, I, RowsCopy{act, I},
        f.dn + (long)l * words<BITS>(I) * h, f.ds + l * td, layer_tab(f.db, td, l), f.zc_d, h,
        f.g_d, h, 0, nullptr,
        [&](int m, int n, const float* v) {
          a.partial[(long)m * h + n] = v[0];
          return 0.f;
        });
  }
}

// The host's items a slot (TpArgs::slot_item) against its positions and
// split: slot b at position p < cap has p / chunk_rows + 1 chunks of
// n_kv_heads * ceil(reps / group) items.
inline bool items_ok(const TpArgs& a, int cap, int reps) {
  const BatchArgs& f = a.b;
  if (a.chunk_rows < 1 || a.group < 1 || a.slot_item[0] != 0) return false;
  const int per = f.n_kv_heads * ((reps + a.group - 1) / a.group);
  for (int b = 0; b < f.batch; ++b) {
    const int p = a.slot_pos[b];
    if (p < 0 || p >= cap || a.slot_item[b + 1] - a.slot_item[b] != (p / a.chunk_rows + 1) * per)
      return false;
  }
  return true;
}

template <class T, int BITS, bool GEN>
cudaError_t launch_tp(const TpArgs& f, cudaStream_t stream) {
  auto kern = tp_kernel<T, BITS, GEN>;
  const size_t smem = sizeof(float) * (size_t)batch_smem_floats(BITS, 8, f.b.head_dim);
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, f.b.max_blocks, &grid);
  if (e != cudaSuccess) return e;
  TpArgs a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T, int BITS>
cudaError_t dispatch_tp(const TpArgs& a, cudaStream_t s) {
  const BatchArgs& f = a.b;
  const int cap = f.table ? f.pps * f.page_size : f.max_len;
  const int reps = f.n_kv_heads > 0 ? f.n_heads / f.n_kv_heads : 0;
  if (f.batch < 1 || f.batch > 8 || f.chunk != 1 || f.ue || !a.xin || !a.res || !a.partial ||
      f.hidden % 4 ||
      a.half < 0 || a.half > 1 || a.layer < 0 || a.layer >= f.n_layers)
    return cudaErrorInvalidValue;
  // the attention split: whole heads an item, a workspace for every chunk
  if (a.half == 0 && (!a.apart || !a.acount || f.head_dim % 4 || f.head_dim > 256 ||
                      tp_attn_floats(f.head_dim <= 128 ? TG : TG / 2, f.head_dim) >
                          batch_xs_floats(BITS, 8, f.head_dim) ||
                      2 * a.n_chunks > NW * (f.head_dim + 2) ||
                      !items_ok(a, cap, reps) ||
                      reps < 1 || a.group < 1 || a.group > (f.head_dim <= 128 ? TG : TG / 2) ||
                      a.chunk_rows < 1 || (long)a.n_chunks * a.chunk_rows < cap))
    return cudaErrorInvalidValue;
  if (BITS == 4 && check_bg_plan(f) != cudaSuccess) return cudaErrorInvalidValue;
  return f.table ? launch_tp<T, BITS, true>(a, s) : launch_tp<T, BITS, false>(a, s);
}

template <class T>
cudaError_t dispatch_bits(const TpArgs& a, int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return dispatch_tp<T, 2>(a, s);
    case 4: return dispatch_tp<T, 4>(a, s);
    case 8: return dispatch_tp<T, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int mi_model_decode_mega_batch_tp(const TpArgs* a, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_bits<float>(*a, bits, s)
                  : dtype == 1 ? dispatch_bits<__nv_bfloat16>(*a, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
