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
// cache and its scales, each read once from device memory, over the memory
// rate (3.35 TB/s): for Llama-2-7B one layer at pos 2047 is 17.3 MB, 5.2 us.
// The TPU kernel reads all T rows and masks them; exp(finfo.min - m) is
// exactly 0, so reading only the live rows gives the same result. The design
// does three things about the bound:
// - Split the live rows across the card (flash decoding). A work item is
//   (chunk of chunk_rows rows, kv head, sub-group of at most 8 of its q
//   heads, 4 above D = 128); the grid holds exactly the live chunks, sized on
//   the host from `pos` (ops/decode_attention.py::split_plan), so one layer
//   at a long position runs on the whole card, not on Hq blocks.
// - Read each kv row once for its GQA group: one item computes every q head
//   of its sub-group from the same staged rows, as the TPU kernel computes a
//   kv head's `reps` q heads from one read.
// - Keep bytes in flight: the chunk's rows stream as slabs (SR = 32 rows of
//   k codes, v codes and both scales; a row of one kv head is D contiguous
//   bytes at a stride of Hkv*D) through a ring of RING shared-memory stages
//   by cp.async, 16-byte pieces where D and the cache allow, RING - 1 slabs
//   in flight while one is computed. Rows past pos are neither copied nor
//   summed.
// Each warp of an item keeps an online softmax (m, l, acc) per q head in f32
// on the CUDA cores (M = 1 work: 4 flops a kv row and q head) over its rows
// of each slab, four rows at a time, so that a slab costs one barrier; a
// row's score is ks[t] * sum(q * code), its value weight p * vs[t] times the
// codes, each code made an exact float by a byte permute and an add. At D =
// 128 with at most 4 q heads an item (the served shapes) a quarter of the
// warp takes each of the four rows (QuadRows: a 16-byte load of codes a lane,
// a dot reduced over 8 lanes); otherwise the whole warp takes each row in
// turn (SplitRows). The item's q heads are roped once into shared memory.
// The warps merge in warp order, the item writes its partial to a
// workspace, and the last item of its (kv head, sub-group) to arrive merges
// the chunks' partials in chunk order (every head's max first, then the
// weighted sums, the loads of eight chunks in flight), so every launch gives
// the same bits. When the live rows fit in one chunk, the item writes
// the output directly.
//
// The new row is made once a kv head, where it is attended: only the items
// of the chunk that holds row pos rope and quantize their kv head's new k
// and v rows; the sub-group-0 item writes the codes and scales into the
// cache, and each of them places the row, as its own codes and scales, in
// its ring as the chunk's last row (the reference reads the row back after
// the write). No item reads row pos from memory, so none races the write.
// Every item ropes its own q heads from global q with the same operations,
// so the bits agree across items.
//
// Bitwise contract with the plain version (ops/decode_attention.py): the
// new row's codes and scales are computed with the same IEEE operations in
// the same order, those XLA's CPU backend runs for the reference kernel:
// RoPE as fma(x, cos, rot*sin) with rot*sin rounded first (explicit
// intrinsics, so nothing else is contracted), scale = amax * f32(1/127)
// (the reference's amax / 127.0 as XLA lowers it: a multiply by the f32
// reciprocal), code = rint(x/scale) as a correctly rounded division, rintf
// (round half to even, as torch.round and jnp.round). The output agrees to
// f32 rounding: its sums run in another order.
#include "decode_common.cuh"

struct DecodeAttnArgs {
  const void* q; const void* k; const void* v;  // [Hq*D], [Hkv*D], [Hkv*D]
  const float* cos; const float* sin;           // [D]
  int8_t* ck; int8_t* cv;                       // [T, Hkv, D]
  float* ks; float* vs;                         // [T, Hkv]
  float* out;                                   // [Hq*D]
  float* part;                                  // [Hq, n_chunks, D] acc | [Hq, n_chunks, 2] (m, l)
                                                // (n_chunks >= the live chunks)
  int* count;                                   // [Hkv, n_sub] arrivals, 0 between launches
                                                // (n_sub = ceil(Hq / Hkv / group))
  int n_heads, n_kv_heads, head_dim, max_len, pos;
  int chunk_rows, n_chunks, group;              // the split (ops/decode_attention.py::split_plan)
};

namespace {

using namespace mi;

constexpr int DT = 128;      // threads a block
constexpr int DW = DT / 32;  // warps a block
constexpr int RING = 4;      // slab stages; RING - 1 in flight during a slab's compute
constexpr int SR = 32;       // rows a slab (ops/decode_attention.py::SLAB_ROWS)
constexpr int MB = 8;        // chunks whose partials the last item loads at once

// The four int8 codes packed little-endian in w, as exact floats: each byte,
// offset by 128 (w ^ 0x80808080), under the exponent of 2^23 by one byte
// permute, then 2^23 + 128 taken off: one PRMT and one FADD a code, where an
// int-to-float conversion issues at a fraction of the FADD's rate.
__device__ __forceinline__ void codes4(int w, float* f) {
  const unsigned u = (unsigned)w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// x*c + xr*s as the reference's kernel runs on XLA's CPU backend: xr*s
// rounded, then one fused multiply-add
__device__ __forceinline__ float rope_rn(float x, float xr, float c, float s) {
  return __fmaf_rn(x, c, __fmul_rn(xr, s));
}

// Max over the block's DW warps; every thread gets it. `red` holds DW floats.
__device__ __forceinline__ float item_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red is free (an earlier call's reads are done)
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_max(lane < DW ? red[lane] : -INFINITY);
}

// One ring stage: k codes [SR][D], v codes [SR][D], k scales [SR], v scales [SR].
__host__ __device__ constexpr size_t stage_bytes(int D) { return (size_t)SR * (2 * D + 8); }

// Stages a launch allocates: one a slab of the chunk, at most RING.
__host__ __device__ constexpr int ring_stages(int chunk_rows) {
  return chunk_rows / SR < RING ? chunk_rows / SR : RING;
}

// Shared memory after the ring: the item's roped q heads [HG][D] (f32),
// the new row's k codes [D] and v codes [D], its two scales, red[DW].
__host__ __device__ constexpr size_t extras_bytes(int D, int HG) {
  return sizeof(float) * (size_t)HG * D + 2 * (size_t)D + sizeof(float) * (2 + DW);
}

// The softmax runs in base 2: a row's score is ks[t] * sum(q * code) *
// log2(e) / sqrt(D), m in the same units, the weights exp2(s - m).

// The lane-split layout (any D): a row's D codes over the warp's 32 lanes, 4
// codes a word, MC words a lane; a row's dot reduced over the warp.
template <int HG, int MC>
struct SplitRows {
  float q[HG][MC][4], m[HG], l[HG], acc[HG][MC][4];

  __device__ __forceinline__ void init(const float* qs, int nr, int D, int lane) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
#pragma unroll
      for (int j = 0; j < MC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * (lane + 32 * j) + e;
          q[h][j][e] = h < nr && d < D ? qs[h * D + d] : 0.f;
          acc[h][j][e] = 0.f;
        }
    }
  }

  // warp w takes rows w, w + DW, ... of a slab (codes kst/vst, rows of D
  // bytes; scales kss/vss; nrow live), four at a time (the first is live)
  __device__ __forceinline__ void slab(const int8_t* kst, const int8_t* vst, const float* kss,
                                      const float* vss, int nrow, int D, int warp, int lane,
                                      float scale2) {
    const int nc = D / 4;
    for (int r0 = warp; r0 < nrow; r0 += 4 * DW) {
      float s[4][HG], ksr[4], vsr[4], vf[4][MC][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i * DW;
        const bool live = r < nrow;
        float kf[MC][4];
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          const int cc = lane + 32 * j;
          const bool on = live && cc < nc;
          codes4(on ? ((const int*)(kst + (size_t)r * D))[cc] : 0, kf[j]);
          codes4(on ? ((const int*)(vst + (size_t)r * D))[cc] : 0, vf[i][j]);
        }
        ksr[i] = live ? kss[r] : 0.f;
        vsr[i] = live ? vss[r] : 0.f;
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < MC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) p = fmaf(q[h][j][e], kf[j][e], p);
          s[i][h] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < HG; ++h) s[i][h] = warp_sum(s[i][h]) * ksr[i] * scale2;
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float mx = s[0][h];
#pragma unroll
        for (int i = 1; i < 4; ++i)
          if (r0 + i * DW < nrow) mx = fmaxf(mx, s[i][h]);
        mx = fmaxf(mx, m[h]);
        {
          const float corr = exp2f(m[h] - mx);
          l[h] *= corr;
#pragma unroll
          for (int j = 0; j < MC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][j][e] *= corr;
          m[h] = mx;
        }
        // rows past the slab's live rows are skipped, never multiplied by 0
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r0 + i * DW >= nrow) break;
          const float p = exp2f(s[i][h] - m[h]);
          l[h] += p;
          const float pv = p * vsr[i];
#pragma unroll
          for (int j = 0; j < MC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][j][e] = fmaf(pv, vf[i][j][e], acc[h][j][e]);
        }
      }
    }
  }

  // the warp's (acc, m, l) of each head into wst [HG][D + 2]
  __device__ __forceinline__ void store(float* wst, int D, int lane) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int cc = lane + 32 * j;
        if (cc < D / 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) wst[h * (D + 2) + 4 * cc + e] = acc[h][j][e];
        }
      }
      if (lane == 0) { wst[h * (D + 2) + D] = m[h]; wst[h * (D + 2) + D + 1] = l[h]; }
    }
  }
};

// The row-group layout (D = 128, at most 4 heads): lane 8 g + s takes row
// r0 + g DW of each four rows of the warp and that row's columns 16 s ..
// 16 s + 15 (one 16-byte load of codes); a row's dot is reduced over 8 lanes,
// and each lane keeps (l, acc) over its own rows, added over the four row
// groups at the end. Per row this is a third of the lane-split layout's
// shuffles and exponentials.
template <int HG>
struct QuadRows {
  static constexpr int D = 128;
  float q[HG][16], m[HG], l[HG], acc[HG][16];

  __device__ __forceinline__ void init(const float* qs, int nr, int, int lane) {
    const int s16 = (lane & 7) * 16;
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        q[h][c] = h < nr ? qs[h * D + s16 + c] : 0.f;
        acc[h][c] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void slab(const int8_t* kst, const int8_t* vst, const float* kss,
                                      const float* vss, int nrow, int, int warp, int lane,
                                      float scale2) {
    const int g = lane >> 3, s16 = (lane & 7) * 16;
    for (int r0 = warp; r0 < nrow; r0 += 4 * DW) {
      const int r = r0 + g * DW;
      const bool live = r < nrow;
      int4 kw = make_int4(0, 0, 0, 0), vw = kw;
      float ksr = 0.f, vsr = 0.f;
      if (live) {
        kw = *(const int4*)(kst + r * D + s16);
        vw = *(const int4*)(vst + r * D + s16);
        ksr = kss[r];
        vsr = vss[r];
      }
      float kf[16], vf[16];
      codes4(kw.x, kf);
      codes4(kw.y, kf + 4);
      codes4(kw.z, kf + 8);
      codes4(kw.w, kf + 12);
      codes4(vw.x, vf);
      codes4(vw.y, vf + 4);
      codes4(vw.z, vf + 8);
      codes4(vw.w, vf + 12);
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 16; ++c) p4[c & 3] = fmaf(q[h][c], kf[c], p4[c & 3]);
        float p = (p4[0] + p4[1]) + (p4[2] + p4[3]);
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        const float sc = live ? p * ksr * scale2 : -INFINITY;
        float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        mx = fmaxf(mx, m[h]);
        {
          const float corr = exp2f(m[h] - mx);
          l[h] *= corr;
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[h][c] *= corr;
          m[h] = mx;
        }
        const float e = exp2f(sc - m[h]);  // 0 for a dead row
        l[h] += e;
        const float pv = e * vsr;
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[h][c] = fmaf(pv, vf[c], acc[h][c]);
      }
    }
  }

  __device__ __forceinline__ void store(float* wst, int, int lane) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 8);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 16);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], 8);
        acc[h][c] += __shfl_xor_sync(0xffffffffu, acc[h][c], 16);
      }
      if (lane < 8) {
#pragma unroll
        for (int c = 0; c < 16; ++c) wst[h * (D + 2) + lane * 16 + c] = acc[h][c];
      }
      if (lane == 0) { wst[h * (D + 2) + D] = m[h]; wst[h * (D + 2) + D + 1] = l[h]; }
    }
  }
};

// A partial of another item, from L2, issued in program order (a volatile
// load is not moved next to its use, so a batch of them is in flight at once)
__device__ __forceinline__ float ld_partial(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// T: q/k/v dtype. HG: q heads an item holds (a power of two >= a.group,
// the sub-group's). MC: 4-code words a lane holds of a row in the lane-split
// layout (D <= 128 * MC). QUAD: the row-group layout (D = 128, HG <= 4).
template <class T, int HG, int MC, bool QUAD>
__global__ void __launch_bounds__(DT, 1) decode_split_kernel(DecodeAttnArgs a, bool wide) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, n_live = gridDim.x;  // the live chunks: pos / chunk_rows + 1
  const int n_sub = gridDim.y / a.n_kv_heads;  // sub-groups of a kv head's q heads
  const int kvh = blockIdx.y / n_sub, sub = blockIdx.y - kvh * n_sub;
  const int D = a.head_dim, Hkv = a.n_kv_heads, pos = a.pos;
  const int T0 = c * a.chunk_rows;
  const int rows = min(a.chunk_rows, pos + 1 - T0);  // the chunk's live rows
  const int n_units = (rows + SR - 1) / SR;
  const bool holds_new = c == n_live - 1;            // row pos is this chunk's last row
  const int u_new = (pos - T0) / SR, r_new = pos - T0 - u_new * SR;
  const int R = a.n_heads / Hkv;
  const int h0 = kvh * R + sub * a.group;            // the item's first q head
  const int nr = min(HG, min(a.group, R - sub * a.group));  // HG >= a.group bounds the
                                                             // head loops for the compiler
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sb = stage_bytes(D);
  unsigned char* ring = smem;
  float* qs = (float*)(smem + ring_stages(a.chunk_rows) * sb);
  int8_t* nk = (int8_t*)(qs + HG * D);
  int8_t* nv = nk + D;
  float* nsc = (float*)(nv + D);
  float* red = nsc + 2;

  // the new row, from nk/nv/nsc, as row r of stage st
  auto place_new = [&](unsigned char* st, int r) {
    for (int i = tid; i < D / 4; i += DT) {
      ((int*)(st + (size_t)r * D))[i] = ((const int*)nk)[i];
      ((int*)(st + (size_t)(SR + r) * D))[i] = ((const int*)nv)[i];
    }
    if (tid == 0) {
      float* sc = (float*)(st + (size_t)2 * SR * D);
      sc[r] = nsc[0];
      sc[SR + r] = nsc[1];
    }
  };

  // this thread's pieces of a slab's k and v rows (16 bytes where `wide`,
  // else 4): pieces tid, tid + DT, ... of the rows' cpr pieces each, as
  // (row, piece) stepped by (dr, dp) without a division
  const int pb = wide ? 16 : 4, cpr = D / pb;
  const int r1 = tid / cpr, p1 = tid - r1 * cpr, dr = DT / cpr, dp = DT - dr * cpr;
  // slab u of the chunk (rows T0 + u*SR ...) into stage u % RING: its rows
  // t < pos from the cache (row pos is made here, not read); the new row is
  // placed by the threads once it is made. One commit group a call.
  auto fetch = [&](int u) {
    if (u < n_units) {
      const int t0 = T0 + u * SR;
      const int nmem = min(SR, pos - t0);
      unsigned char* st = ring + (size_t)(u % RING) * sb;
      const long stride = (long)Hkv * D;
      const int8_t* kg = a.ck + ((long)t0 * Hkv + kvh) * D;
      const int8_t* vg = a.cv + ((long)t0 * Hkv + kvh) * D;
      for (int r = r1, p = p1; r < nmem;) {
        const long g = r * stride + p * pb;
        unsigned char* s = st + (size_t)r * D + p * pb;
        if (wide) {
          cp_async16(s, kg + g, true);
          cp_async16(s + (size_t)SR * D, vg + g, true);
        } else {
          cp_async4(s, kg + g, true);
          cp_async4(s + (size_t)SR * D, vg + g, true);
        }
        r += dr;
        p += dp;
        if (p >= cpr) { p -= cpr; ++r; }
      }
      float* sc = (float*)(st + (size_t)2 * SR * D);
      for (int i = tid; i < 2 * nmem; i += DT) {
        const int kv = i >= nmem, r = i - kv * nmem;
        cp_async4(sc + kv * SR + r, (kv ? a.vs : a.ks) + (long)(t0 + r) * Hkv + kvh, true);
      }
      if (holds_new && u == u_new && u >= RING - 1) place_new(st, r_new);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < RING - 1; ++u) fetch(u);

  const int half = D / 2;
  if (holds_new) {
    // rope and quantize the kv head's new row while the first slabs land;
    // thread tid holds values d = tid + DT * i
    const T* kh = (const T*)a.k + (long)kvh * D;
    const T* vh = (const T*)a.v + (long)kvh * D;
    float kr[MC], vr[MC], kmx = 0.f, vmx = 0.f;
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      const int d = tid + DT * i;
      kr[i] = vr[i] = 0.f;
      if (d < D) {
        const float krot = d < half ? -to_f(kh[d + half]) : to_f(kh[d - half]);
        kr[i] = rope_rn(to_f(kh[d]), krot, a.cos[d], a.sin[d]);
        vr[i] = to_f(vh[d]);
        kmx = fmaxf(kmx, fabsf(kr[i]));
        vmx = fmaxf(vmx, fabsf(vr[i]));
      }
    }
    const float kam = fmaxf(item_max(kmx, red), 1e-8f);
    const float vam = fmaxf(item_max(vmx, red), 1e-8f);
    const float ksc = __fmul_rn(kam, KV_RCP), vsc = __fmul_rn(vam, KV_RCP);
    const long row = ((long)pos * Hkv + kvh) * D;
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      const int d = tid + DT * i;
      if (d < D) {
        const float kq = fminf(fmaxf(rintf(__fdiv_rn(kr[i], ksc)), -127.f), 127.f);
        const float vq = fminf(fmaxf(rintf(__fdiv_rn(vr[i], vsc)), -127.f), 127.f);
        nk[d] = (int8_t)kq;
        nv[d] = (int8_t)vq;
        if (sub == 0) {
          a.ck[row + d] = (int8_t)kq;
          a.cv[row + d] = (int8_t)vq;
        }
      }
    }
    if (tid == 0) {
      nsc[0] = ksc;
      nsc[1] = vsc;
      if (sub == 0) {
        a.ks[(long)pos * Hkv + kvh] = ksc;
        a.vs[(long)pos * Hkv + kvh] = vsc;
      }
    }
    __syncthreads();  // nk, nv, nsc complete
    if (u_new < RING - 1) place_new(ring + (size_t)u_new * sb, r_new);
  }

  // the item's q heads roped into shared memory, thread tid values tid + DT * i
  const T* qb = (const T*)a.q + (long)h0 * D;
  for (int d = tid; d < D; d += DT)
    for (int h = 0; h < nr; ++h) {
      const T* qh = qb + (long)h * D;
      const float rot = d < half ? -to_f(qh[d + half]) : to_f(qh[d - half]);
      qs[h * D + d] = rope_rn(to_f(qh[d]), rot, a.cos[d], a.sin[d]);
    }
  __syncthreads();
  std::conditional_t<QUAD, QuadRows<HG>, SplitRows<HG, MC>> rs;  // the rows' state
  rs.init(qs, nr, D, lane);
  const float scale2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(D)

  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<RING - 2>();  // slab u has landed (this thread's pieces)
    __syncthreads();            // ... every thread's; every warp is done with slab u - 1
    fetch(u + RING - 1);        // into the stage slab u - 1 left
    const unsigned char* stg = ring + (size_t)(u % RING) * sb;
    const int8_t* kst = (const int8_t*)stg;
    const float* kss = (const float*)(stg + (size_t)2 * SR * D);
    rs.slab(kst, kst + (size_t)SR * D, kss, kss + SR, min(SR, rows - u * SR), D, warp, lane,
            scale2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory holds the warps' states

  // the warps merge in warp order; thread tid takes columns tid + DT * i
  float* mrg = (float*)smem;  // [DW][HG][D + 2]
  rs.store(mrg + (size_t)warp * HG * (D + 2), D, lane);
  __syncthreads();
  float bm[HG], bl[HG], ba[HG][MC];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DW; ++w) M = fmaxf(M, mrg[(w * HG + h) * (D + 2) + D]);
    float L = 0.f, A[MC];
#pragma unroll
    for (int i = 0; i < MC; ++i) A[i] = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float* ws = mrg + (w * HG + h) * (D + 2);
      if (ws[D] == -INFINITY) continue;  // a warp with no live row
      const float x = exp2f(ws[D] - M);
      L = fmaf(ws[D + 1], x, L);
#pragma unroll
      for (int i = 0; i < MC; ++i)
        if (tid + DT * i < D) A[i] = fmaf(ws[tid + DT * i], x, A[i]);
    }
    bm[h] = M;
    bl[h] = L;
#pragma unroll
    for (int i = 0; i < MC; ++i) ba[h][i] = A[i];
  }

  float* out = a.out + (long)h0 * D;
  if (n_live == 1) {
#pragma unroll
    for (int h = 0; h < HG; ++h)
#pragma unroll
      for (int i = 0; i < MC; ++i)
        if (h < nr && tid + DT * i < D) out[(long)h * D + tid + DT * i] = ba[h][i] / bl[h];
    return;
  }
  const int nch = a.n_chunks;
  float* part = a.part + (long)h0 * nch * D;
  float* ml = a.part + (long)a.n_heads * nch * D + (long)h0 * nch * 2;
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (h >= nr) break;
#pragma unroll
    for (int i = 0; i < MC; ++i)
      if (tid + DT * i < D) part[((long)h * nch + c) * D + tid + DT * i] = ba[h][i];
    if (tid == 0) {
      ml[((long)h * nch + c) * 2] = bm[h];
      ml[((long)h * nch + c) * 2 + 1] = bl[h];
    }
  }
  // arrival: the block's writes, then one release by thread 0 (as a grid
  // barrier does); the last to arrive merges
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) {
    __threadfence();
    int* cnt = a.count + blockIdx.y;
    is_last = atomicAdd(cnt, 1) == n_live - 1;
    if (is_last) *cnt = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last item merges its heads' chunks: the chunks' (m, l) into shared
  // memory at once, each head's max M and the chunks' weights e^(m - M) (a
  // warp a head), then each thread its columns of every head, the weighted
  // sums in chunk order, the loads of MB chunks of every head in flight
  float* wsh = (float*)smem;        // [HG][n_live]: m, then e^(m - M)
  float* lsh = wsh + HG * n_live;   // [HG][n_live]
  for (int i = tid; i < nr * n_live; i += DT) {
    const int h = i / n_live, k = i - h * n_live;
    wsh[i] = ld_partial(ml + ((long)h * nch + k) * 2);
    lsh[i] = ld_partial(ml + ((long)h * nch + k) * 2 + 1);
  }
  __syncthreads();
  for (int h = warp; h < nr; h += DW) {
    float M = -INFINITY;
    for (int k = lane; k < n_live; k += 32) M = fmaxf(M, wsh[h * n_live + k]);
    M = warp_max(M);
    for (int k = lane; k < n_live; k += 32) wsh[h * n_live + k] = exp2f(wsh[h * n_live + k] - M);
  }
  __syncthreads();
  float L[HG], A[HG][MC];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    L[h] = 0.f;
#pragma unroll
    for (int i = 0; i < MC; ++i) A[h][i] = 0.f;
  }
  for (int k0 = 0; k0 < n_live; k0 += MB) {
    float x[MB][HG][MC];
#pragma unroll
    for (int j = 0; j < MB; ++j)
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int i = 0; i < MC; ++i) {  // head and column clamped, the chunk guarded
          x[j][h][i] = 0.f;
          if (k0 + j < n_live)
            x[j][h][i] = ld_partial(part + ((long)min(h, nr - 1) * nch + k0 + j) * D +
                                    min(tid + DT * i, D - 1));
        }
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      if (k0 + j >= n_live) break;
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        if (h >= nr) break;
        const float w = wsh[h * n_live + k0 + j];
        L[h] = fmaf(lsh[h * n_live + k0 + j], w, L[h]);
#pragma unroll
        for (int i = 0; i < MC; ++i) A[h][i] = fmaf(x[j][h][i], w, A[h][i]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HG; ++h)
#pragma unroll
    for (int i = 0; i < MC; ++i)
      if (h < nr && tid + DT * i < D) out[(long)h * D + tid + DT * i] = A[h][i] / L[h];
}

template <class T, int HG, int MC, bool QUAD>
cudaError_t launch(const DecodeAttnArgs& a, bool wide, cudaStream_t stream) {
  const int D = a.head_dim;
  const size_t ring = ring_stages(a.chunk_rows) * stage_bytes(D) + extras_bytes(D, HG);
  // the warps' states, then the last item's (m, l) and weights of its chunks
  const size_t warps = sizeof(float) * (size_t)DW * HG * (D + 2);
  const size_t chunks = sizeof(float) * 2 * HG * (size_t)a.n_chunks;
  const size_t merge = warps > chunks ? warps : chunks;
  const size_t smem = ring > merge ? ring : merge;
  if (smem > 40 * 1024) {  // the static is_last counts against the 48 KB default too
    const cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, HG, MC, QUAD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_sub = (a.n_heads / a.n_kv_heads + a.group - 1) / a.group;
  decode_split_kernel<T, HG, MC, QUAD><<<dim3(a.pos / a.chunk_rows + 1, a.n_kv_heads * n_sub),
                                         dim3(DT), smem, stream>>>(a, wide);
  return cudaSuccess;
}

// The instance whose HG holds the plan's sub-group of a.group q heads; none
// holds more than 8, or 4 above D = 128.
template <class T>
cudaError_t dispatch(const DecodeAttnArgs& a, bool wide, cudaStream_t s) {
  const int hg = a.group;
  if (hg > (a.head_dim <= 128 ? 8 : 4)) return cudaErrorInvalidValue;
  if (a.head_dim == 128 && hg <= 4) {  // the row-group layout
    if (hg <= 1) return launch<T, 1, 1, true>(a, wide, s);
    if (hg <= 2) return launch<T, 2, 1, true>(a, wide, s);
    return launch<T, 4, 1, true>(a, wide, s);
  }
  if (a.head_dim <= 128) {
    if (hg <= 1) return launch<T, 1, 1, false>(a, wide, s);
    if (hg <= 2) return launch<T, 2, 1, false>(a, wide, s);
    if (hg <= 4) return launch<T, 4, 1, false>(a, wide, s);
    return launch<T, 8, 1, false>(a, wide, s);
  }
  if (hg <= 1) return launch<T, 1, 2, false>(a, wide, s);
  if (hg <= 2) return launch<T, 2, 2, false>(a, wide, s);
  return launch<T, 4, 2, false>(a, wide, s);
}

}  // namespace

// dtype (of q, k, v): 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_decode_attention(const DecodeAttnArgs* a, int dtype, void* stream) {
  cudaGetLastError();
  const int D = a->head_dim;
  if (D % 4 || D < 4 || D > 256 || a->n_kv_heads < 1 || a->n_heads % a->n_kv_heads ||
      a->pos < 0 || a->pos >= a->max_len || a->chunk_rows < SR || a->chunk_rows % SR ||
      a->n_chunks < a->pos / a->chunk_rows + 1 || a->group < 1 ||
      (uintptr_t)a->ck % 4 || (uintptr_t)a->cv % 4)
    return (int)cudaErrorInvalidValue;
  // 16-byte pieces where every row starts on 16 bytes
  const bool wide = D % 16 == 0 && (uintptr_t)a->ck % 16 == 0 && (uintptr_t)a->cv % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch<float>(*a, wide, s)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(*a, wide, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
