// Every decoder layer in ONE cooperative launch, without the lm_head: for one
// token (model_decode_mega with 2- and 8-bit words; 4-bit words take
// model_mega4.cu) and for B rows at their own positions
// (model_decode_mega_batch: slots of one token, or of a chunk of C tokens,
// over a dense cache or a page pool).
//
// Replaces the TPU kernels mi_optimize_tpu/ops/model_fused.py::_kernel
// (model_decode_mega) and ::_kernel_b in its modes (a) batched decode, (b)
// paged, (c) chunk and (d) terminal lm rows (model_decode_mega_batch).
//
// What bounds them on an H100: the stacked packed weights of the whole model
// (about 3.4 GB at Llama-2-7B, int4 g128, plus 0.2 GB of f32 bias tables on
// an asymmetric grid) read once per step over the memory rate, plus each
// slot's live int8 KV history. Both kernels run the five phases of
// decode_common.cuh per layer with grid barriers in place of launches and
// the residual kept in f32 across all layers; only x_out is rounded to the
// model dtype, after the last layer. Where a linear's zero is not one
// constant across the model its f32 bias table is streamed beside the
// scales; otherwise the bias is -zc*s in registers.
//
// The batched kernel reads each packed word ONCE per step and applies it to
// all B rows. With 4-bit words (every served model) its GEMV phases run on
// the tensor cores (batch_gemv.cuh): the reference's grouped rescale over
// centered codes, mma.m16n8k16 with the rows as an n8 operand, rows staged
// as exact bf16 planes a window of K at a time, each GEMV cut into (column
// tile x K split) items by the host's plan with the partials added in
// split order by each tile's last block. With 2- and 8-bit words a lane
// loads a word and its scale once, dequantizes each value once and keeps
// NB (>= B) accumulators; the B activation rows are staged in shared memory
// KC columns at a time (NB x KC floats, 32 KB at NB = 8). Either way the
// rows are staged a window at a time, not whole: at B = 8 the down
// projection's input alone would be 352 KB, more than a block may have.
// Attention runs one (slot, q head) work item per block, over the slot's
// head-transposed cache [L, B, Hkv, T, D] up to its own position (a free
// slot at position 0 has no history). New int8 rows and scales go out for
// the caller to scatter.
//
// Terminal lm rows (d), with any of the modes above: after the last layer,
// every row's final rmsnorm, its f32 logits over the packed lm_head (each
// word read once for all rows, by the layers' GEMV) and a first-index
// argmax: per-block (max, index) pairs a row, which block 0 reduces after
// one more grid barrier (model_flat.cu's lm phase, NB rows wide). It adds
// the lm_head's words and scales to the step's bytes. Launches with lm rows
// take instances of their own (LM = true, NB = 8), so the others compile
// as they did without them.
//
// Paged mode (b): the history of slot s is a page pool [L, n_pages, Hkv, P,
// D] read through the slot's page-table row: row t is row t % P of page
// table[s][t / P]. Only the addresses change, so the step moves the dense
// step's bytes. Chunk mode (c): rows s*C .. s*C + C-1 are C consecutive
// tokens of slot s; each attends to the slot's history t < positions[s*C]
// and to the chunk's rows before it, which other blocks write in the same
// layer. So P2 splits in two with a grid barrier between: (2a) RoPE and the
// int8 k/v rows of every (row, kv head), (2b) attention of every (row, q
// head) reading the chunk's rows back through L2. One-token decode keeps
// the single P2 and its barrier count. Paged and chunk launches take a
// second instance of the kernel (GEN = true, NB = 8 only, to bound the
// build), so the dense instances compile as before.
#include "batch_common.cuh"

namespace {

using namespace mi;

// ---------------------------------------------------------------------------
// model_decode_mega: B = S = 1
// ---------------------------------------------------------------------------

template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) mega_kernel(MegaArgs f) {
  extern __shared__ float smem[];
  float* red = smem;
  float* vec = smem + RED_FLOATS;
  cg::grid_group grid = cg::this_grid();

  const int h = f.hidden, D = f.head_dim, I = f.inter, L = f.n_layers;
  const int qdim = f.n_heads * D, kvdim = f.n_kv_heads * D, nqkv = qdim + 2 * kvdim;

  LayerArgs a{};
  a.xres = f.scratch;
  a.qkv_buf = f.scratch + h;
  a.attn_buf = a.qkv_buf + nqkv;
  a.xmid_buf = a.attn_buf + qdim;
  a.act_buf = a.xmid_buf + h;
  a.cos = f.cos; a.sin = f.sin;
  a.kv_stride = kvdim;
  a.s_stride = f.n_kv_heads;
  a.hidden = h; a.n_heads = f.n_heads; a.n_kv_heads = f.n_kv_heads; a.head_dim = D;
  a.inter = I; a.pos = f.pos;
  a.g_qkv = f.g_qkv; a.g_o = f.g_o; a.g_gu = f.g_gu; a.g_d = f.g_d;
  a.zc_qkv = f.zc_qkv; a.zc_o = f.zc_o; a.zc_gu = f.zc_gu; a.zc_d = f.zc_d;
  a.eps = f.eps;

  const long tq = (long)(h / f.g_qkv) * nqkv, to = (long)(qdim / f.g_o) * h;
  const long tgu = (long)(h / f.g_gu) * 2 * I, td = (long)(I / f.g_d) * h;
  for (int l = 0; l < L; ++l) {
    a.x_t = l == 0 ? f.x : nullptr;
    a.x_out = l == L - 1 ? f.x_out : nullptr;  // x_out rounded once, after the last layer
    a.n1 = (const T*)f.n1 + (long)l * h;
    a.n2 = (const T*)f.n2 + (long)l * h;
    a.qkv = f.qkv + (long)l * words<BITS>(h) * nqkv;
    a.qs = f.qs + l * tq; a.qb = layer_tab(f.qb, tq, l);
    a.o = f.o + (long)l * words<BITS>(qdim) * h;
    a.os = f.os + l * to; a.ob = layer_tab(f.ob, to, l);
    a.gu = f.gu + (long)l * words<BITS>(h) * 2 * I;
    a.gus = f.gus + l * tgu; a.gub = layer_tab(f.gub, tgu, l);
    a.dn = f.dn + (long)l * words<BITS>(I) * h;
    a.ds = f.ds + l * td; a.db = layer_tab(f.db, td, l);
    a.ck = f.ck + (long)l * f.max_len * kvdim;
    a.cv = f.cv + (long)l * f.max_len * kvdim;
    a.cks = f.cks + (long)l * f.max_len * f.n_kv_heads;
    a.cvs = f.cvs + (long)l * f.max_len * f.n_kv_heads;
    a.krow = f.krow + (long)l * kvdim;
    a.vrow = f.vrow + (long)l * kvdim;
    a.ks_out = f.ks + (long)l * f.n_kv_heads;
    a.vs_out = f.vs + (long)l * f.n_kv_heads;
    decoder_layer<T, BITS>(a, vec, red);
    if (l + 1 < L) grid.sync();
  }
}

// (max, first index) of two candidates.
__device__ __forceinline__ void arg_best(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
}

// Mode (d)'s logits with 2- and 8-bit words: the CUDA-core tile_dot_b over
// 32-column tiles, and this block's (max, first index) of each row into
// f.part_val / f.part_idx.
template <class T, int BITS, int NB>
__device__ __forceinline__ void lm_logits_cuda_core(const BatchArgs& f, const float* xres,
                                                    float* xs, float* red, const float* rstd) {
  const int B = f.batch, h = f.hidden, V = f.vocab;
  float best[NB];
  int best_i[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) { best[m] = -INFINITY; best_i[m] = 0x7fffffff; }
  const int ntiles = (V + 31) / 32;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n = t * 32 + (threadIdx.x & 31);
    float out[1][NB];
    tile_dot_b<BITS, NB, 1>(xs, B, h, RowsNorm<T>{xres, h, (const T*)f.fnorm, rstd}, f.ue, f.ues,
                            nullptr, f.zc_ue, V, f.g_ue, n, 0, n < V, red, out);
    if (threadIdx.x < 32) {
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m >= B) continue;
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        if (n < V) {
          f.logits[(long)m * V + n] = out[0][m];
          bv = out[0][m]; bi = n;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        if (bv > best[m] || (bv == best[m] && bi < best_i[m])) { best[m] = bv; best_i[m] = bi; }
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      f.part_val[(long)blockIdx.x * 8 + m] = best[m];
      f.part_idx[(long)blockIdx.x * 8 + m] = best_i[m];
    }
  }
}

// Mode (d)'s logits with 4-bit words: the tensor-core GEMV. A lane's
// outputs are rows 2t and 2t + 1 (t = lane % 4); it keeps the best of each
// over the columns it finishes, then the warp's lanes and the block's warps
// (in order) reduce them into f.part_val / f.part_idx.
template <class T>
__device__ __forceinline__ void lm_logits_mma(const BatchArgs& f, const float* xres, float* xs,
                                              float* red, const float* rstd) {
  static_assert(RED_FLOATS >= 2 * NW * 8, "the warps' (max, index) pairs fit in red");
  const int B = f.batch, h = f.hidden, V = f.vocab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bv[2] = {-INFINITY, -INFINITY};
  int bi[2] = {0x7fffffff, 0x7fffffff};
  bg_gemv<NormPlanes<T>::n, 1>(
      xs, B, h, RowsNorm<T>{xres, h, (const T*)f.fnorm, rstd}, f.ue, f.ues, nullptr, f.zc_ue, V,
      f.g_ue, V, 0, f.plan_ws[4], f.plan_splits[4], f.part, f.counters, nullptr,
      [&](int m, int n, const float* v) {
        f.logits[(long)m * V + n] = v[0];
        if (m & 1) arg_best(bv[1], bi[1], v[0], n);
        else arg_best(bv[0], bi[0], v[0], n);
        return 0.f;
      });
  int* red_i = reinterpret_cast<int*>(red) + NW * 8;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      arg_best(bv[e], bi[e], __shfl_xor_sync(0xffffffffu, bv[e], o),
               __shfl_xor_sync(0xffffffffu, bi[e], o));
    if (lane < 4) {
      red[warp * 8 + 2 * lane + e] = bv[e];
      red_i[warp * 8 + 2 * lane + e] = bi[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int m = threadIdx.x;
    float b = -INFINITY;
    int i = 0x7fffffff;
    for (int w = 0; w < NW; ++w) arg_best(b, i, red[w * 8 + m], red_i[w * 8 + m]);
    f.part_val[(long)blockIdx.x * 8 + m] = b;
    f.part_idx[(long)blockIdx.x * 8 + m] = i;
  }
}

// Mode (d): the final rmsnorm of every row, its logits and its first-index
// argmax into f.tokens, after the last layer's residual rows (the caller's
// grid barrier) are complete. Only the LM instances compile it: inside the
// other instances it raised the paged/chunk instance's spills (80 -> 96
// bytes) and made those launches 3-5% slower; as a call it made every
// instance 17% slower.
template <class T, int BITS, int NB>
__device__ __forceinline__ void lm_rows(const BatchArgs& f, const float* xres, float* xs,
                                        float* red, float* rstd) {
  cg::grid_group grid = cg::this_grid();
  const int B = f.batch;
  if (BITS == 4) bg_rstd(rstd, f.ssq, plan_tiles(f, 3), B, f.hidden, f.eps);
  else row_rstd(rstd, xres, B, f.hidden, f.eps, red);
  if constexpr (BITS == 4) lm_logits_mma<T>(f, xres, xs, red, rstd);
  else lm_logits_cuda_core<T, BITS, NB>(f, xres, xs, red, rstd);
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x < B) {
    const int m = threadIdx.x;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float v = __ldcg(f.part_val + (long)b * 8 + m);
      const int i = __ldcg(f.part_idx + (long)b * 8 + m);
      if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
    }
    f.tokens[m] = bi;
  }
}

template <class T, int BITS, int NB, bool GEN, bool LM>
__global__ void __launch_bounds__(NT, COOP_PER_SM) batch_kernel(BatchArgs f) {
  extern __shared__ float smem[];
  const int D = f.head_dim;
  float* xs = smem;  // the staged rows, or the attention buffers
  float* red = smem + batch_xs_floats(BITS, NB, D);
  float* rstd = red + batch_red_floats(BITS, NB);
  constexpr int NPN = NormPlanes<T>::n;  // bf16 planes of a normed row (an f32 row: BG_PLANES)
  cg::grid_group grid = cg::this_grid();

  const int B = f.batch, h = f.hidden, I = f.inter, L = f.n_layers, T_ = f.max_len;
  const int H = f.n_heads, Hkv = f.n_kv_heads, reps = H / Hkv;
  const int qdim = H * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim;
  float* xres = f.scratch;                    // [B, h] f32 residual
  float* qkvb = xres + (long)B * h;           // [B, nqkv]
  float* attn = qkvb + (long)B * nqkv;        // [B, qdim]
  float* xmid = attn + (long)B * qdim;        // [B, h]
  float* act = xmid + (long)B * h;            // [B, I]
  const T* x = (const T*)f.x;
  T* x_out = (T*)f.x_out;

  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < (long)B * h; i += (long)gridDim.x * NT)
    xres[i] = to_f(x[i]);
  if constexpr (BITS == 4)
    for (int i = blockIdx.x * NT + threadIdx.x; i < f.n_counters; i += gridDim.x * NT)
      f.counters[i] = 0;
  grid.sync();

  const long tq = (long)(h / f.g_qkv) * nqkv, to = (long)(qdim / f.g_o) * h;
  const long tgu = (long)(h / f.g_gu) * 2 * I, td = (long)(I / f.g_d) * h;
  for (int l = 0; l < L; ++l) {
    const T* n1 = (const T*)f.n1 + (long)l * h;
    const T* n2 = (const T*)f.n2 + (long)l * h;

    // P1: rmsnorm of every row (model-dtype rounding points) -> qkv; with
    // 4-bit words past layer 0 the rows' squares come from P5's tiles
    if (BITS == 4 && l > 0) bg_rstd(rstd, f.ssq, plan_tiles(f, 3), B, h, f.eps);
    else row_rstd(rstd, xres, B, h, f.eps, red);
    phase_gemv<BITS, NB, NPN, 1>(
        f, 0, xs, red, B, h, RowsNorm<T>{xres, h, n1, rstd},
        f.qkv + (long)l * words<BITS>(h) * nqkv, f.qs + l * tq, layer_tab(f.qb, tq, l),
        f.zc_qkv, nqkv, f.g_qkv, nqkv, 0, nullptr,
        [&](int m, int n, const float* v) {
          qkvb[(long)m * nqkv + n] = v[0];
          return 0.f;
        });
    grid.sync();

    // P2: one (slot, q head) per block: RoPE, new rows, attention over the
    // slot's history t < pos[b]
    if constexpr (!GEN) {
      for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
        const int b = it / H, hq = it - b * H, kvh = hq / reps;
        const long c = ((long)l * B + b) * Hkv + kvh;  // (layer, slot, kv head)
        const HeadHist hh{f.ck + c * T_ * D, f.cv + c * T_ * D, f.cks + c * T_, f.cvs + c * T_,
                          (long)D, 1L, min(__ldg(f.pos + b), T_)};
        attention_item(qkvb + (long)b * nqkv, f.cos + (long)b * D, f.sin + (long)b * D, hq, kvh,
                       qdim, kvdim, D, hh, hq % reps == 0, f.krow + c * D, f.vrow + c * D,
                       f.ks + c, f.vs + c, attn + (long)b * qdim + (long)hq * D, xs, red);
      }
    } else if (f.chunk == 1) {
      // paged decode: the dense item with the history read through the table
      const int cap = f.pps * f.page_size;
      for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
        const int b = it / H, hq = it - b * H, kvh = hq / reps;
        const long c = ((long)l * B + b) * Hkv + kvh;
        const int p = min(__ldg(f.pos + b), cap);
        const PagedChunkHist hh = chunk_hist(f, l, b, kvh, p, p, c);
        attention_item(qkvb + (long)b * nqkv, f.cos + (long)b * D, f.sin + (long)b * D, hq, kvh,
                       qdim, kvdim, D, hh, hq % reps == 0, f.krow + c * D, f.vrow + c * D,
                       f.ks + c, f.vs + c, attn + (long)b * qdim + (long)hq * D, xs, red);
      }
    } else {
      const int C = f.chunk;
      const int cap = f.table ? f.pps * f.page_size : T_;  // rows a slot holds
      // (2a) every row's int8 k/v rows, for the chunk's later rows to read
      for (int it = blockIdx.x; it < B * Hkv; it += gridDim.x) {
        const int r = it / Hkv, kvh = it - r * Hkv;
        const long c = ((long)l * B + r) * Hkv + kvh;
        chunk_kv_row(qkvb + (long)r * nqkv, f.cos + (long)r * D, f.sin + (long)r * D, kvh, qdim,
                     kvdim, D, f.krow + c * D, f.vrow + c * D, f.ks + c, f.vs + c, red);
      }
      grid.sync();
      // (2b) row s*C + i: history t < prefix, then the chunk's rows 0..i-1
      for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
        const int r = it / H, hq = it - r * H, kvh = hq / reps;
        const int s = r / C, i = r - s * C;
        const long c0 = ((long)l * B + s * C) * Hkv + kvh;
        const long c = c0 + (long)i * Hkv;
        const int prefix = min(__ldg(f.pos + s * C), cap);
        const PagedChunkHist hh = chunk_hist(f, l, s, kvh, prefix, prefix + i, c0);
        chunk_attend(qkvb + (long)r * nqkv, f.cos + (long)r * D, f.sin + (long)r * D, hq, D, hh,
                     f.krow + c * D, f.vrow + c * D, f.ks + c, f.vs + c,
                     attn + (long)r * qdim + (long)hq * D, xs, red);
      }
    }
    grid.sync();

    // P3: o_proj + residual
    phase_gemv<BITS, NB, BG_PLANES, 1>(
        f, 1, xs, red, B, qdim, RowsCopy{attn, qdim},
        f.o + (long)l * words<BITS>(qdim) * h, f.os + l * to, layer_tab(f.ob, to, l), f.zc_o,
        h, f.g_o, h, 0, f.ssq,
        [&](int m, int n, const float* v) {
          const float r = __ldcg(xres + (long)m * h + n) + v[0];
          xmid[(long)m * h + n] = r;
          return r;
        });
    grid.sync();

    // P4: rmsnorm, gate and up columns n and I + n from one staging, silu(g) * u
    if (BITS == 4) bg_rstd(rstd, f.ssq, plan_tiles(f, 1), B, h, f.eps);
    else row_rstd(rstd, xmid, B, h, f.eps, red);
    phase_gemv<BITS, NB, NPN, 2>(
        f, 2, xs, red, B, h, RowsNorm<T>{xmid, h, n2, rstd},
        f.gu + (long)l * words<BITS>(h) * 2 * I, f.gus + l * tgu, layer_tab(f.gub, tgu, l),
        f.zc_gu, 2 * I, f.g_gu, I, I, nullptr,
        [&](int m, int n, const float* v) {
          act[(long)m * I + n] = v[0] * (1.f / (1.f + expf(-v[0]))) * v[1];
          return 0.f;
        });
    grid.sync();

    // P5: down_proj + residual; the last layer also writes x_out
    const bool last = l == L - 1;
    phase_gemv<BITS, NB, BG_PLANES, 1>(
        f, 3, xs, red, B, I, RowsCopy{act, I},
        f.dn + (long)l * words<BITS>(I) * h, f.ds + l * td, layer_tab(f.db, td, l), f.zc_d, h,
        f.g_d, h, 0, f.ssq,
        [&](int m, int n, const float* v) {
          const float r = __ldcg(xmid + (long)m * h + n) + v[0];
          xres[(long)m * h + n] = r;
          if (last) x_out[(long)m * h + n] = from_f<T>(r);
          return r;
        });
    if (!last || LM) grid.sync();
  }
  if constexpr (LM) lm_rows<T, BITS, NB>(f, xres, xs, red, rstd);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class T, int BITS>
cudaError_t launch_mega(const MegaArgs& f, cudaStream_t stream) {
  auto kern = mega_kernel<T, BITS>;
  const size_t smem = sizeof(float) * (size_t)decode_smem_floats(
      f.hidden, f.n_heads * f.head_dim, f.inter, f.head_dim);
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, 0, &grid);
  if (e != cudaSuccess) return e;
  MegaArgs a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T, int BITS, int NB, bool GEN, bool LM>
cudaError_t launch_batch(const BatchArgs& f, cudaStream_t stream) {
  auto kern = batch_kernel<T, BITS, NB, GEN, LM>;
  const size_t smem = sizeof(float) * (size_t)batch_smem_floats(BITS, NB, f.head_dim);
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, f.max_blocks, &grid);
  if (e != cudaSuccess) return e;
  BatchArgs a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T, int BITS>
cudaError_t dispatch_nb(const BatchArgs& f, cudaStream_t s) {
  if (f.batch < 1 || f.batch > 8 || f.chunk < 1 || f.batch % f.chunk)
    return cudaErrorInvalidValue;
  if (BITS == 4 && check_bg_plan(f) != cudaSuccess) return cudaErrorInvalidValue;
  const bool gen = f.table || f.chunk > 1;
  if (f.ue)  // the lm rows take NB = 8 instances of their own
    return gen ? launch_batch<T, BITS, 8, true, true>(f, s)
               : launch_batch<T, BITS, 8, false, true>(f, s);
  if (gen) return launch_batch<T, BITS, 8, true, false>(f, s);
  if constexpr (BITS != 4) {  // 4-bit: the GEMV's n8 fragments hold 8 rows whatever B is
    if (f.batch <= 2) return launch_batch<T, BITS, 2, false, false>(f, s);
    if (f.batch <= 4) return launch_batch<T, BITS, 4, false, false>(f, s);
  }
  return launch_batch<T, BITS, 8, false, false>(f, s);
}

template <class T>
cudaError_t dispatch_mega(const MegaArgs& f, int bits, cudaStream_t s) {
  switch (bits) {  // 4-bit words: model_mega4.cu
    case 2: return launch_mega<T, 2>(f, s);
    case 8: return launch_mega<T, 8>(f, s);
  }
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t dispatch_batch(const BatchArgs& f, int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return dispatch_nb<T, 2>(f, s);
    case 4: return dispatch_nb<T, 4>(f, s);
    case 8: return dispatch_nb<T, 8>(f, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each returns cudaGetLastError() after the launch.
extern "C" int mi_model_decode_mega(const MegaArgs* f, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_mega<float>(*f, bits, s)
                  : dtype == 1 ? dispatch_mega<__nv_bfloat16>(*f, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int mi_model_decode_mega_batch(const BatchArgs* f, int bits, int dtype,
                                          void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_batch<float>(*f, bits, s)
                  : dtype == 1 ? dispatch_batch<__nv_bfloat16>(*f, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
