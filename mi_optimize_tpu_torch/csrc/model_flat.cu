// The whole model in ONE cooperative launch: every decoder layer, the final
// rmsnorm, the packed lm_head and a first-index argmax, for one token
// (model_flat_kernel) or for kseg greedy tokens back to back
// (model_flat_seg_kernel).
//
// Replaces the TPU kernels mi_optimize_tpu/ops/model_flat.py::_kernel_flat
// (model_decode_flat) and mi_optimize_tpu/ops/model_flat_seg.py::
// _kernel_flat_seg (model_decode_flat_seg). What bounds them on an H100 is
// the packed weights of the whole model plus the lm_head (about 3.5 GB at
// Llama-2-7B, int4 g128) read once per token over the memory rate: token
// t + 1's first layer needs token t's argmax, so a segment cannot share a
// weight read between its tokens. The design runs the layers of
// decode_common.cuh back to back with the residual kept in f32 across all of
// them (grid barriers between phases, no launch between layers), then
// computes the logits with the same tiled dequant dot and folds a per-block
// (max, index) pair that block 0 reduces after one more barrier. Symmetric
// grids only: every bias is -zc*s from one constant per linear, so no bias
// table is read. The new k/v rows and scales of every layer go out for the
// caller to scatter into the merged [L, T, 2, Hkv, D] cache.
//
// Which loop each instance runs:
//   * 4-bit words, both kernels (model_flat_kernel<T, 4>,
//     model_flat_seg_kernel<T, 4>): the tensor-core layer loop of
//     flat_model.cuh (flat4_model, which model_mega4.cu's one-token kernel
//     without the lm_head runs too). Its GEMVs run on the tensor cores
//     (flat_gemv.cuh: the reference's grouped rescale, the row as exact bf16
//     planes of an n8 mma operand, every phase cut by the host's plan to fill
//     the grid, the next phase's first words in flight across each grid
//     barrier, the residual kept in shared memory); P2's history rows come
//     through a per-warp cp.async ring (attend_head<Hist, true>). The
//     multi-token kernel runs the one-token kernel's steps once for each of
//     its kseg tokens in the same launch (flat4_model's FgSeg): the same
//     plan, phases and rounding points, so that its tokens, rows and scales
//     are those of kseg one-token launches with the rows scattered between
//     them, bit for bit.
//   * 2- and 8-bit words: decode_common.cuh's CUDA-core decoder_layer and
//     tile_dot, the one-token kernel with its own copy of the layer loop and
//     lm phase, the multi-token kernel through flat_layer_args, set_layer and
//     lm_argmax.
//
// The multi-token kernel saves the launches and the host glue between
// tokens, which is what a few-layer draft model pays for. After token t's
// argmax every block reduces the blocks' pairs itself and reads the winner's
// embedding row directly (the TPU kernel streamed the whole table through a
// one-hot dot). Token t attends to the cache rows before the segment and
// then to the rows of tokens 0..t-1 of this launch, read back from the
// output buffers through L2, never L1 (SegHist); the caller writes all kseg
// rows into the cache after the launch.
#include "decode_common.cuh"
#include "flat_gemv.cuh"
#include "flat_model.cuh"

namespace {

using namespace mi;

template <int BITS>
__device__ __forceinline__ long words(long k) { return k / (32 / BITS); }

// Everything of LayerArgs that does not change between layers and tokens.
__device__ __forceinline__ LayerArgs flat_layer_args(const FlatArgs& f) {
  const int h = f.hidden, D = f.head_dim;
  const int qdim = f.n_heads * D, kvdim = f.n_kv_heads * D, nqkv = qdim + 2 * kvdim;
  LayerArgs a{};
  a.xres = f.scratch; a.x_out = nullptr;
  a.qkv_buf = f.scratch + h;
  a.attn_buf = a.qkv_buf + nqkv;
  a.xmid_buf = a.attn_buf + qdim;
  a.act_buf = a.xmid_buf + h;
  a.qb = a.ob = a.gub = a.db = nullptr;
  a.cos = f.cos; a.sin = f.sin;
  a.kv_stride = 2L * kvdim;
  a.s_stride = 2L * f.n_kv_heads;
  a.hidden = h; a.n_heads = f.n_heads; a.n_kv_heads = f.n_kv_heads; a.head_dim = D;
  a.inter = f.inter; a.pos = f.pos;
  a.g_qkv = f.g_qkv; a.g_o = f.g_o; a.g_gu = f.g_gu; a.g_d = f.g_d;
  a.zc_qkv = f.zc_qkv; a.zc_o = f.zc_o; a.zc_gu = f.zc_gu; a.zc_d = f.zc_d;
  a.eps = f.eps;
  return a;
}

// Layer l's weights and cache rows, and token t's output rows of layer l.
template <class T, int BITS>
__device__ __forceinline__ void set_layer(LayerArgs& a, const FlatArgs& f, int l, int t) {
  const int h = f.hidden, I = f.inter, Hkv = f.n_kv_heads;
  const int qdim = f.n_heads * f.head_dim, kvdim = Hkv * f.head_dim, nqkv = qdim + 2 * kvdim;
  a.n1 = (const T*)f.n1 + (long)l * h;
  a.n2 = (const T*)f.n2 + (long)l * h;
  a.qkv = f.qkv + (long)l * words<BITS>(h) * nqkv;
  a.qs = f.qs + (long)l * (h / f.g_qkv) * nqkv;
  a.o = f.o + (long)l * words<BITS>(qdim) * h;
  a.os = f.os + (long)l * (qdim / f.g_o) * h;
  a.gu = f.gu + (long)l * words<BITS>(h) * 2 * I;
  a.gus = f.gus + (long)l * (h / f.g_gu) * 2 * I;
  a.dn = f.dn + (long)l * words<BITS>(I) * h;
  a.ds = f.ds + (long)l * (I / f.g_d) * h;
  const int8_t* kvl = f.kv + (long)l * f.max_len * 2 * kvdim;
  const float* kvsl = f.kvs + (long)l * f.max_len * 2 * Hkv;
  a.ck = kvl; a.cv = kvl + kvdim;
  a.cks = kvsl; a.cvs = kvsl + Hkv;
  const long r = (long)t * f.n_layers + l;
  a.krow = f.kvrow + r * 2 * kvdim;
  a.vrow = a.krow + kvdim;
  a.ks_out = f.kvsc + r * 2 * Hkv;
  a.vs_out = a.ks_out + Hkv;
}

// Final rmsnorm of the residual, the lm_head logits, per-block (max, first
// index) pairs, and after a grid barrier block 0's reduction into *token.
template <class T, int BITS>
__device__ __forceinline__ void lm_argmax(const FlatArgs& f, const float* xres, float* part_val,
                                          float* vec, float* red, int* token) {
  cg::grid_group grid = cg::this_grid();
  const int h = f.hidden;
  stage_rmsnorm<T>(vec, nullptr, xres, (const T*)f.fnorm, h, f.eps, red);
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  const int ntiles = (f.vocab + 31) / 32;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int c0 = t * 32;
    const float v = tile_dot<BITS>(vec, h, f.ue, f.ues, nullptr, f.zc_ue, f.vocab, f.g_ue, c0,
                                   c0, f.vocab, red);
    if (threadIdx.x < 32) {
      const int n = c0 + threadIdx.x;
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      if (n < f.vocab) {
        f.logits[n] = v;
        bv = v; bi = n;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (bv > best || (bv == best && bi < best_i)) { best = bv; best_i = bi; }
    }
  }
  if (threadIdx.x == 0) { part_val[blockIdx.x] = best; f.part_idx[blockIdx.x] = best_i; }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float v = __ldcg(part_val + b);
      const int i = __ldcg(f.part_idx + b);
      if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
    }
    *token = bi;
  }
}

// The one-token kernel keeps its own copy of the layer loop and the lm phase
// (the multi-token kernel below reaches them through flat_layer_args,
// set_layer and lm_argmax): routing it through those helpers moved ptxas's
// register budget for it from 128 to 104. 4-bit words take flat4_model.
template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) model_flat_kernel(FlatArgs f) {
  extern __shared__ float smem[];
  if constexpr (BITS == 4) {
    FgFlat flat;
    flat4_model<T>(f, flat, smem);
  } else {
    float* red = smem;
    float* vec = smem + RED_FLOATS;
    cg::grid_group grid = cg::this_grid();

    const int h = f.hidden, D = f.head_dim, I = f.inter;
    const int qdim = f.n_heads * D, kvdim = f.n_kv_heads * D, nqkv = qdim + 2 * kvdim;
    float* xres = f.scratch;
    float* part_val = f.scratch + h + nqkv + qdim + h + I;

    LayerArgs a{};
    a.xres = xres; a.x_out = nullptr;
    a.qkv_buf = f.scratch + h;
    a.attn_buf = a.qkv_buf + nqkv;
    a.xmid_buf = a.attn_buf + qdim;
    a.act_buf = a.xmid_buf + h;
    a.qb = a.ob = a.gub = a.db = nullptr;
    a.cos = f.cos; a.sin = f.sin;
    a.kv_stride = 2L * kvdim;
    a.s_stride = 2L * f.n_kv_heads;
    a.hidden = h; a.n_heads = f.n_heads; a.n_kv_heads = f.n_kv_heads; a.head_dim = D;
    a.inter = I; a.pos = f.pos;
    a.g_qkv = f.g_qkv; a.g_o = f.g_o; a.g_gu = f.g_gu; a.g_d = f.g_d;
    a.zc_qkv = f.zc_qkv; a.zc_o = f.zc_o; a.zc_gu = f.zc_gu; a.zc_d = f.zc_d;
    a.eps = f.eps;

    for (int l = 0; l < f.n_layers; ++l) {
      a.x_t = l == 0 ? f.x : nullptr;
      a.n1 = (const T*)f.n1 + (long)l * h;
      a.n2 = (const T*)f.n2 + (long)l * h;
      a.qkv = f.qkv + (long)l * words<BITS>(h) * nqkv;
      a.qs = f.qs + (long)l * (h / f.g_qkv) * nqkv;
      a.o = f.o + (long)l * words<BITS>(qdim) * h;
      a.os = f.os + (long)l * (qdim / f.g_o) * h;
      a.gu = f.gu + (long)l * words<BITS>(h) * 2 * I;
      a.gus = f.gus + (long)l * (h / f.g_gu) * 2 * I;
      a.dn = f.dn + (long)l * words<BITS>(I) * h;
      a.ds = f.ds + (long)l * (I / f.g_d) * h;
      const int8_t* kvl = f.kv + (long)l * f.max_len * 2 * kvdim;
      const float* kvsl = f.kvs + (long)l * f.max_len * 2 * f.n_kv_heads;
      a.ck = kvl; a.cv = kvl + kvdim;
      a.cks = kvsl; a.cvs = kvsl + f.n_kv_heads;
      a.krow = f.kvrow + (long)l * 2 * kvdim;
      a.vrow = a.krow + kvdim;
      a.ks_out = f.kvsc + (long)l * 2 * f.n_kv_heads;
      a.vs_out = a.ks_out + f.n_kv_heads;
      decoder_layer<T, BITS>(a, vec, red);
      grid.sync();
    }

    // final rmsnorm, lm_head logits, per-block (max, first index)
    stage_rmsnorm<T>(vec, nullptr, xres, (const T*)f.fnorm, h, f.eps, red);
    float best = -INFINITY;
    int best_i = 0x7fffffff;
    const int ntiles = (f.vocab + 31) / 32;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int c0 = t * 32;
      const float v = tile_dot<BITS>(vec, h, f.ue, f.ues, nullptr, f.zc_ue, f.vocab, f.g_ue, c0,
                                     c0, f.vocab, red);
      if (threadIdx.x < 32) {
        const int n = c0 + threadIdx.x;
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        if (n < f.vocab) {
          f.logits[n] = v;
          bv = v; bi = n;
        }
  #pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        if (bv > best || (bv == best && bi < best_i)) { best = bv; best_i = bi; }
      }
    }
    if (threadIdx.x == 0) { part_val[blockIdx.x] = best; f.part_idx[blockIdx.x] = best_i; }
    grid.sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int b = 0; b < (int)gridDim.x; ++b) {
        const float v = __ldcg(part_val + b);
        const int i = __ldcg(f.part_idx + b);
        if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
      }
      f.token[0] = bi;
    }
  }
}

// P2 of token t of a segment: every q head over SegHist. rows/scales point at
// layer l's [2, Hkv, D] rows and [2, Hkv] scales of the segment's token 0 in
// the [kseg, L, ...] outputs.
struct SegAttention {
  const int8_t* rows;
  const float* scales;
  int L, pos0;
  __device__ __forceinline__ void operator()(const LayerArgs& a, float* sm, float* red) const {
    const int D = a.head_dim, Hkv = a.n_kv_heads, reps = a.n_heads / Hkv;
    const int qdim = a.n_heads * D, kvdim = Hkv * D;
    for (int hq = blockIdx.x; hq < a.n_heads; hq += gridDim.x) {
      const int kvh = hq / reps;
      const SegHist hh{a.ck + (long)kvh * D, a.cks + kvh, rows + (long)kvh * D, scales + kvh,
                       kvdim, Hkv, L, pos0, a.pos};
      attention_item(a.qkv_buf, a.cos, a.sin, hq, kvh, qdim, kvdim, D, hh, hq % reps == 0,
                     a.krow + (long)kvh * D, a.vrow + (long)kvh * D, a.ks_out + kvh,
                     a.vs_out + kvh, a.attn_buf + (long)hq * D, sm, red);
    }
  }
};

// 4-bit words take flat4_model (FgSeg); 2- and 8-bit words decoder_layer
// with SegAttention and lm_argmax, one more barrier passing each token on.
template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) model_flat_seg_kernel(FlatArgs f) {
  extern __shared__ float smem[];
  if constexpr (BITS == 4) {
    FgSeg seg;
    flat4_model<T>(f, seg, smem);
  } else {
    float* red = smem;
    float* vec = smem + RED_FLOATS;
    cg::grid_group grid = cg::this_grid();

    const int h = f.hidden, D = f.head_dim, I = f.inter, L = f.n_layers, Hkv = f.n_kv_heads;
    const int qdim = f.n_heads * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim;
    float* part_val = f.scratch + h + nqkv + qdim + h + I;

    LayerArgs a = flat_layer_args(f);
    for (int t = 0; t < f.kseg; ++t) {
      // token t's input: the first token's row, else the embedding row of the
      // token block 0 chose before the last barrier
      const T* xt = t == 0 ? (const T*)f.x : (const T*)f.emb + (long)__ldcg(f.token + t - 1) * h;
      a.cos = f.cos + (long)t * D;
      a.sin = f.sin + (long)t * D;
      a.pos = f.pos + t;
      for (int l = 0; l < L; ++l) {
        a.x_t = l == 0 ? xt : nullptr;
        set_layer<T, BITS>(a, f, l, t);
        const SegAttention attn{f.kvrow + (long)l * 2 * kvdim, f.kvsc + (long)l * 2 * Hkv, L,
                                f.pos};
        decoder_layer<T, BITS>(a, vec, red, attn);
        grid.sync();
      }
      lm_argmax<T, BITS>(f, a.xres, part_val, vec, red, f.token + t);
      if (t + 1 < f.kseg) grid.sync();
    }
  }
}

// The 4-bit kernels' plan against its scratch (flat_gemv.cuh):
// 1, 2, 4 or 8 warp strips a tile; K splits of whole groups (a group a
// multiple of 8 k that divides K), at least one group each, the lm_head
// unsplit; a staged window of a multiple of 64 k up to FG_KC_MAX; the
// partials of qkv, o_proj, gate/up and down_proj within n_part floats.
cudaError_t check_plan(const FlatArgs& f) {
  const int h = f.hidden, qdim = f.n_heads * f.head_dim;
  const int nqkv = qdim + 2 * f.n_kv_heads * f.head_dim;
  const int K[FG_GEMVS] = {h, qdim, h, f.inter, h};
  const int G[FG_GEMVS] = {f.g_qkv, f.g_o, f.g_gu, f.g_d, f.g_ue};
  if (!f.part || f.plan_kc < 64 || f.plan_kc > FG_KC_MAX || f.plan_kc % 64)
    return cudaErrorInvalidValue;
  for (int p = 0; p < FG_GEMVS; ++p) {
    const int ws = f.plan_ws[p], sp = f.plan_splits[p];
    if ((ws != 1 && ws != 2 && ws != 4 && ws != 8) || G[p] < 8 || G[p] % 8 || K[p] % G[p] ||
        sp < 1 || sp > K[p] / G[p])
      return cudaErrorInvalidValue;
  }
  if (f.plan_splits[4] != 1) return cudaErrorInvalidValue;
  const long need = (long)f.plan_splits[0] * nqkv + (long)f.plan_splits[2] * 2 * f.inter +
                    (long)(f.plan_splits[1] + f.plan_splits[3]) * h;
  return need <= (long)f.n_part ? cudaSuccess : cudaErrorInvalidValue;
}

template <class T, int BITS, bool SEG>
cudaError_t launch(const FlatArgs& f, cudaStream_t stream) {
  auto kern = SEG ? model_flat_seg_kernel<T, BITS> : model_flat_kernel<T, BITS>;
  constexpr bool MMA = BITS == 4;
  if (MMA) {
    const cudaError_t e = check_plan(f);
    if (e != cudaSuccess) return e;
  }
  const size_t smem = sizeof(float) * (size_t)(
      MMA ? fg_smem_floats(f.hidden, f.plan_kc, f.head_dim)
          : decode_smem_floats(f.hidden, f.n_heads * f.head_dim, f.inter, f.head_dim));
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, f.max_blocks, &grid);
  if (e != cudaSuccess) return e;
  FlatArgs a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T, bool SEG>
cudaError_t dispatch_bits(const FlatArgs& f, int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return launch<T, 2, SEG>(f, s);
    case 4: return launch<T, 4, SEG>(f, s);
    case 8: return launch<T, 8, SEG>(f, s);
  }
  return cudaErrorInvalidValue;
}

template <bool SEG>
int dispatch(const FlatArgs* f, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_bits<float, SEG>(*f, bits, s)
                  : dtype == 1 ? dispatch_bits<__nv_bfloat16, SEG>(*f, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each returns cudaGetLastError() after the launch.
extern "C" int mi_model_decode_flat(const FlatArgs* f, int bits, int dtype, void* stream) {
  return dispatch<false>(f, bits, dtype, stream);
}

extern "C" int mi_model_decode_flat_seg(const FlatArgs* f, int bits, int dtype, void* stream) {
  if (f->kseg < 1 || !f->emb) return (int)cudaErrorInvalidValue;
  return dispatch<true>(f, bits, dtype, stream);
}
