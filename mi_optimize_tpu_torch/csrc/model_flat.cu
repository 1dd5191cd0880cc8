// The whole model for one token in ONE cooperative launch: every decoder
// layer, the final rmsnorm, the packed lm_head and a first-index argmax.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/model_flat.py::_kernel_flat
// (model_decode_flat). What bounds it on an H100 is the packed weights of the
// whole model plus the lm_head (about 3.5 GB at Llama-2-7B, int4 g128) read
// once per token over the memory rate. The design runs the layers of
// decode_common.cuh back to back with the residual kept in f32 across all of
// them (grid barriers between phases, no launch between layers), then
// computes the logits with the same tiled dequant dot and folds a per-block
// (max, index) pair that block 0 reduces after one more barrier. Symmetric
// grids only: every bias is -zc*s from one constant per linear, so no bias
// table is read. The new k/v rows and scales of every layer go out for the
// caller to scatter into the merged [L, T, 2, Hkv, D] cache.
#include "decode_common.cuh"

// Host-side argument block, mirrored field by field by the ctypes Structure
// in ops/model_flat.py. Stacked arrays carry a leading layer axis.
struct FlatArgs {
  const void* x;                     // model dtype [h] (embedding row)
  const void* n1; const void* n2;    // model dtype [L, h]
  const int32_t* qkv; const float* qs;   // [L, h/vpw, nqkv], [L, h/g, nqkv]
  const int32_t* o; const float* os;     // [L, qdim/vpw, h], [L, qdim/g, h]
  const int32_t* gu; const float* gus;   // [L, h/vpw, 2I], [L, h/g, 2I]
  const int32_t* dn; const float* ds;    // [L, I/vpw, h], [L, I/g, h]
  const int32_t* ue; const float* ues;   // [h/vpw, V], [h/g, V]
  const void* fnorm;                     // model dtype [h]
  const float* cos; const float* sin;    // [D]
  const int8_t* kv; const float* kvs;    // [L, T, 2, Hkv, D], [L, T, 2, Hkv]
  int* token; float* logits;             // [1], [V]
  int8_t* kvrow; float* kvsc;            // [L, 2, Hkv, D], [L, 2, 1, Hkv]
  float* scratch;  // f32: xres h | qkv nqkv | attn qdim | xmid h | act inter | part_val
  int* part_idx;   // [max_blocks]
  int n_layers, hidden, n_heads, n_kv_heads, head_dim, inter, vocab, max_len, pos;
  int g_qkv, g_o, g_gu, g_d, g_ue, max_blocks;
  float zc_qkv, zc_o, zc_gu, zc_d, zc_ue, eps;
};

namespace {

using namespace mi;

template <int BITS>
__device__ __forceinline__ long words(long k) { return k / (32 / BITS); }

template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) model_flat_kernel(FlatArgs f) {
  extern __shared__ float smem[];
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

template <class T, int BITS>
cudaError_t launch(const FlatArgs& f, cudaStream_t stream) {
  auto kern = model_flat_kernel<T, BITS>;
  const size_t smem = sizeof(float) * (size_t)decode_smem_floats(
      f.hidden, f.n_heads * f.head_dim, f.inter, f.head_dim);
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, f.max_blocks, &grid);
  if (e != cudaSuccess) return e;
  FlatArgs a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T>
cudaError_t dispatch_bits(const FlatArgs& f, int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return launch<T, 2>(f, s);
    case 4: return launch<T, 4>(f, s);
    case 8: return launch<T, 8>(f, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int mi_model_decode_flat(const FlatArgs* f, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_bits<float>(*f, bits, s)
                  : dtype == 1 ? dispatch_bits<__nv_bfloat16>(*f, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
