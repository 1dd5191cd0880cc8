// One decoder layer for one token (B = S = 1) in ONE cooperative launch, with
// 2- or 8-bit words.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/block_fused.py::_kernel
// (block_decode_mega) for 2- and 8-bit words; 4-bit words take the
// whole-model kernel's tensor-core layer loop at one layer
// (csrc/model_mega4.cu; ops/block_fused.py::block_route picks). What bounds
// it on an H100 is the packed weights of the layer (about 200 MB of int8
// words and scales at Llama-2-7B width) read once over the memory rate; the
// math is a few operations per byte. The design
// keeps every intermediate (qkv, attention, residual, MLP activation) in f32
// global scratch that stays in L2, reads each packed word once, and orders
// the five phases with grid barriers instead of five launches (see
// decode_common.cuh). The kernel emits only the new int8 k/v rows and their
// scales; the caller scatters them into the cache.
#include "decode_common.cuh"

// Host-side argument block, mirrored field by field by the ctypes Structure
// in ops/block_fused.py.
struct BlockArgs {
  const void* x; const void* n1; const void* n2;
  const int32_t* qkv; const float* qs; const float* qb;
  const int32_t* o; const float* os; const float* ob;
  const int32_t* gu; const float* gus; const float* gub;
  const int32_t* dn; const float* ds; const float* db;
  const float* cos; const float* sin;
  const int8_t* ck; const int8_t* cv; const float* cks; const float* cvs;
  void* x_out; int8_t* krow; int8_t* vrow; float* ks; float* vs;
  float* scratch;  // f32: xres h | qkv nqkv | attn qdim | xmid h | act inter
  int hidden, n_heads, n_kv_heads, head_dim, inter, pos;
  int g_qkv, g_o, g_gu, g_d;
  float eps;
};

namespace {

using namespace mi;

template <class T, int BITS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) block_decode_kernel(LayerArgs a) {
  extern __shared__ float smem[];
  float* red = smem;
  float* vec = smem + RED_FLOATS;
  decoder_layer<T, BITS>(a, vec, red);
}

template <class T, int BITS>
cudaError_t launch(const BlockArgs& b, cudaStream_t stream) {
  const int D = b.head_dim;
  const int qdim = b.n_heads * D, kvdim = b.n_kv_heads * D;
  LayerArgs a{};
  a.x_t = b.x; a.xres = b.scratch; a.x_out = b.x_out; a.n1 = b.n1; a.n2 = b.n2;
  a.qkv = b.qkv; a.qs = b.qs; a.qb = b.qb;
  a.o = b.o; a.os = b.os; a.ob = b.ob;
  a.gu = b.gu; a.gus = b.gus; a.gub = b.gub;
  a.dn = b.dn; a.ds = b.ds; a.db = b.db;
  a.ck = b.ck; a.cv = b.cv; a.cks = b.cks; a.cvs = b.cvs;
  a.krow = b.krow; a.vrow = b.vrow; a.ks_out = b.ks; a.vs_out = b.vs;
  a.cos = b.cos; a.sin = b.sin;
  a.qkv_buf = b.scratch + b.hidden;
  a.attn_buf = a.qkv_buf + qdim + 2 * kvdim;
  a.xmid_buf = a.attn_buf + qdim;
  a.act_buf = a.xmid_buf + b.hidden;
  a.kv_stride = (long)kvdim;
  a.s_stride = b.n_kv_heads;
  a.hidden = b.hidden; a.n_heads = b.n_heads; a.n_kv_heads = b.n_kv_heads;
  a.head_dim = D; a.inter = b.inter; a.pos = b.pos;
  a.g_qkv = b.g_qkv; a.g_o = b.g_o; a.g_gu = b.g_gu; a.g_d = b.g_d;
  a.eps = b.eps;

  auto kern = block_decode_kernel<T, BITS>;
  const size_t smem =
      sizeof(float) * (size_t)decode_smem_floats(b.hidden, qdim, b.inter, D);
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, 0, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

template <class T>
cudaError_t dispatch_bits(const BlockArgs& b, int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return launch<T, 2>(b, s);
    case 8: return launch<T, 8>(b, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// bits: 2 or 8; dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_block_decode(const BlockArgs* b, int bits, int dtype, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dtype == 0   ? dispatch_bits<float>(*b, bits, s)
                  : dtype == 1 ? dispatch_bits<__nv_bfloat16>(*b, bits, s)
                               : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
