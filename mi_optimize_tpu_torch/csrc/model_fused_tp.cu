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
// once a launch, as batch_kernel. The phases are batch_kernel's (the device
// code of batch_common.cuh: the tensor-core GEMV for 4-bit words, the
// CUDA-core one for 2 and 8 bits, one attention item a (slot, q head)); the
// rows are at most 8 (NB = 8 instances only).
#include "batch_common.cuh"

// The launch's argument block, mirrored by ops/model_fused.py's _TpArgs.
struct TpArgs {
  BatchArgs b;         // the rank's stack, cache, rows and plan (no lm rows, one token a slot)
  const float* xin;    // f32 [B, h]: the residual before this half
  const float* add;    // f32 [B, h]: the reduced partial to add to it first, or null
  float* res;          // f32 [B, h]: xin + add, which this half's rmsnorm reads
  float* partial;      // f32 [B, h]: the rank's o_proj (half 0) or down_proj (half 1) partial
  int layer, half;
};

namespace {

using namespace mi;

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

  const int B = f.batch, h = f.hidden, I = f.inter, T_ = f.max_len, l = a.layer;
  const int H = f.n_heads, Hkv = f.n_kv_heads, reps = H / Hkv;
  const int qdim = H * D, kvdim = Hkv * D, nqkv = qdim + 2 * kvdim;
  float* qkvb = f.scratch;                // [B, nqkv]
  float* attn = qkvb + (long)B * nqkv;    // [B, qdim]
  float* act = attn + (long)B * qdim;     // [B, I]

  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < (long)B * h; i += (long)gridDim.x * NT)
    a.res[i] = a.add ? a.xin[i] + a.add[i] : a.xin[i];
  if constexpr (BITS == 4)
    for (int i = blockIdx.x * NT + threadIdx.x; i < f.n_counters; i += gridDim.x * NT)
      f.counters[i] = 0;
  grid.sync();
  row_rstd(rstd, a.res, B, h, f.eps, red);

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
    // one (slot, q head) a block: RoPE, the kv head's new rows, attention
    // over the slot's history t < pos[b] (dense, or through the page table)
    for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
      const int b = it / H, hq = it - b * H, kvh = hq / reps;
      const long c = ((long)l * B + b) * Hkv + kvh;  // (layer, slot, kv head)
      float* out = attn + (long)b * qdim + (long)hq * D;
      if constexpr (!GEN) {
        const HeadHist hh{f.ck + c * T_ * D, f.cv + c * T_ * D, f.cks + c * T_, f.cvs + c * T_,
                          (long)D, 1L, min(__ldg(f.pos + b), T_)};
        attention_item(qkvb + (long)b * nqkv, f.cos + (long)b * D, f.sin + (long)b * D, hq, kvh,
                       qdim, kvdim, D, hh, hq % reps == 0, f.krow + c * D, f.vrow + c * D,
                       f.ks + c, f.vs + c, out, xs, red);
      } else {
        const int p = min(__ldg(f.pos + b), f.pps * f.page_size);
        const PagedChunkHist hh = chunk_hist(f, l, b, kvh, p, p, c);
        attention_item(qkvb + (long)b * nqkv, f.cos + (long)b * D, f.sin + (long)b * D, hq, kvh,
                       qdim, kvdim, D, hh, hq % reps == 0, f.krow + c * D, f.vrow + c * D,
                       f.ks + c, f.vs + c, out, xs, red);
      }
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
  if (f.batch < 1 || f.batch > 8 || f.chunk != 1 || f.ue || !a.xin || !a.res || !a.partial ||
      a.half < 0 || a.half > 1 || a.layer < 0 || a.layer >= f.n_layers)
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
