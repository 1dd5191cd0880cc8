// Every decoder layer in ONE cooperative launch, without the lm_head, for one
// token, with 4-bit words: model_decode_mega's tensor-core layer loop.
//
// Replaces the TPU kernel mi_optimize_tpu/ops/model_fused.py::_kernel
// (model_decode_mega) for 4-bit words; 2- and 8-bit words keep
// model_fused.cu's mega_kernel (ops/model_fused.py::mega_route picks).
//
// What bounds it on an H100: the stacked packed words and scales of every
// layer, plus the f32 bias tables of an asymmetric grid (a zero a group and
// column, as GPTQ's default grid gives), read once a token: 3.70 GB at
// Llama-2-7B int4 g128, 1.10 ms at 3.35 TB/s. The design is the flat
// kernel's: it runs the flat kernel's layer loop (flat_model.cuh::
// flat4_model, over flat_gemv.cuh) without the lm step:
//   * Each GEMV is the reference's grouped rescale on mma.m16n8k16, the row
//     as exact bf16 planes, cut into (column tile x K split) items by the
//     host's plan (ops/model_flat.py::flat_plan) so that each phase fills
//     the grid. Where a linear has a bias table, its BIAS instance copies a
//     group's biases beside its scales through the same ring (lane t = 1 of
//     a quad takes the biases where t = 0 takes the scales) and the group's
//     epilogue adds (b + 8s) * xsum; a linear without one takes -zc*s.
//   * The next step's first ring stages are issued before each grid
//     barrier, so that the words fly through the barrier (and for o_proj
//     through the attention phase).
//   * The residual stays in f32 in each block's shared memory; the splits'
//     partials are added in split order by the phase that reads them. After
//     the last down_proj and one more barrier the blocks add its partials
//     to the residual and write x_out, rounded once to the model dtype:
//     mega_kernel's rounding points.
//   * Attention reads the split cache [L, T, Hkv, D] (scales [L, T, Hkv])
//     and writes the new int8 rows [L, Hkv, D] and scales [L, Hkv] for the
//     caller to scatter, as mega_kernel does.
// The same bits on every launch: no float atomics.
#include "decode_common.cuh"
#include "flat_gemv.cuh"
#include "flat_model.cuh"
#include "mega_args.cuh"

constexpr int MG_GEMVS = 4;  // qkv, o_proj, gate/up, down_proj

// The flat kernel's argument block for the layer loop both kernels run (the
// stacked words, scales and norms, the shapes, the plan of
// ops/model_flat.py::flat_plans without the lm_head row in its first four
// entries, the f32 partials; no lm_head and no merged cache; f.scratch is
// m.scratch, whose attention row lies where the flat kernel's does), then
// MegaArgs for the bias tables, the split cache, x_out and the new rows.
// Mirrored by ops/model_fused.py::_Mega4Args.
struct Mega4Args {
  FlatArgs f;
  MegaArgs m;
};

namespace {

using namespace mi;

// mega4_kernel's X for flat4_model (flat_model.cuh): no lm step; step st's
// bias table (null: -zc*s), held in bt from its prime to its GEMV, and the
// block's bias ring; layer l's split cache, new rows and scales; x_out.
template <bool BIAS>
struct Mega4View {
  static constexpr bool kLm = false, kSeg = false, kBias = BIAS;
  const MegaArgs& m;
  int down_splits;
  float4* bring;
  const float* bt;

  __device__ __forceinline__ const float* table(int st) const {
    const int p = st & 3, h = m.hidden, I = m.inter, qdim = m.n_heads * m.head_dim;
    const int K[4] = {h, qdim, h, I}, G[4] = {m.g_qkv, m.g_o, m.g_gu, m.g_d};
    const int N[4] = {qdim + 2 * m.n_kv_heads * m.head_dim, h, 2 * I, h};
    const float* B[4] = {m.qb, m.ob, m.gub, m.db};
    return B[p] ? B[p] + (long)(st >> 2) * (K[p] / G[p]) * N[p] : nullptr;
  }

  __device__ __forceinline__ void cache(int l, LayerArgs& a) const {
    const int Hkv = m.n_kv_heads, kvdim = Hkv * m.head_dim;
    a.ck = m.ck + (long)l * m.max_len * kvdim;
    a.cv = m.cv + (long)l * m.max_len * kvdim;
    a.cks = m.cks + (long)l * m.max_len * Hkv;
    a.cvs = m.cvs + (long)l * m.max_len * Hkv;
    a.krow = m.krow + (long)l * kvdim;
    a.vrow = m.vrow + (long)l * kvdim;
    a.ks_out = m.ks + (long)l * Hkv;
    a.vs_out = m.vs + (long)l * Hkv;
  }

  // x_out = the residual plus the last down_proj's partials pd (added in
  // split order, as fg_residual adds them), rounded once; each block writes
  // its share.
  template <class T>
  __device__ __forceinline__ void finish(const FgSmem& sm, const float* pd) const {
    const int h = m.hidden;
    T* xo = (T*)m.x_out;
    for (int i = blockIdx.x * NT + threadIdx.x; i < h; i += gridDim.x * NT) {
      float acc = __ldcg(pd + i);
      for (int s = 1; s < down_splits; ++s) acc += __ldcg(pd + (long)s * h + i);
      xo[i] = from_f<T>(sm.vec[i] + acc);
    }
  }
};

// The flat kernel's layer loop over a4.f, without the lm step; the bias
// ring after the loop's shared memory in a BIAS instance.
template <class T, bool BIAS>
__global__ void __launch_bounds__(NT, COOP_PER_SM) mega4_kernel(Mega4Args a4) {
  extern __shared__ float smem[];
  float4* bring = BIAS ? reinterpret_cast<float4*>(
                             smem + fg_smem_floats(a4.f.hidden, a4.f.plan_kc, a4.f.head_dim))
                       : nullptr;
  Mega4View<BIAS> x{a4.m, a4.f.plan_splits[3], bring, nullptr};
  flat4_model<T>(a4.f, x, smem);
}

// The plan against its scratch: 1, 2, 4 or 8 warp strips a tile; K splits
// of whole groups (a group a multiple of 8 k that divides K), at least one
// group each; a staged window of a multiple of 64 k up to FG_KC_MAX; the
// partials within n_part floats.
cudaError_t check_plan(const Mega4Args& a4) {
  const FlatArgs& f = a4.f;
  const int h = f.hidden, qdim = f.n_heads * f.head_dim;
  const int nqkv = qdim + 2 * f.n_kv_heads * f.head_dim;
  const int K[MG_GEMVS] = {h, qdim, h, f.inter};
  const int G[MG_GEMVS] = {f.g_qkv, f.g_o, f.g_gu, f.g_d};
  if (!f.part || f.plan_kc < 64 || f.plan_kc > FG_KC_MAX || f.plan_kc % 64)
    return cudaErrorInvalidValue;
  for (int p = 0; p < MG_GEMVS; ++p) {
    const int ws = f.plan_ws[p], sp = f.plan_splits[p];
    if ((ws != 1 && ws != 2 && ws != 4 && ws != 8) || G[p] < 8 || G[p] % 8 || K[p] % G[p] ||
        sp < 1 || sp > K[p] / G[p])
      return cudaErrorInvalidValue;
  }
  const long need = (long)f.plan_splits[0] * nqkv + (long)f.plan_splits[2] * 2 * f.inter +
                    (long)(f.plan_splits[1] + f.plan_splits[3]) * h;
  return need <= (long)f.n_part ? cudaSuccess : cudaErrorInvalidValue;
}

template <class T, bool BIAS>
cudaError_t launch(const Mega4Args& f, cudaStream_t stream) {
  auto kern = mega4_kernel<T, BIAS>;
  const size_t smem = sizeof(float) * (size_t)(fg_smem_floats(f.f.hidden, f.f.plan_kc,
                                                              f.f.head_dim) +
                                               (BIAS ? FG_BRING_FLOATS : 0));
  int grid = 0;
  cudaError_t e = coop_grid(kern, smem, 0, &grid);
  if (e != cudaSuccess) return e;
  Mega4Args a = f;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(NT), args, smem,
                                     stream);
}

// The BIAS instance where any linear streams a bias table; a stack without
// tables (a symmetric grid) takes BIAS = false, which ran the symmetric 7B
// stack 2.7% faster than the BIAS instance with null tables
// (scripts/torch_mega4_times.py).
template <class T>
cudaError_t dispatch(const Mega4Args& f, cudaStream_t s) {
  const MegaArgs& m = f.m;
  return m.qb || m.ob || m.gub || m.db ? launch<T, true>(f, s) : launch<T, false>(f, s);
}

}  // namespace

// bits must be 4; dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch.
extern "C" int mi_model_decode_mega4(const Mega4Args* f, int bits, int dtype, void* stream) {
  cudaGetLastError();
  if (bits != 4) return (int)cudaErrorInvalidValue;
  cudaError_t e = check_plan(*f);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = dtype == 0   ? dispatch<float>(*f, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(*f, s)
                   : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
