// The argument block of the one-token whole-model kernels without the
// lm_head (model_decode_mega): model_fused.cu's mega_kernel takes it as it
// is, model_mega4.cu's mega4_kernel as the first member of its own.
// Mirrored field by field by ops/model_fused.py::_MegaArgs. Stacked arrays
// carry a leading layer axis; a null bias table means "use -zc*s".
#pragma once

#include <cstdint>

struct MegaArgs {
  const void* x;                                          // model dtype [h]
  const void* n1; const void* n2;                         // model dtype [L, h]
  const int32_t* qkv; const float* qs; const float* qb;   // [L, h/vpw, nqkv], [L, h/g, nqkv]
  const int32_t* o; const float* os; const float* ob;     // [L, qdim/vpw, h], [L, qdim/g, h]
  const int32_t* gu; const float* gus; const float* gub;  // [L, h/vpw, 2I], [L, h/g, 2I]
  const int32_t* dn; const float* ds; const float* db;    // [L, I/vpw, h], [L, I/g, h]
  const float* cos; const float* sin;                     // [D]
  const int8_t* ck; const int8_t* cv;                     // [L, T, Hkv, D]
  const float* cks; const float* cvs;                     // [L, T, Hkv]
  void* x_out;                                            // model dtype [h]
  int8_t* krow; int8_t* vrow; float* ks; float* vs;       // [L, Hkv, D], [L, Hkv]
  float* scratch;  // f32: xres h | qkv nqkv | attn qdim | xmid h | act inter (mega_kernel;
                   // mega4_kernel uses attn only, where the flat kernel has it)
  int n_layers, hidden, n_heads, n_kv_heads, head_dim, inter, max_len, pos;
  int g_qkv, g_o, g_gu, g_d;
  float zc_qkv, zc_o, zc_gu, zc_d, eps;
};
