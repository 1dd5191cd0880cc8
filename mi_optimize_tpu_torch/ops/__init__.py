"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

  dequant_matmul  packed-int dequant matmul      <- ops/dequant_matmul.py::_kernel
  block_fused     one decoder layer, one launch  <- ops/block_fused.py::_kernel
  model_flat      whole model + lm_head + argmax <- ops/model_flat.py::_kernel_flat
  model_flat_seg  kseg tokens of model_flat, one launch
                                                 <- ops/model_flat_seg.py::_kernel_flat_seg
  model_fused     whole model, one token or B rows (dense, paged, chunk, lm rows)
                                                 <- ops/model_fused.py::_kernel, ::_kernel_b
  paged_attention flash decode over a page pool  <- ops/paged_attention.py::_kernel
  decode_attention rope + int8 cache append + attention of one token
                                                 <- ops/decode_attention.py::_kernel
  mlp_fused       gate/up, SiLU * up and down in one launch
                                                 <- ops/mlp_fused.py::_kernel
  w4a8_matmul     int4 weights x int8 activations, exact int32 group sums
                                                 <- ops/w4a8_matmul.py::_kernel

Each module keeps a plain-int `launches` counter of its kernel launches.
"""
