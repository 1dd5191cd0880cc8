"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

  dequant_matmul  packed-int dequant matmul      <- ops/dequant_matmul.py::_kernel
  block_fused     one decoder layer, one launch  <- ops/block_fused.py::_kernel
  model_flat      whole model + lm_head + argmax <- ops/model_flat.py::_kernel_flat

Each module keeps a plain-int `launches` counter of its kernel launches.
"""
