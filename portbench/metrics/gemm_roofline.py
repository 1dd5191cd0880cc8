"""gemm_roofline.<part> (`gemm_roofline.prefill`, `.ppl`): % of their roofline
that the tensor-core products reach over the traced window (the
dequant-matmul's `mma_kernel` with its split-K sum, the fused MLP's
`mlp_mma_kernel`): the summed bound of every product (2 M K N at 989
TFLOP/s, or its bytes at 3.35 TB/s where larger) over the kernels' summed
device time."""
from portbench import readers


def read(run):
    return readers.gemm_share(run)
