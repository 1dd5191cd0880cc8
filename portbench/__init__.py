"""The benchmark of the PyTorch / CUDA port (`mi_optimize_tpu_torch`): one
command runs one cell of BENCHMARK.json once (`portbench/run.py`)."""
