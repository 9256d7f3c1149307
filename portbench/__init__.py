"""The benchmark of the PyTorch / CUDA port (``tpu_perf_torch``): see
``portbench/README.md``."""
