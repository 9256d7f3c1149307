"""tpu_perf_torch — the PyTorch / CUDA port of tpu_perf.

The same benchmark (timed message-size sweeps of collectives and local
memory instruments, rows in the tpu_perf CSV schema), run on an NVIDIA
GPU instead of a TPU.  The JAX package ``tpu_perf`` is the reference;
this package imports nothing from it and keeps its own copies of what it
needs.  Module names mirror the JAX package's, so each counterpart is
easy to find.

On one card the ring collectives run in a *sim world*
(:mod:`tpu_perf_torch.world`): n ranks are the n rows of one CUDA
allocation and a "remote" copy is a device-memory copy done by the
kernel itself.  Rows from that world carry ``backend="torch-sim"`` so
nobody reads them as NVLink numbers.

Layers, entry point down:
  cli -> driver -> runner -> ops (collectives, pallas_ring, stream_triton)
  -> kernels (nvcc-built CUDA C++ under csrc/, Triton) -> the card.
"""

__version__ = "0.1.0"
