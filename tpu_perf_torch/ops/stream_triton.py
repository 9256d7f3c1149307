"""The wrap-add stream kernel, in Triton.

Replaces: ``tpu_perf/ops/pallas_ring.py`` ``_hbm_stream_vec_kernel``, the
TPU kernel of ``pl_hbm_stream``.  It computes the body of the XLA
``hbm_stream`` op: ``x * 1.0000001 + 1e-7`` for floats (both constants
first rounded to the working dtype, as the JAX kernel's numpy scalars are:
in bfloat16 the scale is exactly 1.0) and a wrapping ``x + 1`` for
integers.

Bound on an H100 (80 GB HBM3 at 3.35 TB/s): memory.  One read and one
write per element and one multiply-add; the card could do ~20 operations
per byte before arithmetic mattered.  The design is one fused pass: each
program loads one masked block (16 KiB), computes in registers and
stores it, so every byte crosses device memory exactly once each way.
The last partial block is masked, as the Pallas grid masks its last tile.
"""

from __future__ import annotations

import functools

import torch

from tpu_perf_torch import kernels

#: bytes each Triton program streams (this kernel's own tile; the JAX
#: package's VMEM tile is a TPU choice and does not apply here)
BLOCK_BYTES = 16384
_NUM_WARPS = 8


def stream_constants(dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) as 0-d tensors of ``dtype``: the constants rounded to
    the working type first, exactly like the JAX body.  A Python float
    scalar would make PyTorch multiply a bfloat16 tensor by the unrounded
    1.0000001 in float32 and give other numbers than JAX."""
    return (torch.tensor(1.0000001, dtype=dtype),
            torch.tensor(1e-7, dtype=dtype))


def stream_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: one elementwise pass, per dtype."""
    kernels.PLAIN_CALLS["stream"] += 1
    if not x.dtype.is_floating_point:
        return x + 1
    scale, shift = (c.to(x.device) for c in stream_constants(x.dtype))
    return x * scale + shift


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def stream_kernel(x_ptr, y_ptr, n_elems, scale, shift,
                      IS_FLOAT: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_elems
        x = tl.load(x_ptr + offs, mask=mask)
        if IS_FLOAT:
            # round after each operation, like the two-op JAX body
            y = (x * scale).to(x.dtype)
            y = (y + shift).to(x.dtype)
        else:
            y = (x + 1).to(x.dtype)
        tl.store(y_ptr + offs, y, mask=mask)

    return triton, stream_kernel


def stream(x: torch.Tensor) -> torch.Tensor:
    """One wrap-add pass over ``x`` (any shape, contiguous); returns a new
    tensor.  A CPU tensor runs the plain version, a CUDA tensor the Triton
    kernel; anything else raises."""
    if x.device.type == "cpu":
        return stream_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream runs on cuda or cpu tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("stream needs a contiguous tensor")
    triton, kern = _kernel()
    y = torch.empty_like(x)
    n_elems = x.numel()
    block = BLOCK_BYTES // x.element_size()
    is_float = x.dtype.is_floating_point
    scale, shift = ((float(c) for c in stream_constants(x.dtype))
                    if is_float else (1.0, 0.0))
    # no fused multiply-add: the body is two rounded operations, as in JAX
    # and in the plain version, so float32 results agree bit for bit
    kern[(triton.cdiv(n_elems, block),)](
        x, y, n_elems, scale, shift, IS_FLOAT=is_float, BLOCK=block,
        num_warps=_NUM_WARPS, enable_fp_fusion=False)
    kernels.LAUNCHES["stream"] += 1
    return y
