"""The single-card sim world (counterpart of ``tpu_perf/parallel/mesh.py``).

The JAX package runs its collectives on a named mesh; its tests fake a
mesh with 8 virtual CPU devices (``claim_cpu_devices``).  One H100 has no
peer, so this package fakes the ranks instead: n ranks are the n rows of
one ``(n, elems)`` tensor on one device.  A ring step's "remote copy" is a
device-memory copy the kernel does itself, from row ``left`` into row
``d``.

The state both packages compute on is the JAX package's *global* layout,
a ``(n * elems,)`` array sharded ``P(axis)``: device d holds elements
``[d*elems, (d+1)*elems)``.  :func:`to_world` and :func:`from_world`
convert between that layout and the sim world's rows.

The windowed exchange (``--window W``) has the JAX global shape
``(W, n * elems)`` sharded ``P(None, axis)``: device d holds
``[:, d*elems:(d+1)*elems]``, its W buffers.  The sim world keeps the rank
axis first, ``(n, W, elems)``: rank r's W buffers are row r, one
contiguous block as on a device, every row-wise body (the exchange's row
shift) moves all W buffers of a rank in one slice copy, and one
allocation holds every window.  W first would leave each rank's buffers
strided over the allocation and make the shift run along axis 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class NoDeviceError(RuntimeError):
    """A CUDA run was asked for (the default) and no card is visible."""


def resolve_device(name: str | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    ``"cpu"``.  Never drops to the CPU by itself."""
    name = name or "cuda"
    if name == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is visible; this entry point runs on the card "
            "(pass --device cpu / device='cpu' to run the plain PyTorch "
            "versions on the CPU)"
        )
    if name == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(name)


@dataclasses.dataclass(frozen=True)
class SimWorld:
    """n sim ranks on one device; rank r's buffer is row r."""

    n: int
    device: torch.device

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"a sim world needs at least one rank, got {self.n}")

    @property
    def backend(self) -> str:
        """The rows' backend column: a one-rank world measures the card
        itself; more ranks share it and measure an emulation."""
        return "torch-sim" if self.n > 1 else "torch"


def to_world(global_np: np.ndarray, n: int) -> np.ndarray:
    """JAX global layout -> sim-world rows: ``(n*elems,)`` -> ``(n, elems)``,
    and the windowed ``(W, n*elems)`` -> ``(n, W, elems)``."""
    arr = np.asarray(global_np)
    if arr.ndim == 2:
        w, total = arr.shape
        if total % n:
            raise ValueError(f"{total} elements do not split over {n} ranks")
        return np.ascontiguousarray(
            arr.reshape(w, n, total // n).transpose(1, 0, 2))
    flat = arr.reshape(-1)
    if flat.size % n:
        raise ValueError(f"{flat.size} elements do not split over {n} ranks")
    return flat.reshape(n, -1)


def from_world(t: torch.Tensor) -> np.ndarray:
    """Sim-world rows -> JAX global layout, on the host: ``(n, elems)`` ->
    ``(n*elems,)``, and the windowed ``(n, W, elems)`` -> ``(W, n*elems)``.
    bfloat16 has no numpy dtype and comes back as float32 (exact: every
    bfloat16 value is a float32 value)."""
    t = t.detach().cpu()
    if t.dim() == 3:
        t = t.transpose(0, 1).reshape(t.shape[1], -1)
    else:
        t = t.reshape(-1)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
