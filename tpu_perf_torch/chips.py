"""Per-card hardware specs for the port: the counterpart of
``tpu_perf/chips.py`` for NVIDIA Hopper cards.

The table is keyed by the name ``torch.cuda.get_device_name()`` reports.
Its peaks are the published ones of NVIDIA's "H100 Tensor Core GPU"
data sheet, dense rates without sparsity, at each form factor's full
power limit: device-memory bandwidth, bf16 tensor-core rate, float32
rate outside the tensor cores and one direction of a card pair's NVLink.  A card set below its power limit runs
slower under load, so every number measured against these peaks is
written beside the card's power limit.

:func:`card_peak` gives one entry's peak for an instrument family and
dtype; ``grid --spec`` and ``bench`` both read their peaks through it.

No floor or nominal is copied from the JAX table: its floors are v5e
ratios, TPU numbers.  Every floor here stays ``None`` until a grid
measured on the card defends one.  An unknown card raises; it never
falls back to another card's figures (pass ``--spec-gbps`` instead).
"""

from __future__ import annotations

import dataclasses


class UnknownCardError(ValueError):
    """The card is not in the table: its peaks are not known here."""


@dataclasses.dataclass(frozen=True)
class CardSpec:
    """One card's published peaks and its measured operating floors."""

    kind: str          # short name ("h100-sxm")
    device_name: str   # what torch.cuda.get_device_name() reports
    hbm_gbps: float    # device-memory bandwidth, GB/s
    bf16_tflops: float  # dense bf16 tensor-core rate
    f32_tflops: float  # float32 outside the tensor cores
    # one direction of one card pair's NVLink, GB/s (the linkmap roofline,
    # the counterpart of the JAX table's per-link ici_gbps); None where
    # the data sheet gives no figure for a pair
    nvlink_gbps: float | None = None
    # the grid's degraded-window floor; None until measured on the card
    stream_floor_gbps: float | None = None


CARDS: dict[str, CardSpec] = {c.kind: c for c in (
    # SXM: 900 GB/s of NVLink a card, 450 each way to the NVSwitch fabric
    CardSpec("h100-sxm", "NVIDIA H100 80GB HBM3", hbm_gbps=3350.0,
             bf16_tflops=989.0, f32_tflops=67.0, nvlink_gbps=450.0),
    # PCIe and NVL: 600 GB/s over the NVLink bridge of a card pair, 300
    # each way (an unbridged pair talks over PCIe: --roofline-gbps)
    CardSpec("h100-pcie", "NVIDIA H100 PCIe", hbm_gbps=2000.0,
             bf16_tflops=756.0, f32_tflops=51.0, nvlink_gbps=300.0),
    CardSpec("h100-nvl", "NVIDIA H100 NVL", hbm_gbps=3900.0,
             bf16_tflops=835.0, f32_tflops=60.0, nvlink_gbps=300.0),
)}

_BY_NAME = {c.device_name.lower(): c for c in CARDS.values()}


def resolve_card(device_name: str) -> CardSpec | None:
    """The table entry for ``device_name``, or None when it is unknown."""
    return _BY_NAME.get(device_name.strip().lower())


#: the instrument families a peak is given for
PEAK_FAMILIES = ("hbm", "mxu")


def card_peak(spec: CardSpec, family: str, dtype: str = "float32") -> float:
    """``spec``'s published peak for one instrument family: ``hbm`` the
    device-memory rate in GB/s (any dtype), ``mxu`` the dense product rate
    in TFLOP/s of the dtype: the tensor-core rate for the 16-bit floats
    (bfloat16 and float16 share it on Hopper), the float32 rate outside
    the tensor cores for float32 (TF32 stays off).  Other dtypes have no
    compute peak and raise."""
    if family == "hbm":
        return spec.hbm_gbps
    if family == "mxu":
        if dtype in ("bfloat16", "float16"):
            return spec.bf16_tflops
        if dtype == "float32":
            return spec.f32_tflops
        raise ValueError(
            f"no compute peak for dtype {dtype!r}: the product runs "
            "float32, bfloat16 or float16")
    raise ValueError(
        f"unknown peak family {family!r}; known: {'|'.join(PEAK_FAMILIES)}")


def detected_name() -> str | None:
    """The first visible card's name, or None when no card is visible."""
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def card_spec(device_name: str | None = None) -> CardSpec:
    """The spec for ``device_name`` (default: the first visible card's).
    Raises :class:`UnknownCardError` for a card the table does not hold or
    when no card is visible."""
    if device_name is None:
        device_name = detected_name()
        if device_name is None:
            raise UnknownCardError(
                "no CUDA device is visible, so no card spec applies; give "
                "the peak explicitly with --spec-gbps / --spec-tflops")
    spec = resolve_card(device_name)
    if spec is None:
        raise UnknownCardError(
            f"card {device_name!r} is not in the spec table "
            f"({', '.join(c.device_name for c in CARDS.values())}); give its "
            "peak explicitly with --spec-gbps / --spec-tflops")
    return spec
