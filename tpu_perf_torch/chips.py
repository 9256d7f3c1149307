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

Each entry also carries the JAX table's operating constants: the
nominals (``bench``'s ``vs_baseline`` denominators) and the plateau
floors (a pass whose best p50 lands under its floor is a degraded window,
retried by ``bench`` and judged ``degraded`` by ``grid``).  The mxu ones
are kept by dtype, as the peaks are.  The ``h100-sxm`` constants are
measured on the card (``defended=True``):

* the stream floor and the stream / triad nominals from ``bench``'s
  ``hbm_stream`` and ``hbm_triad`` plateau points (384 MiB x 16 and
  256 MiB x 25), the mxu ones from ``mxu_gemm`` at m = 4096 in bfloat16
  and from ``grid --spec mxu``'s chosen float32 cell, each point's p50
  in separate processes (``python -m tpu_perf_torch.tools.plateaus``);
* a floor is the lowest plateau p50 seen less a margin: three times the
  pass-to-pass spread ((max - min) / median of the p50s), at least 5%,
  rounded down (``plateaus.floor_of``); stream and triad share one
  floor, under the lower of the two plateaus;
* a nominal is 0.9 of the median plateau p50 (``plateaus.nominal_of``),
  kept for bench's instruments only (float32 has a floor, no nominal);
* ``allreduce_nominal_gbps`` is 0.9 of the median p50 busbw of
  ``bench``'s own n >= 2 headline (``bench.headline``: the allreduce at 4
  MiB a rank on four cards of one host), rounded to 10 GB/s
  (``plateaus --nccl``, a torchrun world a process).

The runs behind them (NVIDIA H100 80GB HBM3 at 700.00 W, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them) are
listed beside each constant below and in ``PERF.md``.  ``h100-pcie`` and
``h100-nvl`` are derived (``defended=False``): each takes the SXM's
measured constant-to-peak ratios times its own peaks.  A constant with no
basis stays ``None``: no floor, and one pass.  An unknown card raises; it
never falls back to another card's figures (pass ``--spec-gbps``
instead).
"""

from __future__ import annotations

import dataclasses


class UnknownCardError(ValueError):
    """The card is not in the table: its peaks are not known here."""


@dataclasses.dataclass(frozen=True)
class CardSpec:
    """One card's published peaks and its operating constants."""

    kind: str          # short name ("h100-sxm")
    device_name: str   # what torch.cuda.get_device_name() reports
    hbm_gbps: float    # device-memory bandwidth, GB/s
    bf16_tflops: float  # dense bf16 tensor-core rate
    f32_tflops: float  # float32 outside the tensor cores
    # one direction of one card pair's NVLink, GB/s (the linkmap roofline,
    # the counterpart of the JAX table's per-link ici_gbps); None where
    # the data sheet gives no figure for a pair
    nvlink_gbps: float | None = None
    # bench's vs_baseline denominators and the degraded-window floors;
    # None where no run is behind them
    stream_nominal_gbps: float | None = None
    stream_floor_gbps: float | None = None
    triad_nominal_gbps: float | None = None
    # by dtype: "bfloat16" (bench's instrument: floor and nominal) and
    # "float32" (grid --spec mxu's default: a floor)
    mxu_nominal_tflops: dict = dataclasses.field(default_factory=dict)
    mxu_floor_tflops: dict = dataclasses.field(default_factory=dict)
    allreduce_nominal_gbps: float | None = None
    defended: bool = False  # measured on the card, or derived


#: the H100 SXM's operating constants, measured on NVIDIA H100 80GB HBM3
#: cards at 700.00 W (the allreduce nominal on four of them); each from
#: ``tools.plateaus`` processes (the one-card constants in three calls to
#: the card, the allreduce in one), the p50s' lowest / median / spread
#: given beside it
H100_SXM = CardSpec(
    "h100-sxm", "NVIDIA H100 80GB HBM3", hbm_gbps=3350.0,
    bf16_tflops=989.0, f32_tflops=67.0,
    # SXM: 900 GB/s of NVLink a card, 450 each way to the NVSwitch fabric
    nvlink_gbps=450.0,
    # hbm_stream, 15 processes: 1268.07 / 1279.22 GB/s, spread 1.05%
    stream_nominal_gbps=1150.0,
    # the lower of stream's 1200 and triad's 1100 (each 5% under its
    # lowest p50): the two share one floor
    stream_floor_gbps=1100.0,
    # hbm_triad, 15 processes: 1163.50 / 1175.27 GB/s, spread 1.09%
    triad_nominal_gbps=1060.0,
    # bfloat16: mxu_gemm m = 4096, 15 processes: 700.58 / 722.93
    # TFLOP/s, spread 6.19% (the floor 18.6% under the lowest);
    # float32: grid --spec mxu's chosen cell (64 MiB, m = 4096), 10
    # processes: 51.12 / 51.12 TFLOP/s, spread 0.76%.  float32 has a floor
    # (grid --spec mxu's) and no nominal: no bench instrument runs it
    mxu_nominal_tflops={"bfloat16": 651.0},
    mxu_floor_tflops={"bfloat16": 570.0, "float32": 48.0},
    # bench's n >= 2 headline (the allreduce at 4 MiB a rank, 25 iters,
    # 8 runs, trace fence) on four cards of one host, 10 torchrun worlds'
    # p50 busbw: 145.28 / 145.57 / 147.17 GB/s (lowest / median /
    # highest), spread 1.29%
    allreduce_nominal_gbps=130.0,
    defended=True,
)


def _scaled(value, peak: float, own: float | None):
    """``value`` taken to another card: the SXM's constant-to-peak ratio
    times that card's own peak; None without a constant or a peak."""
    if value is None or own is None:
        return None
    return float(round(value / peak * own))


def _derived(kind: str, device_name: str, hbm: float, bf16: float,
             f32: float, nvlink: float | None) -> CardSpec:
    """A card's entry from its peaks and the SXM's measured ratios."""
    s = H100_SXM
    mxu_peak = {"bfloat16": (s.bf16_tflops, bf16),
                "float32": (s.f32_tflops, f32)}
    mxu = {}
    for name in ("mxu_nominal_tflops", "mxu_floor_tflops"):
        mxu[name] = {dt: _scaled(v, *mxu_peak[dt])
                     for dt, v in getattr(s, name).items()}
    return CardSpec(
        kind, device_name, hbm_gbps=hbm, bf16_tflops=bf16, f32_tflops=f32,
        nvlink_gbps=nvlink,
        stream_nominal_gbps=_scaled(s.stream_nominal_gbps, s.hbm_gbps, hbm),
        stream_floor_gbps=_scaled(s.stream_floor_gbps, s.hbm_gbps, hbm),
        triad_nominal_gbps=_scaled(s.triad_nominal_gbps, s.hbm_gbps, hbm),
        allreduce_nominal_gbps=_scaled(s.allreduce_nominal_gbps,
                                       s.nvlink_gbps, nvlink),
        defended=False, **mxu)


CARDS: dict[str, CardSpec] = {c.kind: c for c in (
    H100_SXM,
    # PCIe and NVL: 600 GB/s over the NVLink bridge of a card pair, 300
    # each way (an unbridged pair talks over PCIe: --roofline-gbps)
    _derived("h100-pcie", "NVIDIA H100 PCIe", hbm=2000.0, bf16=756.0,
             f32=51.0, nvlink=300.0),
    _derived("h100-nvl", "NVIDIA H100 NVL", hbm=3900.0, bf16=835.0,
             f32=60.0, nvlink=300.0),
)}

_BY_NAME = {c.device_name.lower(): c for c in CARDS.values()}


def resolve_card(device_name: str) -> CardSpec | None:
    """The table entry for ``device_name``, or None when it is unknown."""
    return _BY_NAME.get(device_name.strip().lower())


#: the instrument families a peak is given for
PEAK_FAMILIES = ("hbm", "mxu", "link")


def card_peak(spec: CardSpec, family: str, dtype: str = "float32") -> float:
    """``spec``'s published peak for one instrument family: ``hbm`` the
    device-memory rate in GB/s (any dtype), ``mxu`` the dense product rate
    in TFLOP/s of the dtype: the tensor-core rate for the 16-bit floats
    (bfloat16 and float16 share it on Hopper), the float32 rate outside
    the tensor cores for float32 (TF32 stays off), ``link`` one direction
    of a card pair's NVLink in GB/s.  Other dtypes have no compute peak
    and raise, as does a card without a link figure."""
    if family == "hbm":
        return spec.hbm_gbps
    if family == "link":
        if spec.nvlink_gbps is None:
            raise ValueError(f"{spec.kind} has no NVLink figure")
        return spec.nvlink_gbps
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
