"""The hand-scheduled ring ops (port of ``tpu_perf/ops/pallas_ring.py``).

On the TPU each ``pl_*`` op is a Pallas kernel that drives the
interconnect with remote DMA.  Here the sim world
(:mod:`tpu_perf_torch.world`) stands in for the ranks, and each kernel
is written by hand for Hopper:

* ``direct_reduce_scatter`` — CUDA C++, ``csrc/reduce_scatter.cu``
  (replaces ``_reduce_scatter_kernel`` with ``_acc_add`` and
  ``_ring_barrier``), every rank's owned chunk in one launch, summed in the
  ring's order;
* ``direct_all_gather``, ``direct_all_gather_bidir`` — CUDA C++, one
  source ``csrc/all_gather.cu`` (replaces ``_all_gather_kernel``, both
  modes, and ``_all_gather_bidir_kernel``; counted apart): every rank's
  own chunk copied into every row in one launch, whose 8 KB tiles, the
  destinations of one source tile side by side, are taken in order from a
  device counter (``csrc/row_copy.cuh``);
* ``stream`` — Triton, :mod:`tpu_perf_torch.ops.stream_triton` (replaces
  ``_hbm_stream_vec_kernel``);
* ``hbm_read``, ``hbm_write`` — CUDA C++ on Hopper's TMA bulk copies,
  ``csrc/hbm_{read,write}.cu`` (replace ``_hbm_read_kernel`` and
  ``_hbm_write_kernel``, the TPU's local DMA instruments);
* ``hbm_copy`` — CUDA C++, ``csrc/hbm_copy.cu`` (replaces
  ``_hbm_copy_kernel``), and ``ring_shift``, ``pair_exchange`` — CUDA C++,
  one row-shift kernel ``csrc/p2p_shift.cu`` (replaces ``_ring_kernel`` and
  ``_exchange_kernel``; counted apart as ``ring`` and ``exchange``): the
  row copies, persistent grids that take 8 KB tiles of all rows in order
  from a device counter (``csrc/row_copy.cuh``);
* ``pingpong`` — CUDA C++, ``csrc/pingpong.cu`` (replaces
  ``_pingpong_kernel``), both legs in one cooperative launch, each pair's
  return leg held by a device arrival count;
* ``barrier`` — CUDA C++, ``csrc/barrier.cu`` (replaces ``_barrier_kernel``
  with ``_global_barrier``), the ranks laid over one thread-block cluster
  that meets at Hopper's hardware cluster barrier;
* ``all_to_all`` — CUDA C++, ``csrc/all_to_all.cu`` (replaces
  ``_all_to_all_direct_kernel``; stream order stands in for its
  ``_global_barrier``), every (destination, source) pair in one launch;
* ``peer_reduce_scatter``, ``peer_all_gather``, ``peer_all_to_all``,
  ``peer_all_gather_bidir``, ``peer_copy`` (counted as ``peer_ring``,
  ``peer_exchange`` and ``peer_pingpong``) and ``peer_barrier`` (with its
  tail copy, ``peer_barrier_copy``) — CUDA C++,
  ``csrc/peer_collectives.cu`` (the copy, the reduce-scatter and the
  gathers draw their tiles in order, ``csrc/row_copy.cuh``): every
  ``pl_*`` op that reaches another rank's memory, in a multi-rank world
  (:class:`tpu_perf_torch.world.DistWorld`), one launch a rank, each
  reaching its peers through pointers and meeting them on signal pads
  (replace the TPU kernels' remote copies and their barrier semaphores
  across cards); the gathers of the ops' steps push each rank's own
  chunk into every rank's output (``peer_all_gather_push``), as the TPU
  kernels send theirs, and the rest pull; the local memory instruments
  run per rank as they are.

Every ``pl_*`` op of the JAX package is ported.  Each wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor (the reduce-scatter's in the kernel's order of accumulation);
anything else raises.  The sizes, carries and op names are the
JAX package's, so rows land on the same curve keys.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import torch

from tpu_perf_torch import kernels
from tpu_perf_torch.kernels import _build
from tpu_perf_torch.ops.stream_triton import stream
from tpu_perf_torch.world import DistWorld, SimWorld, is_dist

PALLAS_OPS = (
    "pl_ring", "pl_exchange", "pl_all_gather", "pl_reduce_scatter",
    "pl_allreduce", "pl_pingpong", "pl_all_gather_bidir", "pl_hbm_copy",
    "pl_hbm_stream", "pl_hbm_read", "pl_hbm_write", "pl_barrier",
    "pl_all_to_all",
)

#: the CUDA sources (``csrc/<name>.cu``) each op launches in the sim world;
#: in a multi-rank world every op but the local instruments launches
#: ``peer_collectives`` (``pl_hbm_stream`` is Triton, built at its first
#: launch)
SIM_SOURCES = {
    "pl_ring": ("p2p_shift",), "pl_exchange": ("p2p_shift",),
    "pl_all_gather": ("all_gather",), "pl_all_gather_bidir": ("all_gather",),
    "pl_reduce_scatter": ("reduce_scatter",),
    "pl_allreduce": ("reduce_scatter", "all_gather"),
    "pl_pingpong": ("pingpong",), "pl_hbm_copy": ("hbm_copy",),
    "pl_hbm_stream": (), "pl_hbm_read": ("hbm_read",),
    "pl_hbm_write": ("hbm_write",), "pl_barrier": ("barrier",),
    "pl_all_to_all": ("all_to_all",),
}


def sources_for(op: str, dist: bool = False) -> tuple[str, ...]:
    """The CUDA sources ``op`` launches, in the sim world or (``dist``) in
    a multi-rank world; none for a library op."""
    if op not in SIM_SOURCES:
        return ()
    if dist and op not in _LOCAL_PALLAS_OPS:
        return ("peer_collectives",)
    return SIM_SOURCES[op]


#: the JAX package's chunk-rounding tile (its VMEM accumulation tile):
#: reduce-scatter chunks above it round up to a multiple of it.  It decides
#: ``nbytes`` on the curve keys, so it stays the JAX value; the CUDA
#: kernels' own tile is a separate constant in their sources.
_ACC_TILE_ELEMS = 65536
#: the JAX package's stream tile: through hbm_dma_block_elems it fixes
#: pl_hbm_write's output (the first block, tiled), so it stays the JAX
#: value; the CUDA kernels' own tiles are constants in their sources
_STREAM_TILE_ELEMS = 524288
#: pl_hbm_read / pl_hbm_write rows round up to this many bytes, the TPU's
#: 4 KiB DMA tiling (which also keeps every bulk copy 16-byte aligned here)
_DMA_ALIGN_BYTES = 4096

#: the row-copy kernels' tile (``csrc/row_copy.cuh`` kTileBytes, the copy's
#: and the row shift's), the edge the checks probe
ROW_COPY_TILE_BYTES = 8192
#: the peer reduce-scatter's tile (``csrc/peer_collectives.cu``: kThreads x
#: kReduceUnits 16-byte units of the owned chunk), the edge the checks probe
PEER_REDUCE_TILE_BYTES = 4096

_RS_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def hbm_dma_block_elems(itemsize: int, elems: int) -> int:
    """The JAX package's DMA block (elements) for its single-sided memory
    instruments and its stream tile: the stream-tile byte budget scaled by
    itemsize, capped by the buffer."""
    return min(max(1, _STREAM_TILE_ELEMS * itemsize // 4), elems)


def _stream_of(t: torch.Tensor) -> int:
    # the raw handle of the current stream on t's card, without building a
    # torch.cuda.Stream object (which costs a few microseconds a launch)
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, kernel needs cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")


# --- reduce-scatter ------------------------------------------------------


def mean_scale(n: int, dtype: torch.dtype) -> float:
    """1/n rounded to ``dtype``, as the JAX carries' ``jnp.asarray(inv,
    dtype)``: the scale the reduce-scatter carries pass the kernel."""
    return float(torch.tensor(1.0 / n, dtype=dtype))


def direct_reduce_scatter_plain(x: torch.Tensor, scale: float = 1.0,
                                tiles: int = 1) -> torch.Tensor:
    """The kernel's order of accumulation in plain PyTorch: rank c's owned
    chunk starts from rank c+1's chunk c and adds ranks c+2, ..., c+n (mod
    n) one at a time, rounding to the working type after every add, as the
    ring forwards it round to rank c; then times ``scale``, rounded once
    more, and repeated ``tiles`` times along the row.  Returns ``(n,
    tiles*chunk)``."""
    kernels.PLAIN_CALLS["direct_reduce_scatter"] += 1
    n = x.shape[0]
    xc = x.view(n, n, x.shape[1] // n)
    c = torch.arange(n, device=x.device)
    acc = xc[(c + 1) % n, c]
    for j in range(2, n + 1):
        acc = acc + xc[(c + j) % n, c]
    # scale is exact in the dtype, so this is the dtype's own multiply
    acc = acc * scale
    return acc.repeat(1, tiles) if tiles > 1 else acc


def direct_reduce_scatter(x: torch.Tensor, *, scale: float = 1.0,
                          tiles: int = 1) -> torch.Tensor:
    """Reduce-scatter over the sim ranks: ``x`` is ``(n, n*chunk)``; returns
    ``(n, tiles*chunk)`` whose row d is the sum over ranks of chunk d
    (psum_scatter(tiled=True) ownership), added in the TPU ring's order,
    times ``scale`` and written ``tiles`` (1 or n) times along the row.
    ``scale`` must be exact in x's dtype (the carries pass 1/n rounded to
    it); 1.0 changes no bit.  One kernel launch for every rank."""
    n, row = x.shape
    if n < 2 or row % n:
        raise ValueError(
            f"direct_reduce_scatter needs >= 2 ranks and whole chunks, got {tuple(x.shape)}")
    if x.dtype not in _RS_DTYPE_CODES:
        raise ValueError(f"direct_reduce_scatter reduces floats, got {x.dtype}")
    if tiles not in (1, n):
        raise ValueError(f"direct_reduce_scatter: tiles is 1 or {n}, got {tiles}")
    if x.device.type == "cpu":
        return direct_reduce_scatter_plain(x, scale, tiles)
    _check_cuda("direct_reduce_scatter", x)
    chunk = row // n
    out = x.new_empty((n, tiles * chunk))
    err = _build.entry("reduce_scatter")(x.data_ptr(), out.data_ptr(), n,
                                         chunk, _RS_DTYPE_CODES[x.dtype],
                                         scale, tiles, _stream_of(x))
    _build.check("direct_reduce_scatter", err)
    kernels.LAUNCHES["direct_reduce_scatter"] += 1
    return out


# --- all-gather ---------------------------------------------------------


def _gather_plain(own: torch.Tensor) -> torch.Tensor:
    # every rank's row is the n own chunks in rank order: (n, n*chunk)
    n, chunk = own.shape
    out = own.new_empty((n, n * chunk))
    out.view(n, n, chunk).copy_(own.unsqueeze(0).expand(n, n, chunk))
    return out


def direct_all_gather_plain(x: torch.Tensor,
                            src_full: bool = False) -> torch.Tensor:
    """The gather's function in plain PyTorch: the n own chunks broadcast
    into every row.  ``x`` as :func:`direct_all_gather` takes it."""
    kernels.PLAIN_CALLS["direct_all_gather"] += 1
    n, row = x.shape
    if src_full:
        d = torch.arange(n, device=x.device)
        x = x.view(n, n, row // n)[d, d]
    return _gather_plain(x)


def _gather(name: str, x: torch.Tensor, chunk: int,
            *entry_args: int) -> torch.Tensor:
    # one launch of the fan-out gather through C entry `name` of
    # csrc/all_gather.cu; entry_args follow its chunk_bytes
    _check_cuda(name, x)
    n = x.shape[0]
    out = x.new_empty((n, n * chunk))
    counters = row_copy_counters("all_gather", x.device)
    isz = x.element_size()
    err = _build.entry("all_gather", name)(
        x.data_ptr(), out.data_ptr(), counters.data_ptr(), n, chunk * isz,
        *entry_args, _stream_of(x))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def direct_all_gather(x: torch.Tensor, *, src_full: bool = False) -> torch.Tensor:
    """All-gather over the sim ranks.  ``x`` is ``(n, chunk)`` (each rank's
    own chunk) or, with ``src_full``, ``(n, n*chunk)`` whose chunk d of row
    d is rank d's own; returns ``(n, n*chunk)`` with every row the gathered
    chunks.  One launch that copies each own chunk into every row."""
    n, row = x.shape
    if src_full and row % n:
        raise ValueError(f"src_full needs whole chunks, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return direct_all_gather_plain(x, src_full)
    chunk = row // n if src_full else row
    isz = x.element_size()
    return _gather("direct_all_gather", x, chunk, row * isz,
                   chunk * isz if src_full else 0)


def direct_all_gather_bidir_plain(x: torch.Tensor) -> torch.Tensor:
    """The bidirectional gather's function in plain PyTorch: the n own
    chunks broadcast into every row, as :func:`direct_all_gather_plain`."""
    kernels.PLAIN_CALLS["direct_all_gather_bidir"] += 1
    return _gather_plain(x)


def direct_all_gather_bidir(x: torch.Tensor) -> torch.Tensor:
    """The bidirectional all-gather over the sim ranks: ``x`` is ``(n,
    chunk)`` with chunk even; returns ``(n, n*chunk)`` with every row the
    gathered chunks.  On the TPU first halves go clockwise and second
    halves counter-clockwise; on one card both directions are the same
    device memory, so it is the gather's one launch (the half-chunk split
    returns with a multi-card world, where they are two links)."""
    n, chunk = x.shape
    if chunk % 2:
        raise ValueError(
            f"direct_all_gather_bidir splits chunks in half, got {chunk} elements")
    if x.device.type == "cpu":
        return direct_all_gather_bidir_plain(x)
    return _gather("direct_all_gather_bidir", x, chunk)


# --- device counters -----------------------------------------------------
# Kernels that hand out work on the device keep their counters in a buffer,
# zero between launches (each kernel returns its counters to zero itself),
# so nothing passes from the host per launch and a CUDA graph can replay
# it.  Launches that share a buffer must be ordered, so there is one buffer
# per card and stream: the launches of one stream share it (a graph
# captured on a stream replays with that stream's buffer), and two
# launches on two streams (--streams, contend) never draw each other's
# tiles.


def _stream_key(device: torch.device) -> tuple:
    """The counter stores' key: the card and its current stream (the raw
    handle); the CPU has one key."""
    if device.type != "cuda":
        return (device.type, None)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return (index, torch._C._cuda_getCurrentRawStream(index))


def _card_counters(store: dict[tuple, torch.Tensor], device: torch.device,
                   words: int) -> torch.Tensor:
    # the buffer of the card's current stream in store, made (or grown)
    # zeroed with >= words words, on that stream
    key = _stream_key(device)
    counters = store.get(key)
    if counters is None or counters.numel() < words:
        counters = store[key] = torch.zeros(
            words, dtype=torch.int32, device=device)
    return counters


#: per kernel that draws tiles in order (csrc/row_copy.cuh), card and
#: stream, its tile counters (uint32: next tile, CTAs done)
_ROW_COPY_COUNTERS: dict[str, dict[tuple, torch.Tensor]] = {
    "hbm_copy": {}, "p2p_shift": {}, "all_gather": {}, "peer_copy": {},
    "peer_reduce": {}, "peer_gather": {}}
_ROW_COPY_COUNTER_WORDS = 2


def row_copy_counters(source: str, device: torch.device) -> torch.Tensor:
    """The tile counters of ``source`` (``hbm_copy``, ``p2p_shift``,
    ``all_gather``, ``peer_copy``, ``peer_reduce`` or ``peer_gather``;
    ring and exchange share one, as do the two gathers, the three peer
    copies and the peer gathers' push and pull) for the card's current
    stream, zeroed once when made."""
    return _card_counters(_ROW_COPY_COUNTERS[source], device,
                          _ROW_COPY_COUNTER_WORDS)


def warm_loopback_streams(streams: list, device: torch.device,
                          nbytes: int) -> None:
    """Make, on each of a loopback's rank streams and with the card idle,
    what a rank's first step there would make: the kernels' tile counters
    and a cached block of ``nbytes`` for its output.  The loopback
    enqueues one rank's launches after another's from one thread, and a
    device allocation (cudaMalloc) between two streams' commands keeps
    them from running at once (the CUDA guide's implicit
    synchronization): a rank's barrier would then wait for a rank whose
    barrier cannot start."""
    for s in streams:
        with torch.cuda.stream(s):
            for source in _ROW_COPY_COUNTERS:
                row_copy_counters(source, device)
            torch.empty(nbytes, dtype=torch.uint8, device=device)
    torch.cuda.synchronize(device)


# --- the local memory instruments --------------------------------------
# x is (n, elems): rank r's buffer is row r.  Each kernel is one launch
# covering every rank.


def hbm_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the copy kernel: ``out = x``."""
    kernels.PLAIN_CALLS["hbm_copy"] += 1
    return x.clone()


def hbm_copy(x: torch.Tensor) -> torch.Tensor:
    """One full-buffer device-memory copy of every rank's row; returns a new
    tensor.  Rows of any size and alignment; one launch, its tiles taken
    in order from the card's ``hbm_copy`` tile counters."""
    if x.device.type == "cpu":
        return hbm_copy_plain(x)
    _check_cuda("hbm_copy", x)
    out = torch.empty_like(x)
    n, row = x.shape
    counters = row_copy_counters("hbm_copy", x.device)
    err = _build.entry("hbm_copy")(x.data_ptr(), out.data_ptr(),
                                   counters.data_ptr(), n,
                                   row * x.element_size(), _stream_of(x))
    _build.check("hbm_copy", err)
    kernels.LAUNCHES["hbm_copy"] += 1
    return out


def _check_bulk_aligned(name: str, *values: int) -> None:
    """A bulk copy takes 16-byte aligned addresses and sizes."""
    for v in values:
        if v % 16:
            raise ValueError(
                f"{name}: {v} is not a multiple of 16 bytes (the op rounds "
                f"rows to {_DMA_ALIGN_BYTES} bytes)")


def hbm_read_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the read sweep: the identity (the
    output aliases the input)."""
    kernels.PLAIN_CALLS["hbm_read"] += 1
    return x


def hbm_read(x: torch.Tensor) -> torch.Tensor:
    """Read every byte of every rank's row into on-chip memory and write
    nothing; returns ``x`` itself, as the TPU kernel's output aliases its
    input.  Rows must be multiples of 16 bytes."""
    if x.device.type == "cpu":
        return hbm_read_plain(x)
    _check_cuda("hbm_read", x)
    n, row = x.shape
    _check_bulk_aligned("hbm_read", x.data_ptr(), row * x.element_size())
    err = _build.entry("hbm_read")(x.data_ptr(), n, row * x.element_size(),
                                   _stream_of(x))
    _build.check("hbm_read", err)
    kernels.LAUNCHES["hbm_read"] += 1
    return x


def hbm_write_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """The plain PyTorch version of the write sweep: each row's first
    ``block`` elements tiled over the row, the last tile cut short."""
    kernels.PLAIN_CALLS["hbm_write"] += 1
    n, row = x.shape
    nblocks, rem = divmod(row, block)
    out = torch.empty_like(x)
    out[:, :nblocks * block].view(n, nblocks, block).copy_(
        x[:, None, :block].expand(n, nblocks, block))
    out[:, nblocks * block:] = x[:, :rem]
    return out


def hbm_write(x: torch.Tensor, block: int) -> torch.Tensor:
    """Write each rank's first ``block`` elements over its whole row
    (tiled, the last tile cut short) into a new tensor, reading the block
    once.  Row and block must be multiples of 16 bytes."""
    n, row = x.shape
    if not 0 < block <= row:
        raise ValueError(f"hbm_write: block {block} outside (0, {row}]")
    if x.device.type == "cpu":
        return hbm_write_plain(x, block)
    _check_cuda("hbm_write", x)
    isz = x.element_size()
    out = torch.empty_like(x)
    _check_bulk_aligned("hbm_write", x.data_ptr(), out.data_ptr(), row * isz,
                        block * isz)
    err = _build.entry("hbm_write")(x.data_ptr(), out.data_ptr(), n,
                                    row * isz, block * isz, _stream_of(x))
    _build.check("hbm_write", err)
    kernels.LAUNCHES["hbm_write"] += 1
    return out


# --- the point-to-point kernels ------------------------------------------
# x is (n, elems): rank r's buffer is row r.  group 0 is ranks [0, n/2),
# rank d's partner is d + n/2.


def _shift_plain(name: str, x: torch.Tensor, shift: int) -> torch.Tensor:
    # out[d] = x[(d - shift) mod n], one gather of whole rows
    kernels.PLAIN_CALLS[name] += 1
    n = x.shape[0]
    return x[(torch.arange(n, device=x.device) - shift) % n]


def _shift(name: str, x: torch.Tensor, shift: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return _shift_plain(name, x, shift)
    _check_cuda(name, x)
    n, row = x.shape
    out = torch.empty_like(x)
    counters = row_copy_counters("p2p_shift", x.device)
    err = _build.entry("p2p_shift")(x.data_ptr(), out.data_ptr(),
                                    counters.data_ptr(), n,
                                    row * x.element_size(), shift % n,
                                    _stream_of(x))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def ring_shift_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the ring kernel: ``out[d] = x[d-1]``."""
    return _shift_plain("ring", x, 1)


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """Every rank sends its row to its right neighbour, (d+1) mod n; returns
    a new tensor with ``out[d] = x[(d-1) mod n]``.  One launch."""
    return _shift("ring", x, 1)


def _check_even(name: str, n: int) -> None:
    if n % 2:
        raise ValueError(f"{name} needs an even rank count, got {n}")


def pair_exchange_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the exchange kernel: the two groups
    swap rows, ``out[d] = x[(d + n/2) mod n]``."""
    _check_even("pair_exchange", x.shape[0])
    return _shift_plain("exchange", x, x.shape[0] // 2)


def pair_exchange(x: torch.Tensor) -> torch.Tensor:
    """Every rank swaps its row with its partner d + n/2, both directions
    at once; returns a new tensor.  Even n; one launch."""
    _check_even("pair_exchange", x.shape[0])
    return _shift("exchange", x, x.shape[0] // 2)


def pingpong_plain(x: torch.Tensor, out: torch.Tensor,
                   stage: torch.Tensor) -> None:
    """The kernel's two legs in plain PyTorch, through the real stage:
    group 0's rows go into the partners' stage rows and come back from
    there into group 0's output; group 1 copies its own rows.  ``out`` and
    ``stage`` are written in place; stage rows below n/2 are not."""
    kernels.PLAIN_CALLS["pingpong"] += 1
    half = x.shape[0] // 2
    stage[half:] = x[:half]    # leg 1: group 0 -> the partner's stage
    out[half:] = x[half:]      #        group 1 keeps its own payload
    out[:half] = stage[half:]  # leg 2: the payload back into group 0


#: per card and stream, the pingpong kernel's pair counters (uint32, zero
#: between launches; the kernel returns them to zero itself)
_PINGPONG_COUNTERS: dict[tuple, torch.Tensor] = {}
#: counters per pair: next tile, arrivals, CTAs done
_PINGPONG_COUNTERS_PER_PAIR = 3


def pingpong_counters(device: torch.device, pairs: int) -> torch.Tensor:
    """The pair-counter buffer of the card's current stream, enough for
    ``pairs`` pairs, zeroed once when it is made or grown."""
    return _card_counters(_PINGPONG_COUNTERS, device,
                          _PINGPONG_COUNTERS_PER_PAIR * pairs)


def pingpong(x: torch.Tensor, stage: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The serialized round trip between the groups; returns ``(out,
    stage)``.  ``out`` equals ``x`` (group 0's rows went to the partner's
    stage and back); ``stage[d + n/2]`` holds group 0's row d, the other
    stage rows are left as they were (a new buffer's unwritten).  Even n;
    one launch, each pair's return leg held on the device until its whole
    payload is in the stage."""
    n, row = x.shape
    _check_even("pingpong", n)
    out = torch.empty_like(x)
    if stage is None:
        stage = torch.empty_like(x)
    elif (stage.shape, stage.dtype, stage.device) != (x.shape, x.dtype,
                                                       x.device):
        raise ValueError(f"pingpong: stage {tuple(stage.shape)} {stage.dtype} "
                         f"on {stage.device} for x {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")
    if x.device.type == "cpu":
        pingpong_plain(x, out, stage)
        return out, stage
    _check_cuda("pingpong", x, stage)
    counters = pingpong_counters(x.device, n // 2)
    err = _build.entry("pingpong")(x.data_ptr(), out.data_ptr(),
                                   stage.data_ptr(), counters.data_ptr(), n,
                                   row * x.element_size(), _stream_of(x))
    _build.check("pingpong", err)
    kernels.LAUNCHES["pingpong"] += 1
    return out, stage


#: a portable thread-block cluster holds 8 CTAs, and a CTA 32 warps: the
#: barrier takes one warp per rank
_CLUSTER_CTAS, _CTA_WARPS = 8, 32
BARRIER_MAX_RANKS = _CLUSTER_CTAS * _CTA_WARPS


def barrier_layout(n: int) -> tuple[int, int]:
    """The barrier kernel's ``(ctas, warps)`` for n ranks: ``min(n, 8)``
    CTAs of one cluster, ``ceil(n / ctas)`` warps each; rank r is warp
    r % warps of CTA r // warps."""
    if not 1 <= n <= BARRIER_MAX_RANKS:
        raise ValueError(
            f"barrier: {n} ranks; one thread-block cluster holds at most "
            f"{BARRIER_MAX_RANKS} ({_CLUSTER_CTAS} CTAs of {_CTA_WARPS} warps)")
    ctas = min(n, _CLUSTER_CTAS)
    return ctas, -(-n // ctas)


@functools.lru_cache(maxsize=None)
def _check_cluster_fits(device_index: int, ctas: int, warps: int) -> None:
    # asked once per device and layout, before the first launch
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.entry("barrier", "barrier_max_active_clusters")(
            ctas, warps, ctypes.byref(clusters))
    _build.check("barrier occupancy query", err)
    if clusters.value < 1:
        raise RuntimeError(
            f"barrier: card {device_index} cannot hold a cluster of {ctas} "
            f"CTAs of {warps} warps")


def barrier_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the barrier kernel: with every rank in
    one process the barrier itself is empty, and the copy is a clone."""
    kernels.PLAIN_CALLS["barrier"] += 1
    return x.clone()


def barrier(x: torch.Tensor) -> torch.Tensor:
    """Every rank signals all n ranks and waits for n signals, then copies
    its row; returns a new tensor equal to ``x``.  One launch of one
    thread-block cluster (:func:`barrier_layout`) that meets at the
    hardware cluster barrier; nothing is kept between launches.  At most
    256 ranks, on the CPU too."""
    n, row = x.shape
    ctas, warps = barrier_layout(n)
    if x.is_cpu:
        return barrier_plain(x)
    _check_cuda("barrier", x)
    _check_cluster_fits(x.get_device(), ctas, warps)
    out = torch.empty_like(x)
    err = _build.entry("barrier")(x.data_ptr(), out.data_ptr(), n, ctas,
                                  warps, row * x.element_size(),
                                  _stream_of(x))
    _build.check("barrier", err)
    kernels.LAUNCHES["barrier"] += 1
    return out


# --- all-to-all ---------------------------------------------------------


def _check_whole_chunks(name: str, x: torch.Tensor) -> int:
    n, row = x.shape
    if row % n:
        raise ValueError(f"{name} needs whole chunks, got {tuple(x.shape)}")
    return row // n


def all_to_all_plain(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's schedule in plain PyTorch: transfer j of every rank
    s sends its chunk (s+j) mod n to that rank's slot s (j = 0 is the local
    copy), ``out[d][s] = x[s][d]``."""
    kernels.PLAIN_CALLS["all_to_all"] += 1
    n = x.shape[0]
    chunk = _check_whole_chunks("all_to_all", x)
    out = torch.empty_like(x)
    xc, oc = x.view(n, n, chunk), out.view(n, n, chunk)
    s = torch.arange(n, device=x.device)
    for j in range(n):
        d = (s + j) % n
        oc[d, s] = xc[s, d]
    return out


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Every rank sends chunk d of its row to rank d, which stores it at
    the sender's slot; returns a new tensor with ``out[d][s] = x[s][d]``.
    One launch covers every pair."""
    chunk = _check_whole_chunks("all_to_all", x)
    if x.device.type == "cpu":
        return all_to_all_plain(x)
    _check_cuda("all_to_all", x)
    out = torch.empty_like(x)
    err = _build.entry("all_to_all")(x.data_ptr(), out.data_ptr(), x.shape[0],
                                     chunk * x.element_size(), _stream_of(x))
    _build.check("all_to_all", err)
    kernels.LAUNCHES["all_to_all"] += 1
    return out


# --- the peer kernels of a multi-rank world -------------------------------
# Each call is one rank's.  A part is a rank's buffer (a tensor, or a
# RemoteBuffer of a peer's memory mapped into this process); on the card
# the kernels read the parts through the device table of their pointers
# that a PeerParts makes once, eagerly, so that a graph captured later
# replays with it.

_PEER_MAX_RANKS = 64


@dataclasses.dataclass(frozen=True)
class RemoteBuffer:
    """A peer's buffer mapped into this process (CUDA IPC): what the peer
    kernels read of a part, where no tensor of this process owns it."""

    ptr: int
    numel: int
    dtype: torch.dtype
    device: torch.device

    def data_ptr(self) -> int:
        return self.ptr

    def element_size(self) -> int:
        return self.dtype.itemsize

    def is_contiguous(self) -> bool:
        return True


class PeerParts(tuple):
    """n ranks' parts, in rank order, and on the card ``table``: the device
    table of their pointers, made here and freed with the object (None on
    the CPU, where the plain versions take the parts themselves)."""

    table: torch.Tensor | None

    def __new__(cls, parts):
        self = super().__new__(cls, parts)
        self.table = None
        if self and self[0].device.type == "cuda":
            dev = self[0].device
            self.table = torch.tensor([p.data_ptr() for p in self],
                                      dtype=torch.int64, device=dev)
            # other ranks' streams read it too (a one-card loopback): the
            # copy is done before any launch takes it
            torch.cuda.current_stream(dev).synchronize()
        return self


def _table_ptr(name: str, parts) -> int:
    # the device table of a launch's parts
    if not isinstance(parts, PeerParts) or parts.table is None:
        raise TypeError(f"{name} on the card takes PeerParts of card "
                        "buffers: their pointer table is made once, outside "
                        "any graph")
    return parts.table.data_ptr()


def _numel(p) -> int:
    return p.numel if isinstance(p, RemoteBuffer) else p.numel()


def _sub(part, offset: int, numel: int):
    """Elements ``[offset, offset + numel)`` of a part: a view of a tensor,
    or a :class:`RemoteBuffer` of that much of a peer's."""
    if isinstance(part, RemoteBuffer):
        return RemoteBuffer(part.ptr + offset * part.element_size(), numel,
                            part.dtype, part.device)
    return part[offset:offset + numel]


def _check_parts(name: str, parts, rank: int | None = None) -> int:
    # n parts of one dtype, device and length; returns the length
    n = len(parts)
    if not 1 <= n <= _PEER_MAX_RANKS:
        raise ValueError(f"{name}: {n} ranks, the kernels take 1 to "
                         f"{_PEER_MAX_RANKS}")
    if rank is not None and not 0 <= rank < n:
        raise ValueError(f"{name}: rank {rank} outside {n} ranks")
    first = parts[0]
    size = _numel(first)
    for p in parts:
        if (p.dtype, p.device, _numel(p)) != (first.dtype, first.device, size):
            raise ValueError(f"{name}: parts differ in dtype, device or "
                             "length")
        if not p.is_contiguous():
            raise ValueError(f"{name}: a part is not contiguous")
    return size


def _check_out(name: str, out: torch.Tensor | None, numel: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # the launch's output: a new tensor, or the given one checked
    if out is None:
        return torch.empty(numel, dtype=dtype, device=device)
    _check_cuda(name, out)
    if _numel(out) != numel or out.dtype != dtype:
        raise ValueError(f"{name}: out of {_numel(out)} {out.dtype} for "
                         f"{numel} elements of {dtype}")
    return out


def _widest_word(nbytes: int, *ptrs: int) -> int:
    # the widest word (16, 4, 2 or 1 bytes) that divides every address
    # and the length
    for word in (16, 4, 2):
        if nbytes % word == 0 and all(p % word == 0 for p in ptrs):
            return word
    return 1


def peer_reduce_scatter_plain(parts: list[torch.Tensor], rank: int,
                              scale: float = 1.0,
                              tiles: int = 1) -> torch.Tensor:
    """The peer reduce-scatter in plain PyTorch: ``parts[s]`` is rank s's
    chunk ``rank`` (``(chunk,)``); returns their sum in the ring's order,
    ((parts[rank+1] + parts[rank+2]) + ...) + parts[rank+n], rounding to
    the dtype after every add, then times ``scale``, repeated ``tiles``
    times: the order of :func:`direct_reduce_scatter_plain` and of the TPU
    ring."""
    kernels.PLAIN_CALLS["peer_reduce_scatter"] += 1
    n = len(parts)
    acc = parts[(rank + 1) % n]
    for j in range(2, n + 1):
        acc = acc + parts[(rank + j) % n]
    acc = acc * scale
    return acc.repeat(tiles) if tiles > 1 else acc


def peer_reduce_scatter(parts, rank: int, *, scale: float = 1.0,
                        tiles: int = 1,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank ``rank``'s reduce-scatter: ``parts[s]`` is rank s's chunk
    ``rank`` (a view into its buffer, or a :class:`RemoteBuffer`); returns
    (into ``out`` when given) the ring-order sum over the n parts times
    ``scale`` (exact in the dtype), written ``tiles`` times along the
    output (``pl_reduce_scatter``'s carry tiles it n times).  One launch,
    reading every part through the pointer table (on the card ``parts`` is
    a :class:`PeerParts`), its tiles drawn in order from the card's
    ``peer_reduce`` counters."""
    chunk = _check_parts("peer_reduce_scatter", parts, rank)
    dtype = parts[0].dtype
    if dtype not in _RS_DTYPE_CODES:
        raise ValueError(f"peer_reduce_scatter reduces floats, got {dtype}")
    if tiles < 1:
        raise ValueError(f"peer_reduce_scatter: tiles {tiles} < 1")
    if parts[0].device.type == "cpu":
        got = peer_reduce_scatter_plain(parts, rank, scale, tiles)
        return got if out is None else out.copy_(got)
    out = _check_out("peer_reduce_scatter", out, tiles * chunk, dtype,
                     parts[0].device)
    vec = _widest_word(chunk * dtype.itemsize, out.data_ptr(),
                       *(p.data_ptr() for p in parts)) == 16
    counters = row_copy_counters("peer_reduce", out.device)
    err = _build.entry("peer_collectives")(
        _table_ptr("peer_reduce_scatter", parts), out.data_ptr(),
        counters.data_ptr(), len(parts), rank, chunk, _RS_DTYPE_CODES[dtype],
        scale, tiles, int(vec), _stream_of(out))
    _build.check("peer_reduce_scatter", err)
    kernels.LAUNCHES["peer_reduce_scatter"] += 1
    return out


def pull_order(n: int, rank: int) -> list[int]:
    """The ranks a whole-chunk pull of rank ``rank`` reads, in the order
    it takes each tile: its own part first, then ``rank + 1``, ``rank +
    2``, ... (mod n), so that across cards the n ranks start at n
    different sources."""
    return [(rank + k) % n for k in range(n)]


def _pull_plain(name: str, parts: list[torch.Tensor],
                rank: int) -> torch.Tensor:
    # the parts read in pull_order, stored in rank order
    kernels.PLAIN_CALLS[name] += 1
    read = {s: parts[s] for s in pull_order(len(parts), rank)}
    return torch.cat([read[s] for s in range(len(parts))])


def peer_all_gather_plain(parts: list[torch.Tensor],
                          rank: int = 0) -> torch.Tensor:
    """The peer all-gather in plain PyTorch: the n owned chunks, read in
    :func:`pull_order` from rank ``rank``, in rank order (``torch.cat``)."""
    return _pull_plain("peer_all_gather", parts, rank)


def peer_all_to_all_plain(parts: list[torch.Tensor],
                          rank: int = 0) -> torch.Tensor:
    """The peer all-to-all in plain PyTorch: ``parts[s]`` is rank s's chunk
    for this rank, read in :func:`pull_order` from rank ``rank``; they
    land in rank order, ``out[s] = x_s[rank]``."""
    return _pull_plain("peer_all_to_all", parts, rank)


def bidir_order(n: int, rank: int) -> list[tuple[int, int, int]]:
    """The half-chunk gather's ``(ring step, half, source rank)`` for rank
    ``rank``: at step k half 0 comes clockwise from rank ``rank - k`` and
    half 1 counter-clockwise from rank ``rank + k`` (mod n), the TPU
    kernel's two directions; step 0 is the rank's own chunk."""
    return [(k, h, (rank - k) % n if h == 0 else (rank + k) % n)
            for k in range(n) for h in (0, 1)]


def push_order(n: int, rank: int,
               bidir: bool = False) -> list[tuple[int, int, int]]:
    """The push gather's ``(ring step, half, destination rank)`` for rank
    ``rank``, in the order the kernel stores each source tile: the whole
    chunk (half 0) to ``rank + k``, or with ``bidir`` half 0 clockwise to
    ``rank + k`` and half 1 counter-clockwise to ``rank - k`` (mod n);
    step 0 is the rank's own output.  Every rank starts at its own
    output, so across cards no output takes every rank's first store."""
    halves = (0, 1) if bidir else (0,)
    return [(k, h, (rank + k) % n if h == 0 else (rank - k) % n)
            for h in halves for k in range(n)]


def peer_all_gather_bidir_plain(parts: list[torch.Tensor],
                                rank: int) -> torch.Tensor:
    """The half-chunk gather in plain PyTorch, half by half in the order
    of :func:`bidir_order`: the n owned chunks in rank order."""
    kernels.PLAIN_CALLS["peer_all_gather_bidir"] += 1
    n, chunk = len(parts), _numel(parts[0])
    half = chunk // 2
    out = parts[0].new_empty(n * chunk)
    for _, h, s in bidir_order(n, rank):
        lo = s * chunk + h * half
        out[lo:lo + half] = parts[s][h * half:(h + 1) * half]
    return out


def _launch_gather(name: str, parts, out: torch.Tensor | None, chunk: int,
                   rank: int, halves: int = 1) -> torch.Tensor:
    # one launch of the pull gather: whole parts from rank + k (sources
    # fastest), or half-chunks in both ring directions from rank
    n, dtype = len(parts), parts[0].dtype
    out = _check_out(name, out, n * chunk, dtype, parts[0].device)
    nbytes = chunk * dtype.itemsize
    word = _widest_word(nbytes // halves, out.data_ptr(),
                        *(p.data_ptr() for p in parts))
    counters = row_copy_counters("peer_gather", out.device)
    err = _build.entry("peer_collectives", "peer_gather_pull")(
        _table_ptr(name, parts), out.data_ptr(), counters.data_ptr(), n,
        rank, nbytes, halves, word, _stream_of(out))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def peer_all_gather(parts, rank: int = 0, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank ``rank``'s pull all-gather: ``parts[s]`` is rank s's owned
    chunk; returns (into ``out`` when given, which no peer need reach) the
    n chunks in rank order, ``(n*chunk,)``.  One launch that pulls every
    peer's chunk into this rank's output, its 8 KB tiles drawn in order
    from the card's ``peer_gather`` counters, each tile of the n sources
    side by side in :func:`pull_order`; on the card ``parts`` is a
    :class:`PeerParts`.  :func:`peer_all_gather_push` is the same gather
    with each rank reading only its own chunk."""
    chunk = _check_parts("peer_all_gather", parts, rank)
    if parts[0].device.type == "cpu":
        got = peer_all_gather_plain(parts, rank)
        return got if out is None else out.copy_(got)
    return _launch_gather("peer_all_gather", parts, out, chunk, rank)


def peer_all_to_all(parts, rank: int = 0, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank ``rank``'s pull all-to-all: ``parts[s]`` is rank s's chunk for
    this rank (chunk ``rank`` of its input); returns (into ``out`` when
    given, which no peer need reach) the n chunks in rank order, ``out[s]
    = x_s[rank]``.  The pull gather's one launch over this table, in
    :func:`pull_order`; on the card ``parts`` is a :class:`PeerParts`.
    :func:`peer_all_to_all_push` is the same function with each rank
    storing into its peers' outputs."""
    chunk = _check_parts("peer_all_to_all", parts, rank)
    if parts[0].device.type == "cpu":
        got = peer_all_to_all_plain(parts, rank)
        return got if out is None else out.copy_(got)
    return _launch_gather("peer_all_to_all", parts, out, chunk, rank)


def peer_all_gather_bidir(parts, rank: int, *,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Rank ``rank``'s bidirectional pull all-gather: the gather of
    :func:`peer_all_gather` (chunks even) in half-chunks, the first halves
    pulled clockwise and the second counter-clockwise
    (:func:`bidir_order`); on a ring of links the halves take the two
    directions, on all-to-all links or one card the output and the bytes
    are the gather's.  One launch; on the card ``parts`` is a
    :class:`PeerParts`."""
    chunk = _check_parts("peer_all_gather_bidir", parts, rank)
    if chunk % 2:
        raise ValueError(f"peer_all_gather_bidir splits chunks in half, got "
                         f"{chunk} elements")
    if parts[0].device.type == "cpu":
        got = peer_all_gather_bidir_plain(parts, rank)
        return got if out is None else out.copy_(got)
    return _launch_gather("peer_all_gather_bidir", parts, out, chunk, rank,
                          halves=2)


def peer_all_gather_push_plain(own: torch.Tensor, outs: list[torch.Tensor],
                               rank: int, bidir: bool = False) -> None:
    """The push gather in plain PyTorch: ``own`` into slot ``rank`` of
    each destination ``outs[s]``, half by half in :func:`push_order`; no
    other element of any destination is written."""
    kernels.PLAIN_CALLS["peer_all_gather_bidir" if bidir
                        else "peer_all_gather"] += 1
    chunk = own.numel()
    width = chunk // 2 if bidir else chunk
    for _, h, s in push_order(len(outs), rank, bidir):
        lo = rank * chunk + h * width
        outs[s][lo:lo + width] = own[h * width:(h + 1) * width]


def _check_push(name: str, own: torch.Tensor, outs, rank: int,
                chunk: int) -> None:
    # n outputs of n chunks, this rank among them, own of the outputs'
    # dtype and card
    n = len(outs)
    size = _check_parts(name, outs, rank)
    if size != n * chunk or own.dtype != outs[0].dtype or \
            own.device != outs[0].device:
        raise ValueError(f"{name}: {own.numel()} elements of {own.dtype} on "
                         f"{own.device} into {n} outputs of {size} "
                         f"{outs[0].dtype} on {outs[0].device}")


def peer_all_gather_push(own: torch.Tensor, outs, rank: int, *,
                         bidir: bool = False) -> None:
    """Rank ``rank``'s push all-gather: stores its own chunk ``own`` into
    slot ``rank`` (elements ``[rank*chunk, (rank+1)*chunk)``) of every
    rank's output ``outs[s]`` (``(n*chunk,)``: this rank's a tensor, a
    peer's a :class:`RemoteBuffer`; on the card a :class:`PeerParts`).
    With ``bidir`` (chunk even, counted as ``peer_all_gather_bidir``) the
    first halves go clockwise and the second counter-clockwise
    (:func:`push_order`), the TPU kernel's two directions.  One launch
    that reads ``own`` once and stores each 8 KB tile into all n outputs
    side by side, its tiles drawn in order from the card's ``peer_gather``
    counters, in the widest word dividing ``own``, every slot and the
    chunk's (or half's) bytes.  A rank's output is whole only once every
    rank has pushed: the caller's next barrier gives that."""
    name = "peer_all_gather_bidir" if bidir else "peer_all_gather"
    n = len(outs)
    chunk = own.numel()
    _check_push(name, own, outs, rank, chunk)
    if bidir and chunk % 2:
        raise ValueError(f"{name} splits chunks in half, got {chunk} "
                         "elements")
    if own.device.type == "cpu":
        peer_all_gather_push_plain(own, outs, rank, bidir)
        return
    _check_cuda(name, own)
    halves = 2 if bidir else 1
    nbytes = chunk * own.element_size()
    word = _widest_word(nbytes // halves, own.data_ptr(),
                        *(o.data_ptr() + rank * nbytes for o in outs))
    counters = row_copy_counters("peer_gather", own.device)
    err = _build.entry("peer_collectives", "peer_gather_push")(
        own.data_ptr(), _table_ptr(name, outs), counters.data_ptr(), n, rank,
        nbytes, halves, word, _stream_of(own))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1


def peer_all_to_all_push_plain(own: torch.Tensor, outs: list[torch.Tensor],
                               rank: int) -> None:
    """The all-to-all's push in plain PyTorch: chunk s of ``own`` into
    slot ``rank`` of each destination ``outs[s]``, in :func:`push_order`;
    no other element of any destination is written."""
    kernels.PLAIN_CALLS["peer_all_to_all"] += 1
    chunk = own.numel() // len(outs)
    for _, _, s in push_order(len(outs), rank):
        outs[s][rank * chunk:(rank + 1) * chunk] = own[s * chunk:
                                                       (s + 1) * chunk]


def peer_all_to_all_push(own: torch.Tensor, outs, rank: int) -> None:
    """Rank ``rank``'s push all-to-all, the TPU kernel's schedule: stores
    chunk s of its input ``own`` (``(n*chunk,)``) into slot ``rank``
    (elements ``[rank*chunk, (rank+1)*chunk)``) of rank s's output
    ``outs[s]`` (``(n*chunk,)``: this rank's a tensor, a peer's a
    :class:`RemoteBuffer`; on the card a :class:`PeerParts`), so that
    ``outs[s][r] = x_r[s]`` once every rank has pushed: the caller's next
    barrier gives that.  One launch, counted as ``peer_all_to_all``, its 8
    KB tiles drawn in order from the card's ``peer_gather`` counters, the
    destinations fastest in :func:`push_order` (every card stores into
    every card at once, as the TPU kernel starts all its transfers), in
    the widest word dividing ``own``, every slot and the chunk's bytes."""
    name = "peer_all_to_all"
    n = len(outs)
    if own.numel() % n:
        raise ValueError(f"{name}: {own.numel()} elements are not {n} "
                         "chunks")
    chunk = own.numel() // n
    _check_push(name, own, outs, rank, chunk)
    if own.device.type == "cpu":
        peer_all_to_all_push_plain(own, outs, rank)
        return
    _check_cuda(name, own)
    nbytes = chunk * own.element_size()
    word = _widest_word(nbytes, own.data_ptr(),
                        *(o.data_ptr() + rank * nbytes for o in outs))
    counters = row_copy_counters("peer_gather", own.device)
    err = _build.entry("peer_collectives", "peer_all_to_all_push")(
        own.data_ptr(), _table_ptr(name, outs), counters.data_ptr(), n, rank,
        nbytes, word, _stream_of(own))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1


#: the ops whose peer form copies a whole buffer with peer_copy, each
#: counted apart (one source, as ring and exchange share p2p_shift.cu)
PEER_COPIES = ("peer_ring", "peer_exchange", "peer_pingpong")


def peer_copy_plain(name: str, src: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The peer copy in plain PyTorch: ``out = src``."""
    kernels.PLAIN_CALLS[name] += 1
    return src.clone() if out is None else out.copy_(src)


def peer_copy(name: str, src, *, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """``out = src`` for the op that ``name`` counts (one of
    :data:`PEER_COPIES`): ``src`` is a peer's buffer (a
    :class:`RemoteBuffer`) or this rank's own tensor, ``out`` this rank's
    (a new tensor when not given) or, for a push, a peer's.  One launch
    that copies it in the widest word dividing both addresses and the
    length, its 8 KB tiles drawn in order from the card's ``peer_copy``
    counters; it never waits.  A pushed copy is whole in the peer's
    buffer once the caller's next barrier has passed."""
    if name not in PEER_COPIES:
        raise ValueError(f"peer_copy counts one of {PEER_COPIES}, got {name!r}")
    if src.device.type == "cpu":
        return peer_copy_plain(name, src, out)
    _check_cuda(name, src)
    out = _check_out(name, out, _numel(src), src.dtype, src.device)
    nbytes = _numel(src) * src.dtype.itemsize
    word = _widest_word(nbytes, src.data_ptr(), out.data_ptr())
    counters = row_copy_counters("peer_copy", out.device)
    err = _build.entry("peer_collectives", "peer_copy")(
        src.data_ptr(), out.data_ptr(), counters.data_ptr(), nbytes, word,
        _stream_of(src if isinstance(out, RemoteBuffer) else out))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


#: the barrier's sets of ranks, by their code in the kernel: every rank
#: (``_global_barrier``), the ring neighbours (``_ring_barrier``), the pair
#: partner (``_pair_barrier``)
PEER_SETS = {"all": 0, "ring": 1, "pair": 2}


def barrier_set(peers: str, n: int, rank: int) -> list[int]:
    """The ranks a barrier of set ``peers`` signals and waits for, as the
    kernel names them: all n, the ring neighbours ``rank - 1`` and ``rank
    + 1``, or the pair partner ``rank + n/2`` (mod n)."""
    if peers == "ring":
        return [(rank - 1) % n, (rank + 1) % n]
    if peers == "pair":
        return [(rank + n // 2) % n]
    return list(range(n))


def peer_barrier_plain(pads: list[torch.Tensor], generation: torch.Tensor,
                       rank: int, peers: str = "all",
                       copy: tuple | None = None) -> None:
    """The barrier's signals in plain PyTorch: bump ``generation`` and
    write it into slot ``rank`` of the pad of every rank of the set, then
    copy ``copy = (src, dst)``.  Nothing waits: the ranks of one process
    run one after another, and a CPU world's ranks meet in their
    collectives."""
    kernels.PLAIN_CALLS["peer_barrier" if copy is None
                        else "peer_barrier_copy"] += 1
    generation += 1
    for s in barrier_set(peers, len(pads), rank):
        pads[s][rank] = generation[0]
    if copy is not None:
        copy[1].copy_(copy[0])


def peer_barrier(pads, generation: torch.Tensor, rank: int, *,
                 peers: str = "all", copy: tuple | None = None) -> None:
    """Rank ``rank`` signals the pads (``pads[s]``: n int32 slots, zero at
    first) of the ranks of set ``peers`` (:data:`PEER_SETS`,
    :func:`barrier_set`) with its next barrier generation and waits until
    each of them has signalled its own pad; then, with ``copy = (src,
    dst)``, copies src into dst (``pl_barrier``'s one element, counted as
    ``peer_barrier_copy``).  ``generation`` is this rank's own (1,) int32
    count, which only its barriers touch, on the device: a replayed graph
    advances it.  One launch of one warp; a wait past a minute of device
    time traps.  On the card ``pads`` is a :class:`PeerParts`."""
    n = len(pads)
    if _check_parts("peer_barrier", pads, rank) != n or pads[0].dtype != torch.int32:
        raise ValueError(f"peer_barrier: pads are {n} int32 slots each")
    if generation.dtype != torch.int32 or generation.numel() != 1:
        raise ValueError("peer_barrier: generation is one int32")
    if peers not in PEER_SETS:
        raise ValueError(f"peer_barrier: set {peers!r}, known: "
                         f"{tuple(PEER_SETS)}")
    if peers == "pair" and n % 2:
        raise ValueError(f"peer_barrier: a pair barrier needs an even rank "
                         f"count, got {n}")
    name = "peer_barrier"
    if copy is not None:
        name = "peer_barrier_copy"
        src, dst = copy
        if (src.numel(), src.dtype, src.device) != (dst.numel(), dst.dtype,
                                                     dst.device):
            raise ValueError("peer_barrier: the copy's src and dst differ")
    if generation.device.type == "cpu":
        peer_barrier_plain(pads, generation, rank, peers, copy)
        return
    _check_cuda(name, generation, *(copy or ()))
    src_ptr, dst_ptr, nbytes = ((copy[0].data_ptr(), copy[1].data_ptr(),
                                 copy[0].numel() * copy[0].element_size())
                                if copy is not None else (0, 0, 0))
    err = _build.entry("peer_collectives", "peer_barrier")(
        _table_ptr(name, pads), generation.data_ptr(), n, rank,
        PEER_SETS[peers], src_ptr, dst_ptr, nbytes, _stream_of(generation))
    _build.check(name, err)
    kernels.LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def peer_barrier_capacity(device_index: int) -> int:
    """How many barrier CTAs card ``device_index`` holds at once: a
    one-card loopback of n ranks needs n waiting barriers resident."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.entry("peer_collectives", "peer_barrier_capacity")(
            ctypes.byref(ctas))
    _build.check("peer barrier occupancy query", err)
    return ctas.value


class _DeviceBytes:
    # a device allocation this package made, seen by torch.as_tensor
    # through the CUDA array interface (torch takes no ownership)
    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None}


def _release_peer_memory(own: int, opened: list[int]) -> None:
    # at the buffers' end (or the interpreter's): close the peers'
    # mappings, free this rank's allocation; errors are not raised here
    try:
        for ptr in opened:
            _build.entry("peer_collectives", "peer_ipc_close")(ptr)
        _build.entry("peer_collectives", "peer_free")(own)
    except Exception:  # noqa: BLE001 — a finalizer must not raise
        pass


#: byte alignment of each buffer in a rank's symmetric allocation
_PEER_ALIGN = 256


class PeerBuffers:
    """One rank's symmetric buffers for a peer op on the card, and its
    views of its peers': the op's named buffers (``layout``: name ->
    (elements, dtype)) and the signal pad, in one allocation per rank
    (``peer_alloc``) whose IPC handle every peer opens (one
    ``all_gather_object`` on the world's group), or, where the world's
    ranks share one process, the allocations its ``peer_memory`` gives.
    Every rank lays its allocation out alike, so a buffer sits at the same
    offset in each.  ``self[name][s]`` is rank s's buffer ``name``: this
    rank's a tensor, a peer's a :class:`RemoteBuffer`.  ``pads`` is a
    :class:`PeerParts`, its table made here and freed with the buffers;
    ``generation`` is this rank's barrier count."""

    def __init__(self, world: DistWorld,
                 layout: dict[str, tuple[int, torch.dtype]]):
        n, rank, dev = world.n, world.rank, world.device
        shapes = [*layout.values(), (n, torch.int32)]
        offsets, total = [], 0
        for numel, dtype in shapes:
            offsets.append(total)
            total += -(-numel * dtype.itemsize // _PEER_ALIGN) * _PEER_ALIGN
        if world.peer_memory is not None:
            own, bases = world.peer_memory(rank, total)
            # the allocations' owner lives as long as the buffers
            self._memory = world.peer_memory
        else:
            own, bases = self._open(world, total)
        region = torch.as_tensor(_DeviceBytes(own, total), device=dev)

        def parts(k: int) -> list:
            lo, (numel, dtype) = offsets[k], shapes[k]
            return [region[lo:lo + numel * dtype.itemsize].view(dtype)
                    if s == rank else
                    RemoteBuffer(bases[s] + lo, numel, dtype, dev)
                    for s in range(n)]

        self._parts = {name: parts(k) for k, name in enumerate(layout)}
        self.pads = PeerParts(parts(len(layout)))
        self.generation = torch.zeros(1, dtype=torch.int32, device=dev)
        self._region = region

    def _open(self, world: DistWorld, total: int) -> tuple[int, list[int]]:
        # this rank's allocation and every rank's base as this process
        # maps it; the mappings are closed and the allocation freed with
        # the buffers
        import weakref

        # the world size apart from the rank: the `if n > 1` gate below
        # holds on every rank alike, so every rank meets the gather
        n = world.n
        rank, dev = world.rank, world.device
        entry = functools.partial(_build.entry, "peer_collectives")
        own = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _build.check("peer_alloc", entry("peer_alloc")(
                total, ctypes.byref(own)))
        bases, opened = [own.value] * n, []
        self._finalizer = weakref.finalize(self, _release_peer_memory,
                                           own.value, opened)
        if n > 1:
            import torch.distributed as dist

            handle = ctypes.create_string_buffer(64)
            _build.check("peer_ipc_handle",
                         entry("peer_ipc_handle")(own.value, handle))
            handles: list = [None] * n
            dist.all_gather_object(handles, handle.raw, group=world.group)
            with torch.cuda.device(dev):
                for s in range(n):
                    if s == rank:
                        continue
                    ptr = ctypes.c_void_p()
                    _build.check("peer_ipc_open", entry("peer_ipc_open")(
                        ctypes.create_string_buffer(handles[s], 64),
                        ctypes.byref(ptr)))
                    bases[s] = ptr.value
                    opened.append(ptr.value)
        return own.value, bases

    def __getitem__(self, name: str) -> list:
        return self._parts[name]


def _peer_chain(buffers: PeerBuffers, rank: int, iters: int, peers: str,
                load: Callable, execution: Callable,
                finish: Callable | None = None) -> Callable:
    """The card's step of a peer op: ``load(x)`` puts the input into this
    rank's symmetric buffer once a step; each execution meets the ranks of
    set ``peers`` at a barrier before it reads a peer, then
    ``execution(cur, last)`` reads the peers' input buffer ``cur`` (the
    two alternate) and writes the other one (this rank's, or with a push
    every rank's), or a new tensor at the last execution, whose result
    the step returns; a last barrier keeps a peer's next step from
    overwriting what this rank still reads, and completes the last push.
    ``finish`` (when given) takes the step's result after that barrier:
    a copy of a symmetric buffer, which a later step overwrites."""
    def barrier():
        peer_barrier(buffers.pads, buffers.generation, rank, peers=peers)

    def step(x):
        load(x)
        out = None
        for j in range(iters):
            barrier()
            out = execution(j % 2, j == iters - 1)
        barrier()
        return out if finish is None else finish(out)

    return step


def _inputs(world: DistWorld, elems: int, tdtype: torch.dtype,
            **more: tuple[int, torch.dtype]) -> PeerBuffers:
    # the two input buffers the executions alternate between, and more
    return PeerBuffers(world, {"in0": (elems, tdtype), "in1": (elems, tdtype),
                               **more})


def _chunk_tables(ins: list[list], rank: int, chunk: int) -> list[PeerParts]:
    """What rank ``rank`` reads of each input buffer in the reduce and the
    all-to-all: chunk ``rank`` of every rank's, with its pointer table."""
    return [PeerParts(_sub(p, rank * chunk, chunk) for p in parts)
            for parts in ins]


def _dist_allreduce_step(world: DistWorld, elems: int, chunk: int,
                         iters: int, tdtype: torch.dtype) -> Callable:
    """``pl_allreduce`` on one rank of a multi-rank world: per execution a
    reduce-scatter of the owned chunk (scaled by 1/n) and an all-gather of
    the owned chunks, the peer kernels' two data launches.

    On the card the input is copied into this rank's symmetric buffer
    once a step; each execution meets every rank at a barrier, reduces
    chunk d of every rank's input buffer j%2 into its mid, meets every
    rank again, and pushes its mid into slot d (chunk d) of every rank's
    input buffer 1-j%2; the last execution pulls the mids into a new
    tensor instead, its sources from rank d on (:func:`pull_order`).
    Pulling there beat pushing and returning a copy of the whole output
    after the last barrier: 1.2357-1.2461 ms an execution at -i 5 against
    1.2617-1.2647 across four cards at 256 MiB a rank, 2.0550-2.0555
    against 2.2167-2.2171 in the one-card loopback of 8 ranks (NVIDIA H100
    80GB HBM3, 700 W; ``python -m tpu_perf_torch.tools.peer_designs
    --parts steps``, which times the other way as an edit of this
    source).

    Hazards on the card.  Slot d of every rank's input buffers is written
    by rank d's pushes, and by each rank's copy-in, which fills its own
    buffer 0; the reduce of rank d reads slot d of every rank's buffer
    j%2, which rank d pushed itself at j-1 (stream order) or rank s's
    copy-in wrote before s signalled barrier 0.  A rank's output is whole
    only once every rank has pushed into it: barrier j+1, which each rank
    signals after its push of j.  A push at j overwrites slot d of buffer
    1-j%2, which only rank d read (at j-1), and the next step's copy-in
    overwrites buffer 0 after the step's last barrier, which every rank
    signals after its last push.  Rank d's mid is read by the pull of a
    last execution after the second barrier of j, which d signals after
    its reduce, and is next written at j+1, after barrier j+1, which
    every puller signals after its pull.  The step's result is a new
    tensor, which no push reaches.  On the CPU the peer
    kernels' plain versions run on what gloo's collectives bring: the n
    parts of the owned chunk (``all_to_all_single``), then the owned
    chunks (the pull gather's plain version)."""
    from tpu_perf_torch.parallel.multihost import _all_gather_tensor

    n, rank = world.n, world.rank
    inv = mean_scale(n, tdtype)
    if _gloo_path(world):
        def execution(x):
            mine = peer_reduce_scatter(list(_all_to_all_cpu(world, x, chunk)),
                                       rank, scale=inv)
            if n == 1:
                owned = mine.view(1, chunk)
            else:
                owned = torch.empty(n, chunk, dtype=tdtype)
                _all_gather_tensor(owned.view(-1), mine, group=world.group)
            return peer_all_gather(list(owned), rank)

        return _chain(execution, iters)

    buffers = _inputs(world, elems, tdtype, mid=(chunk, tdtype))
    ins = [buffers["in0"], buffers["in1"]]
    reads = _chunk_tables(ins, rank, chunk)
    mids = PeerParts(buffers["mid"])
    outs = [PeerParts(parts) for parts in ins]

    def execution(cur, final):
        peer_reduce_scatter(reads[cur], rank, scale=inv, out=mids[rank])
        peer_barrier(buffers.pads, buffers.generation, rank)
        if final:
            return peer_all_gather(mids, rank, out=_fresh(world, elems,
                                                          tdtype))
        peer_all_gather_push(mids[rank], outs[1 - cur], rank)
        return ins[1 - cur][rank]

    return _peer_chain(buffers, rank, iters, "all", ins[0][rank].copy_,
                       execution)


def _gloo_path(world: DistWorld) -> bool:
    """Whether a peer op's step runs its plain versions on what gloo's
    collectives bring (a CPU world) rather than the peer kernels on
    symmetric buffers (a world of cards)."""
    return world.device.type == "cpu"


def _chain(execution: Callable, iters: int) -> Callable:
    # iters chained executions, each fed the previous output
    from tpu_perf_torch.ops.collectives import chained

    return chained(execution, iters)


def _fresh(world: DistWorld, numel: int, tdtype: torch.dtype) -> torch.Tensor:
    # the last execution's output, which the step returns
    return torch.empty(numel, dtype=tdtype, device=world.device)


def _all_to_all_cpu(world: DistWorld, x: torch.Tensor, chunk: int):
    # on the CPU: the n chunks the ranks send this rank, (n, chunk)
    import torch.distributed as dist

    if world.n == 1:
        return x.view(1, chunk)
    recv = torch.empty_like(x)
    dist.all_to_all_single(recv, x, group=world.group)
    return recv.view(world.n, chunk)


def _dist_shift_step(op: str, world: DistWorld, elems: int, iters: int,
                     tdtype: torch.dtype) -> Callable:
    """``pl_ring`` (``out[d] = x[d-1]``, ring-neighbour barriers) or
    ``pl_exchange`` (``out[d] = x[d+n/2]``, pair barriers) on one rank:
    per execution one ``peer_copy`` that pulls the source rank's input
    into this rank's buffer, one launch as the TPU kernel's one remote
    copy (which pushes to d+1 or d+n/2: the same function).

    Hazards on the card.  Rank d reads only its source's buffers, and only
    its reader (d+1, or the partner) reads d's; source and reader are both
    in d's barrier set.  At execution j rank d reads its source's input
    buffer j%2, which the source wrote (at j-1, or its copy-in) before it
    signalled barrier j, and writes its own buffer 1-j%2, which its reader
    last read at j-1, before it signalled barrier j: d passed barrier j
    only after both.  The reader reads what d wrote at j+1, after d's
    signal of barrier j+1.  The last barrier keeps the next step's copy-in
    off a buffer the reader still reads.  A rank outside d's set (d+2 on
    a ring) never touches d's buffers, so it may run ahead.  On the CPU
    ``batch_isend_irecv`` brings the source's buffer and the plain version
    copies it."""
    from tpu_perf_torch.ops.collectives import _ppermute
    from tpu_perf_torch.topology import ring_permutation

    n, rank = world.n, world.rank
    name, shift = (("peer_ring", 1) if op == "pl_ring"
                   else ("peer_exchange", n // 2))
    if _gloo_path(world):
        perm = ring_permutation(n, shift=shift)
        return _chain(lambda x: peer_copy(name, _ppermute(world, x, perm)),
                      iters)
    buffers = _inputs(world, elems, tdtype)
    ins = [buffers["in0"], buffers["in1"]]
    src = (rank - shift) % n

    def execution(cur, last):
        return peer_copy(name, ins[cur][src], out=_fresh(
            world, elems, tdtype) if last else ins[1 - cur][rank])

    return _peer_chain(buffers, rank, iters,
                       "ring" if op == "pl_ring" else "pair",
                       ins[0][rank].copy_, execution)


def _dist_pingpong_step(world: DistWorld, elems: int, iters: int,
                        tdtype: torch.dtype) -> Callable:
    """``pl_pingpong`` on one rank: the round trip between partners d and
    d+n/2 as two serial legs, each a push, the TPU kernel's schedule, so
    that no data kernel waits.  Per execution: a pair barrier; group 0 (d
    < n/2) pushes its input into group 1's stage (leg 1) while group 1
    copies its own input into its output (the TPU kernel's local copy,
    under leg 1); a pair barrier; group 1 pushes its stage into group 0's
    output (leg 2).  The last execution's leg 2 is group 0's pull of the
    stage into a new tensor instead.  The op is the identity on both
    groups.  Launches an execution: two pair barriers, one copy in group 0
    (two at the last execution) and two in group 1 (one at the last); a
    step adds its last barrier.  Across four cards at 256 MiB a rank an
    execution took 1.4478-1.4481 ms, where pulled legs took 1.6228-1.6236
    with the local copy (0.18 alone) in series and 1.5135-1.5139 with it
    under leg 2; the last pull beat pushing leg 2 and returning a copy,
    1.4845-1.4853 ms an execution at -i 5 against 1.5212-1.5225 (NVIDIA
    H100 80GB HBM3, 700 W; ``python -m tpu_perf_torch.tools.peer_designs
    --parts pingpong,steps``).

    Hazards on the card.  Group 0's input buffers are written by its
    copy-in and by its partner's leg 2, and read by its own leg 1; group
    1's stage is written by its partner's leg 1 and read by its own leg 2
    and the partner's last pull; group 1's input buffers are its own
    alone.  Leg 1 of execution j reads group 0's buffer j%2, which leg 2
    of j-1 wrote before group 1 signalled the first barrier of j (or the
    copy-in), and overwrites the stage, which group 1 last read in leg 2
    of j-1, also before that signal.  Leg 2 reads the stage after the
    second barrier, which group 0 signals after leg 1, and writes group
    0's buffer 1-j%2, which group 0 last read in leg 1 of j-1, before it
    signalled the first barrier of j; group 0 reads it next in leg 1 of
    j+1, after the first barrier of j+1, which group 1 signals after leg
    2.  The last pull reads the stage after the second barrier; the step's
    last pair barrier, which group 0 signals after that pull, keeps group
    1 in the step (and its stage alive) until the read is done, and the
    next step's leg 1 comes after group 0's pull in its own stream.  On
    the CPU each leg is a ``batch_isend_irecv`` and the plain version
    copies what it brings."""
    from tpu_perf_torch.ops.collectives import _ppermute
    from tpu_perf_torch.topology import one_way_permutation

    n, rank = world.n, world.rank
    group1 = rank >= n // 2
    if _gloo_path(world):
        fwd = one_way_permutation(n)
        back = one_way_permutation(n, reverse=True)

        def execution(x):
            got = _ppermute(world, x, fwd)  # group 1: the partner's input
            if group1:
                stage = peer_copy("peer_pingpong", got)
                out = peer_copy("peer_pingpong", x)
                _ppermute(world, stage, back)
                return out
            return peer_copy("peer_pingpong", _ppermute(world, x, back))

        return _chain(execution, iters)

    buffers = _inputs(world, elems, tdtype, stage=(elems, tdtype))
    ins, stage = [buffers["in0"], buffers["in1"]], buffers["stage"]
    partner = (rank + n // 2) % n

    def execution(cur, final):
        out = _fresh(world, elems, tdtype) if final else ins[1 - cur][rank]
        if group1:
            peer_copy("peer_pingpong", ins[cur][rank], out=out)
        else:
            peer_copy("peer_pingpong", ins[cur][rank], out=stage[partner])
        peer_barrier(buffers.pads, buffers.generation, rank, peers="pair")
        if group1 and not final:
            peer_copy("peer_pingpong", stage[rank], out=ins[1 - cur][partner])
        elif not group1 and final:
            peer_copy("peer_pingpong", stage[partner], out=out)
        return out

    return _peer_chain(buffers, rank, iters, "pair", ins[0][rank].copy_,
                       execution)


def _dist_barrier_step(world: DistWorld, iters: int,
                       tdtype: torch.dtype) -> Callable:
    """``pl_barrier`` on one rank: per execution one all-rank
    ``peer_barrier`` with its tail copy of the one element, the TPU
    kernel's global barrier and tiny local copy in one launch, as that is
    one ``pallas_call``.  No rank reads another's data, so the pads are
    the only symmetric buffer and no last barrier is needed; the copies
    alternate between two local buffers (the last into a new tensor).  On
    the CPU the ranks meet at gloo's barrier, then the plain version
    signals stand-ins for the peers' pads and copies."""
    n, rank = world.n, world.rank
    if _gloo_path(world):
        import torch.distributed as dist

        pads = [torch.zeros(n, dtype=torch.int32) for _ in range(n)]
        generation = torch.zeros(1, dtype=torch.int32)

        def execution(x):
            dist.barrier(group=world.group)
            out = torch.empty_like(x)
            peer_barrier(pads, generation, rank, copy=(x, out))
            return out

        return _chain(execution, iters)

    buffers = PeerBuffers(world, {})
    spare = [_fresh(world, 1, tdtype) for _ in range(2)]

    def step(x):
        for j in range(iters):
            out = torch.empty_like(x) if j == iters - 1 else spare[j % 2]
            peer_barrier(buffers.pads, buffers.generation, rank,
                         copy=(x, out))
            x = out
        return x

    return step


def _dist_all_to_all_step(world: DistWorld, elems: int, chunk: int,
                          iters: int, tdtype: torch.dtype) -> Callable:
    """``pl_all_to_all`` on one rank, ``out[s] = x_s[d]``: per execution,
    after an all-rank barrier (the TPU kernel's ``_global_barrier``), one
    ``peer_all_to_all_push``: rank d stores chunk s of its input buffer
    j%2 into slot d of rank s's buffer 1-j%2, the destinations staggered
    (s = d, d+1, ...), as the TPU kernel sends chunk s to device s.  The
    last execution pulls chunk d of every rank's buffer j%2 into a new
    tensor instead, its sources staggered the same way.  Across four
    cards at 256 MiB a rank the push took 0.5605 ms a launch, the pull
    0.6200-0.6280 (in address order, the PRs before, 0.9576-0.9850); at
    the last execution the pull beat pushing and returning a copy:
    0.6133-0.6148 ms an execution at -i 5 against 0.6389-0.6400, and
    1.7666-1.7674 against 2.0508-2.0516 in the one-card loopback of 8
    ranks (NVIDIA H100 80GB HBM3, 700 W; ``python -m
    tpu_perf_torch.tools.peer_designs --parts a2a,steps``).

    Hazards on the card.  Slot d of any rank's input buffers is written
    only by rank d (its pushes) and by the buffer's own rank (its copy-in,
    which fills its buffer 0 whole); rank s reads its own buffer (every
    chunk, to push it on) and, at the last execution, chunk d of every
    rank's.  A push of rank d at j reads its own buffer j%2, whose slot s
    rank s pushed at j-1 before it signalled barrier j (or d's copy-in
    wrote), and writes slot d of rank s's buffer 1-j%2, which rank s last
    read at j-1 (its push, or nothing), before it signalled barrier j: d
    passed barrier j only after both.  So the pushes of one execution
    never touch what another rank reads, and a rank's output is whole at
    the next barrier, which every rank signals after its push.  The last
    pull reads buffer j%2 of every rank after barrier j; the step's last
    barrier, which every puller signals after its pull, keeps the next
    step's copy-in (buffer 0) and pushes (buffer 1, after the next step's
    first barrier) off what it reads, and the step's result is a new
    tensor, which no push reaches.  On the CPU ``all_to_all_single``
    brings the n chunks and the pull's plain version stores them."""
    n, rank = world.n, world.rank
    if _gloo_path(world):
        return _chain(lambda x: peer_all_to_all(
            list(_all_to_all_cpu(world, x, chunk)), rank), iters)
    buffers = _inputs(world, elems, tdtype)
    ins = [buffers["in0"], buffers["in1"]]
    outs = [PeerParts(parts) for parts in ins]
    reads = _chunk_tables(ins, rank, chunk)

    def execution(cur, final):
        if final:
            return peer_all_to_all(reads[cur], rank,
                                   out=_fresh(world, elems, tdtype))
        peer_all_to_all_push(ins[cur][rank], outs[1 - cur], rank)
        return ins[1 - cur][rank]

    return _peer_chain(buffers, rank, iters, "all", ins[0][rank].copy_,
                       execution)


def _dist_reduce_scatter_step(world: DistWorld, elems: int, chunk: int,
                              iters: int, tdtype: torch.dtype) -> Callable:
    """``pl_reduce_scatter`` on one rank: per execution one
    ``peer_reduce_scatter`` of chunk d of every rank's input, in the
    ring's order, scaled by 1/n and written n times along the output (the
    JAX carry ``jnp.tile(mine * inv, n)``, in the kernel), after an
    all-rank barrier.  Every rank reads every rank's input: the argument
    of :func:`_dist_all_to_all_step`.  On the CPU ``all_to_all_single``
    brings the n parts."""
    n, rank = world.n, world.rank
    inv = mean_scale(n, tdtype)
    if _gloo_path(world):
        return _chain(lambda x: peer_reduce_scatter(
            list(_all_to_all_cpu(world, x, chunk)), rank, scale=inv,
            tiles=n), iters)
    buffers = _inputs(world, elems, tdtype)
    ins = [buffers["in0"], buffers["in1"]]
    reads = _chunk_tables(ins, rank, chunk)

    def execution(cur, last):
        return peer_reduce_scatter(
            reads[cur], rank, scale=inv, tiles=n,
            out=_fresh(world, elems, tdtype) if last else ins[1 - cur][rank])

    return _peer_chain(buffers, rank, iters, "all", ins[0][rank].copy_,
                       execution)


def _dist_gather_step(op: str, world: DistWorld, chunk: int, iters: int,
                      tdtype: torch.dtype) -> Callable:
    """``pl_all_gather`` (``peer_all_gather``) or ``pl_all_gather_bidir``
    (``peer_all_gather_bidir``) on one rank: per execution one gather of
    every rank's own chunk, then the JAX carry, the own chunk taken back
    out.  On the card each rank keeps two symmetric gathered buffers
    (``n * chunk``); each execution pushes this rank's own chunk, slot d
    of its current buffer, into slot d of every rank's other buffer (the
    bidirectional op in half-chunks, both ways round the ring): the
    carry's own chunk is read in place, so no slice copy runs between
    executions.  The last execution pushes too, and the step returns a
    copy of the own slot taken after its last barrier.  That beat pulling
    every rank's own slot into a new tensor at the last execution: 0.929-
    0.933 ms an execution of ``pl_all_gather`` at -i 5 against 0.944-0.952,
    8 ranks x 256 MiB in the one-card loopback (NVIDIA H100 80GB HBM3, 700
    W; ``python -m tpu_perf_torch.tools.peer_designs --parts steps``,
    which times the pull as an edit of this source).

    Hazards on the card.  Slot d of any rank's gathered buffers is written
    only by rank d (its pushes, and its copy-in into its own buffer 0) and
    read only by rank d (its own chunk, pushed at the next execution and
    copied at the end).  So the pushes of one execution never touch what
    another rank reads, and every rank's output is whole at the next
    barrier, which each rank signals after its push.  The step's result
    is a copy of the own slot, taken after the last barrier and before
    the next step's copy-in in this rank's stream, in a tensor no push
    reaches.  On the CPU an all-gather brings the owned chunks and the
    pull gather's plain version runs on them."""
    from tpu_perf_torch.parallel.multihost import _all_gather_tensor

    n, rank = world.n, world.rank
    mine = slice(rank * chunk, (rank + 1) * chunk)

    def gather(parts, out=None):
        if op == "pl_all_gather":
            return peer_all_gather(parts, rank, out=out)
        return peer_all_gather_bidir(parts, rank, out=out)

    if _gloo_path(world):
        def execution(x):
            owned = x.view(1, chunk)
            if n > 1:
                owned = torch.empty(n, chunk, dtype=tdtype)
                _all_gather_tensor(owned.view(-1), x, group=world.group)
            return gather(list(owned))[mine]

        return _chain(execution, iters)

    buffers = _inputs(world, n * chunk, tdtype)
    gathered = [buffers["in0"], buffers["in1"]]
    outs = [PeerParts(parts) for parts in gathered]

    def execution(cur, final):
        peer_all_gather_push(gathered[cur][rank][mine], outs[1 - cur], rank,
                             bidir=op == "pl_all_gather_bidir")
        return gathered[1 - cur][rank][mine]

    return _peer_chain(buffers, rank, iters, "all",
                       gathered[0][rank][mine].copy_, execution, torch.clone)


def _rs_chunk(nbytes: int, itemsize: int, n: int) -> int:
    """The reduce-scatter ops' chunk: the per-rank input's n-th, rounded
    up to a whole number of the JAX package's accumulation tiles."""
    raw_chunk = max(1, -(-max(1, -(-nbytes // itemsize)) // n))
    if raw_chunk > _ACC_TILE_ELEMS:
        return -(-raw_chunk // _ACC_TILE_ELEMS) * _ACC_TILE_ELEMS
    return raw_chunk


#: the local memory instruments: their function is each rank's own
_LOCAL_PALLAS_OPS = ("pl_hbm_stream", "pl_hbm_copy", "pl_hbm_read",
                     "pl_hbm_write")


def _build_dist_pallas_step(op: str, world: DistWorld, nbytes: int,
                            iters: int, *, dtype: str
                            ) -> tuple[Callable, int, int]:
    """A ``pl_*`` op on one rank of a multi-rank world, at any world size
    the JAX op accepts.  The local memory instruments run the rank's sim
    kernel at n = 1 on its own buffer, as the JAX package runs them on
    every device of its mesh; every other op runs its peer form
    (``pl_allreduce`` in a world of one too, where the JAX op asks for
    two devices: the world of one still meets at its barrier and reads
    through its tables).  Sizes and refusals are the sim world's."""
    from tpu_perf_torch.ops.collectives import DTYPES

    if len(world.axis_names) != 1:
        raise ValueError(
            f"pallas ops need a single-axis mesh, got axes {world.axis_names}")
    n, tdtype = world.n, DTYPES[dtype]
    if op == "pl_allreduce":
        chunk = _rs_chunk(nbytes, tdtype.itemsize, n)
        elems = chunk * n
        return (_dist_allreduce_step(world, elems, chunk, iters, tdtype),
                elems, elems * tdtype.itemsize)
    elems, chunk, actual = _pallas_sizes(op, n, nbytes, tdtype.itemsize)
    if op in _LOCAL_PALLAS_OPS:
        step, _, _ = build_pallas_step(
            op, SimWorld(1, world.device), nbytes, iters, dtype=dtype)
        return (lambda x: step(x.view(1, -1)).view(-1)), elems, actual
    if op in ("pl_ring", "pl_exchange"):
        step = _dist_shift_step(op, world, elems, iters, tdtype)
    elif op == "pl_pingpong":
        step = _dist_pingpong_step(world, elems, iters, tdtype)
    elif op == "pl_barrier":
        step = _dist_barrier_step(world, iters, tdtype)
    elif op == "pl_all_to_all":
        step = _dist_all_to_all_step(world, elems, chunk, iters, tdtype)
    elif op == "pl_reduce_scatter":
        step = _dist_reduce_scatter_step(world, elems, chunk, iters, tdtype)
    else:  # pl_all_gather, pl_all_gather_bidir
        step = _dist_gather_step(op, world, chunk, iters, tdtype)
    return step, elems, actual


# --- the pl_* ops -------------------------------------------------------


def _pallas_sizes(op: str, n: int, nbytes: int,
                  itemsize: int) -> tuple[int, int, int]:
    """``(elems_per_rank, chunk, actual_nbytes)`` of ``op`` on n ranks: the
    JAX package's sizes, and its refusals word for word."""
    if op in ("pl_exchange", "pl_pingpong") and n % 2:
        raise ValueError(f"{op} needs an even device count, got {n}")
    if op == "pl_all_gather":
        # nbytes = gathered total; per-rank shard = nbytes/n
        chunk = max(1, -(-nbytes // (itemsize * n)))
        return chunk, chunk, chunk * n * itemsize
    if op == "pl_all_gather_bidir":
        # the same gathered-total semantics; the shard splits into two
        # half-chunks, one per ring direction, so chunk rounds up to even
        chunk = max(2, -(-nbytes // (itemsize * n)))
        chunk += chunk % 2
        return chunk, chunk, chunk * n * itemsize
    if op == "pl_all_to_all":
        # nbytes = per-rank input buffer; chunk = elems/n per destination
        raw = max(1, -(-nbytes // itemsize))
        chunk = max(1, -(-raw // n))
        return chunk * n, chunk, chunk * n * itemsize
    if op in ("pl_reduce_scatter", "pl_allreduce"):
        if n < 2:
            raise ValueError(f"{op} needs at least 2 devices, got {n}")
        # nbytes = per-rank input buffer; chunk = elems/n, rounded up to a
        # whole number of the JAX package's accumulation tiles
        chunk = _rs_chunk(nbytes, itemsize, n)
        return chunk * n, chunk, chunk * n * itemsize
    if op in ("pl_hbm_read", "pl_hbm_write"):
        # the single-sided sweeps round up to the 4 KiB DMA tiling, not to
        # the itemsize: every 4 KiB-multiple sweep size still lands on the
        # hbm_read / hbm_write curve key
        align = max(1, _DMA_ALIGN_BYTES // itemsize)
        elems = -(-max(1, -(-nbytes // itemsize)) // align) * align
        return elems, elems, elems * itemsize
    if op == "pl_barrier":
        if n < 2:
            # the JAX package's message, kept word for word
            raise ValueError(
                "pl_barrier needs at least 2 devices; a single-device "
                "run measures a local semaphore self-signal, not ICI"
            )
        # latency only: one element whatever -b asks, like the barrier op
        return 1, 1, itemsize
    # the hbm_stream rounding: pl_hbm_stream, pl_hbm_copy, pl_ring,
    # pl_exchange, pl_pingpong
    elems = max(1, -(-nbytes // itemsize))
    return elems, elems, elems * itemsize


def build_pallas_step(op: str, world: SimWorld | DistWorld, nbytes: int,
                      iters: int, *,
                      dtype: str = "float32") -> tuple[Callable, int, int]:
    """The step executing ``iters`` chained kernel executions for ``op``.

    Returns ``(step, elems_per_rank, actual_nbytes)``; the caller
    (ops.build_op) makes the example input and wraps it into a BuiltOp.
    """
    from tpu_perf_torch.ops.collectives import DTYPES

    if op not in PALLAS_OPS:
        raise ValueError(f"unknown pallas op {op!r}; known: {PALLAS_OPS}")
    if is_dist(world):
        return _build_dist_pallas_step(op, world, nbytes, iters, dtype=dtype)
    if len(world.axis_names) != 1:
        # the kernels address ranks by their index on one axis
        raise ValueError(
            f"pallas ops need a single-axis mesh, got axes {world.axis_names}")
    n = world.n
    tdtype = DTYPES[dtype]
    itemsize = tdtype.itemsize
    elems, chunk, actual = _pallas_sizes(op, n, nbytes, itemsize)

    d = torch.arange(n, device=world.device)

    def own_chunks(t):
        # row d's chunk d, as (n, chunk): the take-own-shard slice
        return t.view(n, n, chunk)[d, d]

    if op == "pl_all_gather":
        # gather, then take the own shard back out (the JAX carry)
        return _chain(lambda x: own_chunks(direct_all_gather(x)), iters), \
            elems, actual
    if op == "pl_all_gather_bidir":
        return _chain(lambda x: own_chunks(direct_all_gather_bidir(x)),
                      iters), elems, actual
    # each iteration feeds the previous output forward, as in JAX
    if op == "pl_all_to_all":
        return _chain(all_to_all, iters), elems, actual
    if op == "pl_hbm_stream":
        return _chain(stream, iters), elems, actual
    if op == "pl_hbm_copy":
        return _chain(hbm_copy, iters), elems, actual
    if op == "pl_hbm_read":
        return _chain(hbm_read, iters), elems, actual
    if op == "pl_hbm_write":
        block = hbm_dma_block_elems(itemsize, elems)
        return _chain(lambda x: hbm_write(x, block), iters), elems, actual
    if op == "pl_ring":
        return _chain(ring_shift, iters), elems, actual
    if op == "pl_exchange":
        return _chain(pair_exchange, iters), elems, actual
    if op == "pl_pingpong":
        # the round trip is the identity on both groups; the stage output
        # is discarded, as the JAX step discards it
        return _chain(lambda x: pingpong(x)[0], iters), elems, actual
    if op == "pl_barrier":
        return _chain(barrier, iters), elems, actual
    # the kernel scales each reduced element by 1/n (the gather only moves
    # values, so scaling before it gives JAX's bits)
    inv = mean_scale(n, tdtype)
    if op == "pl_reduce_scatter":
        # own reduced chunk * 1/n, tiled over the whole buffer
        return _chain(lambda x: direct_reduce_scatter(x, scale=inv, tiles=n),
                      iters), elems, actual
    # reduce-scatter phase (scaled), all-gather phase of the owned chunks
    return _chain(
        lambda x: direct_all_gather(direct_reduce_scatter(x, scale=inv)),
        iters), elems, actual
