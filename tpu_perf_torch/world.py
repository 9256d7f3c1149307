"""The worlds an op runs in: the single-card sim world and the
multi-process world (counterparts of ``tpu_perf/parallel``).

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

The multi-process world (:class:`DistWorld`) is the PyTorch idiom of the
JAX package's mesh over several processes: one process a rank, joined
through ``torch.distributed`` (NCCL on the card, gloo on the CPU), each
rank holding its own ``(elems,)`` buffer, the JAX global layout's
``[r*elems, (r+1)*elems)`` (:func:`to_rank`).  Either world may carry a
named mesh (:mod:`tpu_perf_torch.parallel.mesh`) over its ranks; the
hierarchical ``hier_allreduce`` needs its two axes ``(dcn, ici)``.
"""

from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

from tpu_perf_torch.parallel.mesh import Mesh, make_mesh


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


def _check_mesh(mesh: Mesh | None, n: int) -> None:
    if mesh is not None and mesh.size != n:
        raise ValueError(f"mesh shape {mesh.shape} does not cover {n} devices")


@dataclasses.dataclass(frozen=True)
class SimWorld:
    """n sim ranks on one device; rank r's buffer is row r.  ``mesh``
    (None: one axis ``"x"``) names the ranks' layout, row-major."""

    n: int
    device: torch.device
    mesh: Mesh | None = None

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"a sim world needs at least one rank, got {self.n}")
        _check_mesh(self.mesh, self.n)

    @property
    def backend(self) -> str:
        """The rows' backend column: a one-rank world measures the card
        itself; more ranks share it and measure an emulation."""
        return "torch-sim" if self.n > 1 else "torch"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.mesh.axis_names if self.mesh is not None else ("x",)


@dataclasses.dataclass(frozen=True, eq=False)
class DistWorld:
    """This process' rank of a ``torch.distributed`` world of ``n`` ranks:
    its buffers are ``(elems,)`` tensors on ``device`` (``cuda:LOCAL_RANK``,
    or the CPU when asked), its collectives run on ``group`` (None: the
    default group) and ``mesh`` lays the ranks out (one axis ``"x"`` by
    default).  Rows carry ``backend="torch"``: each rank measures its own
    card and its links."""

    rank: int
    n: int
    local_rank: int
    device: torch.device
    mesh: Mesh
    group: object = None
    #: axis name -> (this rank's process group along it, its ranks); the
    #: groups are made once, the first time an axis is asked for
    _axis_groups: dict = dataclasses.field(default_factory=dict, repr=False)
    #: where the peer ops' symmetric allocations come from when the ranks
    #: share one process (the one-card loopback): ``(rank, nbytes) ->
    #: (this rank's pointer, every rank's pointer)``, the allocations its
    #: own; None: one allocation a process, whose IPC handle every peer
    #: opens (:class:`tpu_perf_torch.ops.pallas_ring.PeerBuffers`)
    peer_memory: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        _check_mesh(self.mesh, self.n)

    backend = "torch"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.mesh.axis_names

    def axis_group(self, axis: str | tuple[str, ...]
                   ) -> tuple[object, list[int]]:
        """``(group, ranks)`` of this rank along mesh axis ``axis`` (or
        the axes of a tuple, row-major in its order): the ranks whose
        other coordinates equal this rank's.  Every rank makes every group
        of the axis in the same order (``new_group`` is a collective of
        the whole world) the first time the axis is asked for; a group of
        one rank is None and its collectives are local."""
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        if key not in self._axis_groups:
            import torch.distributed as dist

            for ranks in self.mesh.groups(key):
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if self.rank in ranks:
                    self._axis_groups[key] = (group, ranks)
        return self._axis_groups[key]

    def along(self, axis: str | tuple[str, ...]) -> "DistWorld":
        """This rank's world along ``axis``: its group's ranks as a world
        of their own (``rank`` its index there, collectives on the axis
        group, one axis ``"x"``).  A group of one rank is a world of one
        with no group: its ops run locally."""
        group, ranks = self.axis_group(axis)
        n = len(ranks)
        return DistWorld(rank=ranks.index(self.rank), n=n,
                         local_rank=self.local_rank, device=self.device,
                         mesh=make_mesh(n=n), group=group)

    def max_over_ranks(self, samples: list[float | None]
                       ) -> list[float | None]:
        """Each sample replaced by its maximum over the ranks, in one
        ``all_reduce(MAX)`` (nccl-tests' convention: a collective takes as
        long as its slowest rank).  None is a sample this rank lost; a
        sample every rank lost stays None."""
        if self.n == 1 or not samples:
            return list(samples)
        import torch.distributed as dist

        t = torch.tensor([-math.inf if s is None else s for s in samples],
                         dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return [None if v == -math.inf else v for v in t.tolist()]


class LoopbackMemory:
    """The symmetric allocations of an n-rank loopback (n ranks in one
    process on one card), every rank's ``DistWorld.peer_memory``: the
    k-th ``PeerBuffers`` each rank makes gets the k-th set of n zeroed
    allocations, one a rank, made when the first rank asks and kept as
    long as this object."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self._sets: list[list[torch.Tensor]] = []
        self._asked = [0] * n

    def __call__(self, rank: int, nbytes: int) -> tuple[int, list[int]]:
        k = self._asked[rank]
        self._asked[rank] += 1
        if k == len(self._sets):
            self._sets.append([torch.zeros(nbytes, dtype=torch.uint8,
                                           device=self.device)
                               for _ in range(self.n)])
        ptrs = [t.data_ptr() for t in self._sets[k]]
        return ptrs[rank], ptrs


def loopback_ranks(n: int, device: torch.device) -> list[DistWorld]:
    """The n ranks of a loopback world on ``device``: each a DistWorld
    whose symmetric buffers one shared :class:`LoopbackMemory` gives."""
    memory = LoopbackMemory(n, device)
    return [DistWorld(rank=r, n=n, local_rank=0, device=device,
                      mesh=make_mesh(n=n), peer_memory=memory)
            for r in range(n)]


def dist_world(device: torch.device, mesh: Mesh | None = None) -> DistWorld:
    """This process' :class:`DistWorld` in the joined default group
    (:func:`tpu_perf_torch.parallel.initialize_distributed`); ``mesh``
    defaults to one axis over every rank."""
    import torch.distributed as dist

    from tpu_perf_torch.parallel.multihost import local_rank

    n = dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return DistWorld(rank=dist.get_rank(), n=n, local_rank=local_rank(),
                     device=device, mesh=mesh or make_mesh(n=n))


def is_dist(world) -> bool:
    return isinstance(world, DistWorld)


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


def to_rank(global_np: np.ndarray, n: int, rank: int) -> np.ndarray:
    """JAX global layout -> rank ``rank``'s own buffer in an ``n``-rank
    world: ``(n*elems,)`` -> its ``[rank*elems, (rank+1)*elems)``, and the
    windowed ``(W, n*elems)`` -> its ``(W, elems)`` columns."""
    rows = to_world(global_np, n)
    return np.ascontiguousarray(rows[rank])


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
