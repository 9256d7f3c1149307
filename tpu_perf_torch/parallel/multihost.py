"""Multi-process worlds: joining one, the (dcn, ici) mesh over its nodes,
and the cross-rank stats (port of ``tpu_perf/parallel/multihost.py``).

The reference scales across hosts with ``mpirun`` and one process a
rank, and aggregates timings with ``MPI_Allreduce`` (mpi_perf.c:560-562).
The JAX package joins one controller process a host through
``jax.distributed.initialize``.  This package takes the PyTorch idiom:
one process a rank (``torchrun``, or the caller's own launcher), joined
through ``torch.distributed`` with NCCL on the card and gloo on the CPU:

* :func:`initialize_distributed` joins from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from explicit arguments, as the JAX function takes
  them, and stays single-process with a warning when it finds neither;
* :func:`make_hybrid_mesh` lays the ranks over ``(dcn, ici)``: the nodes
  (``WORLD_SIZE / LOCAL_WORLD_SIZE``) by the ranks of a node;
* :func:`exchange_ips` is the reference's rank-card allgather;
* :func:`allreduce_times` is the min/max/avg triple over every rank;
* :func:`leave_world` ends the process group (``cli.main`` calls it
  when a command that joined one ends, on every exit path).

A process that never joined takes the no-op paths, so every call here
is safe to make unconditionally.
"""

from __future__ import annotations

import math
import numbers
import os
import sys

import torch
import torch.distributed as dist

from tpu_perf_torch.parallel.mesh import Mesh, make_mesh

#: torchrun's variables, all four needed to join without arguments
_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _all_gather_tensor(out: torch.Tensor, t: torch.Tensor, group=None):
    # the name each torch version has without a deprecation warning
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    return fn(out, t, group=group)


def _reduce_scatter_tensor(out: torch.Tensor, t: torch.Tensor, group=None):
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    return fn(out, t, group=group)


def joined() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str = "cuda") -> bool:
    """Join the multi-process job; returns True when this process is in a
    process group, False when it stays single-process.

    With no arguments the world comes from torchrun's environment;
    ``coordinator`` (``host:port``), ``num_processes`` and ``process_id``
    override it for a manual launch, as the JAX function takes them.
    ``device`` ``"cuda"`` joins through NCCL, on card ``LOCAL_RANK`` (made
    the current card first); ``"cpu"`` through gloo.  NCCL is never
    swapped for gloo on a card.  A process that finds no cluster and was
    given no arguments stays single-process with the JAX package's
    warning on stderr, and its device is left as it was.  Idempotent: a
    process already in a group returns True at once."""
    if joined():
        return True
    env = os.environ
    explicit = (coordinator, num_processes, process_id) != (None, None, None)
    if explicit:
        if None in (coordinator, num_processes, process_id):
            raise ValueError(
                "coordinator, num_processes and process_id are given "
                "together (a manual launch names all three)")
        addr, world, rank = coordinator, int(num_processes), int(process_id)
    elif all(k in env for k in _ENV_KEYS):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        print("[tpu-perf-torch] not joining a multi-host cluster; running "
              f"single-process (none of {', '.join(_ENV_KEYS)} set and no "
              "coordinator given)", file=sys.stderr)
        return False
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if device == "cuda":
        if not torch.cuda.is_available():
            from tpu_perf_torch.world import NoDeviceError

            raise NoDeviceError(
                "a distributed world on the card needs a visible CUDA "
                "device (pass --device cpu to join through gloo)")
        local = local_rank()
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=f"tcp://{addr}",
                                world_size=world, rank=rank,
                                device_id=torch.device("cuda", local))
    elif device == "cpu":
        dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                                world_size=world, rank=rank)
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return True


def leave_world(*, barrier: bool = True) -> None:
    """End this process' process group: one ``barrier`` first (every rank
    has flushed its last row when it arrives), then
    ``destroy_process_group``, which joins the backend's threads.  A
    process still in its group at interpreter exit dies there with SIGABRT
    (the gloo and NCCL threads are destroyed while joinable), though its
    run was whole.  A process that never joined does nothing."""
    if not joined():
        return
    try:
        if barrier:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def local_rank() -> int:
    """This process' rank on its node (torchrun's ``LOCAL_RANK``; the
    global rank when unset, one node)."""
    env = os.environ
    if "LOCAL_RANK" in env:
        return int(env["LOCAL_RANK"])
    return dist.get_rank() if joined() else int(env.get("RANK", 0))


def world_size() -> int:
    return dist.get_world_size() if joined() else 1


def local_world_size() -> int:
    """Ranks a node (torchrun's ``LOCAL_WORLD_SIZE``; the whole world
    when unset, one node)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return world_size()


def make_hybrid_mesh(*, n: int | None = None, per_node: int | None = None,
                     dcn_axis: str = "dcn", ici_axis: str = "ici") -> Mesh:
    """The ``(dcn, ici)`` mesh: the leading axis spans the nodes, the
    trailing one the ranks of a node.  ``n`` and ``per_node`` default to
    the world's size and ``LOCAL_WORLD_SIZE``; a single process is one
    node of one rank, so the same path (and the same ``hier_allreduce``)
    runs everywhere."""
    n = world_size() if n is None else n
    per_node = local_world_size() if per_node is None else per_node
    if per_node < 1 or n % per_node:
        raise ValueError(
            f"{n} devices do not divide evenly over nodes of {per_node} "
            "ranks — a degraded pod cannot form a (dcn, ici) mesh")
    return make_mesh((n // per_node, per_node), (dcn_axis, ici_axis), n=n)


def _wire_device() -> torch.device:
    # the device a collective's tensors live on: the card under NCCL
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def exchange_ips(ip: str) -> list[str]:
    """Allgather of each rank's IP string, indexed by rank: the
    reference's rank-card ``MPI_Allgather`` behind peer discovery
    (mpi_perf.c:204-224), 16 bytes a rank.  Single process: ``[ip]``."""
    n = world_size()
    if n == 1:
        return [ip]
    raw = ip.encode()[:16]
    buf = torch.zeros(16, dtype=torch.uint8)
    buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    dev = _wire_device()
    out = torch.empty(n * 16, dtype=torch.uint8, device=dev)
    _all_gather_tensor(out, buf.to(dev))
    rows = out.cpu().view(n, 16).tolist()
    return [bytes(b for b in row if b).decode() for row in rows]


def share_job_id(job_id: str) -> str:
    """Rank 0's job ID on every rank: the reference mints its run UUID
    while parsing the options on rank 0 and broadcasts them, so every
    rank's rows and records carry one ``JobId`` (mpi_perf.c:335-338,
    :394-422), and the timeline aligns a job's ranks on their shared
    heartbeat boundaries.  Single process: ``job_id``."""
    if world_size() == 1:
        return job_id
    raw = job_id.encode()[:64]
    buf = torch.zeros(64, dtype=torch.uint8)
    buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    buf = buf.to(_wire_device())
    dist.broadcast(buf, src=0)
    return bytes(b for b in buf.cpu().tolist() if b).decode()


def allreduce_times(t_seconds: float | list[float]) -> dict[str, float]:
    """The reference's ``MPI_Allreduce`` MIN/MAX/SUM triple
    (mpi_perf.c:560-562) over every rank, of one sample or a whole stats
    window.

    The window is reduced locally to its (min, max, avg) first, so three
    scalars a rank cross the wire whatever the window's length; the
    cross-rank ``avg`` is the mean of the ranks' averages.  A rank with no
    data passes NaN (or an empty window): it still enters the collective,
    since skipping it would leave the others waiting, and its row is left
    out of the triple; all-NaN gives NaNs.  In this package one process is
    one rank, so the triple runs over the ranks, where the JAX package's
    runs over processes that each hold several chips.  A single process
    returns its local triple."""
    if isinstance(t_seconds, numbers.Real) or (
            hasattr(t_seconds, "ndim") and t_seconds.ndim == 0):
        samples = [float(t_seconds)]
    else:
        samples = [float(s) for s in t_seconds]
    valid_local = [s for s in samples if not math.isnan(s)]
    if valid_local:
        local = [min(valid_local), max(valid_local),
                 sum(valid_local) / len(valid_local)]
    else:
        local = [float("nan")] * 3
    n = world_size()
    if n == 1:
        return {"min": local[0], "max": local[1], "avg": local[2]}
    dev = _wire_device()
    out = torch.empty(n * 3, dtype=torch.float64, device=dev)
    _all_gather_tensor(out, torch.tensor(local, dtype=torch.float64,
                                         device=dev))
    triples = out.cpu().view(n, 3)
    # a rank contributes all three or none (a NaN row)
    valid = triples[~torch.isnan(triples[:, 0])]
    if valid.numel() == 0:
        nan = float("nan")
        return {"min": nan, "max": nan, "avg": nan}
    return {"min": float(valid[:, 0].min()), "max": float(valid[:, 1].max()),
            "avg": float(valid[:, 2].mean())}
