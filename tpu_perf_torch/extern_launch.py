"""External client/server launcher mode (the reference's dotnet path;
copy of ``tpu_perf/extern_launch.py``).

The reference's ``-d`` flag short-circuits the MPI kernels: each rank builds
a ``dotnet clientserverapp.dll server|client <ip> <port> <flows> <bytes>
<iters> ...`` command line from the pair topology — with the ``system()``
call commented out, so the mode only *prints* the command to stderr while
the run loop still records wall time and CSV rows (mpi_perf.c:147-168,
504-507).  MPI is used purely as a launcher there (SURVEY.md §2 "C1 in
depth", vestigial dotnet mode).

Here the same slot is generalised and kept print-only: a user-supplied
template with placeholders is rendered per process from the two-group pair
topology and written to stderr, never executed.  This package drives every
sim rank from one process, so its process is its own loopback pair and
its peer's IP is its own.

Placeholders: ``{role}`` (server|client), ``{ip}``, ``{port}``,
``{flows}``, ``{bytes}``, ``{iters}``.  Server rank r advertises its own IP
on ``DEF_PORT + r``; its paired client dials the server's IP and port
(mpi_perf.c:155-165, where group 1 is the server side).
"""

from __future__ import annotations

#: mpi_perf.c:150 — base TCP port; rank r's server listens on DEF_PORT + r.
DEF_PORT = 40000

#: rendered when ``-d`` is passed without a template; same argument shape as
#: the reference's hardwired dotnet command line (mpi_perf.c:155-165).
DEFAULT_TEMPLATE = "extern-bench {role} {ip} {port} {flows} {bytes} {iters}"


def pair_for_rank(rank: int, n_procs: int) -> tuple[int, int]:
    """Two-group positional pairing: ``(group, peer_rank)``.

    The reference splits ranks into two host groups and pairs equal
    group-communicator ranks (mpi_perf.c:200-238); positionally that is
    first half (group 0, clients) vs second half (group 1, servers).
    A single process is its own loopback pair on the server side.
    """
    if n_procs < 2:
        return 1, rank
    if n_procs % 2:
        raise ValueError(
            f"extern mode needs an even process count to form pairs, got {n_procs}"
        )
    half = n_procs // 2
    if rank >= half:
        return 1, rank - half
    return 0, rank + half


def render_extern_command(
    template: str,
    *,
    group: int,
    rank: int,
    peer_rank: int,
    my_ip: str,
    peer_ip: str,
    ppn: int,
    buff_sz: int,
    iters: int,
) -> str:
    """Substitute the pair topology into ``template`` (mpi_perf.c:153-165)."""
    if group == 1:
        role, ip, port = "server", my_ip, DEF_PORT + rank
    else:
        role, ip, port = "client", peer_ip, DEF_PORT + peer_rank
    try:
        return template.format(
            role=role, ip=ip, port=port, flows=ppn, bytes=buff_sz, iters=iters
        )
    except (KeyError, IndexError) as e:
        raise ValueError(
            f"bad placeholder in extern command template {template!r}: {e}"
        ) from None
