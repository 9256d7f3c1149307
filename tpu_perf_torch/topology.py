"""Two-group pairwise topology, pure logic (the parts of
``tpu_perf/topology.py`` this package uses).

The reference splits its ranks into two host groups: rank 0 reads a file
of "group 1" hostnames (mpi_perf.c:405-431), and each rank's peer is the
rank of the other group with the same group rank (get_peer_rank,
mpi_perf.c:200-238).  In the sim world the pairing is positional: rank i
of the first half pairs with rank i + n/2, which is what the exchange
body's half shift (``ops.collectives._exchange``) moves; the group-1 file
only validates counts (:func:`validate_groups`).
"""

from __future__ import annotations


def validate_groups(world_size: int, group1_size: int, ppn: int) -> None:
    """The reference's sanity check (mpi_perf.c:399-403): each group must
    hold exactly half the world, i.e. group-1 hosts * ppn == world / 2."""
    if world_size % 2 != 0:
        raise ValueError(
            f"world_size {world_size} must be even for pairwise runs")
    expected = world_size // (2 * ppn)
    if group1_size != expected:
        raise ValueError(
            f"group-1 size {group1_size} != world_size/(2*ppn) = {expected} "
            f"(world={world_size}, ppn={ppn})"
        )


def one_way_permutation(n: int, *, reverse: bool = False
                        ) -> list[tuple[int, int]]:
    """Half of :func:`pair_permutation`: group 0 -> group 1 (or back)
    only, the unidirectional payload's direction."""
    if n % 2 != 0:
        raise ValueError(f"need an even device count, got {n}")
    half = n // 2
    if reverse:
        return [(i + half, i) for i in range(half)]
    return [(i, i + half) for i in range(half)]


def ring_permutation(n: int, *, shift: int = 1) -> list[tuple[int, int]]:
    """The ring shift: rank i sends to rank (i + shift) mod n."""
    if n <= 0:
        raise ValueError(f"need positive device count, got {n}")
    return [(i, (i + shift) % n) for i in range(n)]


def pair_permutation(n: int) -> list[tuple[int, int]]:
    """The pair topology on ``n`` ranks as ``(source, destination)``
    pairs: rank i of group 0 (the first half) and rank i + n/2 of group 1
    send to each other."""
    if n % 2 != 0:
        raise ValueError(f"need an even device count, got {n}")
    half = n // 2
    perm = []
    for i in range(half):
        perm.append((i, i + half))
        perm.append((i + half, i))
    return perm


# --- keyed mesh-axis tuples (the hierarchical arena algorithms) ----
# ``hier-ring:dcn=2+ici=4``: the algo string carries the axes and their
# sizes, so rows and labels are self-describing about their mesh.

#: separator between axis segments of a keyed mesh-axis tuple
AXIS_TUPLE_SEP = "+"


def format_axis_tuple(pairs) -> str:
    """``(("dcn", 2), ("ici", 4))`` -> ``"dcn=2+ici=4"`` — the keyed
    mesh-axis-tuple spelling rows and labels carry.  ``name=size``
    segments keep the grammar unambiguous for axis names that end in
    digits (the auto-named ``ax0``/``ax1`` axes)."""
    pairs = tuple((str(a), int(s)) for a, s in pairs)
    if not pairs:
        raise ValueError("empty axis tuple")
    for name, size in pairs:
        if not name or AXIS_TUPLE_SEP in name or "=" in name \
                or ":" in name or "," in name:
            raise ValueError(f"bad axis name {name!r}")
        if size <= 0:
            raise ValueError(f"axis {name!r} needs a positive size, "
                             f"got {size}")
    return AXIS_TUPLE_SEP.join(f"{a}={s}" for a, s in pairs)


def parse_axis_tuple(spec: str) -> tuple[tuple[str, int], ...]:
    """Inverse of :func:`format_axis_tuple`: ``"dcn=2+ici=4"`` ->
    ``(("dcn", 2), ("ici", 4))``.  Raises on anything else — a keyed
    algo name that does not parse must fail loudly, never degrade into
    a silently different mesh."""
    parts = str(spec).split(AXIS_TUPLE_SEP)
    pairs = []
    for part in parts:
        name, eq, size = part.partition("=")
        if not eq or not name or not size.isdigit() or int(size) <= 0:
            raise ValueError(f"unparseable axis tuple {spec!r} "
                             f"(expected name=size{AXIS_TUPLE_SEP}"
                             f"name=size, e.g. dcn=2+ici=4)")
        pairs.append((name, int(size)))
    return tuple(pairs)
