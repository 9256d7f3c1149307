"""Named meshes over the ranks of a world (port of
``tpu_perf/parallel/mesh.py``).

The JAX package lays its devices over a named ``jax.sharding.Mesh``: a
single-slice axis rides the chips' own links, a leading ``"dcn"`` axis
crosses hosts, and the hierarchical collectives do their op axis by axis.
Here a mesh is the same shape and axis names laid over the ranks of a
world (:mod:`tpu_perf_torch.world`): rank r sits at the row-major
coordinates of r, so a rank's position in a mesh is the position its
device has in the JAX mesh of the same shape.

``claim_cpu_devices`` has no counterpart.  The JAX tests fake a mesh with
XLA's virtual host devices in one process; this package fakes ranks with
processes (a gloo world on the CPU) or with the rows of one allocation
(the sim world), so there is no device count to claim.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A shape and axis names over ``size`` ranks, row-major."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, rank: int) -> tuple[int, ...]:
        """Rank ``rank``'s coordinates, row-major."""
        out = []
        for s in reversed(self.shape):
            rank, c = divmod(rank, s)
            out.append(c)
        return tuple(reversed(out))

    def axis_groups(self, name: str) -> list[list[int]]:
        """The rank lists along axis ``name``: each holds the ranks whose
        other coordinates agree, in the axis' order (the groups a
        collective over that axis runs in)."""
        k = self.axis_names.index(name)
        groups: dict[tuple, list[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            groups.setdefault(c[:k] + c[k + 1:], []).append(r)
        return list(groups.values())


def make_mesh(shape: tuple[int, ...] = (), axis_names: tuple[str, ...] = (),
              *, n: int) -> Mesh:
    """A named mesh over ``n`` ranks, with the JAX package's rules and
    errors: no shape puts every rank on one ``"x"`` axis; one ``-1``
    is inferred; the shape must cover the ranks exactly."""
    if not shape:
        shape, axis_names = (n,), ("x",)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} / axis_names {axis_names} length mismatch")
    shape = tuple(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 in mesh shape, got {shape}")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if known == 0 or n % known:
            raise ValueError(f"cannot infer -1 in {shape} over {n} devices")
        shape = tuple(n // known if s == -1 else s for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return Mesh(shape, tuple(axis_names))


def mesh_ranks_flat(mesh: Mesh) -> list[int]:
    """The ranks of a mesh in row-major mesh order (``mesh_devices_flat``:
    the order a permutation over the flattened axes refers to)."""
    return list(range(mesh.size))
