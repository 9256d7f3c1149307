"""The per-device view the arena's schedules are written in.

The JAX package writes every arena algorithm, v-schedule and scenario
phase in the per-device view of ``shard_map``: each device holds its own
buffer, learns its place from ``lax.axis_index`` and moves data only
through ``lax.ppermute``, every device running the same program.  This
module is that view for the two worlds of this package (:mod:`tpu_perf_
torch.world`), stacked: every per-device tensor carries a leading
dimension of the ranks this process holds, ``rows`` of them.

* In the sim world the process holds every rank: row r is flat rank r,
  ``axis_index`` is a ``(n,)`` tensor of each rank's place along the axis
  and ``ppermute`` is a row permutation, ``out[dst] = x[src]`` over the
  pairs of ``perm`` in every group of the axis, the rows no pair
  addresses zero (``ppermute`` zero-fills a device no one sends to: the
  binomial trees rely on it).
* In a multi-process world (:class:`~tpu_perf_torch.world.DistWorld`) the
  process holds its own rank, one row: ``axis_index`` is its place along
  the axis and ``ppermute`` is one ``batch_isend_irecv`` on the axis'
  group (``ops.collectives._ppermute``).  Every rank calls every
  ``ppermute`` of a schedule, with sizes that derive from static tables
  only, so each send meets its receive.

A per-rank choice is never a Python branch on the rank: it is
:func:`where` on a ``(rows,)`` condition, and a per-rank offset is a
``(rows,)`` tensor that :func:`dslice` and :func:`dupdate` read with
``lax.dynamic_slice``'s clamping.
"""

from __future__ import annotations

import torch

from tpu_perf_torch.world import is_dist


def _key(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Ranks:
    """The ranks one process holds, stacked, along the mesh of ``world``
    (a sim world or one rank of a multi-process world)."""

    def __init__(self, world):
        self.world = world
        self.device = world.device
        self.dist = is_dist(world)
        self.rows = 1 if self.dist else world.n
        self._place: dict[tuple, object] = {}  # axis places, group rows
        self._perms: dict[tuple, tuple] = {}
        self._along: dict[tuple, object] = {}

    def _mesh(self):
        from tpu_perf_torch.parallel.mesh import make_mesh

        mesh = self.world.mesh
        return mesh if mesh is not None else make_mesh(n=self.world.n)

    def _groups(self, axis) -> list[list[int]]:
        return self._mesh().groups(_key(axis))

    def axis_size(self, axis) -> int:
        return len(self._groups(axis)[0])

    def axis_index(self, axis) -> torch.Tensor:
        """``lax.axis_index``: each held rank's place along ``axis`` (an
        axis name, or a tuple of them, row-major in its order), a
        ``(rows,)`` int64 tensor."""
        key = _key(axis)
        if key not in self._place:
            place = {}
            for g in self._groups(key):
                for j, r in enumerate(g):
                    place[r] = j
            ranks = [self.world.rank] if self.dist else range(self.world.n)
            self._place[key] = torch.tensor([place[r] for r in ranks],
                                            device=self.device)
        return self._place[key]

    def ppermute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        """``lax.ppermute(x, axis, perm)`` on the held rows: each group of
        ``axis`` sends its member ``s``'s row to its member ``d`` for
        every ``(s, d)`` of ``perm``; a row no pair addresses is zeros."""
        key = _key(axis)
        perm = tuple((int(s), int(d)) for s, d in perm)
        if self.dist:
            from tpu_perf_torch.ops.collectives import _ppermute

            sub = self._sub(key)
            if sub.n == 1:
                own = [p for p in perm if p == (0, 0)]
                return x.clone() if own else torch.zeros_like(x)
            return _ppermute(sub, x[0].contiguous(), list(perm))[None]
        if (key, perm) not in self._perms:
            src, dst = [], []
            for g in self._groups(key):
                for s, d in perm:
                    src.append(g[s])
                    dst.append(g[d])
            self._perms[(key, perm)] = (
                torch.tensor(src, dtype=torch.long, device=self.device),
                torch.tensor(dst, dtype=torch.long, device=self.device))
        src, dst = self._perms[(key, perm)]
        out = torch.zeros_like(x)
        if len(perm):
            out[dst] = x[src]
        return out

    def _sub(self, axis):
        """This rank's world along ``axis``: the world itself when the
        axis is all of its axes (its group already holds those ranks,
        and a world along an axis of another has only its own ranks to
        name), else its axis group (``DistWorld.along``)."""
        key = _key(axis)
        if key == tuple(self.world.axis_names):
            return self.world
        if key not in self._along:
            self._along[key] = self.world.along(key)
        return self._along[key]

    def _group_rows(self, axis) -> list[torch.Tensor]:
        key = ("rows",) + _key(axis)
        if key not in self._place:
            self._place[key] = [torch.tensor(g, device=self.device)
                                for g in self._groups(axis)]
        return self._place[key]

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.psum`` along ``axis``: every rank of a group gets the sum
        over the group, in the dtype (the library's all-reduce across
        processes)."""
        if self.dist:
            import torch.distributed as dist

            sub = self._sub(axis)
            y = x.clone()
            if sub.n > 1:
                dist.all_reduce(y, group=sub.group)
            return y
        out = torch.empty_like(x)
        for idx in self._group_rows(axis):
            out[idx] = x[idx].sum(0, dtype=x.dtype, keepdim=True).expand(
                len(idx), *x.shape[1:])
        return out

    def psum_scatter(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.psum_scatter(x, axis, tiled=True)``: member j of a group
        gets block j of the group's sum (the library's reduce-scatter
        across processes)."""
        k = self.axis_size(axis)
        shard = x.shape[1] // k
        if self.dist:
            from tpu_perf_torch.parallel.multihost import (
                _reduce_scatter_tensor,
            )

            sub = self._sub(axis)
            if sub.n == 1:
                return x.clone()
            out = x.new_empty(1, shard)
            _reduce_scatter_tensor(out[0], x[0].contiguous(),
                                   group=sub.group)
            return out
        s = self.psum(x, axis)
        return dslice(s, self.axis_index(axis) * shard, shard)

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.all_gather(x, axis, tiled=True)``: every member of a
        group gets the members' buffers concatenated in order (the
        library's all-gather across processes)."""
        k = self.axis_size(axis)
        if self.dist:
            from tpu_perf_torch.parallel.multihost import _all_gather_tensor

            sub = self._sub(axis)
            if sub.n == 1:
                return x.clone()
            out = x.new_empty(1, k * x.shape[1])
            _all_gather_tensor(out[0], x[0].contiguous(), group=sub.group)
            return out
        out = x.new_empty(x.shape[0], k * x.shape[1])
        for idx in self._group_rows(axis):
            out[idx] = x[idx].reshape(1, -1).expand(len(idx), -1)
        return out

    def all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: member d's block
        s is member s's block d (the library's all-to-all across
        processes)."""
        k = self.axis_size(axis)
        if self.dist:
            import torch.distributed as dist

            sub = self._sub(axis)
            if sub.n == 1:
                return x.clone()
            out = torch.empty_like(x)
            dist.all_to_all_single(out[0], x[0].contiguous(),
                                   group=sub.group)
            return out
        out = torch.empty_like(x)
        for idx in self._group_rows(axis):
            out[idx] = x[idx].view(k, k, -1).transpose(0, 1).reshape(k, -1)
        return out


def rows_index(rk: Ranks) -> torch.Tensor:
    return torch.arange(rk.rows, device=rk.device)


def _bshape(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return cond.view(cond.shape[0], *([1] * (like.dim() - 1)))


def where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """``jnp.where`` on a per-rank ``(rows,)`` condition."""
    return torch.where(_bshape(cond, a), a, b)


def member(idx: torch.Tensor, ranks) -> torch.Tensor:
    """Is each held rank's place one of ``ranks``?"""
    want = torch.zeros_like(idx, dtype=torch.bool)
    for r in ranks:
        want |= idx == int(r)
    return want


def dget(buf: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Row ``j`` (per rank) of each rank's ``(n, ...)`` block stack."""
    return buf[torch.arange(buf.shape[0], device=buf.device), j]


def _window(x: torch.Tensor, start, size: int) -> torch.Tensor:
    length = x.shape[1]
    if not isinstance(start, torch.Tensor):
        start = torch.full((x.shape[0],), int(start), device=x.device)
    start = start.clamp(0, max(0, length - size))
    return start[:, None] + torch.arange(size, device=x.device)


def dslice(x: torch.Tensor, start, size: int) -> torch.Tensor:
    """``lax.dynamic_slice`` of each rank's ``(L,)`` buffer at its own
    ``start``, clamped into the buffer as XLA clamps it."""
    return x.gather(1, _window(x, start, size))


def dupdate(x: torch.Tensor, upd: torch.Tensor, start) -> torch.Tensor:
    """``lax.dynamic_update_slice``: each rank's ``(L,)`` buffer with
    ``upd`` written at its own ``start`` (clamped), as a copy."""
    out = x.clone()
    out.scatter_(1, _window(x, start, upd.shape[1]), upd)
    return out


#: static tables on the device, made once (a host-to-device copy inside a
#: captured graph is not allowed: the eager warm-up fills this)
_TABLES: dict[tuple, torch.Tensor] = {}


def take(table, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(table)[idx]``: a static table read at per-rank
    places."""
    key = (tuple(int(v) for v in table), idx.device)
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(key[0], device=idx.device)
    return _TABLES[key][idx]


def dwrite(x: torch.Tensor, upd: torch.Tensor, start) -> torch.Tensor:
    """:func:`dupdate` in place, on a buffer the schedule owns."""
    x.scatter_(1, _window(x, start, upd.shape[1]), upd)
    return x


def pad_to(v: torch.Tensor, width: int) -> torch.Tensor:
    """``jnp.zeros((width,)).at[:len(v)].set(v)`` for each rank's row."""
    out = v.new_zeros(v.shape[0], width)
    out[:, :v.shape[1]] = v
    return out
