"""The device mesh, its shard groups and collectives, and the
distribution context (the counterpart of ``repro.distributed.context``
and of the JAX package's ``jax.sharding.Mesh``).

One process drives every shard.  A :class:`Mesh` is an ordered set of
named axes (``("pod",) "data", "model"``) over a grid of
``torch.device``s, row-major, in which a device may repeat: N shards on
one card (or on the CPU) run the same program as N cards, one after the
other.  A mesh without devices (:func:`repro_torch.launch.mesh.
abstract_mesh`) carries shapes only.

A :class:`ShardGroup` is the 1-D group of shards along one or more mesh
axes (``mesh.group(axes, at=...)``).  A value that the group shards is a
list of N tensors, tensor i on device i.  The collectives are plain
tensor operations: they gather the N tensors onto ``devices[0]``, reduce
them in the fixed shard order 0, 1, ..., N-1, and copy the result back to
every shard's device, so the result is the same bits on every shard and
on every run.  Each collective is written to the mesh's
:class:`CollectiveLog` (kind, group size, bytes a shard, the member
ranks), whose :meth:`~CollectiveLog.summary` has the shape of the JAX
package's ``repro.roofline.hlo.parse_collectives``.

The context (:class:`DistContext`, :func:`use_dist`, :func:`current`,
:func:`flag`) maps logical axis names to mesh axes and carries the flags
model code reads (``"moe_alltoall"``, ``"flash_decode"``, ...).  The JAX
package's ``constrain`` is not ported: it only asks GSPMD to place an
activation, which has no meaning in one process.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device

_STATE = threading.local()


def make_serving_devices(n_shards: int,
                         devices: Optional[Sequence] = None
                         ) -> List[torch.device]:
    """The devices of ``n_shards`` shards (a serving group, a mesh):
    ``devices[:n]`` when given (a device may repeat), else ``cuda:0 ..
    cuda:N-1``.  Raises when there are fewer; nothing picks a device
    quietly."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be at least 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            missing = ", ".join(f"cuda:{i}" for i in range(have, n_shards))
            raise ValueError(
                f"{n_shards} shards need {n_shards} CUDA devices, have "
                f"{have} ({missing} missing; pass the devices, e.g. "
                f"['cpu'] * {n_shards} or ['cuda:0'] * {n_shards}, to run "
                "the shards on fewer)")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    devs = [resolve_device(d) for d in devices]
    if len(devs) < n_shards:
        raise ValueError(f"sharded serving needs {n_shards} devices, got "
                         f"{len(devs)}")
    return devs[:n_shards]


# ---------------------------------------------------------------------------
# The collective log
# ---------------------------------------------------------------------------

#: ring-algorithm wire bytes a device per byte of its operand
#: (``repro.roofline.hlo``): all-reduce 2 x in x (n-1)/n, all-gather
#: out x (n-1)/n, reduce-scatter and all-to-all in x (n-1)/n,
#: collective-permute in.  Kinds are HLO's names, with dashes.
RING_FACTORS = {"all-reduce": lambda b, n: 2.0 * b * (n - 1) / n,
                "all-gather": lambda b, n: b * (n - 1) / n,
                "reduce-scatter": lambda b, n: b * (n - 1) / n,
                "all-to-all": lambda b, n: b * (n - 1) / n,
                "collective-permute": lambda b, n: float(b)}


@dataclass(frozen=True)
class Collective:
    """A kind of collective a group issues: its kind (an HLO collective
    name), its reduction (``"max"``/``"sum"``, or ``""``), the group
    size, the bytes of one shard's operand (of its result for an
    all-gather) and the mesh ranks of its members."""
    kind: str
    op: str
    n: int
    shard_bytes: int
    ranks: Tuple[int, ...]


class CollectiveLog:
    """How many times each :class:`Collective` was issued (counts, so a
    log that lives as long as a server stays the size of its distinct
    shapes)."""

    def __init__(self):
        self.counts: Dict[Collective, int] = {}

    def clear(self) -> None:
        self.counts.clear()

    def record(self, kind: str, op: str, ranks: Sequence[int],
               shard_bytes: int) -> None:
        if len(ranks) > 1:          # a group of one moves nothing
            c = Collective(kind, op, len(ranks), int(shard_bytes),
                           tuple(ranks))
            self.counts[c] = self.counts.get(c, 0) + 1

    def ops(self, rank: int = 0) -> Dict[Tuple[str, str, int], int]:
        """{(kind, reduction, group size): count} of the collectives mesh
        rank ``rank`` took part in."""
        out: Dict[Tuple[str, str, int], int] = {}
        for c, k in self.counts.items():
            if rank in c.ranks:
                out[c.kind, c.op, c.n] = out.get((c.kind, c.op, c.n), 0) + k
        return out

    def summary(self, rank: int = 0) -> Dict[str, Dict[str, float]]:
        """``{kind: {"count", "wire_bytes"}}`` for the device at mesh rank
        ``rank``, as ``parse_collectives`` reads them from a compiled
        per-device module: one count a collective the device takes part
        in, wire bytes by the ring factors."""
        out: Dict[str, Dict[str, float]] = {}
        for c, k in self.counts.items():
            if rank in c.ranks:
                s = out.setdefault(c.kind, {"wire_bytes": 0.0, "count": 0})
                s["wire_bytes"] += k * RING_FACTORS[c.kind](c.shard_bytes, c.n)
                s["count"] += k
        return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Shard groups
# ---------------------------------------------------------------------------


class ShardGroup:
    """N shards, shard i on ``devices[i]``, and their collectives.
    ``ranks`` are the members' mesh ranks (default 0..N-1) and ``log``
    the log their collectives go to (default a log of the group's own)."""

    def __init__(self, devices: Sequence, *,
                 ranks: Optional[Sequence[int]] = None,
                 log: Optional[CollectiveLog] = None):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        self.n = len(self.devices)
        self.ranks = tuple(range(self.n)) if ranks is None else tuple(ranks)
        if len(self.ranks) != self.n:
            raise ValueError(f"{len(self.ranks)} ranks for {self.n} devices")
        self.log = CollectiveLog() if log is None else log

    def scatter(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One tensor copied to every shard's device (a no-op copy where
        it already lies there)."""
        return [x.to(d) for d in self.devices]

    def _gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} values for {self.n} shards")
        return [x.to(self.devices[0]) for x in xs]

    def all_reduce_max(self, xs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Elementwise max over the shards."""
        g = self._gather(xs)
        self.log.record("all-reduce", "max", self.ranks, _nbytes(g[0]))
        out = g[0]
        for x in g[1:]:
            out = torch.maximum(out, x)
        return self.scatter(out)

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Elementwise sum over the shards, in shard order, in float32,
        cast once to the inputs' type."""
        g = self._gather(xs)
        self.log.record("all-reduce", "sum", self.ranks, _nbytes(g[0]))
        out = g[0].float()
        for x in g[1:]:
            out = out + x.float()
        return self.scatter(out.to(xs[0].dtype))

    def gather(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' tensors concatenated along ``dim``, in shard order,
        on ``devices[0]`` only."""
        g = self._gather(xs)
        out = torch.cat(g, dim=dim)
        self.log.record("all-gather", "", self.ranks, _nbytes(out))
        return out

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
        """The shards' tensors concatenated along ``dim``, in shard
        order, on every shard."""
        return self.scatter(self.gather(xs, dim))

    def all_to_all(self, xs: Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> List[torch.Tensor]:
        """``jax.lax.all_to_all(x, split_axis=split_dim,
        concat_axis=concat_dim, tiled=True)``: each shard's tensor is cut
        into N equal blocks along ``split_dim``; shard j receives block j
        of every shard, concatenated along ``concat_dim`` in shard order,
        on its own device."""
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} values for {self.n} shards")
        size = xs[0].shape[split_dim]
        if size % self.n:
            raise ValueError(f"all_to_all: dim {split_dim} of size {size} "
                             f"does not split over {self.n} shards")
        self.log.record("all-to-all", "", self.ranks, _nbytes(xs[0]))
        blocks = [torch.chunk(x, self.n, dim=split_dim) for x in xs]
        return [torch.cat([blocks[i][j].to(dev) for i in range(self.n)],
                          dim=concat_dim)
                for j, dev in enumerate(self.devices)]


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

Axes = Union[str, Sequence[str]]


def axis_tuple(axes: Optional[Axes]) -> Tuple[str, ...]:
    """A rule's mesh axes as a tuple: ``None`` -> (), ``"model"`` ->
    ("model",)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over a row-major grid of devices (``devices`` None: an
    abstract mesh, shapes only).  ``shape`` maps each axis name to its
    size, in axis order, as ``jax.sharding.Mesh.shape`` does; rank r is
    the row-major index of a grid position."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 devices: Optional[Sequence] = None):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} do not match")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.devices: Optional[List[torch.device]] = None
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
            if len(devs) != self.size:
                raise ValueError(f"a {tuple(shape)} mesh needs {self.size} "
                                 f"devices, got {len(devs)}")
            self.devices = devs
        self.log = CollectiveLog()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank -> {axis: index}."""
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords.get(a, 0)
        return r

    def size_of(self, axes: Optional[Axes]) -> int:
        """The number of shards along ``axes`` (1 for none)."""
        return math.prod(self.shape[a] for a in axis_tuple(axes))

    def index(self, rank: int, axes: Optional[Axes]) -> int:
        """Rank's shard index along ``axes``, flattened row-major in the
        order given (``jax.lax.axis_index(axes)``)."""
        c, i = self.coords(rank), 0
        for a in axis_tuple(axes):
            i = i * self.shape[a] + c[a]
        return i

    def position(self, axes: Optional[Axes], i: int) -> Dict[str, int]:
        """{axis: index} of shard index ``i`` along ``axes`` (the inverse
        of :meth:`index`)."""
        out = {}
        for a in reversed(axis_tuple(axes)):
            i, out[a] = divmod(i, self.shape[a])
        return out

    def device(self, rank: int = 0) -> torch.device:
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[rank]

    def group(self, axes: Axes, at: Union[int, Dict[str, int]] = 0
              ) -> ShardGroup:
        """The 1-D group along ``axes`` (one axis or several, flattened
        row-major in the order given) through the grid position ``at``
        (a rank, or {axis: index} for the other axes; missing axes at 0):
        its shards in axis-index order, its collectives in this mesh's
        log."""
        base = self.coords(at) if isinstance(at, int) else dict(at)
        ranks = [self.rank({**base, **self.position(axes, i)})
                 for i in range(self.size_of(axes))]
        return ShardGroup([self.device(r) for r in ranks], ranks=ranks,
                          log=self.log)


@dataclass
class ShardedTensor:
    """A tensor of global ``shape`` cut over ``mesh``: ``pieces[r]`` is
    mesh rank r's block on rank r's device, ``spec`` the mesh axes each
    dim is split over (``None``: whole on every rank).  Ranks that differ
    only on axes the spec does not name hold the same block (the same
    tensor where they share a device)."""
    mesh: Mesh
    spec: Tuple
    shape: torch.Size
    pieces: List[torch.Tensor]

    def block(self, rank: int, dim: int) -> Tuple[int, int]:
        """(start, length) of rank's block along ``dim``."""
        n = self.mesh.size_of(self.spec[dim])
        size = self.shape[dim] // n
        return self.mesh.index(rank, self.spec[dim]) * size, size

    def select(self, i: int) -> "ShardedTensor":
        """Index ``i`` of the (unsplit) leading dim, as views."""
        if self.spec[0] is not None:
            raise ValueError("select: the leading dim is split")
        return ShardedTensor(self.mesh, self.spec[1:], self.shape[1:],
                             [p[i] for p in self.pieces])

    def full(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        out = torch.empty(self.shape, dtype=self.pieces[0].dtype,
                          device=self.mesh.device(0))
        for r, p in enumerate(self.pieces):
            idx = []
            for d in range(len(self.shape)):
                start, size = self.block(r, d)
                idx.append(slice(start, start + size))
            out[tuple(idx)] = p.to(out.device)
        return out


def fit_spec(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> Tuple:
    """``spec`` with ``None`` on every dim that does not divide over its
    axes: such a dim stays whole (the JAX package's rule for the decode
    cache's sequence)."""
    return tuple(s if s is not None and shape[d] % mesh.size_of(s) == 0
                 else None for d, s in enumerate(spec))


def place(x: torch.Tensor, spec: Sequence, mesh: Mesh) -> ShardedTensor:
    """``x`` cut over ``mesh`` by ``spec`` (mesh axes per dim, fitted by
    :func:`fit_spec`), each rank's block a view of ``x`` where its device
    is ``x``'s, a copy on its device otherwise."""
    out = ShardedTensor(mesh, fit_spec(x.shape, spec, mesh), x.shape, [])
    spec = out.spec
    seen: Dict[Tuple, torch.Tensor] = {}
    for r in range(mesh.size):
        dev = mesh.device(r)
        key = (dev,) + tuple(out.block(r, d) for d in range(x.dim()))
        if key not in seen:
            p = x
            for d in range(x.dim()):
                if spec[d] is not None:
                    p = p.narrow(d, *out.block(r, d))
            seen[key] = p.to(dev)
        out.pieces.append(seen[key])
    return out


# ---------------------------------------------------------------------------
# The distribution context
# ---------------------------------------------------------------------------


@dataclass
class DistContext:
    mesh: Mesh
    # logical axis name -> mesh axis name (or tuple of mesh axes) or None
    rules: Dict[str, object] = field(default_factory=dict)
    # free-form flags consulted by model code ("moe_alltoall", ...)
    flags: Dict[str, object] = field(default_factory=dict)

    def spec(self, *axes: Optional[str]) -> Tuple:
        """The mesh axes of each logical axis (the entries of the JAX
        package's ``PartitionSpec``)."""
        return tuple(None if ax is None else self.rules.get(ax)
                     for ax in axes)

    def axis_size(self, logical: str) -> int:
        return self.mesh.size_of(self.rules.get(logical))


def current() -> Optional[DistContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_dist(ctx: Optional[DistContext]):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def flag(name: str, default=None):
    ctx = current()
    if ctx is None:
        return default
    return ctx.flags.get(name, default)
