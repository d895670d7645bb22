"""Mesh construction (the counterpart of ``repro.launch.mesh``).

A mesh is a :class:`repro_torch.distributed.context.Mesh`: named axes over
a row-major grid of ``torch.device``s, driven by one process.  There is
no SPMD compiler behind it: the sharded model paths
(``repro_torch.distributed``) cut a tensor into per-shard pieces, run each
piece on its shard's device and combine them through the mesh's
:class:`ShardGroup` collectives.  A device may repeat in the grid, so a
mesh of N shards runs on one card (``devices=["cuda:0"] * N``) or on the
CPU (``["cpu"] * N``).

Nothing here picks a device quietly: without ``devices``, a mesh of n
positions takes ``cuda:0 .. cuda:n-1`` and raises when there are fewer.
``abstract_mesh`` and ``make_production_mesh`` carry shapes only (no 256
devices exist here); the sharding rules read nothing else.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.distributed.context import Mesh, make_serving_devices


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major; a device may
    repeat), or over ``cuda:0 .. cuda:n-1``."""
    n = math.prod(shape)
    return Mesh(shape, axes, make_serving_devices(n, devices))


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A device-free mesh carrying axis sizes (the sharding rules and the
    shardings need nothing else)."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, shapes only: 16 x 16 = 256
    chips a pod; ``multi_pod`` adds a leading 2-pod axis."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh with the production axis names."""
    return make_mesh(shape, axes, devices=devices)


def make_serving_mesh(n_shards: int, *,
                      devices: Optional[Sequence] = None) -> Mesh:
    """The sharded serving engine's ``(data=1, model=n)`` mesh: the KV
    page pools and the weights' head, ffn and vocab dims shard over
    ``model``; its ``model`` group is the engine's :class:`ShardGroup`."""
    return Mesh((1, n_shards), ("data", "model"),
                make_serving_devices(n_shards, devices))
