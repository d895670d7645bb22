"""The shard group of sharded serving: one process drives every shard
(the counterpart of the JAX package's ``(data=1, model=N)`` serving mesh,
``repro.launch.mesh.make_serving_mesh``, and its collectives).

A :class:`ShardGroup` holds an explicit list of N devices, one per shard.
A value that every shard holds is a list of N tensors, tensor i on
device i.  The collectives are plain tensor operations: they gather the N
tensors onto ``devices[0]``, reduce them in the fixed shard order
0, 1, ..., N-1, and copy the result back to every shard's device, so the
result is the same bits on every shard and on every run.  A device may
repeat in the list: N shards on one card (or on the CPU) run the same
program as N cards, one after the other.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import resolve_device


def make_serving_devices(n_shards: int,
                         devices: Optional[Sequence] = None
                         ) -> List[torch.device]:
    """The devices of an ``n_shards``-way serving group: ``devices[:n]``
    when given (a device may repeat), else ``cuda:0 .. cuda:N-1``.
    Raises when there are fewer; nothing picks a device quietly."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be at least 1")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise ValueError(
                f"sharded serving needs {n_shards} CUDA devices, have "
                f"{have} (pass the devices, e.g. shard_devices=['cpu'] * "
                f"{n_shards}, to run the shards on fewer)")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    devs = [resolve_device(d) for d in devices]
    if len(devs) < n_shards:
        raise ValueError(f"sharded serving needs {n_shards} devices, got "
                         f"{len(devs)}")
    return devs[:n_shards]


class ShardGroup:
    """N shards, shard i on ``devices[i]``, and their collectives."""

    def __init__(self, devices: Sequence):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        self.n = len(self.devices)

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
        out = g[0]
        for x in g[1:]:
            out = torch.maximum(out, x)
        return self.scatter(out)

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Elementwise sum over the shards, in shard order, in float32,
        cast once to the inputs' type."""
        g = self._gather(xs)
        out = g[0].float()
        for x in g[1:]:
            out = out + x.float()
        return self.scatter(out.to(xs[0].dtype))

    def gather(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' tensors concatenated along ``dim``, in shard order,
        on ``devices[0]`` only."""
        return torch.cat(self._gather(xs), dim=dim)

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int
                   ) -> List[torch.Tensor]:
        """The shards' tensors concatenated along ``dim``, in shard
        order, on every shard."""
        return self.scatter(self.gather(xs, dim))
