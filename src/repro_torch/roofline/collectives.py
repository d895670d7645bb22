"""Per-device collective wire bytes from a mesh's
:class:`~repro_torch.distributed.context.CollectiveLog` (the counterpart
of ``repro.roofline.hlo``, which parses them out of a compiled module's
HLO; the port has no HLO).

The log records every collective a :class:`ShardGroup` issues, and
:meth:`CollectiveLog.summary` converts them to wire bytes with the same
ring-algorithm factors as the HLO parser:

    all-gather        out x (n-1)/n       (received bytes)
    all-reduce        2 x in x (n-1)/n    (reduce-scatter + all-gather)
    reduce-scatter    in x (n-1)/n
    all-to-all        in x (n-1)/n
    collective-permute in

Kinds are named as HLO names them, with dashes (``all-reduce``,
``all-gather``, ``all-to-all``, ``reduce-scatter``), in the log, in this
module and in the dry run's records alike.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.distributed.context import RING_FACTORS, CollectiveLog


def collectives_of(log: CollectiveLog, rank: int = 0
                   ) -> Dict[str, Dict[str, float]]:
    """``{kind: {"wire_bytes", "count"}}`` of the device at mesh rank
    ``rank`` (the shape of ``parse_collectives``)."""
    return log.summary(rank)


def wire_bytes(kind: str, operand_bytes: float, n: int) -> float:
    """A device's wire bytes for one collective of ``kind`` over a group
    of ``n`` on an operand of ``operand_bytes`` (0 for a group of one)."""
    if n <= 1:
        return 0.0
    return RING_FACTORS[kind](operand_bytes, n)


def total_wire_bytes(collectives: Dict[str, Dict[str, float]]) -> float:
    return sum(v["wire_bytes"] for v in collectives.values())
