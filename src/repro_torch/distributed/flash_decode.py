"""Page-sharded paged attention with the exact log-sum-exp merge (the
serving parts of ``repro.distributed.flash_decode``: ``lse_merge``,
``sharded_msa_fused``, ``sharded_pool_ops``), over a :class:`ShardGroup`.

The KV page pool of P pages is cut into N contiguous runs of P/N pages,
one per shard, and the block manager stripes every sequence's pages over
the shards, so each shard holds about 1/N of every context.  Shard i's
pools are ``(L, P/N + 1, page, KH, D)``: index P/N is the shard's drop
page, where KV writes of other shards' pages and padding swap-ins land
(the single-device pools keep page P for this).  A shard's local pages
are one segment subset of the multi-segment context; its partial
``(o, lse)`` (``msa_fused_partial``: the (o, lse) mode of the fused CUDA
kernel on the card) merges with the others' exactly:

    m = max_i lse_i;   out = sum_i e^(lse_i - m) o_i / sum_i e^(lse_i - m)

``sharded_decode_attention`` (the full model's decode step) comes with
the full-model slice of the port.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.distributed.context import ShardGroup
from repro_torch.kernels.msa.ops import (apply_page_copies, apply_swap_ins,
                                         msa_fused_partial, write_kv_pages)

Shards = Sequence[torch.Tensor]        # one tensor per shard, on its device


def lse_merge(group: ShardGroup, o: Shards, lse: Shards
              ) -> List[torch.Tensor]:
    """Exact cross-shard softmax merge of normalised partials ``o`` (T, H,
    D) f32 and their log-sum-exps ``lse`` (T, H) f32.  Rows that every
    shard saw fully masked (``lse == NEG_INF`` everywhere) merge to exact
    zeros."""
    m = group.all_reduce_max(lse)
    w = [torch.exp(x - mx) for x, mx in zip(lse, m)]   # NEG_INF rows -> 0
    o_sum = group.all_reduce_sum([oi * wi[..., None]
                                  for oi, wi in zip(o, w)])
    w_sum = group.all_reduce_sum(w)
    return [s / torch.clamp(ws, min=1e-30)[..., None]
            for s, ws in zip(o_sum, w_sum)]


def shard_tables(shard: int, p_loc: int, write_slot: torch.Tensor,
                 valid: torch.Tensor, bt: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Shard ``shard``'s view of a step's global page indices: the local
    write slots, which rows write a local page, which block-table entries
    are local (``page_valid``), and the table of local slots (0 where the
    page lives elsewhere)."""
    lo = shard * p_loc
    ls = write_slot - lo
    local_ok = valid & (ls >= 0) & (ls < p_loc)
    page_valid = (bt >= lo) & (bt < lo + p_loc)
    return ls, local_ok, page_valid, torch.where(page_valid, bt - lo, 0)


def sharded_msa_fused(group: ShardGroup, q: Shards, k_pools: Shards,
                      v_pools: Shards, k_new: Shards, v_new: Shards,
                      write_slot: Shards, write_off: Shards, valid: Shards,
                      bt: Shards, context_lens: Shards, q_pos: Shards,
                      seq_ids: Shards, *, window: int = 0,
                      softcap: float = 0.0, worklists=None, units=None,
                      q_tile: int = 128, tables=None) -> List[torch.Tensor]:
    """One layer's KV page write and fused varlen MSA over page-sharded
    pools; returns the merged attention, one (T, H, D) tensor in q's type
    per shard.

    ``k_pools[i]``/``v_pools[i]`` are shard i's (P/N + 1, page, KH, D)
    pools of the layer, updated in place; every other argument is the
    step's global value, held by every shard.  Each shard (a) writes the
    new tokens whose page it owns (other rows land in its drop page),
    (b) computes the attention partial over its local pages only (on the
    card over its own work-list and units, ``worklists[i]``/``units[i]``
    from ``build_worklist(..., page_valid=...)``), and (c) the partials
    merge through :func:`lse_merge`.  ``tables`` may carry each shard's
    :func:`shard_tables` of the step (the engine computes them once a
    step, not once a layer)."""
    outs, lses = [], []
    for i in range(group.n):
        kp, vp = k_pools[i], v_pools[i]
        ls, local_ok, page_valid, local_bt = (
            tables[i] if tables is not None else shard_tables(
                i, kp.shape[0] - 1, write_slot[i], valid[i], bt[i]))
        write_kv_pages(kp, vp, k_new[i], v_new[i], ls, write_off[i],
                       local_ok)
        o, lse = msa_fused_partial(
            q[i], kp, vp, local_bt, context_lens[i], q_pos[i], seq_ids[i],
            valid[i], page_valid,
            worklist=None if worklists is None else worklists[i],
            units=None if units is None else units[i],
            window=window, softcap=softcap, q_tile=q_tile)
        outs.append(o)
        lses.append(lse)
    return [a.to(q[0].dtype) for a in lse_merge(group, outs, lses)]


def sharded_pool_ops(group: ShardGroup, k_pools: Shards, v_pools: Shards,
                     swap_k_dst: Shards, swap_v_dst: Shards, swap_k: Shards,
                     swap_v: Shards, copy_src: Shards,
                     copy_dst: Shards) -> None:
    """Each shard's in-step page maintenance on its (L, P/N + 1, ...)
    pools, in place: swap-ins first, then copy-on-write copies.  Every
    index is shard-local (padding: swap destination P/N, the drop page;
    copies repeat the shard's last real local pair or are the identity
    0 -> 0).  Payloads are full precision: quantized payloads need the
    single-device engine.  A copy between shards cannot be expressed
    here; the engine runs it eagerly."""
    for i in range(group.n):
        apply_swap_ins(k_pools[i], v_pools[i], swap_k_dst[i], swap_v_dst[i],
                       swap_k[i], swap_v[i])
        apply_page_copies(k_pools[i], v_pools[i], copy_src[i], copy_dst[i])
