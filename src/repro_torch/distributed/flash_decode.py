"""Cross-shard flash decoding with the exact log-sum-exp merge (the
counterpart of ``repro.distributed.flash_decode``): the full model's
decode attention over a sequence-sharded cache
(``sharded_decode_attention``), and the serving engine's page-sharded
paged attention (``sharded_msa_fused``, ``sharded_pool_ops``), over
:class:`ShardGroup`s.

Sequence-sharded decode: the dense decode cache ``(B, S, KH, D)`` is cut
along B over the context's ``batch`` axes and along S over its
``kv_seq`` axes.  Each shard's slice of the cache is one segment: it
computes its partial ``(o, lse)`` at its global start offset, and the
partials of one batch slice merge exactly over the ``kv_seq`` group
(one max and two sums a layer).  When S does not divide over the shards
(Whisper's 1500 encoder frames) the cache stays whole on every shard, and
the identical partials merge to themselves.

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
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import (ShardedTensor, ShardGroup,
                                             axis_tuple, fit_spec, place)
from repro_torch.kernels.msa.ops import (apply_page_copies, apply_swap_ins,
                                         msa_fused_partial, write_kv_pages)
from repro_torch.kernels.msa.ref import NEG_INF
from repro_torch.models.layers import INT32_MAX, decode_attention

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


def _local_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   start: int, kv_len: torch.Tensor, window: Optional[int],
                   softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial attention over a local slice of the cache: q (B, H, D),
    k/v (B, S_loc, KH, D) whose first slot is global position ``start``,
    kv_len (B,) -> (o (B, H, D) float32 normalised by the local softmax
    mass, lse (B, H) float32).  As the JAX package does, q is rounded to
    the cache's type and the probabilities to v's before their products,
    which accumulate in float32 (products of two values of the cache's
    type are exact in float32)."""
    b, s_loc, kh, d = k.shape
    h = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = (q.float().reshape(b, kh, h // kh, d) * scale).to(k.dtype)
    s_ = torch.einsum("bgrd,bsgd->bgrs", qf.float(), k.float())
    if softcap and softcap > 0:
        s_ = softcap * torch.tanh(s_ / softcap)
    gpos = start + torch.arange(s_loc, device=k.device)
    kv_len = kv_len[:, None, None, None]
    mask = gpos < kv_len
    if window is not None:
        mask = mask & (gpos >= kv_len - (window if window > 0
                                         else INT32_MAX // 2))
    s_ = torch.where(mask, s_, NEG_INF)
    m = s_.amax(dim=-1)                                        # (B,KH,R)
    p = torch.where(mask, torch.exp(s_ - m[..., None]), 0.0)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bgrs,bsgd->bgrd", p.to(v.dtype).float(), v.float())
    lse = m + torch.log(l)
    return (o / l[..., None]).reshape(b, h, d), lse.reshape(b, h)


KV = Union[torch.Tensor, ShardedTensor]


def as_spec(x: KV, spec: Sequence, mesh) -> ShardedTensor:
    """``x`` cut over ``mesh`` by ``spec``: a whole tensor is placed
    (views where devices match); a sharded one is taken as it is, or
    narrowed (views) on a dim it holds whole and ``spec`` splits (the
    resharding the JAX package's ``shard_map`` in-specs ask of GSPMD)."""
    if isinstance(x, torch.Tensor):
        return place(x, spec, mesh)
    out = ShardedTensor(mesh, fit_spec(x.shape, spec, mesh), x.shape, [])
    if out.spec == x.spec:
        return x
    for r, p in enumerate(x.pieces):
        for d, (have, want) in enumerate(zip(x.spec, out.spec)):
            if have == want:
                continue
            if have is not None:
                raise ValueError(f"cannot reshard dim {d} from {have!r} "
                                 f"to {want!r}")
            p = p.narrow(d, *out.block(r, d))
        out.pieces.append(p)
    return out


def sharded_decode_attention(q: torch.Tensor, k_cache: KV, v_cache: KV,
                             kv_len: torch.Tensor, *,
                             window: Optional[int] = None,
                             softcap: float = 0.0) -> torch.Tensor:
    """Decode attention, one token a sequence, over a cache sharded by
    the active context: q (B, H, D) and kv_len (B,) on the mesh's first
    device; k/v_cache (B, S, KH, D), whole or a :class:`ShardedTensor`,
    with B over the ``batch`` axes and S over the ``kv_seq`` axes ->
    (B, H, D) in q's type on the first device.  Without ``kv_seq`` it is
    :func:`decode_attention` on the whole cache."""
    dc = dctx.current()
    if dc is None:
        raise RuntimeError("sharded_decode_attention needs a DistContext")
    mesh = dc.mesh
    seq = axis_tuple(dc.rules.get("kv_seq"))
    if not seq:
        whole = [c if isinstance(c, torch.Tensor) else c.full()
                 for c in (k_cache, v_cache)]
        return decode_attention(q, *whole, kv_len, window=window,
                                softcap=softcap)
    spec = (dc.rules.get("batch"), dc.rules.get("kv_seq"), None, None)
    kc = as_spec(k_cache, spec, mesh)
    vc = as_spec(v_cache, spec, mesh)
    replicated = kc.spec[1] is None
    bat = axis_tuple(kc.spec[0])
    outs = []
    for bi in range(mesh.size_of(bat)):
        g = mesh.group(seq, at=mesh.position(bat, bi))
        os_, lses = [], []
        for r, dev in zip(g.ranks, g.devices):
            b0, b_loc = kc.block(r, 0)
            start = 0 if replicated else kc.block(r, 1)[0]
            o, lse = _local_partial(
                q[b0:b0 + b_loc].to(dev), kc.pieces[r], vc.pieces[r], start,
                kv_len[b0:b0 + b_loc].to(dev), window, softcap)
            os_.append(o)
            lses.append(lse)
        outs.append(lse_merge(g, os_, lses)[0].to(q.device))
    return torch.cat(outs).to(q.dtype)


def write_token(cache: ShardedTensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new`` (B, KH, D) at slot ``slot`` (B,) of every sequence
    into the pieces of a sharded (B, S, KH, D) cache that hold it, in
    place (a fixed-shape update: no host sync)."""
    for r, p in enumerate(cache.pieces):
        b0, b_loc = cache.block(r, 0)
        s0, s_loc = cache.block(r, 1)
        local = slot[b0:b0 + b_loc].to(p.device).long() - s0
        ok = (local >= 0) & (local < s_loc)
        at = local.clamp(0, s_loc - 1)
        rows = torch.arange(b_loc, device=p.device)
        p[rows, at] = torch.where(ok[:, None, None],
                                  new[b0:b0 + b_loc].to(p.device),
                                  p[rows, at])


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
