"""Dispatch of the MSA attention and the in-step page maintenance.

The device of the tensors picks the path: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel
or raises.  There is no implementation switch and no fallback.

Page ops work on the layer-stacked pools (L, P + 1, page, KH, D) in place
(JAX donated the pools into its step and returned new ones).  Index P —
one past the block manager's slots — is the drop page that padding
entries of the swap queues and the KV writes land in.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.msa import ref
from repro_torch.kernels.msa.msa_fused import msa_fused_cuda


def msa_fused(q, k_pages, v_pages, block_tables, context_lens, q_pos,
              seq_ids, q_valid, *, q_start=None, q_len=None, worklist=None,
              tile_first=None, window: int = 0, softcap: float = 0.0,
              q_tile: int = 128) -> torch.Tensor:
    """One fused dispatch over the flattened (T, H, D) mixed token stream
    (prefill chunks + decode rows).  On the CPU the plain version resolves
    each token's context through ``seq_ids``; on the card the kernel walks
    the compacted work-list (``msa_fused.build_worklist``) tile by tile
    (``tile_first``) with per-sequence ``q_start``/``q_len`` runs."""
    if q.device.type == "cpu":
        return ref.msa_fused_ref(q, k_pages, v_pages, block_tables,
                                 context_lens, q_pos, seq_ids, q_valid,
                                 window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"msa_fused: no kernel for device {q.device}")
    if q_start is None or q_len is None or worklist is None \
            or tile_first is None:
        raise ValueError("msa_fused on cuda needs q_start/q_len, the "
                         "work-list and tile_first")
    return msa_fused_cuda(q, k_pages, v_pages, q_start, q_len, q_pos,
                          context_lens, worklist, tile_first, window=window,
                          softcap=softcap, q_tile=q_tile)


write_kv_pages = ref.write_kv_pages


def apply_page_copies(k_pools: torch.Tensor, v_pools: torch.Tensor,
                      copy_src: torch.Tensor, copy_dst: torch.Tensor) -> None:
    """Copy-on-write page copies ``src -> dst`` across all layers, in
    place.  Padding entries repeat the last real copy (idempotent) or are
    the identity ``0 -> 0`` on copy-free steps (``Engine._fold_page_ops``).
    Every source page is gathered before any write; sources are committed
    blocks and destinations fresh allocations, so they never alias."""
    if copy_src.shape[0] == 0:
        return
    src, dst = copy_src.long(), copy_dst.long()
    k_pools[:, dst] = k_pools[:, src]
    v_pools[:, dst] = v_pools[:, src]


def apply_swap_ins(k_pools: torch.Tensor, v_pools: torch.Tensor,
                   swap_k_dst: torch.Tensor, swap_v_dst: torch.Tensor,
                   swap_k: torch.Tensor, swap_v: torch.Tensor) -> None:
    """Host-tier swap-ins of full-precision ("fp") payloads: scatter
    (L, S, page, KH, D) halves into their pool pages in place; padding
    destinations (== P) land in the drop page.  K and V carry independent
    destination buckets, so a V-only swap-in ships no K payload."""
    if swap_k_dst.shape[0] > 0:
        k_pools[:, swap_k_dst.long()] = swap_k.to(k_pools.dtype)
    if swap_v_dst.shape[0] > 0:
        v_pools[:, swap_v_dst.long()] = swap_v.to(v_pools.dtype)
