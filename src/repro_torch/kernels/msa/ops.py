"""Dispatch of the MSA attention and the in-step page maintenance.

The device of the tensors picks the path: a CPU tensor runs the plain
PyTorch version (``ref``), a CUDA tensor launches the hand-written kernel
(``msa_fused_cuda``, ``msa_fused_partial_cuda``, ``msa_prefill_cuda``,
``msa_decode_cuda``) or raises.  There is no implementation switch and
no fallback.

Page ops work on the layer-stacked pools (L, P + 1, page, KH, D) in place
(JAX donated the pools into its step and returned new ones).  Index P —
one past the block manager's slots — is the drop page that padding
entries of the swap queues and the KV writes land in.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.msa import ref
from repro_torch.kernels.msa.msa_decode import msa_decode_cuda
from repro_torch.kernels.msa.msa_fused import (msa_fused_cuda,
                                               msa_fused_partial_cuda)
from repro_torch.kernels.msa.msa_prefill import msa_prefill_cuda


def _on_cpu(name: str, q: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA tensor
    (the kernel); raises for any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return False


def msa_prefill(q, k_pages, v_pages, block_tables, context_lens, q_pos,
                q_lens, *, window: int = 0,
                softcap: float = 0.0) -> torch.Tensor:
    """Padded multi-segment prefill over ``(R, QP, H, D)`` chunks.  Any QP
    is legal: rows at or past ``q_lens`` (padding) come out as exact
    zeros."""
    if _on_cpu("msa_prefill", q):
        return ref.msa_prefill_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, q_pos, q_lens,
                                   window=window, softcap=softcap)
    return msa_prefill_cuda(q, k_pages, v_pages, block_tables, context_lens,
                            q_pos, q_lens, window=window, softcap=softcap)


def msa_decode(q, k_pages, v_pages, block_tables, context_lens, *,
               window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Paged decode: one ``(B, H, D)`` token per sequence at position
    ``ctx - 1``."""
    if _on_cpu("msa_decode", q):
        return ref.msa_decode_ref(q, k_pages, v_pages, block_tables,
                                  context_lens, window=window,
                                  softcap=softcap)
    return msa_decode_cuda(q, k_pages, v_pages, block_tables, context_lens,
                           window=window, softcap=softcap)


def msa_fused(q, k_pages, v_pages, block_tables, context_lens, q_pos,
              seq_ids, q_valid, *, worklist=None, units=None,
              window: int = 0, softcap: float = 0.0,
              q_tile: int = 128) -> torch.Tensor:
    """One fused dispatch over the flattened (T, H, D) mixed token stream
    (prefill chunks + decode rows).  On the CPU the plain version resolves
    each token's context through ``seq_ids``; on the card the kernel runs
    the work units (``msa_fused.build_units``) of the compacted work-list
    (``msa_fused.build_worklist``)."""
    if _on_cpu("msa_fused", q):
        return ref.msa_fused_ref(q, k_pages, v_pages, block_tables,
                                 context_lens, q_pos, seq_ids, q_valid,
                                 window=window, softcap=softcap)
    if worklist is None or units is None:
        raise ValueError("msa_fused on cuda needs the work-list and its "
                         "work units")
    return msa_fused_cuda(q, k_pages, v_pages, q_pos, context_lens,
                          worklist, units, window=window, softcap=softcap,
                          q_tile=q_tile)


def msa_fused_partial(q, k_pages, v_pages, block_tables, context_lens,
                      q_pos, seq_ids, q_valid, page_valid, *, worklist=None,
                      units=None, window: int = 0, softcap: float = 0.0,
                      q_tile: int = 128):
    """Per-shard partial of the fused dispatch: attention restricted to
    the pages marked valid (the shard's local pages, ``block_tables``
    holding local slots), in the normalised ``(o, lse)`` form the
    cross-shard log-sum-exp merge consumes.  On the card the kernel's
    (o, lse) mode runs the shard's work-list (``build_worklist(...,
    page_valid=...)``) and its work units."""
    if _on_cpu("msa_fused_partial", q):
        return ref.msa_fused_partial_ref(
            q, k_pages, v_pages, block_tables, context_lens, q_pos,
            seq_ids, q_valid, page_valid, window=window, softcap=softcap)
    if worklist is None or units is None:
        raise ValueError("msa_fused_partial on cuda needs the shard's "
                         "work-list and its work units")
    return msa_fused_partial_cuda(q, k_pages, v_pages, q_pos, context_lens,
                                  worklist, units, window=window,
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


def _dequant_payload(payload: torch.Tensor, scale, dtype) -> torch.Tensor:
    """In-step dequantization of a (L, S, page, KH, D) swap payload.  int8
    codes carry a per-page-per-head (L, S, KH) f32 scale; fp8 payloads
    (``float8_e4m3fn``) and fp payloads just cast.  The f32 multiply keeps
    the host-side ``offload.dequantize_half`` operand order, so eager and
    in-step swap-ins reproduce identical pool bytes."""
    if scale is not None:
        return (payload.float() * scale[:, :, None, :, None]).to(dtype)
    return payload.to(dtype)


def apply_swap_ins(k_pools: torch.Tensor, v_pools: torch.Tensor,
                   swap_k_dst: torch.Tensor, swap_v_dst: torch.Tensor,
                   swap_k: torch.Tensor, swap_v: torch.Tensor,
                   swap_k_scale=None, swap_v_scale=None) -> None:
    """Host-tier swap-ins: scatter (L, S, page, KH, D) halves into their
    pool pages in place; padding destinations (== P) land in the drop
    page.  K and V carry independent destination buckets, so a V-only
    swap-in ships no K payload.  Quantized payloads (int8 codes + scale,
    or fp8) dequantize here, on the device: the host->device copy carried
    the compressed bytes."""
    if swap_k_dst.shape[0] > 0:
        k_pools[:, swap_k_dst.long()] = _dequant_payload(
            swap_k, swap_k_scale, k_pools.dtype)
    if swap_v_dst.shape[0] > 0:
        v_pools[:, swap_v_dst.long()] = _dequant_payload(
            swap_v, swap_v_scale, v_pools.dtype)
