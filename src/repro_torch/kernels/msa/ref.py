"""Plain PyTorch versions of the Multi-Segment Attention kernels.

They define the contract the hand-written CUDA kernels implement (the
counterpart of ``repro.kernels.msa.ref``):

Paged KV layout: ``k_pages``/``v_pages`` are (P, page, KH, D) pools.  A
request's logical KV space maps to pool pages through its row of
``block_tables`` (R, NP): logical block j lives in pool page
``block_tables[r, j]``.  Multi-segment contexts need no special casing —
non-contiguity exists only in pool-slot space; logical positions stay
dense and the causal mask compares logical positions.

* ``NEG_INF = -0.7 * f32max`` masks scores (finite, so ``exp`` of a
  difference of two masked scores is 1, never NaN);
* fully masked rows come out as exact zeros;
* GQA folds the head groups into the product instead of repeating K/V;
* padding rows of a KV write land in the pool's drop page and never
  reach a block table.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _gather_kv(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, KH, D), (R, NP) -> (R, NP*page, KH, D)."""
    r, np_ = block_tables.shape
    _, page, kh, d = pages.shape
    return pages[block_tables.long()].reshape(r, np_ * page, kh, d)


def msa_prefill_ref(
    q: torch.Tensor,              # (R, QP, H, D)
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (R, NP) int32
    context_lens: torch.Tensor,   # (R,) int32 — total logical kv length
    q_pos: torch.Tensor,          # (R, QP) int32 logical position per q token
    q_lens: torch.Tensor,         # (R,) int32 valid q rows
    *,
    window: int = 0,              # 0 = full causal
    softcap: float = 0.0,
) -> torch.Tensor:
    r, qp, h, d = q.shape
    kh = k_pages.shape[2]
    n_rep = h // kh
    scale = 1.0 / math.sqrt(d)

    kf = _gather_kv(k_pages, block_tables).float()      # (R, S, KH, D)
    vf = _gather_kv(v_pages, block_tables).float()
    s_len = kf.shape[1]
    qf = (q.float() * scale).reshape(r, qp, kh, n_rep, d)

    scores = torch.einsum("rqhgd,rshd->rhgqs", qf, kf)  # (R, KH, G, QP, S)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)

    kv_pos = torch.arange(s_len, dtype=torch.int32, device=q.device)
    mask = kv_pos[None, None, :] < context_lens[:, None, None]
    rel = q_pos[:, :, None] - kv_pos[None, None, :]
    mask = mask & (rel >= 0)
    if window > 0:
        mask = mask & (rel < window)
    qvalid = (torch.arange(qp, dtype=torch.int32, device=q.device)[None, :]
              < q_lens[:, None])
    mask = (mask & qvalid[:, :, None])[:, None, None]   # (R, 1, 1, QP, S)

    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask, p, 0.0)                       # fully masked rows -> 0
    out = torch.einsum("rhgqs,rshd->rqhgd", p, vf)
    return out.reshape(r, qp, h, d).to(q.dtype)


def msa_fused_ref(
    q: torch.Tensor,              # (T, H, D) flattened mixed token stream
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (N, NP) int32 — one row per sequence
    context_lens: torch.Tensor,   # (N,) int32
    q_pos: torch.Tensor,          # (T,) int32 logical position per token
    seq_ids: torch.Tensor,        # (T,) int32 — owning sequence row per token
    q_valid: torch.Tensor,        # (T,) bool — padding rows are False
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Varlen plain version of the fused mixed-batch dispatch: the
    (T, H, D) stream viewed as T single-token requests, each resolving its
    paged context through its sequence's row of ``block_tables``."""
    sid = seq_ids.long()
    out = msa_prefill_ref(
        q[:, None], k_pages, v_pages, block_tables[sid], context_lens[sid],
        q_pos[:, None], q_valid.to(torch.int32), window=window,
        softcap=softcap)
    return out[:, 0]


def msa_fused_partial_ref(
    q: torch.Tensor,              # (T, H, D) flattened mixed token stream
    k_pages: torch.Tensor,        # (P_loc, page, KH, D) — a LOCAL pool shard
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (N, NP) int32 — LOCAL page ids
    context_lens: torch.Tensor,   # (N,) int32
    q_pos: torch.Tensor,          # (T,) int32
    seq_ids: torch.Tensor,        # (T,) int32
    q_valid: torch.Tensor,        # (T,) bool
    page_valid: torch.Tensor,     # (N, NP) bool — False = page lives elsewhere
    *,
    window: int = 0,
    softcap: float = 0.0,
):
    """Partial varlen MSA over a subset of each context's pages, in the
    normalised ``(o, lse)`` form of the multi-segment / flash-decode
    merge: ``o`` is the softmax-weighted V restricted to the valid pages,
    ``lse`` the log-sum-exp of the restricted scores.  Each shard's local
    pool is one segment subset; the shards' partials merge exactly
    (``repro_torch.distributed.flash_decode.lse_merge``).

    Rows with no valid visible key (all their keys live on other shards
    or are masked) and invalid rows give ``lse = NEG_INF`` and ``o = 0``,
    a zero-weight term of the merge.  Returns ``(o (T, H, D) f32, lse
    (T, H) f32)``."""
    t, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    scale = 1.0 / math.sqrt(d)
    sid = seq_ids.long()
    bt = block_tables[sid]                              # (T, NP)
    kf = _gather_kv(k_pages, bt).float()                # (T, S, KH, D)
    vf = _gather_kv(v_pages, bt).float()
    s_len = kf.shape[1]
    qf = (q.float() * scale).reshape(t, kh, h // kh, d)
    scores = torch.einsum("thgd,tshd->thgs", qf, kf)   # (T, KH, G, S)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)

    ctx = context_lens[sid]
    kv_pos = torch.arange(s_len, dtype=torch.int32, device=q.device)
    mask = kv_pos[None, :] < ctx[:, None]
    rel = q_pos[:, None] - kv_pos[None, :]
    mask = mask & (rel >= 0)
    if window > 0:
        mask = mask & (rel < window)
    mask = mask & page_valid[sid].repeat_interleave(page, dim=1)
    mask = (mask & q_valid[:, None])[:, None, None, :]  # (T, 1, 1, S)

    scores = torch.where(mask, scores, NEG_INF)
    m = scores.max(dim=-1).values                       # (T, KH, G)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("thgs,tshd->thgd", p, vf)
    o = o / torch.clamp(l, min=1e-30)[..., None]
    # fully masked rows: l == 0, o already 0; lse pinned to NEG_INF so
    # the merge gives them zero weight
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      NEG_INF)
    return o.reshape(t, h, d), lse.reshape(t, h)


def msa_decode_ref(
    q: torch.Tensor,              # (B, H, D) — one new token per sequence
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, NP) int32
    context_lens: torch.Tensor,   # (B,) int32 — includes the new token
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain paged decode: :func:`msa_prefill_ref` over one row per
    sequence at logical position ``ctx - 1``."""
    b = q.shape[0]
    q_pos = (context_lens - 1)[:, None]
    out = msa_prefill_ref(
        q[:, None], k_pages, v_pages, block_tables, context_lens, q_pos,
        torch.ones((b,), dtype=torch.int32, device=q.device), window=window,
        softcap=softcap)
    return out[:, 0]


def write_kv_pages(
    k_pages: torch.Tensor,        # (P + 1, page, KH, D) — last page = drop page
    v_pages: torch.Tensor,
    k_new: torch.Tensor,          # (T, KH, D)
    v_new: torch.Tensor,
    slot_ids: torch.Tensor,       # (T,) int32 — pool page per new token
    slot_offsets: torch.Tensor,   # (T,) int32 — offset within page
    valid: torch.Tensor,          # (T,) bool
) -> None:
    """Scatter freshly computed K/V into the paged pools, in place (the
    JAX version returned new pools that the step had donated).

    Invalid (padding) rows are routed to the pool's last page, a drop
    page that no block table references — the counterpart of JAX's
    out-of-range ``mode="drop"`` scatter.  It stays a pure scatter: no
    read-modify-write and no host sync on the mask."""
    drop = k_pages.shape[0] - 1
    slot = torch.where(valid, slot_ids, drop).long()
    off = slot_offsets.long()
    k_pages[slot, off] = k_new.to(k_pages.dtype)
    v_pages[slot, off] = v_new.to(v_pages.dtype)
