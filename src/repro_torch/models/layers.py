"""Serving-path layers (counterparts of ``repro.models.layers``).

Plain functions on tensors; parameters come from the same-layout dict
that ``init_params`` or the weight bridge builds.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32 that scales by ``1 + weight`` (norm weights
    are zero-initialised)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    if theta <= 0:
        return torch.zeros((head_dim // 2,), dtype=torch.float32,
                           device=device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.  Rotates
    the split halves (not interleaved pairs) of each head."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """x: (..., d); w1/w3: (d, f); w2: (f, d)."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


# ---------------------------------------------------------------------------
# MoE: top-k routing with sort-based capacity dispatch
# ---------------------------------------------------------------------------

def topk_route(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k) float32, idx (T, k)); weights
    softmaxed over the top k.  Among equal logits the lower expert comes
    first, as ``lax.top_k`` orders them (bf16 router logits tie often):
    a stable descending sort keeps that order, where ``torch.topk``
    promises none."""
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(topv[:, :k].float(), dim=-1), topi[:, :k]


def capacity_dispatch(flat_expert: torch.Tensor, num_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's position within its expert's bucket, and whether it
    fits.  ``flat_expert``: (N,) expert ids.  Returns (pos (N,), keep (N,)
    bool): a stable sort ranks the slots of one expert in slot order, and
    slots past ``capacity`` drop (their tokens keep only the residual)."""
    n = flat_expert.shape[0]
    order = torch.argsort(flat_expert, stable=True)           # rank -> slot
    sorted_e = flat_expert[order]
    start = torch.searchsorted(sorted_e, torch.arange(
        num_experts, dtype=sorted_e.dtype, device=sorted_e.device))
    pos_sorted = torch.arange(n, device=flat_expert.device) \
        - start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos, pos < capacity


def expand_virtual_experts(weights: torch.Tensor, topi: torch.Tensor,
                           split: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map physical top-k routing (T, k) to virtual (column-split)
    experts: physical expert e becomes experts e*split .. e*split+split-1,
    whose outputs sum to its output (SwiGLU decomposes over d_ff column
    blocks), each with the physical expert's router weight.  Returns
    (T, k*split) arrays."""
    if split == 1:
        return weights, topi
    t, k = topi.shape
    virt = topi[:, :, None] * split + torch.arange(
        split, dtype=topi.dtype, device=topi.device)
    w = weights[:, :, None].expand(t, k, split)
    return w.reshape(t, k * split), virt.reshape(t, k * split)


def moe_ffn_local(x: torch.Tensor, router_w: torch.Tensor,
                  we1: torch.Tensor, we3: torch.Tensor, we2: torch.Tensor,
                  top_k: int, capacity_factor: float = 1.25,
                  dropless: bool = False,
                  expert_split: int = 1) -> torch.Tensor:
    """Single-program MoE over (T, d) tokens: route each token to its top
    k experts and compute every expert over its (capacity, d) bucket of
    the (E, C, d) buffer.  ``router_w`` (d, E_physical); ``we1``/``we3``
    (E_virtual, d, f); ``we2`` (E_virtual, f, d).

    ``dropless=True`` sets C = T (top-k experts are distinct, so an expert
    gets at most one slot a token): nothing drops, which lossless serving
    needs.  Otherwise C = ceil(T·k/E·capacity_factor) and overflow slots
    drop.  The buffer's shape depends only on T, so a row's result does
    not depend on how the other rows routed; it computes E·C rows where
    T·k are routed."""
    t, d = x.shape
    e = we1.shape[0]                                        # virtual
    weights, topi = topk_route(x @ router_w, top_k)
    weights, topi = expand_virtual_experts(weights, topi, expert_split)
    k_eff = top_k * expert_split
    n = t * k_eff
    flat_e = topi.reshape(n)
    capacity = t if dropless else max(
        1, int(math.ceil(t * k_eff / e * capacity_factor)))
    pos, keep = capacity_dispatch(flat_e, e, capacity)
    slot = torch.where(keep, flat_e * capacity + pos, e * capacity)
    buf = x.new_zeros((e * capacity + 1, d))
    buf[slot] = x.repeat_interleave(k_eff, dim=0)           # overflow row
    buf = buf[:-1].view(e, capacity, d)
    h = F.silu(torch.bmm(buf, we1)) * torch.bmm(buf, we3)
    y = torch.bmm(h, we2).view(e * capacity, d)             # (E*C, d)
    gathered = torch.where(keep[:, None], y[torch.where(keep, slot, 0)],
                           0.0)
    gathered = gathered * weights.reshape(n)[:, None].to(x.dtype)
    return gathered.view(t, k_eff, d).sum(dim=1)
