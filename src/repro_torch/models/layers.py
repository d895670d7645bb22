"""Serving-path layers (counterparts of ``repro.models.layers``).

Plain functions on tensors; parameters come from the same-layout dict
that ``init_params`` or the weight bridge builds.
"""
from __future__ import annotations

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
