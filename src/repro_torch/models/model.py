"""Decoder-only token models (dense and MoE): parameter construction and
the dense no-cache forward that backs ``reference_logits`` (counterparts
of ``repro.models.model``).

Parameters are a plain dict with the JAX package's layout: per-layer
tensors stacked on a leading ``L`` axis under ``params["blocks"]``;
``wq`` (L, d, H, hd), ``wk``/``wv`` (L, d, KH, hd), ``wo`` (L, H, hd, d),
and either ``w1``/``w3`` (L, d, f), ``w2`` (L, f, d) or, for MoE,
``router`` (L, d, E_physical), ``we1``/``we3`` (L, E, d, f), ``we2``
(L, E, f, d); norms zero-initialised (they scale by ``1 + w``).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.msa.ref import NEG_INF
from repro_torch.models.layers import (apply_rope, moe_ffn_local, rms_norm,
                                       swiglu_mlp)


def _param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """(shape, scale) of every parameter of the dense and MoE families, as
    the JAX package's ``_block_defs``/``_build`` declare them: scale
    ``None`` = 1/sqrt(shape[-2]); 0.0 = zeros; residual-output
    projections (wo, w2, we2) depth-scaled by 1/sqrt(2L)."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    H, KH, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    depth = 1.0 / math.sqrt(2.0 * max(L, 1))
    blocks = {
        "attn_norm": ((L, d), 0.0),
        "wq": ((L, d, H, hd), None),
        "wk": ((L, d, KH, hd), None),
        "wv": ((L, d, KH, hd), None),
        "wo": ((L, H, hd, d), depth / math.sqrt(H * hd)),
        "mlp_norm": ((L, d), 0.0),
    }
    if cfg.moe is not None:
        E = cfg.moe.num_experts            # virtual experts / split d_ff
        blocks.update({
            "router": ((L, d, cfg.moe.num_physical_experts), None),
            "we1": ((L, E, d, f), None),
            "we3": ((L, E, d, f), None),
            "we2": ((L, E, f, d), depth / math.sqrt(f)),
        })
    else:
        blocks.update({
            "w1": ((L, d, f), None),
            "w3": ((L, d, f), None),
            "w2": ((L, f, d), depth / math.sqrt(f)),
        })
    top = {"embed": ((cfg.vocab_size, d), 0.02),
           "final_norm": ((d,), 0.0)}
    if not cfg.tie_embeddings:
        top["lm_head"] = ((d, cfg.vocab_size), 0.02)
    return {"blocks": blocks, **top}


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict:
    """Random parameters of the dense or MoE family, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (normal * scale
    in float32, then cast to ``cfg.dtype``).  The expert weights are
    drawn one (layer, expert) matrix at a time into the ``cfg.dtype``
    tensor, so the float32 temporary is one matrix, not the stack (at
    Grok-1's width 0.8 GB, where a 4-layer ``we1`` would be 25.8 GB);
    every other tensor is drawn whole.  Other families come with later
    slices."""
    if cfg.family not in ("dense", "moe") or cfg.d_ff <= 0:
        raise NotImplementedError(
            f"init_params: family {cfg.family!r} comes with a later slice "
            "of the port (dense and MoE only here)")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, shape, scale):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=dev)
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2
                                    else shape[-1])
        lead = 2 if name in ("we1", "we3", "we2") else 0
        out = torch.empty(shape, dtype=dt, device=dev)
        for idx in itertools.product(*map(range, shape[:lead])):
            t = torch.empty(shape[lead:], dtype=torch.float32, device=dev)
            out[idx] = t.normal_(generator=gen).mul_(scale)
        return out

    shapes = _param_shapes(cfg)
    params = {"blocks": {k: make(k, *v)
                         for k, v in shapes["blocks"].items()}}
    for k, v in shapes.items():
        if k != "blocks":
            params[k] = make(k, *v)
    return params


def _layer_windows(cfg: ModelConfig, n_layers: int) -> List[int]:
    """Per-layer attention window (0 = full attention)."""
    return [cfg.sliding_window
            if cfg.sliding_window > 0 and cfg.layer_is_local(i) else 0
            for i in range(n_layers)]


def _dense_attention(q, k, v, window: int, softcap: float) -> torch.Tensor:
    """Plain causal attention (B, S, H, D) x (B, S, KH, D): float32
    scores, GQA folded, the same mask and softcap as the kernels.  A
    check for the serving path, not part of it."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(d))).reshape(b, s, kh, h // kh, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = rel >= 0
    if window > 0:
        mask = mask & (rel < window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def forward(params: Dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward of the dense or MoE family over ``tokens``
    (B, S): logits (B, S, V)."""
    if cfg.family not in ("dense", "moe") or cfg.rope_theta <= 0:
        raise NotImplementedError(
            "forward: the dense and MoE rope families only (the full model "
            "comes with a later slice of the port)")
    blocks = params["blocks"]
    x = params["embed"][tokens]                       # (B, S, d)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    windows = _layer_windows(cfg, cfg.n_layers)
    for l in range(cfg.n_layers):
        h = rms_norm(x, blocks["attn_norm"][l], cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", h, blocks["wq"][l])
        k = torch.einsum("bsd,dhk->bshk", h, blocks["wk"][l])
        v = torch.einsum("bsd,dhk->bshk", h, blocks["wv"][l])
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        attn = _dense_attention(q, k, v, windows[l], cfg.attn_logit_softcap)
        x = x + torch.einsum("bshk,hkd->bsd", attn, blocks["wo"][l])
        h2 = rms_norm(x, blocks["mlp_norm"][l], cfg.norm_eps)
        if cfg.moe is not None:
            m = cfg.moe
            y = moe_ffn_local(
                h2.reshape(b * s, -1), blocks["router"][l],
                blocks["we1"][l], blocks["we3"][l], blocks["we2"][l],
                m.top_k, m.capacity_factor, dropless=m.dropless,
                expert_split=m.expert_split).reshape(b, s, -1)
        else:
            y = swiglu_mlp(h2, blocks["w1"][l], blocks["w3"][l],
                           blocks["w2"][l])
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head
