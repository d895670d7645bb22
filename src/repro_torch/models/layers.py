"""Model layers (counterparts of ``repro.models.layers``): the serving
path's norms, rope, SwiGLU and MoE, and the full model's attention
(chunked online softmax, banded, decode) and Mamba-2 pieces.

Plain functions on tensors; parameters come from the same-layout dict
that ``init_params`` or the weight bridge builds.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.msa.ref import NEG_INF


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


# ---------------------------------------------------------------------------
# Positions and attention of the full model (plain PyTorch, as the JAX
# package's XLA path: the paged serving path runs the MSA kernels instead)
# ---------------------------------------------------------------------------

#: the padded kv tail's position: after every query, so causally masked
INT32_MAX = 2**31 - 1


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (float32), computed on the fly:
    positions (...) -> (..., d_model)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, KH*n_rep, D): each kv head serves n_rep
    consecutive query heads."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0,
                    kv_len: Optional[torch.Tensor] = None,
                    chunk_size: int = 1024) -> torch.Tensor:
    """Attention with an online softmax over kv chunks of ``chunk_size``:
    q (B, Sq, H, D), k/v (B, Sk, KH, D), q_pos (B, Sq) and kv_pos (B, Sk)
    logical positions -> (B, Sq, H, D) in q's dtype.  Causal masking
    compares logical positions, so a multi-segment context works as is;
    ``window`` (> 0) keeps the keys less than ``window`` positions back,
    ``kv_len`` (B,) masks a padded kv tail.  Scores and the running
    (max, sum, acc) are float32; no score tensor larger than one chunk's
    (B, H, Sq, chunk) exists."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    nchunks = max(1, -(-sk // chunk_size))
    pad = nchunks * chunk_size - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((b, pad), INT32_MAX)],
                           dim=1)
    if kv_len is None:
        kv_len = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    qf = q.float() * scale
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        cs = slice(c * chunk_size, (c + 1) * chunk_size)
        s = torch.einsum("bqhd,bchd->bhqc", qf, k[:, cs].float())
        s = _softcap(s, softcap)
        idx = torch.arange(cs.start, cs.stop, device=q.device)
        mask = idx[None, None, None, :] < kv_len[:, None, None, None]
        if causal:
            rel = q_pos[:, None, :, None] - kv_pos[:, None, None, cs]
            mask = mask & (rel >= 0)
            if window is not None and window > 0:
                mask = mask & (rel < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqc,bchd->bhqd", p, v[:, cs].float())
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def banded_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0, q_tile: int = 512,
                           kv_tile: int = 512) -> torch.Tensor:
    """Causal (``window`` 0) or sliding-window self-attention over
    contiguous positions 0..S-1 that skips kv tiles outside the band:
    q tile t visits kv tiles from (t·q_tile - window + 1) // kv_tile (0
    without a window) to ceil((t+1)·q_tile / kv_tile), ranges fixed by
    the shapes alone, so the work is O(S·(window + tile)) on a windowed
    layer and about the lower triangle on a full one.  Same layouts and
    float32 online softmax as :func:`flash_attention`."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    assert s % q_tile == 0 and s % kv_tile == 0, (s, q_tile, kv_tile)
    kf = repeat_kv(k, h // kh)
    vf = repeat_kv(v, h // kh)
    outs = []
    for t in range(s // q_tile):
        lo = max(0, t * q_tile - window + 1) if window > 0 else 0
        lo_tile, hi_tile = lo // kv_tile, -(-((t + 1) * q_tile) // kv_tile)
        qt = q[:, t * q_tile:(t + 1) * q_tile].float() * scale
        q_pos = t * q_tile + torch.arange(q_tile, device=q.device)
        m = torch.full((b, h, q_tile), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_tile), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, q_tile, d), dtype=torch.float32,
                          device=q.device)
        for j in range(lo_tile, hi_tile):
            ks = slice(j * kv_tile, (j + 1) * kv_tile)
            s_ = _softcap(torch.einsum("bqhd,bchd->bhqc", qt,
                                       kf[:, ks].float()), softcap)
            kv_pos = torch.arange(ks.start, ks.stop, device=q.device)
            rel = q_pos[:, None] - kv_pos[None, :]
            mask = rel >= 0
            if window > 0:
                mask = mask & (rel < window)
            s_ = torch.where(mask[None, None], s_, NEG_INF)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.where(mask[None, None],
                            torch.exp(s_ - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqc,bchd->bhqd", p, vf[:, ks].float())
            m = m_new
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(o.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """One new token a sequence over a contiguous cache: q (B, H, D),
    k/v_cache (B, S, KH, D), kv_len (B,) valid slots (the new token's
    included) -> (B, H, D).  One masked float32 softmax; ``window`` (> 0)
    keeps slots ``idx >= kv_len - window``."""
    b, s, kh, d = k_cache.shape
    h = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, kh, h // kh, d) * scale
    s_ = _softcap(torch.einsum("bgrd,bsgd->bgrs", qf, k_cache.float()),
                  softcap)
    idx = torch.arange(s, device=q.device)[None, None, None, :]
    kv_len = kv_len[:, None, None, None]
    mask = idx < kv_len
    if window is not None:
        mask = mask & (idx >= kv_len - (window if window > 0
                                         else INT32_MAX // 2))
    p = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality): chunked scan
# ---------------------------------------------------------------------------

def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum of x[..., j+1 .. i] for i >= j, else -inf."""
    cs = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    out = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's SSD over x (B, L, H, P), dt (B, L, H) float32 step
    sizes, A (H,) float32 negative decay rates, B_/C_ (B, L, G, N), L a
    multiple of ``chunk``: (y (B, L, H, P) in x's dtype, final state
    (B, H, P, N) float32).  Four stages: the quadratic term inside each
    chunk, each chunk's final state, the recurrence across chunks (a loop
    over them, from ``init_state``), and the output of the carried-in
    state."""
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    assert l % chunk == 0, (l, chunk)
    c = l // chunk
    rep = h // g
    xd = x * dt[..., None]                                    # float32
    a = dt * A[None, None, :]                                 # log-decay
    xc = xd.reshape(b, c, chunk, h, p).float()
    ac = a.reshape(b, c, chunk, h)
    Bc = torch.repeat_interleave(B_.reshape(b, c, chunk, g, n), rep, dim=3)
    Cc = torch.repeat_interleave(C_.reshape(b, c, chunk, g, n), rep, dim=3)
    a_cum = torch.cumsum(ac, dim=2)                           # (B,c,cs,H)

    # 1. inside each chunk (quadratic)
    Lmat = torch.exp(segsum(ac.permute(0, 1, 3, 2)))          # (B,c,H,cs,cs)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    y_diag = torch.einsum("bchij,bchij,bcjhp->bcihp", scores.float(), Lmat,
                          xc).to(x.dtype)

    # 2. each chunk's final state
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)     # (B,c,cs,H)
    states = torch.einsum("bcihn,bcih,bcihp->bchpn", Bc.float(),
                          decay_states, xc)                   # (B,c,H,P,N)

    # 3. across chunks: the state entering each chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # (B,c,H)
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    prev = []
    for i in range(c):
        prev.append(st)
        st = st * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                    # (B,c,H,P,N)

    # 4. output of the carried-in state
    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", Cc.float(), prev_states,
                         torch.exp(a_cum)).to(x.dtype)
    return (y_diag + y_off).reshape(b, l, h, p), st


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C_: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the SSD recurrence: x (B, H, P), dt (B, H), A (H,),
    B_/C_ (B, G, N), state (B, H, P, N) float32 -> (y (B, H, P) in x's
    dtype, new state)."""
    rep = x.shape[1] // B_.shape[1]
    Bh = torch.repeat_interleave(B_, rep, dim=1)              # (B,H,N)
    Ch = torch.repeat_interleave(C_, rep, dim=1)
    decay = torch.exp(dt * A[None, :])                        # (B,H)
    xd = (x * dt[..., None]).float()
    new_state = state * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xd, Bh.float())
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.float())
    return y.to(x.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x (B, L, C), w (C, K), b (C,);
    out[t] = sum_i x[t-(K-1)+i] * w[:, i] + b."""
    k, l = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + l, :] * w[:, i][None, None, :]
    return out + b[None, None, :]


def causal_conv1d_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of :func:`causal_conv1d`: x_new (B, C),
    conv_state (B, K-1, C) the previous inputs -> (out (B, C), new
    conv_state)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,K,C)
    out = torch.einsum("bkc,ck->bc", window, w) + b[None, :]
    return out, window[:, 1:, :]
