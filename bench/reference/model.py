"""The plain reference: the served model's forward pass over whole token
sequences, in float32 (TF32 off), with no cache, no pages, no batching
and no kernel of the port.  It imports nothing of the program.

It follows the port's equations, which are the published architecture
less the departures each configuration file lists: RMS norm scaling by
``1 + w``; rotary embedding on the split halves of each head; grouped
query attention (query head h reads key/value head h // (H / KH)) with
scores ``q.k / sqrt(D)``, softcapped as ``c * tanh(s / c)`` when the
model has a cap, causal, and on a windowed layer (``layer_window``) a
row at position p sees the keys at p - W + 1 .. p only; SwiGLU, or a
mixture of experts that routes each token to its top-k experts by the
router's logits and weighs their SwiGLU outputs by the softmax over
those k logits; a final norm and the logits against the tied embedding
or the head.

``quant="fp8"`` is the control: every weight and every activation that
enters a linear layer is rounded to float8 e4m3 (per output column for
weights, per row for activations, scaled to the format's range) before
the product, the rest as above.  It stands for a port that computed in
the nearest precision below the configuration's bfloat16.

Work is done layer by layer over all sequences at once, a layer's
weights upcast when it runs, attention in blocks of query rows, so that
the reference fits beside the weights it reads.

This is the configurations' default module (``bench/harness/spec.py``):
``leaves`` gives the parameter layout the benchmark draws the weights
in, ``logits_at`` the forward pass.  A configuration whose model this
module does not express names a module of its own that may reuse the
helpers here (``rms_norm``, ``rope``, ``attention``, ``mlp``,
``layer_window``, ``leaves``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

F8_MAX = 448.0
Q_BLOCK = 1024


def leaves(cfg) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter of the port's ``ModelConfig``
    ``cfg``, in the order the benchmark draws them; scale 0 = zeros.  The
    scales (the configuration file's ``assumed.weights`` states them): q,
    k and v projections and the router at fan-in, so attention scores
    have a standard deviation near 1 (at 1/sqrt(H) a head's softmax is
    one-hot and flips with the last bit), residual outputs depth-scaled,
    norm weights 0 (the port's norm scales by 1 + w)."""
    L, d, H, KH, D = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                      cfg.n_kv_heads, cfg.head_dim)
    f, V = cfg.d_ff, cfg.vocab_size
    fan = 1.0 / math.sqrt(d)
    out = [("embed", (V, d), 0.02),
           ("blocks.attn_norm", (L, d), 0.0),
           ("blocks.wq", (L, d, H, D), fan),
           ("blocks.wk", (L, d, KH, D), fan),
           ("blocks.wv", (L, d, KH, D), fan),
           ("blocks.wo", (L, H, D, d), 1.0 / math.sqrt(2 * L * H * D)),
           ("blocks.mlp_norm", (L, d), 0.0)]
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        out += [("blocks.router", (L, d, E), fan),
                ("blocks.we1", (L, E, d, f), fan),
                ("blocks.we3", (L, E, d, f), fan),
                ("blocks.we2", (L, E, f, d), 1.0 / math.sqrt(2 * L * f))]
    else:
        out += [("blocks.w1", (L, d, f), fan),
                ("blocks.w3", (L, d, f), fan),
                ("blocks.w2", (L, f, d), 1.0 / math.sqrt(2 * L * f))]
    out.append(("final_norm", (d,), 0.0))
    if not cfg.tie_embeddings:
        out.append(("lm_head", (d, V), 0.02))
    return out


def layer_window(model: Dict, layer: int) -> int:
    """The attention window of ``layer`` (0: every earlier key), by the
    port's rule, written again here: ``sliding_window`` W > 0 applies to
    every layer when ``local_global_ratio`` r is 0, and with r > 0 to
    the local layers, those with ``layer % (r + 1) != r``."""
    w = model.get("sliding_window", 0)
    r = model.get("local_global_ratio", 0)
    if w <= 0 or (r > 0 and layer % (r + 1) == r):
        return 0
    return w


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a scale per slice along ``dim``
    (the amax over ``dim`` maps to the format's largest value)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Linear:
    """``x @ w`` in float32, or with both operands rounded to fp8."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _q8(w, dim=-2) if self.quant else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = _q8(x, dim=-1)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D), pos (T,): rotate the two halves of each head."""
    if theta <= 0:
        return x
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, softcap: float, window: int = 0) -> torch.Tensor:
    """Causal GQA over one sequence: q (T, H, D), k/v (T, KH, D); with
    ``window`` W > 0 the keys at ``q_pos - kv_pos >= W`` are masked too
    (the port's kernel mask), and each block of rows reads only the keys
    its window reaches."""
    T, H, D = q.shape
    KH = k.shape[1]
    G = H // KH
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                       # (KH, D, T)
    vt = v.permute(1, 0, 2)                       # (KH, T, D)
    scale = 1.0 / math.sqrt(D)
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        c = max(0, s - window + 1) if window > 0 else 0
        qb = q[s:e].reshape(e - s, KH, G, D).permute(1, 2, 0, 3) * scale
        sc = qb.reshape(KH, G * (e - s), D) @ kt[:, :, c:e]  # (KH, G*n, e-c)
        sc = sc.view(KH, G, e - s, e - c)
        if softcap > 0:
            sc = softcap * torch.tanh(sc / softcap)
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(c, e, device=q.device)[None, :]
        masked = cols > rows
        if window > 0:
            masked |= rows - cols >= window
        sc = sc.masked_fill(masked, float("-inf"))
        p = torch.softmax(sc, dim=-1).view(KH, G * (e - s), e - c)
        o = (p @ vt[:, c:e]).view(KH, G, e - s, D)
        out[s:e] = o.permute(2, 0, 1, 3).reshape(e - s, H, D)
    return out


def mlp(h, blocks: Dict, l: int, moe: Optional[Dict], lin: Linear):
    if moe is None:
        a = lin(h, lin.weight(blocks["w1"][l]))
        b = lin(h, lin.weight(blocks["w3"][l]))
        return lin(F.silu(a) * b, lin.weight(blocks["w2"][l]))
    logits = h @ blocks["router"][l].float()               # (T, E)
    top_v, top_i = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = moe["top_k"]
    wts = torch.softmax(top_v[:, :k], dim=-1)             # (T, k)
    y = torch.zeros_like(h)
    for e in range(moe["num_experts"]):
        hit = top_i[:, :k] == e                           # (T, k)
        rows = hit.any(dim=-1).nonzero().squeeze(-1)
        if rows.numel() == 0:
            continue
        x = h[rows]
        a = lin(x, lin.weight(blocks["we1"][l, e]))
        b = lin(x, lin.weight(blocks["we3"][l, e]))
        o = lin(F.silu(a) * b, lin.weight(blocks["we2"][l, e]))
        w = (wts[rows] * hit[rows]).sum(dim=-1, keepdim=True)
        y.index_add_(0, rows, o * w)
    return y


def logits_at(params: Dict, model: Dict, seqs: Sequence[torch.Tensor],
              keep: Sequence[torch.Tensor],
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """The logits (float32) of each sequence of ``seqs`` (int token ids)
    at its positions ``keep``.  ``model`` is the configuration file's
    ``model`` block; ``params`` the weights as the benchmark made them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits_at(params, model, seqs, keep, Linear(quant))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits_at(params, model, seqs, keep, lin):
    blocks = params["blocks"]
    L, H, KH = model["n_layers"], model["n_heads"], model["n_kv_heads"]
    d = model["d_model"]
    D = model.get("head_dim") or d // H
    eps = model.get("norm_eps", 1e-5)
    theta = model.get("rope_theta", 10000.0)
    cap = model.get("attn_logit_softcap", 0.0)
    moe = model.get("moe")
    lens = [int(s.shape[0]) for s in seqs]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    x = params["embed"][torch.cat([s.long() for s in seqs])].float()
    pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
    N = x.shape[0]
    for l in range(L):
        h = rms_norm(x, blocks["attn_norm"][l], eps)
        q = rope(lin(h, lin.weight(blocks["wq"][l].reshape(d, H * D)))
                 .view(N, H, D), pos, theta)
        k = rope(lin(h, lin.weight(blocks["wk"][l].reshape(d, KH * D)))
                 .view(N, KH, D), pos, theta)
        v = lin(h, lin.weight(blocks["wv"][l].reshape(d, KH * D))) \
            .view(N, KH, D)
        del h
        o = torch.empty_like(q)
        win = layer_window(model, l)
        for s0, n in zip(starts, lens):
            o[s0:s0 + n] = attention(q[s0:s0 + n], k[s0:s0 + n],
                                     v[s0:s0 + n], cap, win)
        del q, k, v
        x = x + lin(o.reshape(N, H * D),
                    lin.weight(blocks["wo"][l].reshape(H * D, d)))
        del o
        x = x + mlp(rms_norm(x, blocks["mlp_norm"][l], eps), blocks, l,
                    moe, lin)
    head = params["embed"].T if model.get("tie_embeddings") \
        else params["lm_head"]
    head = lin.weight(head)
    rows = torch.cat([kp.long() + s0 for kp, s0 in zip(keep, starts)])
    out = lin(rms_norm(x[rows], params["final_norm"], eps), head)
    return list(out.split([int(kp.shape[0]) for kp in keep]))
