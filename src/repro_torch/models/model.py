"""The full model of every family (counterpart of ``repro.models.model``):
dense, MoE, VLM, SSM (Mamba-2), hybrid attention + SSM (Hymba) and
encoder-decoder (Whisper).

Entry points:
  * ``init_params(cfg, seed, device)``
  * ``forward(params, cfg, batch)``: full-sequence causal forward (train
    and prefill), optionally with each layer's K/V and last-position
    logits only, and with each layer recomputed in the backward
    (``remat``);
  * ``loss_fn(params, cfg, batch)``: mean next-token cross-entropy, its
    layers recomputed in the backward by default (training);
  * ``init_decode_state(cfg, batch_size, max_len)``,
    ``prep_cross_attention`` and ``decode_step``: the dense (contiguous
    per-sequence) decode cache and its one-token step;
  * ``shard_decode_state(state, ctx)``: the decode cache cut over a
    context's mesh.

Under an active ``DistContext`` (``repro_torch.distributed``) the model
reads the JAX package's flags: ``moe_alltoall`` takes the MoE through
the expert-parallel all-to-all (``moe_ffn_alltoall``), ``flash_decode``
takes decode attention over the sequence-sharded cache
(``sharded_decode_attention``), and ``banded_attention`` and
``attn_chunk`` steer ``forward``'s attention as its keyword arguments do
for callers without a context.  The flags that only steer XLA
(``unroll_scans``, ``seq_parallel``, ``ar_barrier``) are accepted and
ignored.  Everything else (norms, projections, MLP, logits) runs on the
mesh's first device: GSPMD's sharding of those changes where they run,
not their values.

Parameters are a plain dict with the JAX package's layout: per-layer
tensors stacked on a leading ``L`` axis under ``params["blocks"]`` (and
``params["enc_blocks"]`` for the encoder); ``wq`` (L, d, H, hd),
``wk``/``wv`` (L, d, KH, hd), ``wo`` (L, H, hd, d), cross-attention the
same under an ``x`` prefix, either ``w1``/``w3`` (L, d, f), ``w2``
(L, f, d) or, for MoE, ``router`` (L, d, E_physical), ``we1``/``we3``
(L, E, d, f), ``we2`` (L, E, f, d), and the SSM's ``in_proj``, ``conv_w``,
``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``gnorm``, ``ssm_out``; norms
zero-initialised (they scale by ``1 + w``).  The layers run in a Python
loop over ``L`` (the JAX package scans them), each taking its weights as
views from one ``torch.unbind`` of each stacked leaf.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (DistContext, ShardedTensor,
                                             current, flag, place)
from repro_torch.models.layers import (apply_rope, banded_flash_attention,
                                       causal_conv1d, causal_conv1d_step,
                                       decode_attention, flash_attention,
                                       moe_ffn_local, rms_norm,
                                       sinusoidal_positions, ssd_chunked,
                                       ssd_decode_step, swiglu_mlp)

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_defs(cfg: ModelConfig, L: int, *,
                cross_attn: bool = False) -> Dict[str, tuple]:
    """(shape, scale, logical axes) of one stack of blocks, as the JAX
    package's ``_block_defs`` declares them: scale ``None`` =
    1/sqrt(shape[-2]); 0.0 = zeros; residual-output projections (wo, xwo,
    w2, we2, ssm_out) depth-scaled by 1/sqrt(2L)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KH, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    depth = 1.0 / math.sqrt(2.0 * max(L, 1))
    defs: Dict[str, tuple] = {}

    def attn(p):
        defs.update({
            p + "attn_norm": ((L, d), 0.0, (None, None)),
            p + "wq": ((L, d, H, hd), None, (None, "fsdp", "heads", None)),
            p + "wk": ((L, d, KH, hd), None,
                       (None, "fsdp", "kv_heads", None)),
            p + "wv": ((L, d, KH, hd), None,
                       (None, "fsdp", "kv_heads", None)),
            p + "wo": ((L, H, hd, d), depth / math.sqrt(H * hd),
                       (None, "heads", None, "fsdp")),
        })

    if cfg.family != "ssm":
        attn("")
    if cross_attn:
        attn("x")
    if cfg.ssm is not None:
        s = cfg.ssm
        di, nh = s.d_inner(d), s.n_heads(d)
        gn = s.n_groups * s.d_state
        defs.update({
            "ssm_norm": ((L, d), 0.0, (None, None)),
            "in_proj": ((L, d, 2 * di + 2 * gn + nh), None,
                        (None, "fsdp", "ssm_inner")),
            "conv_w": ((L, di + 2 * gn, s.d_conv), 0.5,
                       (None, "ssm_inner", None)),
            "conv_b": ((L, di + 2 * gn), 0.0, (None, "ssm_inner")),
            "A_log": ((L, nh), 1.0, (None, "ssm_heads")),
            "D": ((L, nh), 1.0, (None, "ssm_heads")),
            "dt_bias": ((L, nh), 1.0, (None, "ssm_heads")),
            "gnorm": ((L, di), 0.0, (None, "ssm_inner")),
            "ssm_out": ((L, di, d), depth / math.sqrt(di),
                        (None, "ssm_inner", "fsdp")),
        })
    if cfg.moe is not None:
        E = cfg.moe.num_experts            # virtual experts / split d_ff
        defs.update({
            "mlp_norm": ((L, d), 0.0, (None, None)),
            "router": ((L, d, cfg.moe.num_physical_experts), None,
                       (None, None, None)),
            "we1": ((L, E, d, f), None,
                    (None, "experts", "expert_fsdp", "expert_ffn")),
            "we3": ((L, E, d, f), None,
                    (None, "experts", "expert_fsdp", "expert_ffn")),
            "we2": ((L, E, f, d), depth / math.sqrt(f),
                    (None, "experts", "expert_ffn", "expert_fsdp")),
        })
    elif f > 0:
        defs.update({
            "mlp_norm": ((L, d), 0.0, (None, None)),
            "w1": ((L, d, f), None, (None, "fsdp", "ffn")),
            "w3": ((L, d, f), None, (None, "fsdp", "ffn")),
            "w2": ((L, f, d), depth / math.sqrt(f), (None, "ffn", "fsdp")),
        })
    return defs


def param_defs(cfg: ModelConfig) -> Dict:
    """(shape, scale, logical axes) of every parameter, in the
    parameters' nesting (the JAX package's ``_build``)."""
    d = cfg.d_model
    defs: Dict = {"embed": ((cfg.vocab_size, d), 0.02, ("vocab", None)),
                  "blocks": _block_defs(cfg, cfg.n_layers,
                                        cross_attn=cfg.enc_dec)}
    if cfg.enc_dec:
        defs["enc_blocks"] = _block_defs(cfg, cfg.n_encoder_layers)
        defs["enc_final_norm"] = ((d,), 0.0, (None,))
    defs["final_norm"] = ((d,), 0.0, (None,))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, cfg.vocab_size), 0.02, (None, "vocab"))
    return defs


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters of any family, drawn from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (normal * scale in float32, then
    cast to ``cfg.dtype``).  The expert weights are drawn one (layer,
    expert) matrix at a time into the ``cfg.dtype`` tensor, so the
    float32 temporary is one matrix, not the stack (at Grok-1's width
    0.8 GB, where a 4-layer ``we1`` would be 25.8 GB); every other tensor
    is drawn whole."""
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

    def build(defs):
        return {k: build(v) if isinstance(v, dict) else make(k, *v[:2])
                for k, v in defs.items()}

    return build(param_defs(cfg))


def abstract_params(cfg: ModelConfig) -> Dict:
    """Every parameter as a tensor on the meta device: its shape and
    ``cfg.dtype``, no memory and no values (the JAX package's
    ``abstract_params``; the dry run sizes and runs a model with them)."""
    dt = torch_dtype(cfg.dtype)

    def build(defs):
        return {k: build(v) if isinstance(v, dict)
                else torch.empty(v[0], dtype=dt, device="meta")
                for k, v in defs.items()}

    return build(param_defs(cfg))


def _layer_windows(cfg: ModelConfig, n_layers: int) -> List[int]:
    """Per-layer attention window (0 = full attention)."""
    return [cfg.sliding_window
            if cfg.sliding_window > 0 and cfg.layer_is_local(i) else 0
            for i in range(n_layers)]


def _layers(blocks: Dict) -> List[Dict]:
    """Each layer's weights, as views of the stacked ``(L, ...)`` leaves
    from one ``torch.unbind`` a leaf: its backward stacks the layers'
    gradients once, where indexing ``v[l]`` a layer would write a zero
    leaf of full size for every layer."""
    per_leaf = {k: torch.unbind(v) for k, v in blocks.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[l] for k, v in per_leaf.items()} for l in range(n)]


def _maybe_remat(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; with ``remat`` and autograd recording,
    under non-reentrant ``torch.utils.checkpoint``: the backward recomputes
    the layer from its inputs instead of keeping its activations (the JAX
    package's ``jax.checkpoint(..., nothing_saveable)``), with the same
    operations, so the same bits."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)


def _head(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Blocks, full-sequence mode
# ---------------------------------------------------------------------------


def _attn_sublayer(x, blk, cfg: ModelConfig, q_pos, kv_pos, window: int, *,
                   prefix: str = "", k_ext=None, causal: bool = True,
                   banded: bool = False, attn_chunk: int = 1024):
    """Self- (or, with ``prefix="x"`` and the encoder output ``k_ext``,
    cross-) attention sublayer: x (B, S, d) -> (out (B, S, d), (k, v)).
    ``banded`` lets a causal self-attention layer take
    :func:`banded_flash_attention` when S divides by its tile, as the JAX
    package's static-window path does; any other layer takes
    :func:`flash_attention` in chunks of ``attn_chunk``."""
    h = rms_norm(x, blk[prefix + "attn_norm"], cfg.norm_eps)
    src = h if k_ext is None else k_ext
    q = torch.einsum("bsd,dhk->bshk", h, blk[prefix + "wq"])
    k = torch.einsum("bsd,dhk->bshk", src, blk[prefix + "wk"])
    v = torch.einsum("bsd,dhk->bshk", src, blk[prefix + "wv"])
    if causal and cfg.rope_theta > 0:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    s_len = q.shape[1]
    # window-sized tiles keep a local layer's work <= 2x window a token;
    # a global layer takes eighths of the sequence, at least 1024
    tile = min(window, 2048) if window > 0 else max(1024, s_len // 8)
    if banded and causal and k_ext is None and s_len % tile == 0:
        out = banded_flash_attention(q, k, v, window=window,
                                     softcap=cfg.attn_logit_softcap,
                                     q_tile=tile, kv_tile=tile)
    else:
        out = flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                              window=window if window > 0 else None,
                              softcap=cfg.attn_logit_softcap,
                              chunk_size=attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out, blk[prefix + "wo"]), (k, v)


def _ssm_split(cfg: ModelConfig, zxbcdt):
    """in_proj's output -> (z, xBC, dt) by width."""
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    return torch.split(zxbcdt, [di, di + 2 * gn, s.n_heads(cfg.d_model)],
                       dim=-1)


def _ssm_coeffs(cfg: ModelConfig, blk, xBC, dt):
    """(x, B, C) of the convolved input and the float32 (dt, A)."""
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    xs, B_, C_ = torch.split(xBC, [di, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + blk["dt_bias"].float())
    A = -torch.exp(blk["A_log"].float())
    return xs, B_, C_, dt, A


def _ssm_sublayer(x, blk, cfg: ModelConfig):
    """Mamba-2 SSD sublayer over the whole sequence: (B, S, d) ->
    (B, S, d).  The sequence is padded to the chunk multiple with zero
    dt, which adds nothing to the state."""
    s = cfg.ssm
    bsz, L, _ = x.shape
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    h = rms_norm(x, blk["ssm_norm"], cfg.norm_eps)
    z, xBC, dt = _ssm_split(cfg, h @ blk["in_proj"])
    xBC = F.silu(causal_conv1d(xBC, blk["conv_w"], blk["conv_b"]))
    xs, B_, C_, dt, A = _ssm_coeffs(cfg, blk, xBC, dt)
    chunk = s.chunk_size
    pad = (-L) % chunk
    if pad:
        xs, B_, C_, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, B_, C_, dt))
    xh = xs.reshape(bsz, L + pad, nh, s.head_dim)
    y, _ = ssd_chunked(
        xh, dt, A, B_.reshape(bsz, L + pad, s.n_groups, s.d_state),
        C_.reshape(bsz, L + pad, s.n_groups, s.d_state), chunk)
    y = y + xh * blk["D"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(bsz, L + pad, di)[:, :L]
    y = rms_norm(y * F.silu(z), blk["gnorm"], cfg.norm_eps)
    return y @ blk["ssm_out"]


def _ffn_sublayer(x, blk, cfg: ModelConfig):
    """SwiGLU or the MoE over (B, S, d), or ``None`` without an MLP.  The
    MoE takes the expert-parallel all-to-all under ``moe_alltoall``."""
    if cfg.moe is not None:
        m = cfg.moe
        h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
        if flag("moe_alltoall", False):
            # imported here, as the JAX package does: the distributed
            # package imports the model's layers
            from repro_torch.distributed.moe_ep import moe_ffn_alltoall
            return moe_ffn_alltoall(h, blk["router"], blk["we1"],
                                    blk["we3"], blk["we2"], cfg)
        bsz, L, d = h.shape
        return moe_ffn_local(
            h.reshape(bsz * L, d), blk["router"], blk["we1"], blk["we3"],
            blk["we2"], m.top_k, m.capacity_factor, dropless=m.dropless,
            expert_split=m.expert_split).reshape(bsz, L, d)
    if cfg.d_ff > 0:
        h = rms_norm(x, blk["mlp_norm"], cfg.norm_eps)
        return swiglu_mlp(h, blk["w1"], blk["w3"], blk["w2"])
    return None


def _apply_block(x, blk, cfg: ModelConfig, q_pos, window: int, *,
                 enc_out=None, banded: bool = False, attn_chunk: int = 1024):
    """One decoder block over the whole sequence: (x, (k, v) or None)."""
    kw = dict(banded=banded, attn_chunk=attn_chunk)
    kv = None
    if cfg.family == "ssm":
        x = x + _ssm_sublayer(x, blk, cfg)
    elif cfg.hybrid_attn_ssm:
        attn, kv = _attn_sublayer(x, blk, cfg, q_pos, q_pos, window, **kw)
        x = x + 0.5 * (attn + _ssm_sublayer(x, blk, cfg))
    else:
        attn, kv = _attn_sublayer(x, blk, cfg, q_pos, q_pos, window, **kw)
        x = x + attn
    if cfg.enc_dec and enc_out is not None:
        enc_pos = torch.zeros(enc_out.shape[:2], dtype=torch.int32,
                              device=x.device)
        x = x + _attn_sublayer(x, blk, cfg, q_pos, enc_pos, 0, prefix="x",
                               k_ext=enc_out, causal=False,
                               attn_chunk=attn_chunk)[0]
    ffn = _ffn_sublayer(x, blk, cfg)
    return (x if ffn is None else x + ffn), kv


def _banded_layers(cfg: ModelConfig, banded: bool) -> bool:
    """Whether every layer's window is static under the JAX package's
    ``banded_attention`` flag: uniform windows, or a layer count that is a
    whole number of local:global periods (``_scan_blocks``); otherwise
    every layer takes the chunked path."""
    if not banded or cfg.family == "ssm":
        return False
    return (len(set(_layer_windows(cfg, cfg.n_layers))) == 1
            or cfg.n_layers % (cfg.local_global_ratio + 1) == 0)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """``batch["embeds"]`` (B, S, d) when given, else the embedding of
    ``batch["tokens"]`` (B, S); sinusoidal positions added when the model
    has no rope and no encoder."""
    if batch.get("embeds") is not None:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
    else:
        x = params["embed"][batch["tokens"]]
    if cfg.rope_theta <= 0 and not cfg.enc_dec:
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x


def _encoder_layer(x, blk, cfg: ModelConfig, pos, attn_chunk: int):
    """One encoder layer: bidirectional attention, then the MLP."""
    h = x + _attn_sublayer(x, blk, cfg, pos, pos, 0, causal=False,
                           attn_chunk=attn_chunk)[0]
    return h + _ffn_sublayer(h, blk, cfg)


def _encoder_forward(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                     attn_chunk: int = 1024,
                     remat: bool = False) -> torch.Tensor:
    """The encoder over (B, S_enc, d) embeddings: sinusoidal positions,
    bidirectional attention and the MLP a layer, the final norm."""
    x = enc_embeds.to(torch_dtype(cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device)[None, :].expand(
        x.shape[:2])
    x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    for blk in _layers(params["enc_blocks"]):
        x = _maybe_remat(remat, _encoder_layer, x, blk, cfg, pos, attn_chunk)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            remat: bool = False, return_kv: bool = False,
            last_only: bool = False, banded: bool = False,
            attn_chunk: int = 1024):
    """Full causal forward over ``batch`` ("tokens" (B, S) or "embeds"
    (B, S, d); "enc_embeds" (B, S_enc, d) for an encoder-decoder):
    logits (B, S, V).

    ``remat`` recomputes each decoder (and encoder) layer in the backward
    instead of keeping its activations (non-reentrant
    ``torch.utils.checkpoint``, only while autograd records): the same
    loss and gradients, bit for bit, at the memory of one layer's
    activations.  ``return_kv`` also returns each attention layer's K/V
    (after rope) as
    ``(k, v)`` stacks of (L, B, S, KH, hd), ``None`` for an SSM: the
    product of a prefill.  ``last_only`` computes the last position's
    logits only (B, 1, V).  ``banded`` and ``attn_chunk`` are the JAX
    package's ``banded_attention`` and ``attn_chunk`` flags (the settings
    ``dist_flags`` gives prefill and training); under an active context
    its flags set them instead."""
    if current() is not None:
        banded = bool(flag("banded_attention", False))
        attn_chunk = int(flag("attn_chunk", 1024))
    x = embed_inputs(params, cfg, batch)
    bsz, S = x.shape[:2]
    q_pos = torch.arange(S, device=x.device)[None, :].expand(bsz, S)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encoder_forward(params, cfg, batch["enc_embeds"],
                                   attn_chunk, remat)
        x = x + sinusoidal_positions(q_pos, cfg.d_model).to(x.dtype)
    banded = _banded_layers(cfg, banded)
    kvs = []
    for blk, window in zip(_layers(params["blocks"]),
                           _layer_windows(cfg, cfg.n_layers)):
        x, kv = _maybe_remat(remat, _apply_block, x, blk, cfg, q_pos, window,
                             enc_out=enc_out, banded=banded,
                             attn_chunk=attn_chunk)
        if return_kv and kv is not None:
            kvs.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = x @ _head(params, cfg)
    if not return_kv:
        return logits
    if not kvs:
        return logits, None
    return logits, (torch.stack([k for k, _ in kvs]),
                    torch.stack([v for _, v in kvs]))


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict, *,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward`` against
    ``batch["labels"]`` (B, S); labels < 0 do not count, and logits at
    and past ``cfg.real_vocab`` (padding) are masked to -1e9.  ``remat``
    as in :func:`forward` (on by default, as the JAX package's)."""
    logits = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    if cfg.real_vocab and cfg.real_vocab < cfg.vocab_size:
        pad_mask = torch.arange(cfg.vocab_size,
                                device=logits.device) >= cfg.real_vocab
        logits = logits.masked_fill(pad_mask, -1e9)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None].long())[
        ..., 0]
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# ---------------------------------------------------------------------------
# Decode state and step
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch_size: int, max_len: int, *,
                      device="cuda", abstract: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """The dense (contiguous per-sequence) decode cache, zeroed: ``pos``
    (B,) int32; ``k``/``v`` (L, B, max_len, KH, hd) for attention;
    ``conv`` (L, B, d_conv - 1, conv_dim) and float32 ``ssm``
    (L, B, nh, head_dim, d_state) for an SSM; ``xk``/``xv``
    (L, B, encoder_len, KH, hd) for cross-attention
    (:func:`prep_cross_attention` fills them).  The serving engine uses
    the paged layout instead.  ``abstract`` gives the same tensors on
    the meta device (shapes and dtypes, no memory), as the JAX package's
    ``abstract=True`` gives ``ShapeDtypeStruct``s.

    A pure sliding-window model (``sliding_window > 0`` with no
    local:global ratio) is refused past its window: the JAX package gives
    it a cache of ``min(max_len, window)`` slots, which ``decode_step``
    overwrites in its last slot from position ``window`` on (it writes
    slot ``min(pos, slots - 1)``, not a ring), so its attention would
    lose keys without a word.  Up to the window no slot is overwritten."""
    if cfg.family != "ssm" and cfg.sliding_window > 0 \
            and cfg.local_global_ratio <= 0 and max_len > cfg.sliding_window:
        raise ValueError(
            f"{cfg.name}: a pure sliding-window cache (window "
            f"{cfg.sliding_window}, no local:global ratio) needs a ring "
            "buffer that decode_step does not keep")
    dev = torch.device("meta") if abstract else resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    L = cfg.n_layers

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = {"pos": zeros((batch_size,), torch.int32)}
    if cfg.family != "ssm":
        shape = (L, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        state["k"], state["v"] = zeros(shape, dt), zeros(shape, dt)
    if cfg.ssm is not None:
        s = cfg.ssm
        di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
        state["conv"] = zeros((L, batch_size, s.d_conv - 1,
                               di + 2 * s.n_groups * s.d_state), dt)
        state["ssm"] = zeros((L, batch_size, nh, s.head_dim, s.d_state),
                             torch.float32)
    if cfg.enc_dec:
        shape = (L, batch_size, cfg.encoder_len, cfg.n_kv_heads,
                 cfg.head_dim)
        state["xk"], state["xv"] = zeros(shape, dt), zeros(shape, dt)
    return state


def prep_cross_attention(params: Dict, cfg: ModelConfig,
                         enc_embeds: torch.Tensor, state: Dict) -> Dict:
    """Run the encoder once and cache each layer's cross-attention K/V:
    ``state`` with ``xk``/``xv`` replaced."""
    enc_out = _encoder_forward(params, cfg, enc_embeds,
                               int(flag("attn_chunk", 1024)))
    blocks = params["blocks"]
    xk = torch.einsum("bsd,ldhk->lbshk", enc_out, blocks["xwk"])
    xv = torch.einsum("bsd,ldhk->lbshk", enc_out, blocks["xwv"])
    return dict(state, xk=xk, xv=xv)


def _decode_attn_sublayer(x1, blk, cfg: ModelConfig, k_l, v_l, pos,
                          window: Optional[int], *, prefix: str = "",
                          rope: bool = True, update_cache: bool = True,
                          kv_len=None):
    """x1 (B, d), one token a sequence at ``pos`` (B,): its K/V written
    into slot ``min(pos, slots - 1)`` of the layer's cache ``k_l``/``v_l``
    (B, slots, KH, hd) in place, then attention over the first ``pos + 1``
    slots (or ``kv_len``) -> (B, d).  Under ``flash_decode`` the cache may
    be a :class:`ShardedTensor` (the piece holding the slot is written)
    and attention merges the shards' partials."""
    from repro_torch.distributed.flash_decode import (
        sharded_decode_attention, write_token)
    h = rms_norm(x1, blk[prefix + "attn_norm"], cfg.norm_eps)
    q = torch.einsum("bd,dhk->bhk", h, blk[prefix + "wq"])
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if update_cache:
        k_new = torch.einsum("bd,dhk->bhk", h, blk[prefix + "wk"])
        v_new = torch.einsum("bd,dhk->bhk", h, blk[prefix + "wv"])
        if rope and cfg.rope_theta > 0:
            k_new = apply_rope(k_new[:, None], pos[:, None],
                               cfg.rope_theta)[:, 0]
        slot = torch.clamp_max(pos, k_l.shape[1] - 1).long()
        if isinstance(k_l, ShardedTensor):
            write_token(k_l, slot, k_new)
            write_token(v_l, slot, v_new)
        else:
            rows = torch.arange(x1.shape[0], device=x1.device)
            k_l[rows, slot] = k_new
            v_l[rows, slot] = v_new
    attend = sharded_decode_attention if flag("flash_decode", False) \
        else decode_attention
    out = attend(q, k_l, v_l, pos + 1 if kv_len is None else kv_len,
                 window=window, softcap=cfg.attn_logit_softcap)
    return torch.einsum("bhk,hkd->bd", out, blk[prefix + "wo"])


def shard_decode_state(state: Dict, ctx: DistContext) -> Dict:
    """``state`` with its attention caches (``k``/``v``, and the
    cross-attention ``xk``/``xv``) cut over ``ctx``'s mesh by
    ``decode_state_shardings``: :class:`ShardedTensor`s whose pieces are
    views of the caches where the shard's device is theirs (the sharded
    state shares memory with ``state`` there).  ``pos`` and the SSM
    states stay whole on the first device, where the model computes with
    them."""
    from repro_torch.distributed.sharding import decode_state_shardings
    specs = decode_state_shardings(None, ctx.mesh, ctx.rules, state)
    return {k: place(v, specs[k], ctx.mesh)
            if k in ("k", "v", "xk", "xv") else v for k, v in state.items()}


def _layer_caches(state: Dict, key: str, n: int) -> List:
    """Layer l's view of a whole or sharded ``(L, ...)`` cache."""
    c = state[key]
    if isinstance(c, ShardedTensor):
        return [c.select(l) for l in range(n)]
    return list(c)


def _decode_ssm_sublayer(x1, blk, cfg: ModelConfig, conv_state, ssm_state):
    """One token of the SSM sublayer: x1 (B, d) -> (y (B, d), new conv
    state, new float32 SSM state)."""
    s = cfg.ssm
    bsz = x1.shape[0]
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    h = rms_norm(x1, blk["ssm_norm"], cfg.norm_eps)
    z, xBC, dt = _ssm_split(cfg, h @ blk["in_proj"])
    xBC, conv_state = causal_conv1d_step(xBC, conv_state, blk["conv_w"],
                                         blk["conv_b"])
    xs, B_, C_, dt, A = _ssm_coeffs(cfg, blk, F.silu(xBC), dt)
    xh = xs.reshape(bsz, nh, s.head_dim)
    y, ssm_state = ssd_decode_step(
        xh, dt, A, B_.reshape(bsz, s.n_groups, s.d_state),
        C_.reshape(bsz, s.n_groups, s.d_state), ssm_state)
    y = y + xh * blk["D"].to(y.dtype)[None, :, None]
    y = rms_norm(y.reshape(bsz, di) * F.silu(z), blk["gnorm"], cfg.norm_eps)
    return y @ blk["ssm_out"], conv_state, ssm_state


def decode_step(params: Dict, cfg: ModelConfig, state: Dict,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step of ``tokens`` (B,) at ``state["pos"]``: (logits
    (B, V), the new state).  The caches (``k``, ``v``, ``conv``, ``ssm``)
    are written in place, so the new state shares them with ``state``;
    its ``pos`` is a new tensor, one further.  Under a decode context the
    attention caches may be sharded (:func:`shard_decode_state`)."""
    pos = state["pos"]
    x = params["embed"][tokens]
    if cfg.rope_theta <= 0:
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    L = cfg.n_layers
    caches = {k: _layer_caches(state, k, L)
              for k in ("k", "v", "xk", "xv") if k in state}
    for l, (blk, window) in enumerate(zip(
            _layers(params["blocks"]), _layer_windows(cfg, L))):
        if cfg.family != "ssm":
            a = _decode_attn_sublayer(x, blk, cfg, caches["k"][l],
                                      caches["v"][l], pos, window)
        if cfg.ssm is not None:
            m, conv, ssm = _decode_ssm_sublayer(
                x, blk, cfg, state["conv"][l], state["ssm"][l])
            state["conv"][l] = conv
            state["ssm"][l] = ssm
        if cfg.family == "ssm":
            x = x + m
        elif cfg.hybrid_attn_ssm:
            x = x + 0.5 * (a + m)
        else:
            x = x + a
        if cfg.enc_dec:
            x = x + _decode_attn_sublayer(
                x, blk, cfg, caches["xk"][l], caches["xv"][l], pos, None,
                prefix="x", rope=False, update_cache=False,
                kv_len=torch.full_like(pos, cfg.encoder_len))
        ffn = _ffn_sublayer(x[:, None, :], blk, cfg)
        if ffn is not None:
            x = x + ffn[:, 0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), dict(state, pos=pos + 1)
