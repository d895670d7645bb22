"""Recomputation cost model (paper §4.3, Eq. 4-7).

The approximated latency model (Eq. 6) for a two-segment context:

    T(l1,q1,l2,q2) = k1·l1 + k2·q1 + k3·l2 + k4·q2
                   + k5·(l1+q1)² + k6·q2·(l1+q1+l2+q2) + β

whose marginal block cost (Eq. 7) depends only on the block's immutable
positional index:

    ΔT_B = 2·k5·(l1+q1) + (k2 − k3 + k5)

We generalize slightly for sliding-window layers (gemma3/hymba): those
layers' attention cost saturates at the window, so

    ΔT(pos) = quad_coeff·min(pos, eff_window) + lin_coeff        [per token]

with eff_window = ∞ for full-attention stacks.  ``pos`` is measured in
tokens (block_pos · block_size).

Constants come from either (a) least-squares fitting of profiled instances
(paper: 1.1K profiles, R² > 0.999) or (b) analytic FLOP-derived estimates
for a given chip (used by the paper-scale discrete-event simulator).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class CostModel:
    """The paper's recomputation latency model (§4.3): Eq. 6's fitted
    constants k1..k6 + β, with :meth:`latency` evaluating Eq. 6 itself,
    :meth:`block_cost` its Eq.-7 marginal block cost ΔT_B (the
    time-invariant, position-only quantity the evictor ranks on — via
    :meth:`log_block_cost`, since the evictor works in log space), and
    Eq. 4's exact per-token form used by the discrete-event clock
    (``AsymCacheServer._step_latency``).  ``eff_window`` caps the
    quadratic term for sliding-window stacks (our generalization beyond
    the paper)."""
    k: Tuple[float, float, float, float, float, float]  # k1..k6
    beta: float
    eff_window: float = math.inf  # token window capping the quadratic term
    r2: float = 1.0

    # -- Eq. 6 ---------------------------------------------------------------
    def latency(self, l1: float, q1: float, l2: float, q2: float) -> float:
        k1, k2, k3, k4, k5, k6 = self.k
        return (k1 * l1 + k2 * q1 + k3 * l2 + k4 * q2
                + k5 * min(l1 + q1, self.eff_window) * (l1 + q1)
                + k6 * q2 * (l1 + q1 + l2 + q2) + self.beta)

    # -- Eq. 7: marginal recompute cost of a block at token position `pos` ---
    def block_cost(self, pos_tokens: int, block_size: int) -> float:
        k1, k2, k3, k4, k5, k6 = self.k
        capped = min(pos_tokens, self.eff_window)
        per_tok = 2.0 * k5 * capped + (k2 - k3 + k5)
        return max(per_tok, 1e-12) * block_size

    def log_block_cost(self, pos_tokens: int, block_size: int) -> float:
        return math.log(self.block_cost(pos_tokens, block_size))

    # -- §4 swap-vs-recompute, extended with per-half byte costs -------------
    def swap_latency(self, nbytes: float, bw: float) -> float:
        """Host<->device transfer time of an ``nbytes`` payload over a
        ``bw`` bytes/sec link (PCIe in the paper's §7 hierarchy)."""
        return nbytes / max(bw, 1e-12)

    def half_offload_gain(self, pos_tokens: int, block_size: int,
                          half_bytes: float, bw: float) -> float:
        """Per-half extension of the §4 swap-vs-recompute decision:
        value of keeping ONE half (K or V) of a block at position
        ``pos_tokens`` host-resident.  Restoring the half over the link
        costs ``swap_latency``; not having it means recomputing the
        block, whose Eq. 7 cost splits evenly across the two halves.
        Positive gain => hosting the half beats recomputing it, so the
        over-budget drop policy keeps the K half of deep-position
        blocks (whose recompute cost grows with position) and sheds
        shallow ones entirely."""
        return self.block_cost(pos_tokens, block_size) / 2.0 \
            - self.swap_latency(half_bytes, bw)

    def restore_cost(self, pos_tokens: int, block_size: int,
                     resident_bytes: float, bw: float) -> float:
        """Cost of bringing a host-complete block back to the device:
        the cheaper of recomputing it (Eq. 7) and swapping its resident
        payload back in.  Used by the opt-in ``swap_aware_eviction``
        weighting so the device evictor prefers victims whose restore
        is cheap *either* way."""
        return min(self.block_cost(pos_tokens, block_size),
                   self.swap_latency(resident_bytes, bw))

    # -- simple chunk-latency helper for the scheduler/simulator -------------
    def chunk_latency(self, new_tokens: int, context_tokens: int) -> float:
        """Latency of prefilling ``new_tokens`` on top of ``context_tokens``."""
        return self.latency(context_tokens, new_tokens, 0, 0)

    def decode_latency(self, batch: int, avg_context: float) -> float:
        k1, k2, k3, k4, k5, k6 = self.k
        return self.beta + batch * (k2 + k6 * avg_context)


# ---------------------------------------------------------------------------
# Fitting (Eq. 6 least squares)
# ---------------------------------------------------------------------------

def design_row(l1: float, q1: float, l2: float, q2: float,
               eff_window: float = math.inf) -> np.ndarray:
    return np.array([
        l1, q1, l2, q2,
        min(l1 + q1, eff_window) * (l1 + q1),
        q2 * (l1 + q1 + l2 + q2),
        1.0,
    ])


def fit(instances: Sequence[Tuple[float, float, float, float]],
        latencies: Sequence[float],
        eff_window: float = math.inf) -> CostModel:
    """Least-squares fit of Eq. 6's k1..k6 + β from profiled two-segment
    instances (paper §4.3: R² > 0.999 over 1.1K profiles).
    ``instances``: rows of (l1, q1, l2, q2); ``latencies``: seconds."""
    X = np.stack([design_row(*row, eff_window) for row in instances])
    y = np.asarray(latencies, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ coef
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-30)
    return CostModel(k=tuple(coef[:6]), beta=float(coef[6]),
                     eff_window=eff_window, r2=r2)


# ---------------------------------------------------------------------------
# Analytic constants (FLOP-derived, for the paper-scale simulator)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Hardware:
    """Chip constants feeding the analytic Eq.-6 instantiation (§4.3's
    alternative to least-squares fitting — the paper profiles 1.1K
    instances on H20; the simulator derives the same k's from FLOP/byte
    counts instead)."""
    name: str = "tpu-v5e"
    flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9          # bytes/s
    ici_bw: float = 50e9           # bytes/s per link
    mfu: float = 0.5               # achieved fraction for prefill GEMMs
    kernel_launch: float = 30e-6   # fixed per-step overhead (s)


TPU_V5E = Hardware()
# the paper's H20 (~148 TFLOP/s bf16, 4.0 TB/s HBM)
H20 = Hardware(name="h20", flops=148e12, hbm_bw=4.0e12, mfu=0.5)


def analytic_cost_model(cfg: ModelConfig, hw: Hardware = TPU_V5E,
                        n_chips: int = 1) -> CostModel:
    """Derive Eq.-6 constants from model FLOPs.

    Per new token: linear part 2·N_active FLOPs (GEMMs); quadratic part
    2·2·L·H·hd per context token (QK^T and PV).  Memory-bound decode is
    captured by k6 via the KV-cache read bandwidth term.
    """
    n_active = cfg.active_param_count()
    gemm_flops_per_tok = 2.0 * n_active
    eff = hw.flops * hw.mfu * n_chips

    n_attn_layers = cfg.n_layers if cfg.family != "ssm" else 0
    attn_flops_per_ctx_tok = 4.0 * n_attn_layers * cfg.n_heads * cfg.head_dim

    kv_bytes_per_tok = 2 * 2 * n_attn_layers * cfg.n_kv_heads * cfg.head_dim

    k2 = gemm_flops_per_tok / eff                  # per new token (GEMM)
    k5 = attn_flops_per_ctx_tok / eff              # per (new × context) pair
    # reading one context token's KV during attention (bandwidth bound)
    k6 = max(attn_flops_per_ctx_tok / eff,
             kv_bytes_per_tok / (hw.hbm_bw * n_chips))
    k1 = 0.2 * k6       # cached-context overhead: KV reads during new-token attn
    k3 = k1
    k4 = k2
    eff_window = float(cfg.sliding_window) if (
        cfg.sliding_window > 0 and cfg.local_global_ratio <= 0) else math.inf
    return CostModel(k=(k1, k2, k3, k4, k5, k6), beta=hw.kernel_launch,
                     eff_window=eff_window)


def mixed_window_cost_model(cfg: ModelConfig, hw: Hardware = TPU_V5E,
                            n_chips: int = 1) -> CostModel:
    """gemma3/hymba: blend local (windowed) and global layers into one
    effective quadratic coefficient; eff_window stays ∞ but k5 reflects
    only global layers beyond the window (documented approximation)."""
    base = analytic_cost_model(cfg, hw, n_chips)
    if cfg.local_global_ratio <= 0 or cfg.sliding_window <= 0:
        return base
    period = cfg.local_global_ratio + 1
    global_frac = 1.0 / period
    k = list(base.k)
    k[4] = k[4] * global_frac   # only global layers grow quadratically
    return CostModel(k=tuple(k), beta=base.beta, eff_window=math.inf)
