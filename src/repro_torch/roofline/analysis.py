"""Three-term roofline model (the counterpart of
``repro.roofline.analysis``), for a card given as a
:class:`~repro_torch.core.cost_model.Hardware`, by default the port's
card, :data:`~repro_torch.core.cost_model.H100`.

Per (arch x shape x mesh) cell of the dry run
(``repro_torch.launch.dryrun``), from its per-device counts:

    compute    = per_device_FLOPs / hardware.flops
    memory     = per_device_bytes_accessed / hardware.hbm_bw
    collective = per_device_wire_bytes / hardware.ici_bw

plus MODEL_FLOPS (6·N·D train / 2·N·D forward, N_active for MoE) and the
useful-compute ratio MODEL_FLOPS / (per-device FLOPs x chips).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cost_model import H100, Hardware


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    bottleneck: str
    details: Dict = field(default_factory=dict)
    hardware: Hardware = H100

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """How close the cell is to the pure-compute roofline: the ideal
        step time (useful FLOPs at the card's peak) over the modeled bound
        time."""
        ideal = self.model_flops / (self.hardware.flops
                                    * self.details.get("chips", 1))
        return ideal / max(self.bound_s, 1e-30)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D for train, 2·N·D for prefill, 2·N·B per decode step; MoE uses
    active params.  Attention context FLOPs added explicitly (they are not
    in N·D)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        base = 6.0 * n * tokens
        attn = 6.0 * 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
            shape.global_batch * shape.seq_len ** 2 / 2 if cfg.n_heads else 0
        return base + attn
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        base = 2.0 * n * tokens
        attn = 2.0 * 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
            shape.global_batch * shape.seq_len ** 2 / 2 if cfg.n_heads else 0
        return base + attn
    # decode: one token per sequence over a seq_len context
    base = 2.0 * n * shape.global_batch
    attn = 2.0 * 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
        shape.global_batch * shape.seq_len if cfg.n_heads else 0
    return base + attn


def roofline(cfg: ModelConfig, shape: ShapeConfig, chips: int,
             per_device_flops: float, per_device_bytes: float,
             per_device_wire_bytes: float,
             collectives: Optional[Dict] = None,
             hardware: Hardware = H100) -> RooflineTerms:
    compute_s = per_device_flops / hardware.flops
    memory_s = per_device_bytes / hardware.hbm_bw
    collective_s = per_device_wire_bytes / hardware.ici_bw
    mf = model_flops(cfg, shape)
    hlo_global = per_device_flops * chips
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=mf / max(hlo_global, 1e-30), bottleneck=bottleneck,
        details={"chips": chips, "collectives": collectives or {},
                 "hardware": hardware.name},
        hardware=hardware)
