"""Model / shape configuration system.

Every assigned architecture is a ``ModelConfig`` produced by a module in
``repro_torch.configs``.  Configs are plain frozen dataclasses so they can be
hashed into jit static arguments and serialized into checkpoints.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # "alltoall": experts sharded over the data axis, token routing via
    #             all-to-all (DeepSpeed-MoE style).  Used when num_experts is
    #             divisible by the data axis (kimi-k2: 384/16).
    # "local":    experts replicated in compute (weights FSDP-stored and
    #             gathered per layer); tokens stay put (grok-1: 8 experts).
    ep_mode: str = "alltoall"
    router_jitter: float = 0.0
    # Virtual expert column-split (DESIGN.md §4): each physical expert's
    # d_ff is split into `expert_split` virtual experts so the expert dim
    # divides the EP axis (grok: 8 experts x 32768 -> 16 x 16384).  SwiGLU
    # decomposes exactly over column blocks, and the router stays over
    # physical experts, so semantics are unchanged.
    expert_split: int = 1
    # Dropless routing (capacity = tokens): required for lossless serving —
    # capacity-factor drops would make outputs depend on batch composition.
    # Training keeps capacity-factor dropping (standard, bounded buffers).
    dropless: bool = False

    @property
    def num_physical_experts(self) -> int:
        return self.num_experts // self.expert_split


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- attention structure ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 -> full attention
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0
    # --- MoE / SSM / hybrid ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_ssm: bool = False    # hymba: parallel attention + SSM heads
    # --- enc-dec (whisper) ---
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500          # stub frontend frames
    # --- frontends ---
    inputs_are_embeddings: bool = False  # vlm/audio stubs feed embeddings
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # when vocab is padded for sharding, the original size (0 = unpadded);
    # loss masks logits >= real_vocab
    real_vocab: int = 0
    # source annotation from the assignment table
    source: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_is_local(self, layer_idx: int) -> bool:
        """gemma3-style interleaving: ratio local layers then 1 global."""
        if self.local_global_ratio <= 0:
            return self.sliding_window > 0
        period = self.local_global_ratio + 1
        return (layer_idx % period) != (period - 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, h = self.d_model, self.head_dim
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":
            per_layer += d * self.q_dim + d * self.kv_dim * 2 + self.q_dim * d
        if self.moe is not None:
            per_layer += d * self.moe.num_experts  # router
            per_layer += self.moe.num_experts * 3 * d * self.d_ff
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            per_layer += d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nh)
            per_layer += di * d  # out proj
            per_layer += self.ssm.d_conv * (di + 2 * self.ssm.n_groups * self.ssm.d_state)
        per_layer += 2 * d  # norms
        total = embed + self.n_layers * per_layer
        if self.enc_dec:
            enc_per_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
            dec_cross = 4 * d * d + d
            total += self.n_encoder_layers * enc_per_layer + self.n_layers * dec_cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.moe.num_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.moe.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active


# ---------------------------------------------------------------------------
# Input-shape configuration (the assigned shape grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# Archs allowed to run long_500k (sub-quadratic attention only; see DESIGN.md)
LONG_CONTEXT_ARCHS = ("mamba2-780m", "hymba-1.5b", "gemma3-12b")

ARCH_IDS = (
    "kimi-k2-1t-a32b",
    "grok-1-314b",
    "chatglm3-6b",
    "minitron-8b",
    "granite-3-8b",
    "gemma3-12b",
    "mamba2-780m",
    "llava-next-34b",
    "hymba-1.5b",
    "whisper-large-v3",
)

_MODULE_BY_ARCH = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
# extra (paper's own) configs
_MODULE_BY_ARCH["llama31-8b"] = "llama31_8b"
_MODULE_BY_ARCH["llama31-70b"] = "llama31_70b"


def get_config(arch: str) -> ModelConfig:
    """Load the full-size assigned config for ``arch``."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_BY_ARCH[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Load the reduced same-family config used by CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_BY_ARCH[arch]}")
    return mod.SMOKE_CONFIG


def cell_is_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is in the dry-run grid; reason if not."""
    cfg = get_config(arch)
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    if SHAPE_BY_NAME[shape].kind == "decode" and cfg.family == "ssm":
        return True, ""
    return True, ""


def runnable_cells():
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = cell_is_runnable(a, s.name)
            if ok:
                out.append((a, s.name))
    return out


def scaled_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
