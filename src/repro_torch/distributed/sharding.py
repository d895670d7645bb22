"""Per-architecture sharding policies (the counterpart of
``repro.distributed.sharding``): the shape-changing hardware adaptation
(``effective_config``), the logical-axis rules of a mesh
(``sharding_rules``), the flags model code reads (``dist_flags``), the
context built from both (``make_context``), and the mesh axes of every
parameter, optimizer-state, batch and decode-state leaf.

A sharding is given per leaf as a tuple of mesh axes per dim: the entries
of the JAX package's ``PartitionSpec`` (``None``, an axis name or a tuple
of names).  :func:`shard_params` cuts the port's parameters into one dict
per shard of the sharded serving engine's ``(data=1, model=n)`` mesh;
the sharded model paths (``flash_decode``, ``moe_ep``) cut what they
need from the same specs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import DistContext, Mesh, ShardGroup

# ---------------------------------------------------------------------------
# Shape-changing hardware adaptation
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def effective_config(cfg: ModelConfig, tp: int = 16,
                     ep: int = 16) -> ModelConfig:
    """``cfg`` adapted to a ``tp``-way model axis and an ``ep``-way expert
    axis: the vocab padded to a multiple of ``16 tp`` (``real_vocab``
    keeps the true size for the loss mask), the q heads padded to ``tp``
    where they do not divide and the attention weights are too large to
    replicate (> ~2 GB in bf16), and the experts column-split into
    ``ep / E`` virtual experts where E does not divide ``ep`` (an exact
    SwiGLU decomposition)."""
    changes: Dict[str, Any] = {}
    if cfg.vocab_size % (tp * 16):
        changes["vocab_size"] = _round_up(cfg.vocab_size, tp * 16)
        changes["real_vocab"] = cfg.vocab_size
    if cfg.n_heads and cfg.n_heads % tp:
        attn_bytes = (2 * cfg.d_model * cfg.n_heads * cfg.head_dim
                      * cfg.n_layers * 2)
        if attn_bytes > 2e9:
            changes["n_heads"] = _round_up(cfg.n_heads, tp)
    if cfg.moe is not None and cfg.moe.num_experts % ep:
        if ep % cfg.moe.num_experts == 0:
            split = ep // cfg.moe.num_experts
            changes["moe"] = dataclasses.replace(
                cfg.moe, num_experts=cfg.moe.num_experts * split,
                expert_split=cfg.moe.expert_split * split)
            changes["d_ff"] = cfg.d_ff // split
    if changes:
        return dataclasses.replace(cfg, **changes)
    return cfg


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

#: logical axes that shard parameters (as opposed to activations and
#: decode state); decode and prefill rules must agree on all of them for
#: one sharded parameter set to serve the engine's mixed step
WEIGHT_AXES = ("heads", "kv_heads", "ffn", "vocab", "experts",
               "expert_ffn", "expert_fsdp", "fsdp", "ssm_inner",
               "ssm_heads")


def _mesh(mesh: Union[Mesh, int]) -> Mesh:
    """A mesh, or ``n`` for the serving engine's ``(data=1, model=n)``
    mesh (shapes only)."""
    if isinstance(mesh, int):
        return Mesh((1, mesh), ("data", "model"))
    return mesh


def sharding_rules(cfg: ModelConfig, mesh: Union[Mesh, int], kind: str,
                   batch_size: int = 0) -> Dict[str, Any]:
    """Logical axis -> mesh axes (or None) for the arch family and the
    execution kind ("train", "prefill", "decode") on ``mesh`` (with or
    without a ``pod`` axis; an int n is the ``(1, n)`` serving mesh).  A
    ``batch_size`` that does not divide over the batch axes replicates
    the batch and gives those axes to the decode cache's sequence dim."""
    shape = _mesh(mesh).shape
    tp = shape["model"]
    dp = shape["data"]
    has_pod = "pod" in shape
    batch_axes: Any = ("pod", "data") if has_pod else "data"
    dp_total = dp * (shape["pod"] if has_pod else 1)
    if batch_size and batch_size % dp_total:
        batch_axes = None

    def div(n: int) -> bool:
        return n % tp == 0

    rules: Dict[str, Any] = {
        "batch": batch_axes,
        "heads": "model" if div(cfg.n_heads or tp) else None,
        "kv_heads": "model" if div(cfg.n_kv_heads or tp) else None,
        "ffn": "model" if div(cfg.d_ff or tp) else None,
        "vocab": "model" if div(cfg.vocab_size) else None,
        "ssm_inner": None,
        "ssm_heads": None,
        "experts": None,
        "expert_fsdp": None,
        "expert_ffn": None,
        "fsdp": None,
        "kv_seq": None,
        "seq_sp": "model",
    }
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(cfg.d_model)
        in_proj_cols = (2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
                        + cfg.ssm.n_heads(cfg.d_model))
        rules["ssm_inner"] = "model" if (div(di) and div(in_proj_cols)) \
            else None
        rules["ssm_heads"] = "model" if div(cfg.ssm.n_heads(cfg.d_model)) \
            else None
    if cfg.moe is not None:
        # experts over (pod, data), expert FFN over model
        ep_axes = ("pod", "data") if has_pod else "data"
        rules["experts"] = ep_axes if cfg.moe.num_experts % dp_total == 0 \
            else "data"
        rules["expert_ffn"] = "model" if div(cfg.d_ff) else None
    if kind == "decode":
        # sequence-sharded KV and cross-shard flash decoding
        if batch_axes is None:
            rules["kv_seq"] = ("pod", "data", "model") if has_pod \
                else ("data", "model")
        else:
            rules["kv_seq"] = "model"
    return rules


def dist_flags(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """The flags model code reads under a context of this kind.  Of
    them, ``ar_barrier`` and ``seq_parallel`` (set by the environment
    variables ``REPRO_AR_BARRIER`` / ``REPRO_SEQ_PARALLEL`` = 1) only
    steer XLA in the JAX package; the port accepts and ignores them."""
    flags: Dict[str, Any] = {}
    if cfg.moe is not None:
        flags["moe_alltoall"] = True
    if kind == "decode" and cfg.family != "ssm":
        flags["flash_decode"] = True
    if kind == "prefill":
        flags["attn_chunk"] = 512
    if kind in ("train", "prefill"):
        flags["banded_attention"] = True
        if os.environ.get("REPRO_AR_BARRIER", "0") == "1":
            flags["ar_barrier"] = True
        if os.environ.get("REPRO_SEQ_PARALLEL", "0") == "1":
            flags["seq_parallel"] = True
    return flags


def make_context(cfg: ModelConfig, mesh: Mesh, kind: str,
                 batch_size: int = 0) -> DistContext:
    return DistContext(mesh=mesh,
                       rules=sharding_rules(cfg, mesh, kind, batch_size),
                       flags=dist_flags(cfg, kind))


# ---------------------------------------------------------------------------
# Shardings: each leaf's mesh axes per dim
# ---------------------------------------------------------------------------


def param_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of every parameter of any family, in the parameters'
    nesting (``repro.models.model.param_axes``), from the same table
    ``init_params`` draws from."""
    # imported here: the model imports this package for its sharded paths
    from repro_torch.models.model import param_defs

    def axes(defs):
        return {k: axes(v) if isinstance(v, dict) else v[2]
                for k, v in defs.items()}
    return axes(param_defs(cfg))


def _resolve(axes: Tuple, rules: Dict) -> Tuple:
    return tuple(rules.get(a) if a is not None else None for a in axes)


def _resolve_tree(tree: Dict, rules: Dict) -> Dict:
    return {k: _resolve_tree(v, rules) if isinstance(v, dict)
            else _resolve(v, rules) for k, v in tree.items()}


def param_shardings(cfg: ModelConfig, mesh: Mesh, rules: Dict) -> Dict:
    """Each parameter's mesh axes per dim."""
    return _resolve_tree(param_axes(cfg), rules)


def opt_shardings(opt_name: str, cfg: ModelConfig, mesh: Mesh,
                  rules: Dict) -> Dict:
    """Optimizer-state shardings mirror the parameter axes: AdamW's m/v
    share the parameter's; Adafactor's vr drops the last axis, vc the
    second-to-last."""
    tree = param_axes(cfg)
    if opt_name == "adamw":
        one = _resolve_tree(tree, rules)
        return {"m": one, "v": one}
    if opt_name == "adafactor":
        def per_leaf(t):
            if isinstance(t, dict):
                return {k: per_leaf(v) for k, v in t.items()}
            if len(t) >= 2:
                return {"vr": _resolve(t[:-1], rules),
                        "vc": _resolve(t[:-2] + t[-1:], rules)}
            return {"v": _resolve(t, rules)}
        return per_leaf(tree)
    raise ValueError(opt_name)


def batch_shardings(cfg: ModelConfig, mesh: Mesh, rules: Dict,
                    batch: Dict) -> Dict:
    """Every batch leaf split on its leading dim over the batch axes."""
    b = rules.get("batch")
    return {k: (b,) + (None,) * (len(v.shape) - 1)
            for k, v in batch.items()}


def decode_state_shardings(cfg: ModelConfig, mesh: Mesh, rules: Dict,
                           state: Dict) -> Dict:
    """The decode cache's leaves: ``k``/``v`` (L, B, S, KH, D) over the
    batch axes and the ``kv_seq`` axes; the cross-attention ``xk``/``xv``
    (whole encoder length), ``conv``, ``ssm`` and ``pos`` over the batch
    axes only; anything else replicated."""
    b = rules.get("batch")
    seq = rules.get("kv_seq")
    out = {}
    for k, v in state.items():
        if k in ("k", "v"):
            out[k] = (None, b, seq, None, None)
        elif k in ("xk", "xv", "ssm"):
            out[k] = (None, b, None, None, None)
        elif k == "conv":
            out[k] = (None, b, None, None)
        elif k == "pos":
            out[k] = (b,)
        else:
            out[k] = (None,) * len(v.shape)
    return out


def serving_param_shardings(cfg: ModelConfig, n: int
                            ) -> Tuple[Dict[str, Any], Dict]:
    """(rules, each parameter's mesh axes per dim) for the sharded serving
    engine on the ``(1, n)`` mesh.  The engine runs prefill chunks and
    decode rows in one mixed step, so its weights must satisfy both
    kinds' rules at once; the rules differ only in batch and kv_seq
    placement, which is checked here per weight axis rather than
    assumed."""
    rd = sharding_rules(cfg, n, "decode")
    rp = sharding_rules(cfg, n, "prefill")
    for a in WEIGHT_AXES:
        if rd.get(a) != rp.get(a):
            raise ValueError(f"decode/prefill weight rules diverge on "
                             f"{a!r}: {rd.get(a)!r} vs {rp.get(a)!r}")
    return rd, param_shardings(cfg, _mesh(n), rd)


def shard_params(params: Dict, cfg: ModelConfig,
                 group: ShardGroup) -> List[Dict]:
    """The port's parameters as one dict per shard of the serving
    engine's group, each on its shard's device: a tensor whose axes put a
    dim on ``"model"`` (heads, kv_heads, ffn, expert_ffn, vocab, where
    they divide by N) is cut along it into N contiguous pieces, shard i
    taking piece i; every other tensor is replicated (a tensor already on
    the shard's device is shared, not copied).  Concatenating the pieces
    in shard order gives the tensor back bit for bit."""
    _, specs = serving_param_shardings(cfg, group.n)

    def split(tree: Dict, spec: Dict) -> List[Dict]:
        out: List[Dict] = [{} for _ in range(group.n)]
        for name, value in tree.items():
            if isinstance(value, dict):
                parts = split(value, spec[name])
            else:
                axes = spec[name]
                if len(axes) != value.dim():
                    raise ValueError(f"{name}: {value.dim()} dims, axes "
                                     f"{axes}")
                dims = [k for k, a in enumerate(axes) if a == "model"]
                if dims:
                    parts = [p.contiguous() for p in
                             torch.chunk(value, group.n, dim=dims[0])]
                else:
                    parts = [value] * group.n
            for i, dev in enumerate(group.devices):
                out[i][name] = parts[i].to(dev) if not isinstance(
                    parts[i], dict) else parts[i]
        return out

    return split(params, specs)
