"""The weight split of sharded serving: the logical-axis rules of the JAX
package (``repro.distributed.sharding.sharding_rules``, ``WEIGHT_AXES``,
``serving_param_shardings``), the parameters' logical axes
(``repro.models.model.param_axes``), and
:func:`shard_params`, which cuts the port's parameters into one dict per
shard.

The serving group is the reference's ``(data=1, model=N)`` mesh, so the
rules take ``n`` (the ``model`` size) where the reference takes a mesh,
and an axis mapped to ``"data"`` (size 1) is not split.  The weights come
in as the port's parameters: ``init_params``, or the JAX package's through
``repro_torch.bridge.params_from_numpy``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import ShardGroup
from repro_torch.models.model import param_defs

#: logical axes that shard parameters (as opposed to activations and
#: decode state); decode and prefill rules must agree on all of them for
#: one sharded parameter set to serve the engine's mixed step
WEIGHT_AXES = ("heads", "kv_heads", "ffn", "vocab", "experts",
               "expert_ffn", "expert_fsdp", "fsdp", "ssm_inner",
               "ssm_heads")


def sharding_rules(cfg: ModelConfig, n: int, kind: str,
                   batch_size: int = 0) -> Dict[str, Any]:
    """Logical axis -> mesh axis (or None) for the arch family and the
    execution kind, on the ``(data=1, model=n)`` serving mesh."""
    tp, dp = n, 1
    batch_axes: Any = "data"
    if batch_size and batch_size % dp:
        batch_axes = None

    def div(k: int) -> bool:
        return k % tp == 0

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
        # experts over data (size 1 here), expert FFN over model
        rules["experts"] = "data"
        rules["expert_ffn"] = "model" if div(cfg.d_ff) else None
    if kind == "decode":
        rules["kv_seq"] = ("data", "model") if batch_axes is None \
            else "model"
    return rules


def param_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of every parameter of any family, in the parameters'
    nesting (``repro.models.model.param_axes``), from the same table
    ``init_params`` draws from."""
    def axes(defs):
        return {k: axes(v) if isinstance(v, dict) else v[2]
                for k, v in defs.items()}
    return axes(param_defs(cfg))


def _resolve(tree: Dict, rules: Dict) -> Dict:
    return {k: _resolve(v, rules) if isinstance(v, dict)
            else tuple(rules.get(a) if a is not None else None for a in v)
            for k, v in tree.items()}


def serving_param_shardings(cfg: ModelConfig, n: int
                            ) -> Tuple[Dict[str, Any], Dict]:
    """(rules, each parameter's mesh axes per dim) for the sharded serving
    engine.  The engine runs prefill chunks and decode rows in one mixed
    step, so its weights must satisfy both kinds' rules at once; the
    rules differ only in batch and kv_seq placement, which is checked
    here per weight axis rather than assumed."""
    rd = sharding_rules(cfg, n, "decode")
    rp = sharding_rules(cfg, n, "prefill")
    for a in WEIGHT_AXES:
        if rd.get(a) != rp.get(a):
            raise ValueError(f"decode/prefill weight rules diverge on "
                             f"{a!r}: {rd.get(a)!r} vs {rp.get(a)!r}")
    return rd, _resolve(param_axes(cfg), rd)


def shard_params(params: Dict, cfg: ModelConfig,
                 group: ShardGroup) -> List[Dict]:
    """The port's parameters as one dict per shard, each on its shard's
    device: a tensor whose axes put a dim on ``"model"`` (heads, kv_heads,
    ffn, expert_ffn, vocab, where they divide by N) is cut along it into N
    contiguous pieces, shard i taking piece i; every other tensor is
    replicated (a tensor already on the shard's device is shared, not
    copied).  Concatenating the pieces in shard order gives the tensor
    back bit for bit."""
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
