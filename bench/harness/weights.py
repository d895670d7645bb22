"""The model a cell serves: the port's ``ModelConfig`` built from the
configuration file's ``model`` block, and random weights made from the
run's seed in the port's parameter layout.

The weights are drawn on the device by one ``torch.Generator`` in one
call, in the type they are served in, into one flat buffer that every
parameter is a view of; each parameter is then scaled by its own factor
(the configuration file's ``assumed.weights`` states them): q, k and v
projections and the router at fan-in, so attention scores have a
standard deviation near 1 (at 1/sqrt(H) a head's softmax is one-hot and
flips with the last bit), residual outputs depth-scaled, norm weights 0
(the port's norm scales by 1 + w)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig


def model_config(cfg_file: Dict) -> ModelConfig:
    m = dict(cfg_file["model"])
    if "moe" in m:
        m["moe"] = MoEConfig(**m["moe"])
    return ModelConfig(**m)


def leaves(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, scale) of every parameter; scale 0 = zeros."""
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


def make_params(cfg: ModelConfig, seed: int, device) -> Dict:
    """The parameters, nested as the port's engine reads them."""
    dt = getattr(torch, cfg.dtype)
    spec = leaves(cfg)
    drawn = [(p, s, c) for p, s, c in spec if c != 0.0]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.empty((total,), dtype=dt, device=device)
    buf.normal_(generator=gen)
    params: Dict = {"blocks": {}}
    off = 0
    for path, shape, scale in spec:
        if scale == 0.0:
            t = torch.zeros(shape, dtype=dt, device=device)
        else:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape).mul_(scale)
            off += n
        if path.startswith("blocks."):
            params["blocks"][path[len("blocks."):]] = t
        else:
            params[path] = t
    return params


def param_bytes(params: Dict) -> int:
    ts = list(params["blocks"].values()) + [
        t for k, t in params.items() if k != "blocks"]
    return sum(t.numel() * t.element_size() for t in ts)
