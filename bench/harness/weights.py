"""The model a cell serves: the port's ``ModelConfig`` built from the
configuration file's ``model`` block, and random weights made from the
run's seed in the parameter layout that the configuration's module
(``bench/reference``) lists.

The weights are drawn on the device by one ``torch.Generator`` in one
call, in the type they are served in, into one flat buffer that every
parameter is a view of, in the order the layout lists them; each
parameter is then scaled by its own factor (``leaves`` in
``bench/reference/model.py`` says why each)."""
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


def make_params(cfg: ModelConfig, seed: int, device,
                spec: List[Tuple[str, Tuple[int, ...], float]]) -> Dict:
    """The parameters of the layout ``spec`` (``leaves(cfg)`` of the
    configuration's module: path, shape, scale; scale 0 = zeros), nested
    as the port's engine reads them."""
    dt = getattr(torch, cfg.dtype)
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
