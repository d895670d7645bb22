"""What the model-running examples share: the float32 smoke Llama they
serve, the multi-turn server of ``quickstart`` and ``serve_multiturn
--real``, the device check of their command lines, and the losslessness
measure against the dense reference."""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.serving import (
    AsymCacheServer,
    SchedulerConfig,
    ServerConfig,
    reference_logits,
)

LOSSLESS_REL_TOL = 2e-3       # the repo-wide losslessness bar


def smoke_model(cfg: Optional[ModelConfig], params: Optional[Dict],
                device) -> Tuple[ModelConfig, Dict, torch.device]:
    """``(cfg, params, device)``: the float32 smoke Llama-3.1-8B and its
    weights from seed 0 on ``device`` where the caller passes none (a
    caller's ``params`` must already lie on ``device``).  A CUDA device
    with no card raises here."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    return cfg, params, dev


def multi_turn_server(cfg: ModelConfig, params: Dict, device,
                      num_blocks: int, clock: str) -> AsymCacheServer:
    """The AsymCache server of ``quickstart`` and ``serve_multiturn
    --real`` over a ``num_blocks``-block pool of 16-token blocks."""
    return AsymCacheServer(cfg, params, ServerConfig(
        policy="asymcache", num_blocks=num_blocks, block_size=16,
        clock=clock,
        scheduler=SchedulerConfig(token_budget=128, max_chunk=64,
                                  max_prefills=2, max_decodes=8)),
        device=device)


def device_ok(device: str, prog: str) -> bool:
    """A command line's ``--device`` check: False, with the reason on
    stderr, when it names no device the port can run on."""
    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return False
    return True


def logit_errors(cfg: ModelConfig, params: Dict, requests: List
                 ) -> Tuple[float, float]:
    """(worst relative, worst absolute) error of the requests'
    ``first_logits`` against the dense, non-paged forward
    (``reference_logits``); relative to max |ref|."""
    worst_rel = worst_abs = 0.0
    for r in requests:
        ref = reference_logits(cfg, params, r.prompt_tokens)
        err = float(np.max(np.abs(ref - r.first_logits)))
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel,
                        err / max(1e-9, float(np.max(np.abs(ref)))))
    return worst_rel, worst_abs
