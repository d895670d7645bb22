"""Training step (counterpart of ``repro.training.train_step``): the
loss's gradients by autograd over the remat'd forward, gradient
accumulation over microbatches, the optimizer's in-place update.

Gradient accumulation bounds activation memory: the global batch splits
into ``grad_accum`` microbatches run one after another, each through
``loss_fn(..., remat=True)`` (each layer recomputed in the backward).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.training.optimizer import Optimizer, leaves


def _microbatch(batch: Dict, n: int, i: int) -> Dict:
    """Microbatch ``i`` of ``n``: rows ``i * B/n`` to ``(i + 1) * B/n``
    of every input (the JAX package's reshape to ``(n, B/n, ...)``)."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split into {n} "
                             "microbatches")
        out[k] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def _unflatten_like(tree: Dict, flat: Dict, prefix: str = "") -> Dict:
    """``flat`` ({path: leaf}) in ``tree``'s nesting."""
    return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
            if isinstance(v, dict) else flat[prefix + k]
            for k, v in tree.items()}


def value_and_grad(params: Dict, cfg: ModelConfig, batch: Dict, *,
                   remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """``loss_fn(params, cfg, batch, remat=remat)`` (detached) and its
    gradients as {path: tensor} (the paths of ``optimizer.leaves``; a
    leaf the loss does not use gets zeros, as ``jax.grad`` gives it).
    The parameters are left without ``requires_grad``."""
    inputs = {name: p.detach().requires_grad_()
              for name, p in leaves(params)}
    loss = loss_fn(_unflatten_like(params, inputs), cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(inputs.values()),
                                materialize_grads=True)
    return loss.detach(), dict(zip(inputs, grads))


def make_train_step(cfg: ModelConfig, opt: Optimizer, grad_accum: int = 1,
                    accum_dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``; ``params`` and ``opt_state`` are updated in
    place (and returned), ``metrics`` holds the float32 ``loss`` (the mean
    over microbatches) and ``grad_norm`` (the square root of the sum of
    squares over every gradient leaf) as 0-dim tensors on the device, and
    ``step`` + 1.

    ``accum_dtype``: the accumulator's dtype with ``grad_accum > 1``:
    float32, or bf16 from 100B parameters (there a float32 accumulator
    alone is twice the parameters' bytes), as the JAX package chooses.
    Each microbatch's gradients are added to it, then scaled by
    ``1 / grad_accum``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be at least 1")
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16 if cfg.param_count() >= 100e9
                       else torch.float32)

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, cfg, batch)
        acc = {name: torch.zeros(p.shape, dtype=accum_dtype,
                                 device=p.device)
               for name, p in leaves(params)}
        loss_sum = None
        for i in range(grad_accum):
            loss, grads = value_and_grad(
                params, cfg, _microbatch(batch, grad_accum, i))
            for name, g in grads.items():
                acc[name].add_(g.to(accum_dtype))
            del grads
            loss_sum = loss if loss_sum is None else loss_sum + loss
        scale = 1.0 / grad_accum
        for a in acc.values():
            a.mul_(scale)
        return loss_sum * scale, acc

    def train_step(params, opt_state, batch, step: int):
        loss, flat = compute_grads(params, batch)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(flat[name].float()))
                               for name, _ in leaves(params)))
        grads = _unflatten_like(params, flat)
        del flat
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": step + 1}

    return train_step
