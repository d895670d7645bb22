"""Optimizers (counterpart of ``repro.training.optimizer``): AdamW with
float32 moments and Adafactor with a factored second moment, over the
port's nested parameter dicts.

``Optimizer(init, update, name)`` as in the JAX package, with one
difference: ``update(grads, state, params, step)`` writes the new
parameters and state into ``params`` and ``state`` in place, leaf by leaf
under ``torch.no_grad()``, and returns them.  A functional update would
hold the old and the new moments at once (at Llama-3.1-8B's first 8
layers another 22 GB).  The arithmetic is the JAX package's, in float32,
the bias correction included (``t = step + 1`` and ``b ** t`` in
float32).

Adafactor is the optimizer of the configurations from 30B parameters
(``for_arch``): AdamW's float32 moments would be 8 bytes a parameter.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

#: elements an AdamW update handles at once: bounds its float32
#: temporaries (a few of this size) on the largest leaves
ADAMW_CHUNK = 1 << 24


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    name: str


def leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level (the
    order ``jax.tree_util`` flattens a dict in), paths joined by "/"."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


def map_leaves(fn: Callable, tree: Dict) -> Dict:
    """The same nesting with ``fn`` applied to every leaf."""
    return {k: map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _zip_leaves(*trees: Dict) -> Iterator[Tuple]:
    """The leaves of trees of the same nesting, side by side; a leaf of a
    later tree may itself be a dict (Adafactor's per-leaf state)."""
    first = trees[0]
    for key in sorted(first):
        if isinstance(first[key], dict):
            yield from _zip_leaves(*(t[key] for t in trees))
        else:
            yield tuple(t[key] for t in trees)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": map_leaves(zeros, params),
                "v": map_leaves(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        f32 = np.float32
        t = f32(step) + f32(1.0)
        bc1 = float(f32(1.0) - f32(b1) ** t)
        bc2 = float(f32(1.0) - f32(b2) ** t)
        for g, m, v, p in _zip_leaves(grads, state["m"], state["v"], params):
            # the state and params are written in place through views; a
            # gradient may come non-contiguous from autograd
            gf = g.reshape(-1)
            mf, vf, pf = (x.view(-1) for x in (m, v, p))
            for lo in range(0, pf.numel(), ADAMW_CHUNK):
                sl = slice(lo, lo + ADAMW_CHUNK)
                g32 = gf[sl].float()
                mc, vc, pc = mf[sl], vf[sl], pf[sl]
                mc.mul_(b1).add_(g32 * (1 - b1))
                vc.mul_(b2).add_(torch.square(g32) * (1 - b2))
                denom = torch.sqrt(vc / bc2).add_(eps)
                delta = (mc / bc1).div_(denom)
                p32 = pc.float()
                delta.add_(p32 * weight_decay)
                pc.copy_(p32 - delta * lr)
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), momentum-free, factored for ndim >= 2
# ---------------------------------------------------------------------------

def adafactor(lr: float = 3e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored over the last two axes of each leaf of two or more dims
    (the layers' stacked ``(L, ...)`` leaves included, so each layer keeps
    its own row and column statistics); the update is clipped by the RMS
    of the whole leaf, as the JAX package clips it."""
    def init(params):
        def per_leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return map_leaves(per_leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step):
        t = np.float32(step) + np.float32(1.0)
        beta = float(np.float32(1.0) - t ** np.float32(-decay))
        for g, s, p in _zip_leaves(grads, state, params):
            g32 = g.float()
            g2 = torch.square(g32).add_(eps)
            if p.dim() >= 2:
                vr, vc = s["vr"], s["vc"]
                vr.mul_(beta).add_(torch.mean(g2, dim=-1) * (1 - beta))
                vc.mul_(beta).add_(torch.mean(g2, dim=-2) * (1 - beta))
                row_mean = torch.clamp_min(
                    torch.mean(vr, dim=-1, keepdim=True), eps)
                rfac = torch.rsqrt(vr / row_mean)
                u = g32 * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].mul_(beta).add_(g2 * (1 - beta))
                u = g32 * torch.rsqrt(s["v"])
            del g2
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            p32 = p.float()
            if weight_decay:
                u = u + p32 * weight_decay
            p.copy_(p32 - u * lr)
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")


def for_arch(arch_params: int, lr: float = 3e-4) -> Optimizer:
    """AdamW below 30B parameters, Adafactor from 30B (the JAX package's
    rule: AdamW's float32 moments stop fitting past ~20B at its TP16
    layout)."""
    if arch_params >= 30e9:
        return adafactor(lr=lr)
    return adamw(lr=lr)
