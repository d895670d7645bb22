"""Expert-parallel MoE with all-to-all token routing (the counterpart of
``repro.distributed.moe_ep``; the Kimi-K2 path).

Over the active context's mesh: x's rows are split over the ``batch``
axes, the experts over the ``experts`` axes and each expert's FFN columns
over ``model``.  Each shard routes its rows (``topk_route``, the virtual
expert split), scatters them by sort into an (E, capacity, d) buffer with
a capacity counted on the shard's own rows, exchanges the buffer with one
``all_to_all`` over the expert axes, runs the SwiGLU of its E/n experts
on its f columns, sends the partial results back with a second
``all_to_all``, combines them into its rows, and sums the rows over
``model``.  Collectives a layer: 2 all-to-alls over the expert axes and 1
sum over ``model``.

With capacity dropping (``dropless=False``) the result is not
``moe_ffn_local``'s: capacity is counted per shard, so which slots drop
depends on the cut.

Where shards share a device, each shard's expert weights are views of
the whole stacks, not copies, and the routing of rows that several shards
hold alike (the ``model`` replicas of one batch slice) is computed once a
device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import axis_tuple
from repro_torch.models.layers import (capacity_dispatch,
                                       expand_virtual_experts, topk_route)


def _dispatch(xt: torch.Tensor, rw: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One shard's routing of its rows xt (t, d): the (E, cap, d) buffer
    and what the combine needs."""
    moe = cfg.moe
    t, d = xt.shape
    e_global, k_eff = moe.num_experts, moe.top_k * moe.expert_split
    weights, topi = topk_route(xt @ rw, moe.top_k)
    weights, topi = expand_virtual_experts(weights, topi, moe.expert_split)
    flat_e = topi.reshape(t * k_eff)
    cap = t if moe.dropless else max(
        1, int(math.ceil(t * k_eff / e_global * moe.capacity_factor)))
    pos, keep = capacity_dispatch(flat_e, e_global, cap)
    slot = torch.where(keep, flat_e * cap + pos, e_global * cap)
    buf = xt.new_zeros((e_global * cap + 1, d))
    buf[slot] = xt.repeat_interleave(k_eff, dim=0)          # overflow row
    return buf[:-1].view(e_global, cap, d), dict(
        keep=keep, safe=torch.where(keep, slot, 0), weights=weights)


def _combine(back: torch.Tensor, route: Dict[str, torch.Tensor],
             t: int, k_eff: int, dtype: torch.dtype) -> torch.Tensor:
    """The returned (E, cap, d) partial results gathered into the
    shard's t rows, weighted and summed over each row's k_eff slots."""
    d = back.shape[-1]
    y = back.reshape(-1, d)
    keep = route["keep"]
    gathered = torch.where(keep[:, None], y[route["safe"]], 0.0)
    gathered = gathered * route["weights"].reshape(-1)[:, None].to(dtype)
    return gathered.view(t, k_eff, d).sum(dim=1).to(dtype)


def moe_ffn_alltoall(x: torch.Tensor, router_w: torch.Tensor,
                     we1: torch.Tensor, we3: torch.Tensor, we2: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) on the mesh's first device; the router (d, E_phys) and
    the whole expert stacks we1/we3 (E, d, f), we2 (E, f, d) -> (B, S, d)
    on the first device."""
    dc = dctx.current()
    if dc is None:
        raise RuntimeError("moe_ffn_alltoall needs a DistContext")
    mesh = dc.mesh
    bat = axis_tuple(dc.rules.get("batch"))
    ep = axis_tuple(dc.rules.get("experts", "data"))
    tp = ("model",)
    n_ep, n_tp = mesh.size_of(ep), mesh.size_of(tp)
    e_global, f = cfg.moe.num_experts, we1.shape[-1]
    if e_global % n_ep or f % n_tp:
        raise ValueError(f"{e_global} experts x {f} columns do not split "
                         f"over {n_ep} x {n_tp} shards")
    k_eff = cfg.moe.top_k * cfg.moe.expert_split
    b, s, d = x.shape
    n_b = mesh.size_of(bat) if b % mesh.size_of(bat) == 0 else 1
    b_loc = b // n_b
    e_loc, f_loc = e_global // n_ep, f // n_tp

    def batch_index(r: int) -> int:
        return mesh.index(r, bat) if n_b > 1 else 0

    # routing, once a (batch slice, device)
    routed: Dict[Tuple[int, torch.device], Tuple] = {}
    for r in range(mesh.size):
        key = (batch_index(r), mesh.device(r))
        if key not in routed:
            i = key[0]
            xt = x[i * b_loc:(i + 1) * b_loc].reshape(b_loc * s, d)
            routed[key] = _dispatch(xt.to(key[1]), router_w.to(key[1]), cfg)

    def route(r):
        return routed[(batch_index(r), mesh.device(r))]

    out: List[torch.Tensor] = [None] * mesh.size
    for r0 in range(mesh.size):
        if mesh.index(r0, ep):
            continue
        g = mesh.group(ep, at=r0)                  # one expert group
        recv = g.all_to_all([route(r)[0] for r in g.ranks], split_dim=0,
                            concat_dim=1)          # (E/n, n*cap, d)
        ys = []
        for j, (r, dev) in enumerate(zip(g.ranks, g.devices)):
            e0 = mesh.index(r, ep) * e_loc
            c0 = mesh.index(r, tp) * f_loc
            w1 = we1[e0:e0 + e_loc, :, c0:c0 + f_loc].to(dev)     # views
            w3 = we3[e0:e0 + e_loc, :, c0:c0 + f_loc].to(dev)
            w2 = we2[e0:e0 + e_loc, c0:c0 + f_loc].to(dev)
            h = F.silu(torch.bmm(recv[j], w1)) * torch.bmm(recv[j], w3)
            ys.append(torch.bmm(h, w2).to(x.dtype))  # partial over f
            recv[j] = None
        back = g.all_to_all(ys, split_dim=1, concat_dim=0)  # (E, cap, d)
        del ys
        for r, y in zip(g.ranks, back):
            out[r] = _combine(y, route(r)[1], b_loc * s, k_eff, x.dtype)
        del back
    rows = []
    for i in range(n_b):
        g = mesh.group(tp, at=mesh.position(bat if n_b > 1 else (), i))
        summed = g.all_reduce_sum([out[r] for r in g.ranks])
        rows.append(summed[0].to(x.device).view(b_loc, s, d))
    return torch.cat(rows)
