"""The dry run (the counterpart of ``repro.launch.dryrun``): per
(architecture x input shape x mesh) cell, what one device of the
production mesh holds and does in one step, with no card and no memory
spent.

The JAX package lowers and compiles a GSPMD step per cell and reads
XLA's ``memory_analysis()``, ``cost_analysis()`` and HLO.  The port has
no compiler behind it, so it computes the same quantities from the
sharding trees and on the meta device (``torch.device("meta")``: shapes
and dtypes, no memory, no arithmetic):

* **Argument bytes**, exactly: every parameter, optimizer-state, batch
  and decode-state leaf (and the train step's int32 step) at its shard
  shape, from its spec in ``param_shardings``/``opt_shardings``/
  ``batch_shardings``/``decode_state_shardings`` over the mesh's axis
  sizes (a dim that does not divide rounds up, as GSPMD pads it).  This
  is XLA's ``argument_size_in_bytes`` for the same shardings.
* **FLOPs**, from ``torch.utils.flop_counter.FlopCounterMode`` on meta
  probes of 1 and 2 layers combined as the reference combines its
  probes (:func:`_combine`): per-layer cost ``P(2L) - P(1L)``, the rest
  once, the train step ``grad_accum`` microbatches plus the optimizer
  update.  A probe runs one device's share of the step: its microbatch
  (the batch over the ``batch`` axes), its slice of the decode cache's
  sequence (over ``kv_seq``), and the model at its per-shard widths
  (:func:`device_config`: heads, ``d_ff``, vocab and experts divided as
  the rules divide them), under the context's ``banded_attention`` and
  ``attn_chunk`` flags.  A decode probe's q heads attend over the
  device's slice of the sequence times the heads split away (flash
  decode runs every head of a row over the slice, which is the same
  number of score and value products).  ``FlopCounterMode`` counts the
  matmul-class ops only (GEMMs, batched GEMMs, the attention's score and
  value products, convolutions), 2 per multiply-add; XLA's ``cost_analysis`` also counts
  every elementwise op and reduction (a softmax, a norm, the optimizer's
  update), so the port's count is XLA's less those.  Where GSPMD
  replicates the K/V projection (kv heads that do not divide over
  ``model``) the probe computes the kv heads its q heads read, not all
  of them; the SSM's inner width stays whole; a MoE probe keeps each
  token's ``top_k`` routes over the device's experts (at least
  ``top_k x expert_split`` of them), which gives the expert-parallel
  buffer's rows exactly.
* **Bytes**: ``bytes_min``, the bytes the step must move at least
  (:func:`bytes_lower_bound`: each argument read once, each output
  written once), is the roofline's memory term, so ``bound_s`` is a
  lower bound on the step's time.  ``bytes_unfused``, every aten op's
  input and output bytes (views excluded) under a dispatch mode on the
  meta device, each op as if it ran alone, is kept beside it as a
  diagnostic: it is no bound, and not XLA's fused ``bytes accessed``.
* **Collectives**, in two parts.  *Logged*: what the port's own sharded
  paths issue, from the meta mesh's :class:`CollectiveLog` (decode
  under ``make_context(..., "decode")``: the flash decode's max and two
  sums a layer; the all-to-all MoE's two all-to-alls and one sum a
  layer), at the full widths and the global (micro)batch on a mesh of
  meta devices.  A train step logs its forward and counts it three
  times (the forward, the remat's second forward, the backward's
  transposed collectives).  *Reckoned* from the sharding trees: the
  all-reduces GSPMD inserts where the port has no path, as XLA's program
  for the JAX package places them (:func:`reckoned_collectives`: the
  tensor-parallel projections' sums, the vocab-split embedding, head and
  loss, the gradients over the data-parallel axes).  On the dense train
  and prefill cells the tests hold them to XLA's wire bytes; an SSM's
  sequence-parallel all-gathers, all-to-alls and permutes, which XLA
  adds, are not reckoned, nor held, and neither is a MoE cell.  The
  records keep the two apart (``wire:logged:<kind>``,
  ``wire:reckoned:<kind>``, kinds named as HLO names them); the
  roofline's collective term is their sum at the card's link rate.
* **Peak memory**: the live storage bytes on the meta device during a
  probe of the whole step (a train step with its accumulator and
  optimizer update, a prefill, a decode step) at 1 and 2 layers,
  combined per layer: ``temp_bytes`` is the probe's peak above its own
  arguments, ``peak_bytes = argument_bytes + temp_bytes``, held against
  one H100's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import torch_dtype
from repro_torch.configs import (ARCH_IDS, SHAPE_BY_NAME, SHAPES,
                                 cell_is_runnable, get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.context import (DistContext, Mesh, axis_tuple,
                                             use_dist)
from repro_torch.distributed.sharding import (batch_shardings,
                                              decode_state_shardings,
                                              effective_config, make_context,
                                              opt_shardings, param_axes,
                                              param_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (abstract_params, decode_step, forward,
                                init_decode_state, shard_decode_state)
from repro_torch.roofline import roofline, wire_bytes
from repro_torch.training.optimizer import (adafactor, adamw, for_arch,
                                           leaves)
from repro_torch.training.train_step import (accum_dtype_for,
                                             make_train_step, value_and_grad)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
#: one card's device memory, the budget a cell's peak is printed against
CARD_HBM_BYTES = 80e9
CARD_NAME = "H100"
META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_kind: str, batch: int,
                seq: int) -> Dict:
    """Meta-tensor stand-ins for every model input, of the reference's
    shapes and dtypes."""
    dt = torch_dtype(cfg.dtype)
    i32 = torch.int32
    out: Dict = {}
    if shape_kind in ("train", "prefill"):
        if cfg.inputs_are_embeddings and not cfg.enc_dec:
            out["embeds"] = _meta((batch, seq, cfg.d_model), dt)
        else:
            out["tokens"] = _meta((batch, seq), i32)
        if cfg.enc_dec:
            out["enc_embeds"] = _meta((batch, cfg.encoder_len, cfg.d_model),
                                      dt)
        if shape_kind == "train":
            out["labels"] = _meta((batch, seq), i32)
        return out
    state = init_decode_state(cfg, batch, seq, abstract=True)
    return {"state": state, "tokens": _meta((batch,), i32)}


def grad_accum_for(cfg: ModelConfig, shape: ShapeConfig, dp_total: int,
                   act_budget_bytes: float = 4e9) -> int:
    """Largest microbatch whose remat-saved layer inputs fit the activation
    budget — more accumulation steps mean more FSDP weight re-gathers per
    step (measured: the dominant collective cost), so microbatches should
    be as large as memory allows."""
    per_dev = max(1, shape.global_batch // dp_total)
    saved_per_seq = cfg.n_layers * shape.seq_len * cfg.d_model * 2
    micro = max(1, min(per_dev, int(act_budget_bytes // max(saved_per_seq, 1))))
    while per_dev % micro:   # microbatch must divide the per-device batch
        micro -= 1
    return max(1, per_dev // micro)


def _probe_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    changes: Dict[str, Any] = {"n_layers": n_layers}
    if cfg.enc_dec:
        changes["n_encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **changes)


def _combine(p1: Dict, p2: Dict, mult_layer: float, mult_outer: float,
             fixed: Optional[Dict] = None) -> Dict[str, float]:
    """total = mult_outer x (C1 + mult_layer·C2) + fixed, per key."""
    keys = set(p1) | set(p2) | set(fixed or {})
    out = {}
    for k in keys:
        a, b = p1.get(k, 0.0), p2.get(k, 0.0)
        c2 = max(b - a, 0.0)
        c1 = max(a - c2, 0.0)
        out[k] = mult_outer * (c1 + mult_layer * c2) + (fixed or {}).get(k, 0.0)
    return out


# ---------------------------------------------------------------------------
# Per-device argument bytes from the sharding trees
# ---------------------------------------------------------------------------

def shard_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` laid out by ``spec``
    (mesh axes per dim): each split dim over its axes' size, rounded up."""
    return tuple(-(-int(d) // mesh.size_of(a)) for d, a in zip(shape, spec))


def _leaf_bytes(t: torch.Tensor, spec, mesh: Mesh) -> int:
    return math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()


def tree_shard_bytes(tree: Dict, specs: Dict, mesh: Mesh) -> int:
    """Per-device bytes of a (nested) dict of meta tensors under a tree
    of specs of the same nesting."""
    total = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            total += tree_shard_bytes(v, specs[k], mesh)
        else:
            total += _leaf_bytes(v, specs[k], mesh)
    return total


def argument_bytes(cfg: ModelConfig, kind: str, mesh: Mesh, rules: Dict,
                   inputs: Dict, opt_name: Optional[str] = None
                   ) -> Dict[str, int]:
    """Per-device bytes of the step's arguments, by part: ``params``,
    ``opt_state`` and ``step`` (train), ``batch`` (train, prefill),
    ``state`` and ``tokens`` (decode); ``total`` their sum."""
    params = abstract_params(cfg)
    out = {"params": tree_shard_bytes(params, param_shardings(
        cfg, mesh, rules), mesh)}
    if kind == "train":
        opt = for_arch(cfg.param_count()) if opt_name is None else \
            _OPTIMIZERS[opt_name]()
        out["opt_state"] = tree_shard_bytes(
            opt.init(params), opt_shardings(opt.name, cfg, mesh, rules),
            mesh)
        out["step"] = 4                       # the step, an int32 scalar
    if kind in ("train", "prefill"):
        out["batch"] = tree_shard_bytes(
            inputs, batch_shardings(cfg, mesh, rules, inputs), mesh)
    else:
        state = inputs["state"]
        out["state"] = tree_shard_bytes(
            state, decode_state_shardings(cfg, mesh, rules, state), mesh)
        out["tokens"] = _leaf_bytes(inputs["tokens"],
                                    (rules.get("batch"),), mesh)
    out["total"] = sum(out.values())
    return out


_OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}


def bytes_lower_bound(cfg: ModelConfig, kind: str, mesh: Mesh, rules: Dict,
                      args: Dict[str, int], out_bytes: float,
                      step_tokens: int) -> float:
    """The HBM bytes one device must move at least in one step: every
    argument read once, and every output written once.  A train step
    writes its parameters and optimizer state back (in place); a prefill
    or decode step writes what it returns beside its arguments
    (``out_bytes``: the logits, a prefill's KV cache; the decode's cache
    row a layer, written in place, is left out).  An inference step reads
    only the experts its ``step_tokens`` can be routed to: at most
    ``step_tokens x top_k`` physical experts, each ``expert_split``
    virtual ones, of the device's (a train step's optimizer reads
    them all)."""
    total = float(args["total"])
    if kind == "train":
        return total + args["params"] + args["opt_state"]
    total += out_bytes
    if cfg.moe is not None:
        specs = _flat(param_shardings(cfg, mesh, rules))
        axes = _flat(param_axes(cfg))
        m = cfg.moe
        for name, p in leaves(abstract_params(cfg)):
            if "experts" not in axes[name]:
                continue
            shape = shard_shape(p.shape, specs[name], mesh)
            e_dev = shape[axes[name].index("experts")]
            reach = min(e_dev, step_tokens * m.top_k * m.expert_split)
            total -= math.prod(shape) * p.element_size() \
                * (e_dev - reach) / e_dev
    return total


# ---------------------------------------------------------------------------
# One device's share: its widths and its batch
# ---------------------------------------------------------------------------

def device_config(cfg: ModelConfig, mesh: Mesh, rules: Dict) -> ModelConfig:
    """``cfg`` at one device's widths under ``rules``: q heads over
    ``heads``, kv heads over ``kv_heads`` (where they stay whole and the q
    heads split, the kv heads those q heads read), the MLP's ``d_ff`` over
    ``ffn`` (a MoE's over ``expert_ffn``), the vocab over ``vocab``, and a
    MoE's experts over ``experts`` (at least ``top_k x expert_split``,
    so each token keeps its routes).  A width that does not divide stays
    whole, as the rules leave it."""
    def split(n: int, logical: str) -> int:
        k = mesh.size_of(rules.get(logical))
        return n // k if k > 1 and n % k == 0 else n

    ch: Dict[str, Any] = {}
    if cfg.n_heads:
        h = split(cfg.n_heads, "heads")
        kh = split(cfg.n_kv_heads, "kv_heads")
        if h < cfg.n_heads and kh == cfg.n_kv_heads:
            kh = max(1, cfg.n_kv_heads * h // cfg.n_heads)
        while h % kh:
            kh -= 1
        ch.update(n_heads=h, n_kv_heads=kh)
    if cfg.moe is not None:
        m = cfg.moe
        ch["d_ff"] = split(cfg.d_ff, "expert_ffn")
        e = max(split(m.num_experts, "experts"), m.top_k * m.expert_split)
        e = -(-e // m.expert_split) * m.expert_split
        ch["moe"] = dataclasses.replace(m, num_experts=e)
    elif cfg.d_ff:
        ch["d_ff"] = split(cfg.d_ff, "ffn")
    v = split(cfg.vocab_size, "vocab")
    if v != cfg.vocab_size:
        ch.update(vocab_size=v, real_vocab=0)
    return dataclasses.replace(cfg, **ch)


def _n_batch(mesh: Mesh, rules: Dict, b: int) -> int:
    n = mesh.size_of(rules.get("batch"))
    return n if b % n == 0 else 1


def _probe_ctx(ctx: DistContext) -> DistContext:
    """A one-device context with the cell's attention flags only: the
    probe runs the device's share itself, no sharded path."""
    return DistContext(Mesh((1, 1), ("data", "model")), {},
                       {k: v for k, v in ctx.flags.items()
                        if k in ("banded_attention", "attn_chunk")})


# ---------------------------------------------------------------------------
# Meters on the meta device
# ---------------------------------------------------------------------------

class MetaMeter(TorchDispatchMode):
    """Every aten op's input and output bytes (views excluded:
    ``bytes``) and the live storage bytes (``live``, ``peak``): a storage
    counts from the op that creates it until its last tensor dies.
    ``track`` adds storages made before the meter (the arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._sizes:
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def track(self, tree) -> int:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._add(t)
        return self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self._add(t)
        return out


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def measure(fn: Callable[[], Any], arguments, ctx: Optional[DistContext]
            = None) -> Dict[str, float]:
    """``fn()`` on the meta device under ``ctx``: its FLOPs, its unfused
    bytes, its peak of live storage above ``arguments``' bytes, and the
    bytes of what it returns outside ``arguments``' storage
    (``out_bytes``: an argument updated in place is not counted)."""
    meter = MetaMeter()
    with FlopCounterMode(display=False) as fc, meter, use_dist(ctx):
        base = meter.track(arguments)
        ret = fn()
    held = {id(t.untyped_storage()) for t in _tensors(arguments)}
    new = {id(t.untyped_storage()): t.untyped_storage().nbytes()
           for t in _tensors(ret)}
    return {"flops": float(fc.get_total_flops()),
            "bytes_unfused": meter.bytes,
            "peak_above_args": float(meter.peak - base),
            "out_bytes": float(sum(n for k, n in new.items()
                                   if k not in held))}


def count_flops(fn: Callable[[], Any]) -> float:
    """``FlopCounterMode``'s total for ``fn()`` (any device)."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

def _train_probes(cfg, lcfg, pctx, micro_loc, seq, opt_name, accum, L):
    """(FLOP/byte totals of the step, temp bytes): grads-only microbatch
    probes and optimizer-update probes at 1 and 2 layers (the
    reference's), and whole-step probes with min(accum, 2) microbatches
    for the peak."""
    make_opt = _OPTIMIZERS[opt_name]
    probes, opt_probes, mem = {}, {}, {}
    for n in (1, 2):
        pcfg = _probe_cfg(lcfg, n)
        params = abstract_params(pcfg)
        batch = input_specs(pcfg, "train", micro_loc, seq)
        probes[n] = measure(lambda: value_and_grad(params, pcfg, batch),
                            (params, batch), pctx)
        opt = make_opt()
        state = opt.init(params)
        grads = {k: torch.empty_like(v) for k, v in leaves(params)}
        opt_probes[n] = measure(
            lambda: opt.update(_nest(params, grads), state, params, 0),
            (params, state, grads), pctx)
        k = min(accum, 2)
        step = make_train_step(pcfg, opt, grad_accum=k)
        full = input_specs(pcfg, "train", micro_loc * k, seq)
        mem[n] = measure(lambda: step(params, state, full, 0),
                         (params, state, full), pctx)
    fixed = _combine(opt_probes[1], opt_probes[2], mult_layer=L,
                     mult_outer=1.0)
    totals = _combine(probes[1], probes[2], mult_layer=L, mult_outer=accum,
                      fixed=fixed)
    temp = _combine({"t": mem[1]["peak_above_args"]},
                    {"t": mem[2]["peak_above_args"]}, L, 1.0)["t"]
    return totals, temp, {"probe_1L": probes[1], "probe_2L": probes[2],
                          "opt_probe_1L": opt_probes[1],
                          "opt_probe_2L": opt_probes[2],
                          "mem_probe_1L": mem[1], "mem_probe_2L": mem[2]}


def _nest(tree: Dict, flat: Dict, prefix: str = "") -> Dict:
    return {k: _nest(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[prefix + k] for k, v in tree.items()}


def _forward_probes(kind, lcfg, pctx, b_loc, seq, L):
    probes = {}
    for n in (1, 2):
        pcfg = _probe_cfg(lcfg, n)
        params = abstract_params(pcfg)
        specs = input_specs(pcfg, kind, b_loc, seq)
        if kind == "prefill":
            ret_kv = pcfg.family != "ssm"

            def fn():
                with torch.no_grad():
                    return forward(params, pcfg, specs, return_kv=ret_kv,
                                   last_only=True)
        else:
            def fn():
                with torch.no_grad():
                    return decode_step(params, pcfg, specs["state"],
                                       specs["tokens"])
        probes[n] = measure(fn, (params, specs), pctx)
    totals = _combine(probes[1], probes[2], mult_layer=L, mult_outer=1.0)
    temp = totals.pop("peak_above_args")
    return totals, temp, {"probe_1L": probes[1], "probe_2L": probes[2]}


def meta_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s shape over meta devices (the sharded paths run there,
    and its log counts their collectives)."""
    return Mesh(tuple(mesh.shape.values()), mesh.axis_names,
                [META] * mesh.size)


def logged_collectives(cfg: ModelConfig, kind: str, mesh: Mesh,
                       batch: int, seq: int) -> Dict[str, Dict[str, float]]:
    """The collectives rank 0 of ``mesh`` takes part in during one
    forward (train, prefill) or decode step of ``cfg`` at ``batch``
    sequences, through the port's sharded paths on a meta mesh
    (``{}`` where the cell takes none of them; a train step's forward
    only)."""
    mm = meta_mesh(mesh)
    ctx = make_context(cfg, mm, kind, batch_size=batch)
    if not (ctx.flags.get("moe_alltoall") or ctx.flags.get("flash_decode")):
        return {}
    params = abstract_params(cfg)
    specs = input_specs(cfg, kind, batch, seq)
    with torch.no_grad(), use_dist(ctx):
        if kind == "decode":
            decode_step(params, cfg, shard_decode_state(specs["state"], ctx),
                        specs["tokens"])
        else:
            forward(params, cfg, specs)
    return mm.log.summary(0)


def _flat_collectives(summary: Dict, tag: str) -> Dict[str, float]:
    out = {}
    for k, v in summary.items():
        out[f"wire:{tag}:{k}"] = float(v["wire_bytes"])
        out[f"count:{tag}:{k}"] = float(v["count"])
    return out


# A layer's tensor-parallel projections: a row-parallel one (its input
# dim split) sums its output over the split in the forward; a
# column-parallel one (an output dim split) sums its input's gradient in
# the backward.  The split logical axis of each (a cross-attention's
# ``x``-prefixed copies alike).
_ROW_PARALLEL = {"wo": "heads", "w2": "ffn", "ssm_out": "ssm_inner",
                 "we2": "expert_ffn"}
_COL_PARALLEL = {"wq": "heads", "wk": "kv_heads", "wv": "kv_heads",
                 "w1": "ffn", "w3": "ffn", "in_proj": "ssm_inner",
                 "we1": "expert_ffn", "we3": "expert_ffn"}
_F32 = 4


def reckoned_collectives(cfg: ModelConfig, kind: str, mesh: Mesh,
                         rules: Dict, b_loc: int, seq: int, accum: int,
                         logged_moe: bool) -> Dict[str, float]:
    """The collectives GSPMD would insert for one step where the port has
    no sharded path, per device, for a microbatch of ``b_loc`` sequences
    of ``seq`` tokens a device (one token a sequence for decode), as
    XLA's program for the JAX package has them (tests/test_torch_dryrun.py
    holds them to it on dense cells):

    * a row-parallel projection's output, summed once a microbatch in the
      forward, and again in the remat's second forward unless it is the
      layer's last (whose sum only the next layer reads); a
      column-parallel one's input gradient, once in the backward; both
      float32, as XLA reduces the float32 partial products before it
      rounds them; likewise a vocab-split embedding's lookup (forward)
      and head (backward), and a vocab-split loss's max, sum and label
      logit a token;
    * the loss's mean over the data axes, and the gradients once a step,
      all-reduced over the data axes a leaf is replicated on (float32, or
      the accumulator's dtype with ``accum > 1``), a tied embedding's
      twice (the lookup's gradient and the head's); an FSDP-split leaf
      (no rule splits one today) gathered in each pass and its gradient
      reduce-scattered.

    The MoE experts' projections are left out where the all-to-all path
    logged them (``logged_moe``)."""
    out: Dict[str, float] = {}

    def add(k: str, operand: float, n: int, count: float) -> None:
        if n > 1 and count:
            out[f"wire:reckoned:{k}"] = out.get(f"wire:reckoned:{k}", 0.0) \
                + count * wire_bytes(k, operand, n)
            out[f"count:reckoned:{k}"] = out.get(f"count:reckoned:{k}", 0.0) \
                + count

    def tp(logical: str) -> int:
        return mesh.size_of(rules.get(logical))

    train = kind == "train"
    tokens = b_loc * (1 if kind == "decode" else seq)
    enc_tokens = b_loc * cfg.encoder_len
    act = cfg.d_model * _F32
    logical = param_axes(cfg)
    stacks = [("blocks", cfg.n_layers)]
    if cfg.enc_dec and kind != "decode":
        stacks.append(("enc_blocks", cfg.n_encoder_layers))
    for stack, n_layers in stacks:
        names = list(logical[stack])
        last_row = [n for n in names if _base(n) in _ROW_PARALLEL][-1:]
        for name in names:
            base = _base(name)
            if logged_moe and base.startswith("we"):
                continue
            # the encoder's stack and the cross-attention's K/V read the
            # encoder's frames (a decode step reads them cached)
            enc = stack == "enc_blocks" or name in ("xwk", "xwv")
            if enc and kind == "decode":
                continue
            rows = enc_tokens if enc else tokens
            if base in _ROW_PARALLEL:
                # the remat's second forward sums again every output the
                # layer's backward reads: all but the layer's last
                again = train and name not in last_row
                add("all-reduce", rows * act, tp(_ROW_PARALLEL[base]),
                    n_layers * accum * (2 if again else 1))
            elif base in _COL_PARALLEL and train:
                add("all-reduce", rows * act, tp(_COL_PARALLEL[base]),
                    n_layers * accum)
    if not (cfg.inputs_are_embeddings and not cfg.enc_dec):
        # a vocab-split embedding lookup: partial rows summed
        add("all-reduce", tokens * act, tp("vocab"), accum)
    if not train:
        return out
    # a vocab-split head's input gradient; a vocab-split loss: max, sum
    # and the label's logit a token; the loss's mean over the data axes
    add("all-reduce", tokens * act, tp("vocab"), accum)
    add("all-reduce", tokens * _F32, tp("vocab"), 3 * accum)
    bat = set(axis_tuple(rules.get("batch")))
    add("all-reduce", _F32, math.prod(mesh.shape[a] for a in bat), accum)
    # the gradients, once a step
    el = torch_dtype(cfg.dtype).itemsize
    acc_el = accum_dtype_for(cfg).itemsize if accum > 1 else _F32
    specs = _flat(param_shardings(cfg, mesh, rules))
    flat_axes = _flat(logical)
    for name, p in leaves(abstract_params(cfg)):
        spec = specs[name]
        held = {a for s in spec for a in axis_tuple(s)}
        fsdp = {a for s, lg in zip(spec, flat_axes[name])
                if lg in ("fsdp", "expert_fsdp") for a in axis_tuple(s)} & bat
        shard = math.prod(shard_shape(p.shape, spec, mesh))
        if fsdp:
            n_f = math.prod(mesh.shape[a] for a in fsdp)
            add("all-gather", shard * el * n_f, n_f, 2 * accum)
            add("reduce-scatter", shard * n_f * acc_el, n_f, 1)
        # a tied embedding's two gradients (the lookup's and the head's)
        # are reduced apart
        twice = name == "embed" and cfg.tie_embeddings
        add("all-reduce", shard * acc_el,
            math.prod(mesh.shape[a] for a in bat - held), 2 if twice else 1)
    return out


def _base(name: str) -> str:
    """A block leaf's name without the cross-attention's ``x``."""
    cross = name[:1] == "x" and (name[1:] in _ROW_PARALLEL
                                 or name[1:] in _COL_PARALLEL)
    return name[1:] if cross else name


def _flat(tree: Dict, prefix: str = "") -> Dict[str, Tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


_COLLECTIVE_TERM_FROM = (
    "wire: logged by the port's sharded paths plus reckoned for GSPMD "
    "(the all-reduces equal XLA's on the dense train and prefill cells "
    "of tests/test_torch_dryrun.py)")


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
            grad_accum: Optional[int] = None,
            skip_probes: bool = False) -> Dict:
    """The dry run of ``cfg`` (already adapted to the mesh) at ``shape``
    on ``mesh``: the record's ``meta``, ``memory``, ``costs_per_device``
    and ``roofline`` (see the module docstring).  ``grad_accum`` replaces
    :func:`grad_accum_for`'s choice."""
    chips = mesh.size
    ctx = make_context(cfg, mesh, shape.kind, batch_size=shape.global_batch)
    rules = ctx.rules
    dp_total = chips // mesh.shape["model"]
    meta: Dict[str, Any] = {"rules": {k: str(v) for k, v in rules.items()},
                            "flags": dict(ctx.flags)}
    lcfg = device_config(cfg, mesh, rules)
    meta["device_config"] = {
        k: getattr(lcfg, k) for k in ("n_heads", "n_kv_heads", "d_ff",
                                      "vocab_size")}
    if lcfg.moe is not None:
        meta["device_config"]["num_experts"] = lcfg.moe.num_experts
    pctx = _probe_ctx(ctx)
    L = cfg.n_layers
    seq = shape.seq_len
    accum, opt_name = 1, None
    if shape.kind == "train":
        accum = grad_accum or grad_accum_for(cfg, shape, dp_total)
        opt_name = for_arch(cfg.param_count()).name
        meta.update(grad_accum=accum, optimizer=opt_name)
        micro = max(dp_total, shape.global_batch // accum)
        inputs = input_specs(cfg, "train", shape.global_batch, seq)
    else:
        micro = shape.global_batch
        inputs = input_specs(cfg, shape.kind, shape.global_batch, seq)
    b_loc = micro // _n_batch(mesh, rules, micro)
    args = argument_bytes(cfg, shape.kind, mesh, rules, inputs, opt_name)
    meta["argument_parts"] = args
    logged_moe = bool(ctx.flags.get("moe_alltoall"))
    totals: Dict[str, float] = {"flops": 0.0, "bytes_unfused": 0.0}
    temp = 0.0
    if not skip_probes:
        if shape.kind == "train":
            totals, temp, probes = _train_probes(
                cfg, lcfg, pctx, b_loc, seq, opt_name, accum, L)
            totals.pop("peak_above_args", None)
            totals.pop("out_bytes", None)
        elif shape.kind == "prefill":
            totals, temp, probes = _forward_probes(
                "prefill", lcfg, pctx, b_loc, seq, L)
        else:
            # flash decode: every q head of the device's rows attends over
            # its slice of the sequence; the probe's q heads (split over
            # model for the projections) attend over as many positions
            n_seq = mesh.size_of(rules.get("kv_seq"))
            s_loc = seq // n_seq if seq % n_seq == 0 else seq
            if lcfg.n_heads:
                s_loc *= cfg.n_heads // lcfg.n_heads
            totals, temp, probes = _forward_probes(
                "decode", lcfg, pctx, b_loc, s_loc, L)
        meta.update(probes)
        logged = [logged_collectives(_probe_cfg(cfg, n), shape.kind, mesh,
                                     micro, seq) for n in (1, 2)]
        logged = _combine(_flat_collectives(logged[0], "logged"),
                          _flat_collectives(logged[1], "logged"),
                          mult_layer=L,
                          mult_outer=3 * accum if shape.kind == "train"
                          else 1.0)
        logged_moe = logged_moe and bool(logged)
        totals.update(logged)
    totals.update(reckoned_collectives(cfg, shape.kind, mesh, rules, b_loc,
                                       seq, accum, logged_moe))
    totals["wire"] = sum(v for k, v in totals.items()
                         if k.startswith("wire:"))
    step_tokens = shape.global_batch * (1 if shape.kind == "decode" else seq)
    totals["bytes_min"] = bytes_lower_bound(
        cfg, shape.kind, mesh, rules, args, totals.pop("out_bytes", 0.0),
        step_tokens)
    terms = roofline(cfg, shape, chips, per_device_flops=totals["flops"],
                     per_device_bytes=totals["bytes_min"],
                     per_device_wire_bytes=totals["wire"])
    return {
        "chips": chips, "meta": meta,
        "memory": {"argument_bytes": args["total"], "temp_bytes": temp,
                   "peak_bytes": args["total"] + temp,
                   "card_hbm_bytes": CARD_HBM_BYTES,
                   "temp_from": "skipped" if skip_probes else
                   "meta-device live storage, probes of 1 and 2 layers"},
        "costs_per_device": totals,
        "roofline": {
            "hardware": dataclasses.asdict(terms.hardware),
            "memory_term_from": "bytes_min: each argument read once, each "
                                "output written once (a lower bound; "
                                "bytes_unfused, each aten op's bytes as "
                                "if it ran alone, is not a bound)",
            "collective_term_from": _COLLECTIVE_TERM_FROM
            + ("" if cfg.ssm is None and cfg.moe is None else
               "; this cell's " + ("SSM" if cfg.moe is None else "MoE")
               + " collectives are not held to XLA's"),
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "bound_s": terms.bound_s,
            "bottleneck": terms.bottleneck,
            "model_flops": terms.model_flops,
            "hlo_flops_global": terms.hlo_flops_global,
            "useful_ratio": terms.useful_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, force: bool = False,
             skip_probes: bool = False) -> Dict:
    """One cell of the grid on the production mesh: its record, written
    to ``out_dir`` (default :data:`RESULTS_DIR`; read back instead when it
    is there and not ``force``)."""
    out_dir = RESULTS_DIR if out_dir is None else out_dir
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    ok, why = cell_is_runnable(arch, shape_name)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "status": "skipped", "reason": why}
    if not ok:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[{arch} x {shape_name} x {mesh_name}] SKIP: {why}")
        return rec

    shape = SHAPE_BY_NAME[shape_name]
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        dp_all = mesh.size // mesh.shape["model"]
        cfg = effective_config(get_config(arch), tp=mesh.shape["model"],
                               ep=dp_all)
        rec.update(dry_run(cfg, shape, mesh, skip_probes=skip_probes))
        rec.update(status="ok", reason="", total_s=round(time.time() - t0, 1))
        _print_cell(rec, f"[{arch} x {shape_name} x {mesh_name}]")
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[{arch} x {shape_name} x {mesh_name}] FAILED: {e}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def _print_cell(rec: Dict, tag: str) -> None:
    mem, tot, rf = rec["memory"], rec["costs_per_device"], rec["roofline"]
    hbm = mem["peak_bytes"] / 1e9
    print(f"{tag} OK total={rec.get('total_s', 0):.0f}s")
    print(f"  memory/device: args={mem['argument_bytes']/1e9:.2f}GB "
          f"temp={mem['temp_bytes']/1e9:.2f}GB (~{hbm:.1f}GB of "
          f"{CARD_HBM_BYTES/1e9:.0f}GB {CARD_NAME} HBM)")
    print(f"  per-device: flops={tot['flops']:.3e} "
          f"bytes_min={tot['bytes_min']:.3e} "
          f"bytes_unfused={tot['bytes_unfused']:.3e} wire={tot['wire']:.3e}")
    print(f"  roofline ({rf['hardware']['name']}): "
          f"compute={rf['compute_s']*1e3:.2f}ms "
          f"memory={rf['memory_s']*1e3:.2f}ms "
          f"collective={rf['collective_s']*1e3:.2f}ms "
          f"-> {rf['bottleneck']}-bound useful={rf['useful_ratio']:.3f} "
          f"frac={rf['roofline_fraction']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = cell_is_runnable(a, s)
                print(f"{a:20s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return

    failures = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(a, s, mp, out_dir=args.out, force=args.force,
                               skip_probes=args.skip_probes or mp)
                if rec["status"] == "error":
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
