"""Bucket-lattice auditor of the port's engine (the counterpart of
``repro.analysis.lattice``); nothing here runs a step but
:func:`collective_probe`.

Enumerates the occupancy lattice an :class:`~repro_torch.serving.engine.
EngineConfig` implies — through the same
:func:`~repro_torch.serving.engine.derive_bucket_lattice` the engine
buckets its steps with — and, per bucket:

* sizes the step's buffers on the meta device (``torch.device("meta")``:
  shapes and dtypes, no memory): the pack buffer, the residual stream,
  the attention score tile and the logits as the reference sizes them,
  plus the fused CUDA kernel's partial scratch, the port's own; and the
  bucket-independent KV pool and parameter bytes, against a declared
  device budget;
* predicts the **exact** set of ``(t, np, w, k)`` bucket keys a scripted
  workload sequence dispatches (the engine's ``buckets_used``), by
  replaying the serving control plane in discrete-event simulation
  (``execute_model=False``: the real block manager, evictor and
  scheduler run; the engine is the Eq.-6 cost model) and mapping every
  dispatched plan through the engine's own ``Engine.buckets_for`` and
  the work-list length ``build_inputs`` pads to ``w``.

The reference predicts its ``attn_impl="xla"`` engines only, whose ``w``
is 0; the port's fused engine always runs the CUDA kernel's work-list,
whose bucket ``w`` follows from the plan (the items
``build_worklist`` emits, padded to a power of two of at least
``WL_BUCKET``), so the replay computes it from the plan's varlen
metadata through the engine's own assembly.
"""
from __future__ import annotations

import copy
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.common import Finding

PASS = "lattice"
ENGINE_FILE = "src/repro_torch/serving/engine.py"


# ---------------------------------------------------------------------------
# lattice enumeration

def enumerate_lattice(ecfg, n_shards: int = 1,
                      max_decode_steps: int = 1) -> Dict[str, object]:
    """The (t, np, w, k) key lattice implied by an EngineConfig."""
    from repro_torch.serving.engine import WL_BUCKET, derive_bucket_lattice
    token_buckets, np_buckets = derive_bucket_lattice(ecfg)
    if ecfg.attn_mode != "fused":
        w_buckets: Tuple[int, ...] = (0,)
        w_note = "split layout: no work-list"
    else:
        w_buckets = ()
        w_note = (f"data-dependent powers of two >= WL_BUCKET="
                  f"{WL_BUCKET} (predicted per plan by the replay)")
    multi_token_ok = (ecfg.attn_mode == "fused" and n_shards == 1
                      and ecfg.assembly != "legacy")
    kmax = max_decode_steps if multi_token_ok else 1
    k_values = tuple(1 << i for i in range(max(1, kmax).bit_length())
                     if (1 << i) <= max(1, kmax))
    return {
        "token_buckets": list(token_buckets),
        "np_buckets": list(np_buckets),
        "w_buckets": list(w_buckets),
        "w_note": w_note,
        "k_values": list(k_values),
        "max_trace_keys": (len(token_buckets) * len(np_buckets)
                           * max(1, len(w_buckets)) * len(k_values)),
    }


# ---------------------------------------------------------------------------
# footprints on the meta device (no memory, no arithmetic)

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _bytes_of(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes_of(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def bucket_buffers(cfg, ecfg, t_b: int, np_b: int, k: int,
                   n_shards: int = 1) -> Dict[str, torch.Tensor]:
    """One bucket's step buffers as meta tensors: the reference's four
    (``pack``, ``residual``, ``attn_scores``, ``logits``) and the fused
    kernel's partial scratch (``attn_scratch``: its ``(o, m, l)`` planes
    of ``RUN_UNITS`` runs, ``(RUN_UNITS, T, H, D + 2)`` float32; none in
    the split layout)."""
    from repro_torch.kernels.msa.msa_fused import RUN_UNITS
    from repro_torch.serving.engine import WL_BUCKET, pack_layout_for
    heads = max(1, cfg.n_heads // max(1, n_shards))
    fused = ecfg.attn_mode == "fused"
    w_b = WL_BUCKET if fused else 0
    _, size = pack_layout_for(ecfg, t_b, np_b, w_b, k, n_shards)
    out = {
        "pack": _meta((size,), torch.int32),
        "residual": _meta((k * t_b, cfg.d_model), torch.float32),
        "attn_scores": _meta((heads, t_b, np_b * ecfg.page_size),
                             torch.float32),
        "logits": _meta((ecfg.max_prefills + ecfg.max_decodes,
                         cfg.vocab_size), torch.float32),
    }
    if fused:
        out["attn_scratch"] = _meta(
            (RUN_UNITS, t_b, heads, cfg.head_dim + 2), torch.float32)
    return out


def bucket_footprints(cfg, ecfg, n_shards: int = 1,
                      device_budget_bytes: Optional[int] = None,
                      k_values: Sequence[int] = (1,)
                      ) -> Tuple[Dict[str, object], List[Finding]]:
    """Per-bucket footprints on the meta device against a declared device
    budget."""
    from repro_torch import torch_dtype
    from repro_torch.models import abstract_params
    from repro_torch.serving.engine import derive_bucket_lattice

    findings: List[Finding] = []
    token_buckets, np_buckets = derive_bucket_lattice(ecfg)
    kv_heads = max(1, cfg.n_kv_heads // max(1, n_shards))
    params_bytes = _bytes_of(abstract_params(cfg))
    kv_pool_bytes = _bytes_of(_meta(
        (cfg.n_layers, 2, ecfg.num_pages, ecfg.page_size, kv_heads,
         cfg.head_dim), torch_dtype(cfg.dtype)))
    buckets = []
    worst = 0
    for t_b in token_buckets:
        for np_b in np_buckets:
            for k in k_values:
                bufs = bucket_buffers(cfg, ecfg, t_b, np_b, k, n_shards)
                sizes = {name: _bytes_of(v) for name, v in bufs.items()}
                act = sum(sizes.values())
                total = act + kv_pool_bytes + params_bytes
                worst = max(worst, total)
                buckets.append({
                    "t_bucket": t_b, "np_bucket": np_b, "k": k,
                    "pack_bytes": sizes["pack"],
                    "buffer_bytes": sizes,
                    "activation_bytes": act,
                    "total_bytes": total,
                })
                if device_budget_bytes and total > device_budget_bytes:
                    findings.append(Finding(
                        PASS, ENGINE_FILE, 1, "bucket-over-budget",
                        f"bucket (t={t_b}, np={np_b}, k={k}): footprint "
                        f"{total} B exceeds the declared device budget "
                        f"{device_budget_bytes} B"))
    report = {
        "params_bytes": params_bytes,
        "kv_pool_bytes": kv_pool_bytes,
        "per_bucket": buckets,
        "worst_case_total_bytes": worst,
        "device_budget_bytes": device_budget_bytes,
    }
    return report, findings


# ---------------------------------------------------------------------------
# bucket-key prediction (discrete-event replay of the control plane)

def _buckets_for(ecfg, token_buckets, np_buckets, plan) -> Tuple[int, int]:
    """``Engine.buckets_for`` itself, run on a stand-in that holds only
    what it reads, so the engine's code decides both the prediction and
    the dispatch (its ``max_blocks_per_seq`` refusal included)."""
    from repro_torch.serving.engine import Engine
    stub = SimpleNamespace(
        ecfg=ecfg, token_buckets=token_buckets, np_buckets=np_buckets,
        _t_bucket_set=set(token_buckets), _np_bucket_set=set(np_buckets),
        t_max=ecfg.max_prefills * ecfg.max_chunk + ecfg.max_decodes)
    return Engine.buckets_for(stub, plan)


def _w_for(ecfg, plan, t_b: int, np_b: int) -> int:
    """The work-list bucket ``build_inputs`` gives the plan: the most
    items of its iterations' work-lists, padded to a power of two of at
    least ``WL_BUCKET`` (0 in the split layout).  The varlen metadata
    comes from the engine's own assembly, run on a stand-in that holds
    only what it reads."""
    from repro_torch.kernels.msa.msa_fused import build_worklist
    from repro_torch.serving.engine import WL_BUCKET, Engine
    if ecfg.attn_mode != "fused":
        return 0
    k = plan.decode_steps
    stub = SimpleNamespace(ecfg=ecfg,
                           n_seqs=ecfg.max_prefills + ecfg.max_decodes)
    fields = (Engine._assemble_fused_multi(stub, plan, t_b, np_b, k)
              if k > 1 else Engine._assemble_fused(stub, plan, t_b, np_b))
    tq = min(ecfg.q_tile, t_b)
    n_tiles = -(-t_b // tq)
    qlen, ctx, pos = (fields[f].reshape(k, -1)
                      for f in ("qlen", "ctx", "positions"))
    most = max(build_worklist(
        fields["qstart"], qlen[i], ctx[i], fields["bt"], pos[i],
        page=ecfg.page_size, q_tile=tq, n_tiles=n_tiles,
        window=0)[0]["wl_seq"].shape[0] for i in range(k))
    return max(WL_BUCKET, 1 << (most - 1).bit_length())


def predict_trace_keys(cfg, scfg, workloads: Sequence,
                       ecfg=None) -> List[Tuple[int, int, int, int]]:
    """Distinct (t, np, w, k) bucket keys the workload sequence
    dispatches.

    Replays the full serving sequence on ONE simulated server
    (``execute_model=False``) — the scheduler, block manager and evictor
    run for real under ``clock="model"``, so the dispatched plan stream
    is the real engine's (workload outputs are scripted, so generated
    tokens and hence prefix-trie hits match too) — and maps each plan
    through the engine's ``buckets_for`` and :func:`_w_for`.  A sharded
    server is predicted by the same single-device replay (its plan stream
    is the single device's; its ``w`` is each shard's, which this does
    not predict)."""
    from repro_torch.serving import AsymCacheServer
    from repro_torch.serving.engine import EngineConfig, derive_bucket_lattice

    scfg = copy.deepcopy(scfg)
    scfg.execute_model = False
    scfg.clock = "model"
    n_shards = scfg.n_shards
    scfg.n_shards = 1
    if ecfg is None:
        ecfg = EngineConfig(
            num_pages=scfg.num_blocks, page_size=scfg.block_size,
            max_chunk=scfg.scheduler.max_chunk,
            max_prefills=scfg.scheduler.max_prefills,
            max_decodes=scfg.scheduler.max_decodes,
            attn_mode=scfg.attn_mode)
    token_buckets, np_buckets = derive_bucket_lattice(ecfg)
    srv = AsymCacheServer(cfg, None, scfg, ecfg=None)
    # mirror the real server's scheduler wiring (__init__ only applies
    # it on the execute_model path)
    srv.sched.cfg.token_buckets = token_buckets
    srv.sched.cfg.page_buckets = np_buckets
    if (n_shards > 1 or ecfg.attn_mode != "fused"
            or ecfg.assembly == "legacy"):
        srv.sched.cfg.max_decode_steps = 1

    keys: List[Tuple[int, int, int, int]] = []
    inner = srv.engine.dispatch

    def spy(plan):
        t_b, np_b = _buckets_for(ecfg, token_buckets, np_buckets, plan)
        keys.append((t_b, np_b, _w_for(ecfg, plan, t_b, np_b),
                     plan.decode_steps))
        return inner(plan)

    srv.engine.dispatch = spy
    for wl in workloads:
        srv.run(wl)
    return sorted(set(keys))


# ---------------------------------------------------------------------------
# collectives per bucket (runs one sharded step a bucket)

def collective_probe(cfg, params, scfg, ecfg=None, n_shards: int = 2
                     ) -> Dict[str, Dict]:
    """Per-bucket collectives of one sharded step: an engine over a
    ``make_serving_mesh(n_shards)`` of CPU shards runs one all-padding
    step a ``(t, np)`` bucket, and its
    mesh's ``CollectiveLog`` is read for rank 0 (``{kind: {"count",
    "wire_bytes"}}``).  The padding step writes the drop pages only."""
    from repro_torch.serving import AsymCacheServer
    from repro_torch.serving.engine import WL_BUCKET
    scfg = copy.deepcopy(scfg)
    scfg.n_shards = n_shards
    scfg.shard_devices = ["cpu"] * n_shards
    srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device="cpu")
    eng = srv.engine
    out: Dict[str, Dict] = {}
    for t_b in eng.token_buckets:
        for np_b in eng.np_buckets:
            layout, size = eng.pack_layout(t_b, np_b, WL_BUCKET)
            buf = np.zeros((size,), np.int32)
            views = {name: buf[off:off + n] for name, off, n in layout}
            eng.group.log.clear()
            with torch.no_grad():
                eng._step_impl(eng.params, eng._pack_inputs(buf, views),
                               t_b, np_b, WL_BUCKET)
            out[f"T{t_b}xNP{np_b}"] = eng.group.log.summary(0)
    return out


# ---------------------------------------------------------------------------
# the audit the CLI runs: the kernel-fusion gate configuration

#: default audit budget: smoke-scale serving must fit a 2 GiB device
DEFAULT_DEVICE_BUDGET = 2 << 30


def _gate_setup():
    """The fused single-device gate configuration of the reference's
    kernel-fusion benchmark (smoke scale), in the port's classes, so the
    audit covers the lattice that configuration dispatches; but for
    ``max_blocks_per_seq``, 64 where the reference has 32: the gate's
    sessions grow past 32 pages, which the reference's engine cuts
    without a word and the port's refuses."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.serving import SchedulerConfig, ServerConfig
    from repro_torch.serving.engine import EngineConfig
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    scfg = ServerConfig(
        policy="asymcache", num_blocks=256, block_size=16,
        clock="model", pipeline_depth=1, attn_mode="fused",
        scheduler=SchedulerConfig(token_budget=256, max_chunk=96,
                                  max_prefills=2, max_decodes=24,
                                  decode_threshold=4, max_running=64))
    ecfg = EngineConfig(
        num_pages=256, page_size=16, max_prefills=2, max_chunk=96,
        max_decodes=24, max_blocks_per_seq=64, attn_mode="fused")
    return cfg, scfg, ecfg


def _gate_workloads(smoke: bool = True):
    """The exact workload sequence the kernel-fusion gate serves on its
    depth-1 fused server (warmup + identity run + counter run +
    segments x perf run)."""
    from repro_torch.serving import AgenticConfig, agentic_workload

    def wl(n_jobs, seed):
        return agentic_workload(AgenticConfig(
            n_jobs=n_jobs, tool_calls_per_job=(2, 4),
            system_prefix_len=48, task_len=(70, 230),
            tool_result_len=(33, 150), output_len=(24, 56),
            tool_duration=(0.2, 0.8), qps=3.0, seed=seed))

    n_jobs, seed = (6, 5) if smoke else (10, 5)
    segments = 2 if smoke else 4
    return ([wl(1, 999), wl(n_jobs, seed), wl(n_jobs, seed + 1)]
            + [wl(n_jobs, seed + 2) for _ in range(segments)])


def audit(root: Path, device_budget_bytes: Optional[int] = None,
          predict: bool = True
          ) -> Tuple[Dict[str, object], List[Finding]]:
    """The full lattice audit: enumeration + footprints (+ the replay's
    prediction).  No step runs."""
    budget = device_budget_bytes or DEFAULT_DEVICE_BUDGET
    cfg, scfg, ecfg = _gate_setup()
    lattice = enumerate_lattice(ecfg, n_shards=1,
                                max_decode_steps=scfg.scheduler
                                .max_decode_steps)
    footprints, findings = bucket_footprints(
        cfg, ecfg, n_shards=1, device_budget_bytes=budget,
        k_values=lattice["k_values"])
    report: Dict[str, object] = {"lattice": lattice,
                                 "footprints": footprints}
    if predict:
        keys = predict_trace_keys(cfg, scfg, _gate_workloads(smoke=True),
                                  ecfg=ecfg)
        report["predicted_trace_keys"] = [list(k) for k in keys]
        report["predicted_jit_traces"] = len(keys)
        tnk = {(t, n, k) for t, n, _, k in keys}
        if len(tnk) > lattice["max_trace_keys"]:
            findings.append(Finding(
                PASS, ENGINE_FILE, 1, "off-lattice-key",
                f"replay predicts {len(tnk)} (t, np, k) keys but the "
                f"lattice only admits {lattice['max_trace_keys']}"))
    return report, findings
