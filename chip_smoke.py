#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Usage, from the root of a checkout::

    python3 chip_smoke.py

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and the torch
     version, and build the three CUDA kernels from ``src/repro_torch``
     with ``nvcc``, one compiler each, all at once (each timed), and
     beside them their checked build (``-DMSA_CHECK_BOUNDS``: device
     bounds asserts) for the memory check.
  2. Hold each kernel against its plain PyTorch version on the card, on
     the same inputs, at Llama-3.1-8B attention shapes (H 32, KH 8,
     D 128, page 16), in bf16 and f32:
     - fused: one mixed step of two multi-segment prefill chunks on
       non-contiguous block tables plus 32 decode rows with contexts up
       to 4k, and small cases with a sliding window, a softcap and
       all-padding tiles; a decode-only step of 32 rows (the fused
       serving run's commonest bucket) is timed as well; every case is
       launched twice and must give the same bits;
     - prefill: R 4 chunks of QP 128 (one with two gaps, one ragged, one
       empty, one full) with contexts up to 4k, and small cases with a
       window, a softcap and an all-padding step;
     - decode: B 64 rows, 32 with contexts up to 4k and 32 padding rows
       (ctx 1), and small window and softcap cases; and the decode
       kernel on the fused decode-only step's 32 rows;
     - both split kernels' main cases again at pieces of 8 to 128 pages
       (each timed and held to the plain version); every split case is
       launched twice and must give the same bits;
     - each kernel once more at Grok-1's attention shapes (H 48, KH 8, a
       GQA group of 6, D 128, softcap 30), timed beside its bound;
     - the fused kernel's (o, lse) mode (sharded serving's per-shard
       partial): one shard's half of a mixed step striped over 2 shards
       (timed), and small cases with a window shorter than a page, a
       softcap, one-page sequences (no local page on the other shard) and
       4 shards, each shard held to ``msa_fused_partial_ref`` (o and lse)
       with the same bits twice, the shards' partials merged against the
       full fused kernel;
     - a memory check in child processes: the small cases under
       ``compute-sanitizer --tool memcheck`` where the tool supports the
       device (it refuses the chip machines' cards, and the script says
       so); every case, the large ones included, through the kernels'
       checked build (device asserts hold every page, row, work-list,
       work-unit and partial index to its tensor's extent) over a
       guard-zone allocator built here with ``nvcc`` (every tensor its
       own allocation between 64 KB guards of 0xFF): no assert fired, no
       guard written, no NaN read, each kernel within tolerance.
     Kernel and plain version are timed with CUDA events (median of 20),
     each call queued behind a device sleep so that the events time the
     device alone, beside the bound; the kernels are timed once more from
     an idle device (``ms_with_enqueue``: the host's enqueue included, the
     method of earlier runs).
  3. Serve a multi-turn workload through ``AsymCacheServer.run`` with
     Llama-3.1-8B at full width and depth (bf16, random weights from a
     seeded generator) and a KV pool small enough to force evictions;
     check every request finished, one kernel launch per layer per step,
     and each request's first logits against the dense reference.
  3b. Serve the same workload in the split layout (``attn_mode="split"``):
     one prefill and one decode kernel launch per layer per step, the
     fused kernel never, first logits against the dense reference; then
     serve it once more in each layout on the model clock, where the
     schedule does not depend on the step times, and hold split to fused:
     the same steps, evictions, recomputed tokens and multi-segment
     chunks (at least one: a prefill chunk recomputed a history with
     gaps), equal first sampled ids, first logits within tolerance.
     The wall-clock runs of phases 3 and 3b report their multi-segment
     chunks but do not require one: on the wall clock the schedule, and
     so which pages are evicted before a session's next turn, follows
     the step times of the card and host.
  3c. The synchronous baseline of the paper's §5.3 (the JAX package's
     ``benchmarks/pipeline.py`` baseline): the same workload on the model
     clock through ``ServerConfig(pipeline_depth=0)`` and
     ``EngineConfig(attn_mode="split", assembly="legacy",
     return_full_logits=True, max_instep_copies=0)`` (per-token Python
     assembly with one host-to-device copy a field, the full (68, 128256)
     logits moved to the host every step, page copies eager), held to
     3b's model-clock split run, the overlapped arm (depth 1, vectorized,
     sampling on the card): the same steps, evictions, recomputed tokens
     and multi-segment chunks, the same generated tokens and sampled ids,
     first logits with the same bits, ``msa_prefill`` and ``msa_decode``
     launched L x steps times each and ``msa_fused`` never, every
     handle's logits (R+B, V); both arms' wall seconds, steps/s,
     control-plane seconds a step, mean assembly seconds, bytes moved to
     the host a step and the host seconds a step spent fetching them, and
     their ratio (one pair, not a claim); the (68, 128256) transfer alone
     from an idle device, to a fresh pageable array and to a pinned one.
  4. Profile a short serving run (``torch.profiler``, one request of
     phase 3's workload) in each layout:
     device time by kernel, the share of the kernels each attention call
     launches (the kernel and its merge: ``msa_fused``; ``msa_prefill``
     and ``msa_decode``), their device ms a call, the device's idle share,
     and in the split layout how many prefill launches had no valid row.
     Phases 3 and 3b also print the mean host seconds a step spends
     assembling its inputs (``StepHandle.assembly_time``).
  5. Serve six agentic jobs (2-4 tool calls each, contexts to ~3.9k
     tokens) through the closed-loop ``OnlineFrontend`` with predictive
     prefetch, over a server with a 384-block pool, a 512-block host tier
     and ``max_decode_steps`` 8 (k fused decode iterations a dispatch),
     same model: every session finishes, k-step dispatches and prefetch
     swap-ins happen, the fused kernel launches once a layer an
     iteration (``attn_dispatches``) and the split kernels never, one
     step variant a bucket, and each turn's first logits match the dense
     reference; TTFT, TPOT and job latency.  The same scripts at k = 1 on
     the wall clock (TPOT beside k = 8), then at k = 1 and k = 8 on the
     model clock over the first 4 layers (8 before phase 3c was added,
     whose time this cut helps pay for): equal outputs and first sampled
     ids, the share of equal ids, first logits within tolerance, fewer
     decode-only dispatches at k = 8.  Last, one decode-only plan as one
     k = 8 dispatch against 8 single dispatches on the same pools: the
     same bits in ids and pools.
  6. Quantized offload, same model cut to its first 2 layers (8 before
     phase 3c was added, whose time this cut helps pay for): phase 5's
     agentic scripts at k = 8 on the model clock with
     ``OffloadConfig(quant="int8", retain_host=True)``
     (int8 codes and scales on the wire, the pool snapped to the int8 grid
     at write time) against its control arm with full-precision payloads
     (``payload_fp=True``), then the same pair with ``quant="fp8"``: in
     each pair the same outputs, sampled ids and first logits bit for bit,
     equal swap-ins, and at most 0.51x the control's swap bytes.  A
     committed page spilled and restored by the eager and the in-step
     swap-in comes back with the same bits, and the fp8 codes of all 65536
     bf16 bit patterns are the same on the card and on the CPU.
  7. Free Llama's weights and serve Grok-1 (MoE: 8 experts, top 2, d_ff
     32768; d 6144, H 48, KH 8, vocab 131072, softcap 30) at full width,
     cut to 4 layers and dropless routing, bf16, random weights from seed
     0: three sessions of two turns through a pool that makes the second
     turns recompute part of their history, fused on the wall clock
     (launches, first logits against the dense forward, TTFT and TPOT),
     then fused against split on the model clock (the same schedule and
     first sampled ids, the share of equal ids), and a profile of a short
     fused run as phase 4 takes one.
  8. (before 7) Serve phase 3b's workload sharded over 2 shards, both on
     this card (``ServerConfig(n_shards=2, shard_devices=["cuda:0"] *
     2)``: page-sharded pools, the weights split by heads, ffn and vocab,
     each shard's attention in the (o, lse) mode, the partials merged), on
     the model clock, against the single-device fused run: the same
     schedule and first sampled ids, the share of equal ids, first logits
     within tolerance of it and of the dense reference, one (o, lse)
     launch a shard a layer a step, each shard's weight bytes; then over
     4 shards on the first of the 4 sessions (2 before phase 3c was
     added); a profile of one request at N = 2.
  9. (after 7, Grok-1 freed) The full model (``repro_torch.models``:
     ``forward``, ``init_decode_state``, ``prep_cross_attention``,
     ``decode_step``; plain PyTorch, no kernel of its own) at full width
     and depth, bf16, random weights from seed 0, wq/wk at fan-in:
     Gemma-3-12B (2 × 2048 tokens: the banded forward against the chunked
     one, a prefill of 2016 tokens whose K/V seed the decode cache, 32
     teacher-forced steps past its 1024 window), Mamba2-780m (2 × 512
     from position 0, across chunks of 256), Hymba-1.5B (1 × 2112 from
     position 0, across its 2048 window), Whisper-large-v3 (128 decoder
     tokens over 2 × 1500 random encoder frames); each step's logits held
     to the forward's (bf16 < 5e-2; Mamba2-780m, whose reference misses
     that bar itself, < 1.5x the reference's own gap); prefill ``forward`` ms
     (``last_only``, ``return_kv``; CUDA events, median of 5), decode ms a
     token on the wall clock and on the device alone (profiler), peak
     device memory.  Then the same in float32 (TF32 off; < 2e-3, the JAX
     package's bar), Gemma-3 cut to its first 12 layers, Mamba2-780m to
     24 and Hymba-1.5B to 16 (full depth before phase 3c was added).
  10. (after 9, everything freed) Training (``repro_torch.training``;
     autograd over the full model, no kernel of its own), bf16, AdamW,
     remat on, random weights from seed 0 with wq/wk at fan-in, TF32
     off: (a) Llama-3.1-8B at full width cut to its first 8 layers
     (2.80B parameters), ``DataConfig(seq_len=2048, global_batch=4,
     seed=17)``, ``grad_accum`` 2, 8 steps through ``Trainer.run``: every
     loss and grad norm finite, the last loss below the first, the first
     step's loss within 1e-2 of a float32 copy of the same weights on the
     same batch (computed first and freed); tokens/s on the wall over
     steps 2-8, device ms a step (CUDA events), peak memory, the share of
     989 TFLOP/s; (b) in a child process under deterministic algorithms
     (``CUBLAS_WORKSPACE_CONFIG=:4096:8``), one forward and backward of
     (a)'s model at 1 x 2048 with remat on and off: the same bits in the
     loss and every gradient leaf, each arm's ms and peak memory;
     (c) Mamba2-780m at full width and depth, 2 x 2048 tokens, 4 steps:
     losses finite and falling, tokens/s, peak memory.

  11. The sharded full model (``repro_torch.distributed``: the mesh,
     ``make_context``, ``shard_decode_state``, ``sharded_decode_attention``,
     ``moe_ffn_alltoall``; plain PyTorch, every shard on this card) and
     the serving launcher: (a, after 8, on phase 3's Llama-3.1-8B weights)
     ``decode_step`` under ``make_context(cfg, mesh, "decode")`` over a
     sequence-sharded cache against the unsharded ``decode_step`` on the
     same random caches, 8 teacher-forced tokens, in bf16 and in float32
     (a copy of the weights): meshes (1, 2) and (1, 4) at B 4 with
     contexts 8192, 6000, 3000 and 1, and (2, 2) at B 1 with 32768 (the
     cache's sequence over (data, model)); the worst relative logit
     error (float32 < 2e-3; bf16 printed beside the unsharded bf16
     step's own gap from float32), the share of equal argmaxes, ms a
     token sharded and unsharded (CUDA events), one max and two sums a
     layer; (b, after 10) Kimi-K2-1T-A32B at full width cut to 1 layer
     (19.4 B parameters, 36.1 GiB), a forward of 4 x 256 tokens under
     ``moe_alltoall`` on the (data 4, model 2) mesh, dropless against the
     local MoE (< 5e-2), then at capacity factor 1.25 (dropped slots of
     each data shard, finite logits), 2 all-to-alls and 1 sum a layer, ms
     and peak memory; (c) ``python -m repro_torch.launch.serve``'s
     ``real``, ``online``, ``--devices 2 --device cuda:0`` and ``sim`` in
     process at the reference's smoke scale (every request finishes, the
     fused kernel once a layer a step or the (o, lse) mode once a shard a
     layer a step, first logits < 2e-3 of the dense reference), and
     ``--devices 2`` refused on a one-card machine, naming ``cuda:1``.
  12. The dry run (``repro_torch.launch.dryrun``: shapes on the meta
     device, FLOPs by ``FlopCounterMode``, bytes from the sharding trees)
     held against the card, each part where its model is already there:
     (c, after 3) the lattice auditor's footprint (``analysis.lattice``)
     of the largest bucket phase 3's fused Llama-3.1-8B run dispatched,
     plus the pool and the parameters, against phase 3's measured peak;
     (b, after 11 a, phase 3's weights) Llama-3.1-8B decode at B 4
     (contexts 8192, 6000, 3000 and 1, phase 11's cache): at (1, 1) the
     dry run's FLOPs a step equal ``FlopCounterMode``'s count of a real
     step on the card, and at (1, 2) its logged collectives a step equal
     phase 11's ``CollectiveLog`` (96 all-reduces: one max and two sums a
     layer); (a, after 10) phase 10's Llama-3.1-8B train cell (8 layers,
     4 x 2048, ``grad_accum`` 2, AdamW, bf16, remat) under its (1, 1)
     train context: argument bytes equal the step's params, optimizer
     state and (int32) batch on the card, the dry run's FLOPs equal the
     count of a real step, and the measured peak over the predicted one
     lies in ``DRYRUN_PEAK_BAND``; the CUDA-event ms of a step beside the
     roofline's bound.  One ``dryrun:`` JSON line a case, after the card
     line.
  13. The examples (``repro_torch.examples``), through their ``run``
     functions: (a, after 12 b, on phase 3's Llama-3.1-8B bf16 weights)
     ``prefix_sharing`` at full width and depth, the example's own
     workload (10 jobs, 80% behind a 280-token preamble, 320 blocks) with
     sharing on and then off on the model clock: every request finished,
     ``msa_fused`` launched L x the engine steps of both arms,
     copy-on-write forks, fewer prefill tokens computed with sharing, each
     request's first logits within ``FULL_TOL["bfloat16"]`` of the dense
     reference, the share of equal first sampled ids between the arms;
     (b, last) each example at the JAX package's sizes on the float32
     smoke Llama: ``quickstart`` and ``prefix_sharing`` (their asserts;
     L x steps launches), ``serve_multiturn --real``, ``serve_online``
     (its asserts; launches ``attn_dispatches``), ``train_lm``
     (``CONFIG_100M``, 20 steps into ``build/``, resumed to 30: the resume
     starts at 20, the loss falls; one more step profiled), and one short
     run of each simulation (no kernel launch).
  14. (after 13 a, on phase 3's Llama-3.1-8B bf16 weights) The
     recomputation cost model fitted on the card: 128 page-aligned
     two-segment instances (l1, q1, l2, q2) built by hand through the
     block manager (l1 0-2048, q1 16-384, l2 0-1024, q2 16-256, a chunk of
     q1 + q2 <= 512, contexts to ~3.7k; an engine of its own, one chunk
     of 512 over 256 pages).  The three deepest are first made resident
     (every position computed, the q1 and q2 segments then evicted to
     fresh pages) and their two-segment step's first logits held to the
     dense reference (< 5e-2).  Each instance is dispatched in a warm-up
     round (layer 0's ``msa_fused`` inputs captured, the kernel timed
     alone on them) and three timed rounds (CUDA events around
     ``Engine.dispatch`` and a sync; an instance's median); both times
     fitted to Eq. 6 with ``core.fit``; ``msa_fused`` launches L x the
     dispatches; the pinned host->device and device->host copy rates (and
     the pageable host->device one) at one block's K and V payload.

Phase 3c prints one ``sync_vs_overlapped:`` JSON line (with the card
line).  Phase 9 prints one ``full_model:`` JSON line a model and dtype,
phase 10 one ``train:`` line a run and one ``train_remat:`` line, phase
11 one ``sharded_model:`` line a run, phase 12 one ``dryrun:`` line a
case, phase 13 one ``example:`` line an example, phase 14 one
``cost_fit:`` line a fit (the step, the kernel: k1..k6, β, R², Eq. 7's
slope beside the analytic H100 model's and its median error against the
steps) and a ``cost_model:`` line (checks, launches, link rates, every
instance's two times) (each with the card line).  Prints the total
seconds of the phases, then the card line again, the (o, lse) mode's row
and the kernel table (all three kernels) as JSON lines, and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Each phase is a function; ``main`` runs them all in order (phases 12, 13
and 14 after the phases whose models they reuse).
Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# Grok-1's attention shapes (src/repro_torch/configs/grok_1_314b.py)
GROK_ATTN = dict(H=48, KH=8, D=128, page=16)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per dtype
# Same tolerances as the repo's kernel tests (tests/test_kernels.py):
# f32 — kernel and plain version both accumulate in float32 and differ
# only in summation order; bf16 — both round the same float32 result to
# bf16 once, so an output can differ by one bf16 step near a rounding
# boundary (2^-8 relative).
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# First logits of the paged bf16 serving path vs the dense bf16 forward,
# max |diff| / max |ref|: bf16 keeps 8 significant bits (2^-9 ≈ 2e-3 per
# rounding), and the two paths round at different places (paged kernel vs
# dense attention, GEMMs of other shapes, recomputed KV) through 32
# residual layers.
LOGIT_REL_TOL = 5e-2
# ~1 ms of device sleep (at ~2 GHz) queued ahead of a timed call: longer
# than the host takes to enqueue one kernel call
SLEEP_CYCLES = 2_000_000


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _median_ms(fn, iters: int = 20, warmup: int = 3,
               device_only: bool = True) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()``.  With
    ``device_only`` each timed call is queued behind a ~1 ms device sleep,
    so the events see the device's work alone; without it the timing
    starts on an idle device and includes the host's time to enqueue the
    call (the method of earlier runs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def _step_case(rng, *, H, KH, D, page, prefills, decode_ctx, t_bucket,
               q_tile, window=0, softcap=0.0, shards=1):
    """A mixed varlen step in the engine's layout: prefill chunks (each
    ``(ctx, [(lo, hi), ...])`` position runs) packed first, then decode
    rows, then bucket slack.  Every sequence owns disjoint, shuffled
    (non-contiguous) pool pages.  ``shards > 1``: the pool is ``shards``
    runs of ``p_loc`` pages and page j of sequence s lies on shard
    (s + j) % shards, as the block manager stripes a sharded pool."""
    from repro_torch.kernels.msa import build_units, build_worklist, \
        pad_worklist
    ctxs = [c for c, _ in prefills] + list(decode_ctx)
    runs = [np.concatenate([np.arange(lo, hi) for lo, hi in segs])
            for _, segs in prefills]
    runs += [np.asarray([c - 1]) for c in decode_ctx]
    n = len(ctxs)
    n_pages = [-(-c // page) for c in ctxs]
    NP = max(n_pages)
    bt = np.zeros((n, NP), np.int32)
    p_loc = 0
    if shards == 1:
        P = sum(n_pages) + 1
        perm = rng.permutation(P)
        off = 0
        for s, k in enumerate(n_pages):
            bt[s, :k] = perm[off:off + k]
            off += k
    else:
        owner = [[(s + j) % shards for j in range(k)]
                 for s, k in enumerate(n_pages)]
        p_loc = max(sum(o.count(i) for o in owner)
                    for i in range(shards)) + 1
        P = shards * p_loc
        local = [iter(rng.permutation(p_loc)) for _ in range(shards)]
        for s, o in enumerate(owner):
            bt[s, :len(o)] = [i * p_loc + next(local[i]) for i in o]
    q_len = np.asarray([len(r) for r in runs], np.int32)
    q_start = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    real = int(q_len.sum())
    assert real <= t_bucket
    q_pos = np.zeros((t_bucket,), np.int32)
    q_pos[:real] = np.concatenate(runs)
    seq_ids = np.zeros((t_bucket,), np.int32)
    seq_ids[:real] = np.repeat(np.arange(n), q_len)
    valid = np.zeros((t_bucket,), bool)
    valid[:real] = True
    ctx = np.asarray(ctxs, np.int32)
    tq = min(q_tile, t_bucket)
    n_tiles = -(-t_bucket // tq)
    wl, count = build_worklist(q_start, q_len, ctx, bt, q_pos, page=page,
                               q_tile=tq, n_tiles=n_tiles, window=0)
    wl = pad_worklist(wl, 1 << (count - 1).bit_length(), sentinel_seq=n)
    units = build_units(wl, q_start, q_len, n_rows=t_bucket, q_tile=tq,
                        n_tiles=n_tiles)
    # bytes the function must move: every pool page a real item names
    # (K and V, all kv heads, read once), q read once, output written once
    real_items = wl["wl_seq"][:count] < n
    pages_read = np.unique(wl["wl_slot"][:count][real_items]).size
    # operations: 2 flops for q.k and 2 for p.v per (row, head, key, dim)
    # over the keys each real row attends
    keys = np.minimum(q_pos[:real] + 1, ctx[seq_ids[:real]])
    if window > 0:
        keys = np.minimum(keys, window)
    return dict(
        q=rng.standard_normal((t_bucket, H, D)).astype(np.float32),
        k=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        v=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        bt=bt, ctx=ctx, q_pos=q_pos, seq_ids=seq_ids, valid=valid,
        wl=wl, units=units, q_start=q_start, q_len=q_len, shards=shards,
        p_loc=p_loc, real=real, window=window, softcap=softcap, q_tile=tq,
        pages_read=pages_read, flops=4.0 * float(keys.sum()) * H * D)


def _bound(nbytes, flops, dtype_name):
    """The least time the card could take: bytes over the memory rate or
    operations over the dtype's peak, whichever is larger."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bytes": nbytes}


def _fused_fns(case, dtype_name):
    """The fused kernel and its plain version on the case's tensors, moved
    to the card in ``dtype_name``, as two closures."""
    import torch
    from repro_torch.kernels.msa import UNIT_FIELDS, WL_FIELDS, msa_fused
    from repro_torch.kernels.msa.ref import msa_fused_ref
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    f = {k: torch.from_numpy(np.asarray(case[k])).to(dev)
         for k in ("bt", "ctx", "q_pos", "seq_ids", "valid")}
    q = torch.from_numpy(case["q"]).to(dev, dt)
    kp = torch.from_numpy(case["k"]).to(dev, dt)
    vp = torch.from_numpy(case["v"]).to(dev, dt)
    wl = tuple(torch.from_numpy(case["wl"][name]).to(dev)
               for name in WL_FIELDS)
    units = tuple(torch.from_numpy(case["units"][name]).to(dev)
                  for name in UNIT_FIELDS)
    kw = dict(window=case["window"], softcap=case["softcap"])

    def kernel():
        return msa_fused(q, kp, vp, f["bt"], f["ctx"], f["q_pos"],
                         f["seq_ids"], f["valid"], worklist=wl, units=units,
                         q_tile=case["q_tile"], **kw)

    def plain():
        return msa_fused_ref(q, kp, vp, f["bt"], f["ctx"], f["q_pos"],
                             f["seq_ids"], f["valid"], **kw)

    return kernel, plain


def _run_case(case, dtype_name, *, time_it=False):
    import torch
    kernel, plain = _fused_fns(case, dtype_name)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    slack_zero = bool((got[case["real"]:] == 0).all())
    n_units, n_merges = (int(x) for x in case["units"]["unit_counts"])
    out = {"max_abs_err": err, "slack_zero": slack_zero,
           "finite": bool(torch.isfinite(got).all()),
           "same_bits_twice": bool(torch.equal(got, again)),
           "units": n_units, "cut_runs": n_merges}
    if time_it:
        out["ms"] = _median_ms(kernel)
        out["ms_with_enqueue"] = _median_ms(kernel, device_only=False)
        out["plain_ms"] = _median_ms(plain)
        itemsize = got.element_size()
        T, H, D = got.shape
        _, page, KH, _ = case["k"].shape
        nbytes = (2 * case["pages_read"] * page * KH * D * itemsize
                  + 2 * T * H * D * itemsize)
        out.update(_bound(nbytes, case["flops"], dtype_name))
    del got, want
    return out


def fused_cases():
    """Phase 2's fused cases, from seed 0: the mixed step, the decode-only
    step and the small cases (a dict)."""
    from repro_torch.serving import EngineConfig
    rng = np.random.default_rng(0)
    llama = dict(H=32, KH=8, D=128, page=16)
    q_tile = EngineConfig(num_pages=1).q_tile    # the engine's q tile
    decode_ctx = rng.integers(64, 4097, size=32)
    main = _step_case(
        rng, **llama, q_tile=q_tile, t_bucket=640,
        prefills=[(1536, [(256, 400), (1408, 1536)]),
                  (2304, [(1000, 1100), (2100, 2304)])],
        decode_ctx=decode_ctx)
    # the serving run's commonest bucket: a decode-only step (T 40)
    decode = _step_case(rng, **llama, q_tile=q_tile, t_bucket=40,
                        prefills=[],
                        decode_ctx=rng.integers(64, 4097, size=32))
    small = {
        "window": _step_case(
            rng, **llama, q_tile=32, t_bucket=96, window=300,
            prefills=[(900, [(100, 140), (870, 900)])],
            decode_ctx=rng.integers(200, 1200, size=6)),
        "softcap": _step_case(
            rng, **llama, q_tile=8, t_bucket=72, softcap=30.0,
            prefills=[(500, [(0, 20), (480, 500)])],
            decode_ctx=rng.integers(1, 700, size=8)),
        # 5 real rows in a 128-row bucket: three whole tiles of padding
        "all_padding_tiles": _step_case(
            rng, **llama, q_tile=32, t_bucket=128,
            prefills=[(40, [(37, 40)])], decode_ctx=[17, 333]),
    }
    # Grok-1's attention (phase 7): a GQA group of 6 heads and softcap 30,
    # a multi-segment chunk (272 rows) and 32 decode rows
    grok = _step_case(
        rng, **GROK_ATTN, q_tile=q_tile, t_bucket=320, softcap=30.0,
        prefills=[(1536, [(256, 400), (1408, 1536)])],
        decode_ctx=rng.integers(64, 1700, size=32))
    return main, decode, small, grok


def kernel_phase():
    main, decode, small, grok = fused_cases()
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        results[("main", dtype_name)] = _run_case(main, dtype_name,
                                                  time_it=True)
        results[("decode", dtype_name)] = _run_case(decode, dtype_name,
                                                    time_it=True)
        results[("grok_g6", dtype_name)] = _run_case(grok, dtype_name,
                                                     time_it=True)
        for name, case in small.items():
            results[(name, dtype_name)] = _run_case(case, dtype_name)
    for (name, dtype_name), res in results.items():
        tol = KERNEL_TOL[dtype_name]
        line = {"case": name, "dtype": dtype_name, "tol": tol,
                **{k: v for k, v in res.items()}}
        print("kernel_check " + json.dumps(line), flush=True)
        if not (res["finite"] and res["slack_zero"]
                and res["same_bits_twice"] and res["max_abs_err"] <= tol):
            raise AssertionError(f"msa_fused kernel disagrees: {line}")
    return results, decode


# ---------------------------------------------------------------------------
# phase 2, sharded serving: the fused kernel's (o, lse) mode
# ---------------------------------------------------------------------------

def _shard_view(case, shard):
    """Shard ``shard``'s part of a striped case (``_step_case(...,
    shards=N)``): its pool pages, its table of local slots and which
    entries are local, its work-list (``build_worklist(...,
    page_valid=...)``) and units, the pages it reads and the operations
    of the keys its rows see."""
    from repro_torch.kernels.msa import build_units, build_worklist, \
        pad_worklist
    p_loc, bt, page = case["p_loc"], case["bt"], case["k"].shape[1]
    lo = shard * p_loc
    page_valid = (bt >= lo) & (bt < lo + p_loc)
    table = np.where(page_valid, bt - lo, 0).astype(np.int32)
    n, T, tq = bt.shape[0], case["q"].shape[0], case["q_tile"]
    n_tiles = -(-T // tq)
    wl, count = build_worklist(
        case["q_start"], case["q_len"], case["ctx"], table, case["q_pos"],
        page=page, q_tile=tq, n_tiles=n_tiles, window=0,
        page_valid=page_valid)
    wl = pad_worklist(wl, 1 << (count - 1).bit_length(), sentinel_seq=n)
    units = build_units(wl, case["q_start"], case["q_len"], n_rows=T,
                        q_tile=tq, n_tiles=n_tiles)
    real_items = wl["wl_seq"][:count] < n
    # keys each real row sees on this shard's pages
    keys = 0
    for r in range(case["real"]):
        s = case["seq_ids"][r]
        hi = min(int(case["q_pos"][r]), int(case["ctx"][s]) - 1)
        lo_k = max(0, hi - case["window"] + 1) if case["window"] else 0
        kv = np.arange(lo_k, hi + 1)
        keys += int(page_valid[s, kv // page].sum())
    H, D = case["q"].shape[1:]
    return dict(k=case["k"][lo:lo + p_loc], v=case["v"][lo:lo + p_loc],
                bt=table, page_valid=page_valid, wl=wl, units=units,
                pages_read=np.unique(wl["wl_slot"][:count][real_items]).size,
                flops=4.0 * keys * H * D)


def _partial_fns(case, view, dtype_name):
    """The (o, lse) mode and its plain version on one shard's view, on the
    card in ``dtype_name``."""
    import torch
    from repro_torch.kernels.msa import (UNIT_FIELDS, WL_FIELDS,
                                         msa_fused_partial)
    from repro_torch.kernels.msa.ref import msa_fused_partial_ref
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    f = {k: torch.from_numpy(np.asarray(case[k])).to(dev)
         for k in ("ctx", "q_pos", "seq_ids", "valid")}
    bt = torch.from_numpy(view["bt"]).to(dev)
    pv = torch.from_numpy(view["page_valid"]).to(dev)
    q = torch.from_numpy(case["q"]).to(dev, dt)
    kp = torch.from_numpy(view["k"]).to(dev, dt)
    vp = torch.from_numpy(view["v"]).to(dev, dt)
    wl = tuple(torch.from_numpy(view["wl"][name]).to(dev)
               for name in WL_FIELDS)
    units = tuple(torch.from_numpy(view["units"][name]).to(dev)
                  for name in UNIT_FIELDS)
    args = (q, kp, vp, bt, f["ctx"], f["q_pos"], f["seq_ids"], f["valid"],
            pv)
    kw = dict(window=case["window"], softcap=case["softcap"])

    def kernel():
        return msa_fused_partial(*args, worklist=wl, units=units,
                                 q_tile=case["q_tile"], **kw)

    def plain():
        return msa_fused_partial_ref(*args, **kw)

    return kernel, plain


# lse of a row with no visible key: NEG_INF, -0.7 * f32 max (the kernel's
# float product and the plain version's double one may round a bit apart)
_NO_KEY = -1e38


def _run_partial_case(case, dtype_name, *, time_it=False):
    """Every shard's (o, lse) against the plain version (o within the
    tolerance, lse within it where a key was seen and NEG_INF on the same
    rows where none was), the same bits twice, padding rows o = 0 and lse
    NEG_INF; then the shards' partials merged (``lse_merge``) against the
    full fused kernel and its plain version on the same step.  Times shard
    0 beside its bound."""
    import torch
    from repro_torch.distributed import ShardGroup, lse_merge
    out = {"shards": case["shards"], "max_abs_err": 0.0, "lse_err": 0.0,
           "same_no_key_rows": True, "same_bits_twice": True,
           "finite": True, "slack_zero": True, "no_key_rows": 0}
    parts, lses = [], []
    for i in range(case["shards"]):
        view = _shard_view(case, i)
        kernel, plain = _partial_fns(case, view, dtype_name)
        (o, lse), (o2, lse2) = kernel(), kernel()
        torch.cuda.synchronize()
        wo, wlse = plain()
        none = wlse <= _NO_KEY
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((o - wo).abs().max()))
        out["lse_err"] = max(out["lse_err"], float(
            (lse - wlse).abs()[~none].max()) if (~none).any() else 0.0)
        out["same_no_key_rows"] &= bool(torch.equal(lse <= _NO_KEY, none))
        out["no_key_rows"] += int(none.sum())
        out["same_bits_twice"] &= bool(torch.equal(o, o2)
                                       and torch.equal(lse, lse2))
        out["finite"] &= bool(torch.isfinite(o).all()
                              and torch.isfinite(lse).all())
        out["slack_zero"] &= bool((o[case["real"]:] == 0).all()
                                  and (lse[case["real"]:] <= _NO_KEY).all())
        parts.append(o)
        lses.append(lse)
        if time_it and i == 0:
            out["ms"] = _median_ms(kernel)
            out["ms_with_enqueue"] = _median_ms(kernel, device_only=False)
            out["plain_ms"] = _median_ms(plain)
            T, H, D = o.shape
            _, page, KH, _ = view["k"].shape
            # K/V of the pages read and q in the input type, o and lse f32
            item = torch.finfo(getattr(torch, dtype_name)).bits // 8
            nbytes = (2 * view["pages_read"] * page * KH * D * item
                      + T * H * D * item + T * H * (D + 1) * 4)
            out.update(_bound(nbytes, view["flops"], dtype_name))
        del wo, wlse
    group = ShardGroup(["cuda"] * case["shards"])
    merged = lse_merge(group, parts, lses)[0]
    full, full_plain = _fused_fns(case, dtype_name)
    got = full()
    dt = got.dtype
    out["merged_vs_kernel"] = float(
        (merged.to(dt).float() - got.float()).abs().max())
    out["merged_vs_plain"] = float(
        (merged.to(dt).float() - full_plain().float()).abs().max())
    return out


def partial_cases():
    """The (o, lse) mode's cases, from seed 1, striped over shards: half
    of phase 2's mixed step (2 shards), and small cases with a window
    shorter than a page (rows whose local keys are all masked), a softcap,
    sequences of one page (no local page on the other shard), and 4
    shards."""
    from repro_torch.serving import EngineConfig
    rng = np.random.default_rng(1)
    llama = dict(H=32, KH=8, D=128, page=16)
    q_tile = EngineConfig(num_pages=1).q_tile
    main = _step_case(
        rng, **llama, q_tile=q_tile, t_bucket=640, shards=2,
        prefills=[(1536, [(256, 400), (1408, 1536)]),
                  (2304, [(1000, 1100), (2100, 2304)])],
        decode_ctx=rng.integers(64, 4097, size=32))
    small = {
        "window": _step_case(
            rng, **llama, q_tile=32, t_bucket=96, window=12, shards=2,
            prefills=[(900, [(100, 140), (870, 900)])],
            decode_ctx=rng.integers(200, 1200, size=6)),
        "softcap": _step_case(
            rng, **llama, q_tile=8, t_bucket=72, softcap=30.0, shards=2,
            prefills=[(500, [(0, 20), (480, 500)])],
            decode_ctx=rng.integers(1, 700, size=8)),
        "no_local_page": _step_case(
            rng, **llama, q_tile=32, t_bucket=128, shards=2,
            prefills=[(12, [(9, 12)])], decode_ctx=[5, 16, 9, 333]),
        "four_shards": _step_case(
            rng, **llama, q_tile=16, t_bucket=96, shards=4,
            prefills=[(700, [(10, 40), (650, 700)])],
            decode_ctx=rng.integers(1, 900, size=8)),
    }
    return main, small


def partial_kernel_phase():
    """The (o, lse) mode of the fused kernel against its plain version,
    and the shards' merged partials against the full kernel."""
    main, small = partial_cases()
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        results[("main", dtype_name)] = _run_partial_case(
            main, dtype_name, time_it=True)
        for name, case in small.items():
            results[(name, dtype_name)] = _run_partial_case(case,
                                                            dtype_name)
    for (name, dtype_name), res in results.items():
        tol = KERNEL_TOL[dtype_name]
        line = {"kernel": "msa_fused_partial", "case": name,
                "dtype": dtype_name, "tol": tol, **res}
        print("kernel_check " + json.dumps(line), flush=True)
        if not (res["finite"] and res["slack_zero"]
                and res["same_bits_twice"] and res["same_no_key_rows"]
                and res["max_abs_err"] <= tol and res["lse_err"] <= tol
                and res["merged_vs_kernel"] <= tol
                and res["merged_vs_plain"] <= tol):
            raise AssertionError(f"msa_fused (o, lse) mode disagrees: "
                                 f"{line}")
    if not any(results[(n, d)]["no_key_rows"] for n in ("window",
                                                        "no_local_page")
               for d in ("bfloat16", "float32")):
        raise AssertionError("no case had a row without a visible local "
                             "key")
    return results


# ---------------------------------------------------------------------------
# phase 2, split layout: the prefill and decode kernels vs plain versions
# ---------------------------------------------------------------------------

def _tables(rng, ctxs, page):
    """Block tables of sequences with disjoint, shuffled (non-contiguous)
    pool pages; the pool size."""
    n_pages = [-(-int(c) // page) for c in ctxs]
    NP = max(n_pages)
    P = sum(n_pages) + 1
    perm = rng.permutation(P)
    bt = np.zeros((len(ctxs), NP), np.int32)
    off = 0
    for s, k in enumerate(n_pages):
        bt[s, :k] = perm[off:off + k]
        off += k
    return bt, P


def _visible(q_pos, ctx, window, page):
    """Keys and pages one valid row at q_pos sees."""
    hi = min(int(q_pos), int(ctx) - 1)
    lo = max(0, int(q_pos) - window + 1) if window > 0 else 0
    if hi < lo:
        return 0, range(0)
    return hi - lo + 1, range(lo // page, hi // page + 1)


def _prefill_case(rng, *, H, KH, D, page, QP, chunks, window=0,
                  softcap=0.0):
    """R padded chunks, each ``(ctx, [(lo, hi), ...])`` position runs
    (none: an empty chunk), on non-contiguous pages; the pages and
    operations the valid rows need."""
    ctxs = [c for c, _ in chunks]
    bt, P = _tables(rng, ctxs, page)
    R = len(chunks)
    q_pos = np.zeros((R, QP), np.int32)
    q_lens = np.zeros((R,), np.int32)
    slots, keys = set(), 0
    for r, (c, segs) in enumerate(chunks):
        pos = np.concatenate([np.arange(lo, hi) for lo, hi in segs]) \
            if segs else np.zeros((0,), np.int64)
        q_pos[r, :len(pos)] = pos
        q_lens[r] = len(pos)
        for p in pos:
            n, pages = _visible(p, c, window, page)
            keys += n
            slots.update(int(bt[r, j]) for j in pages)
    return dict(
        args=(rng.standard_normal((R, QP, H, D)).astype(np.float32),
              rng.standard_normal((P, page, KH, D)).astype(np.float32),
              rng.standard_normal((P, page, KH, D)).astype(np.float32),
              bt, np.asarray(ctxs, np.int32), q_pos, q_lens),
        window=window, softcap=softcap, pages_read=len(slots),
        flops=4.0 * keys * H * D, rows_in=int(q_lens.sum()), rows_out=R * QP)


def _decode_case(rng, *, H, KH, D, page, ctx_active, n_pad, window=0,
                 softcap=0.0):
    """Decode rows with contexts ``ctx_active`` on non-contiguous pages,
    then ``n_pad`` padding rows as the serving engine makes them (ctx 1,
    an all-zero block table: slot 0 is a real page, read and never
    selected)."""
    bt_act, P = _tables(rng, ctx_active, page)
    B = len(ctx_active) + n_pad
    bt = np.zeros((B, bt_act.shape[1]), np.int32)
    bt[:len(ctx_active)] = bt_act
    ctx = np.ones((B,), np.int32)
    ctx[:len(ctx_active)] = ctx_active
    slots, keys = set(), 0
    for b in range(B):
        n, pages = _visible(ctx[b] - 1, ctx[b], window, page)
        keys += n
        slots.update(int(bt[b, j]) for j in pages)
    return dict(
        args=(rng.standard_normal((B, H, D)).astype(np.float32),
              rng.standard_normal((P, page, KH, D)).astype(np.float32),
              rng.standard_normal((P, page, KH, D)).astype(np.float32),
              bt, ctx),
        window=window, softcap=softcap, pages_read=len(slots),
        flops=4.0 * keys * H * D, rows_in=B, rows_out=B)


def _split_fns(kind, case, dtype_name):
    """The ``kind`` ("prefill" or "decode") kernel and its plain version on
    the case's tensors, moved to the card in ``dtype_name``: two closures
    and the tensors."""
    import torch
    from repro_torch.kernels.msa import msa_decode, msa_prefill
    from repro_torch.kernels.msa.ref import msa_decode_ref, msa_prefill_ref
    dt = getattr(torch, dtype_name)
    args = [torch.from_numpy(a).to("cuda", dt) if a.dtype == np.float32
            else torch.from_numpy(a).to("cuda") for a in case["args"]]
    kw = dict(window=case["window"], softcap=case["softcap"])
    kernel_fn, plain_fn = ((msa_prefill, msa_prefill_ref) if kind == "prefill"
                           else (msa_decode, msa_decode_ref))

    def kernel():
        return kernel_fn(*args, **kw)

    def plain():
        return plain_fn(*args, **kw)

    return kernel, plain, args


def _run_split_case(kind, case, dtype_name, *, time_it=False):
    import torch
    dev = torch.device("cuda")
    kernel, plain, args = _split_fns(kind, case, dtype_name)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = plain()
    out = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "finite": bool(torch.isfinite(got).all()), "padding_zero": True,
           "same_bits_twice": bool(torch.equal(got, again))}
    if kind == "prefill":
        q_lens = args[6]
        pad = (torch.arange(got.shape[1], device=dev)[None, :]
               >= q_lens[:, None])
        out["padding_zero"] = bool((got[pad] == 0).all())
    if time_it:
        out["ms"] = _median_ms(kernel)
        out["ms_with_enqueue"] = _median_ms(kernel, device_only=False)
        out["plain_ms"] = _median_ms(plain)
        q, kp = args[0], args[1]
        _, page, KH, D = kp.shape
        H, itemsize = q.shape[-2], q.element_size()
        # K and V of each needed page, q of the rows the kernel reads (a
        # prefill padding row is never read) and o of every row it writes
        nbytes = (2 * case["pages_read"] * page * KH * D
                  + (case["rows_in"] + case["rows_out"]) * H * D) * itemsize
        out.update(_bound(nbytes, case["flops"], dtype_name))
    del got, want
    return out


def split_cases():
    """Phase 2's split cases, from seed 1: the prefill and decode main
    cases and the small cases (a dict keyed by (kernel, case))."""
    rng = np.random.default_rng(1)
    llama = dict(H=32, KH=8, D=128, page=16)
    main_prefill = _prefill_case(rng, **llama, QP=128, chunks=[
        # a multi-segment recompute: two gaps in its positions
        (3000, [(200, 240), (1500, 1540), (2952, 3000)]),
        (4096, [(3999, 4096)]),          # ragged: q_lens 97
        (2048, []),                      # empty: q_lens 0, exact zeros
        (1152, [(1024, 1152)])])         # full
    decode_ctx = rng.integers(64, 4097, size=32)
    main_decode = _decode_case(rng, **llama, ctx_active=decode_ctx,
                               n_pad=32)
    small = {
        ("prefill", "window"): _prefill_case(
            rng, **llama, QP=64, window=300, chunks=[
                (900, [(100, 140), (876, 900)]), (600, [(560, 600)])]),
        ("prefill", "softcap"): _prefill_case(
            rng, **llama, QP=32, softcap=30.0, chunks=[
                (500, [(0, 20), (488, 500)]), (77, [(70, 77)])]),
        ("prefill", "all_padding"): _prefill_case(
            rng, **llama, QP=128, chunks=[(4096, []), (1000, []),
                                          (17, []), (2500, [])]),
        ("decode", "window"): _decode_case(
            rng, **llama, window=300,
            ctx_active=rng.integers(1, 2000, size=12), n_pad=4),
        ("decode", "softcap"): _decode_case(
            rng, **llama, softcap=30.0,
            ctx_active=rng.integers(1, 2000, size=12), n_pad=4),
    }
    # Grok-1's attention (phase 7), timed: a GQA group of 6, softcap 30
    grok = {
        ("prefill", "grok_g6"): _prefill_case(
            rng, **GROK_ATTN, QP=128, softcap=30.0, chunks=[
                (1536, [(256, 300), (1452, 1536)]), (1700, [(1600, 1700)]),
                (900, []), (512, [(384, 512)])]),
        ("decode", "grok_g6"): _decode_case(
            rng, **GROK_ATTN, softcap=30.0,
            ctx_active=rng.integers(64, 1700, size=32), n_pad=32),
    }
    return main_prefill, main_decode, small, grok


def _decode_only_as_split(fused_decode):
    """The fused kernel's decode-only step (32 rows) as a decode case."""
    n = len(fused_decode["ctx"])
    return dict(
        args=(fused_decode["q"][:n], fused_decode["k"], fused_decode["v"],
              fused_decode["bt"], fused_decode["ctx"]),
        window=0, softcap=0.0, pages_read=fused_decode["pages_read"],
        flops=fused_decode["flops"], rows_in=n, rows_out=n)


def split_kernel_phase(fused_results, fused_decode):
    """The prefill and decode kernels against their plain versions, and
    the decode kernel on the fused kernel's decode-only step."""
    import torch
    main_prefill, main_decode, small, grok = split_cases()
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        results[("prefill", "main", dtype_name)] = _run_split_case(
            "prefill", main_prefill, dtype_name, time_it=True)
        results[("decode", "main", dtype_name)] = _run_split_case(
            "decode", main_decode, dtype_name, time_it=True)
        for (kind, name), case in grok.items():
            results[(kind, name, dtype_name)] = _run_split_case(
                kind, case, dtype_name, time_it=True)
        for (kind, name), case in small.items():
            results[(kind, name, dtype_name)] = _run_split_case(
                kind, case, dtype_name)
    for (kind, name, dtype_name), res in results.items():
        tol = KERNEL_TOL[dtype_name]
        line = {"kernel": f"msa_{kind}", "case": name, "dtype": dtype_name,
                "tol": tol, **res}
        print("kernel_check " + json.dumps(line), flush=True)
        if not (res["finite"] and res["padding_zero"]
                and res["same_bits_twice"] and res["max_abs_err"] <= tol):
            raise AssertionError(f"msa_{kind} kernel disagrees: {line}")

    # the split kernels' free parameter, the pages of a piece of a long
    # range (the wrappers' default is 32): each setting timed and held to
    # the plain version (a setting changes the order of the sums, so the
    # bits may differ between settings)
    from repro_torch.kernels.msa import msa_decode_cuda, msa_prefill_cuda
    for kind, case, fn in (("prefill", main_prefill, msa_prefill_cuda),
                           ("decode", main_decode, msa_decode_cuda)):
        _, plain, args = _split_fns(kind, case, "bfloat16")
        want = plain().float()
        for piece_pages in (8, 16, 32, 64, 128):
            got = fn(*args, piece_pages=piece_pages)
            err = float((got.float() - want).abs().max())
            ms = _median_ms(lambda: fn(*args, piece_pages=piece_pages))
            print("piece_sweep " + json.dumps(
                {"kernel": f"msa_{kind}", "dtype": "bfloat16",
                 "piece_pages": piece_pages, "ms": ms, "max_abs_err": err,
                 "tol": KERNEL_TOL["bfloat16"]}), flush=True)
            if not err <= KERNEL_TOL["bfloat16"]:
                raise AssertionError(f"msa_{kind} disagrees at piece_pages "
                                     f"{piece_pages}: {err}")
        del args, want, got

    # the fused kernel's decode-only step (32 rows) through the decode
    # kernel: one page read per GQA group against the fused kernel's walk
    # of each head on its own
    same_step = _decode_only_as_split(fused_decode)
    for dtype_name in ("bfloat16", "float32"):
        dec = _run_split_case("decode", same_step, dtype_name, time_it=True)
        fused = fused_results[("decode", dtype_name)]
        line = {"step": "decode-only, 32 rows", "dtype": dtype_name,
                "msa_fused_ms": fused["ms"],
                "msa_fused_bound_ms": fused["bound_ms"],
                "msa_decode_ms": dec["ms"],
                "msa_decode_bound_ms": dec["bound_ms"],
                "msa_decode_max_abs_err": dec["max_abs_err"]}
        print("fused_vs_decode " + json.dumps(line), flush=True)
        if not (dec["finite"]
                and dec["max_abs_err"] <= KERNEL_TOL[dtype_name]):
            raise AssertionError(f"msa_decode kernel disagrees: {line}")
    torch.cuda.synchronize()
    return (results[("prefill", "main", "bfloat16")],
            results[("decode", "main", "bfloat16")])


# ---------------------------------------------------------------------------
# phase 2, memory check: phase 2's small cases under compute-sanitizer
# ---------------------------------------------------------------------------

# The guard-zone allocator of the memory check (``--memcheck guard``): a
# PyTorch pluggable CUDA allocator that gives every tensor its own
# cudaMalloc with GUARD bytes of 0xFF before and after it and fills the
# tensor itself with 0xFF (NaN in bf16 and f32, -1 in int32).  A write
# past either end of any tensor changes a guard, which the allocator
# checks when the tensor is freed and ``guard_check_live`` checks for the
# tensors still alive; a read past an end, or of an element no one wrote,
# brings a NaN into the result, which the check compares with the plain
# version.
_GUARD_SRC = r"""
#include <cuda_runtime.h>
#include <sys/types.h>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {
constexpr size_t kGuard = 1 << 16;
std::mutex mu;
std::unordered_map<void*, size_t> live;
long long n_checked = 0, n_bad = 0;

bool intact(void* user, size_t size) {
  std::vector<unsigned char> h(kGuard);
  unsigned char* lo = static_cast<unsigned char*>(user) - kGuard;
  for (unsigned char* g : {lo, lo + kGuard + size}) {
    if (cudaMemcpy(h.data(), g, kGuard, cudaMemcpyDeviceToHost) !=
        cudaSuccess)
      return false;
    for (unsigned char c : h)
      if (c != 0xFF) return false;
  }
  return true;
}
}  // namespace

extern "C" {
void* guard_malloc(ssize_t size, int device, void* stream) {
  unsigned char* p = nullptr;
  const size_t total = (size_t)size + 2 * kGuard;
  if (cudaMalloc(&p, total) != cudaSuccess) return nullptr;
  if (cudaMemset(p, 0xFF, total) != cudaSuccess ||
      cudaDeviceSynchronize() != cudaSuccess)
    return nullptr;
  std::lock_guard<std::mutex> lock(mu);
  live[p + kGuard] = (size_t)size;
  return p + kGuard;
}

void guard_free(void* ptr, ssize_t size, int device, void* stream) {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(mu);
  auto it = live.find(ptr);
  if (it == live.end()) return;
  ++n_checked;
  if (!intact(ptr, it->second)) ++n_bad;
  live.erase(it);
  cudaFree(static_cast<unsigned char*>(ptr) - kGuard);
}

// checks every live allocation; returns the guards found changed so far
long long guard_check_live() {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(mu);
  for (auto& kv : live) {
    ++n_checked;
    if (!intact(kv.first, kv.second)) ++n_bad;
  }
  return n_bad;
}

long long guard_checked() { return n_checked; }
}
"""


def _guard_allocator():
    """Build the guard-zone allocator with ``nvcc`` into ``build/`` and
    make it PyTorch's CUDA allocator (before any CUDA allocation); returns
    its library."""
    import ctypes
    import torch
    from repro_torch.kernels.msa import _build
    src = _build.BUILD_DIR / "guard_alloc.cu"
    so = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_GUARD_SRC)
    subprocess.run([_build._nvcc(), "-std=c++17", "-O2", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                   check=True, timeout=300)
    torch.cuda.memory.change_current_allocator(
        torch.cuda.memory.CUDAPluggableAllocator(str(so), "guard_malloc",
                                                 "guard_free"))
    lib = ctypes.CDLL(str(so))
    lib.guard_check_live.restype = ctypes.c_longlong
    lib.guard_checked.restype = ctypes.c_longlong
    return lib


def _memcheck_child(mode: str) -> None:
    """Phase 2's cases, each kernel launched once (the fused kernel, its
    (o, lse) mode, and the prefill and decode kernels), in bf16 and f32:
    the small cases under ``compute-sanitizer`` (``mode`` "sanitizer");
    every case, the large ones included (the mixed step, decode-only,
    R 4 x QP 128, B 64, G = 6, the (o, lse) half-step, the split main
    cases at pieces of 8 and 128 pages), over the guard-zone allocator
    (``mode`` "guard", started with ``MSA_CHECK_BOUNDS=1``, so the kernels
    are their checked build, whose device asserts hold every index to its
    tensor's extent).  There each launch is also synchronised and held to
    its plain version (a read past a tensor reads NaN), and every guard is
    checked at the end."""
    import torch
    from repro_torch.kernels.msa import _build
    lib = _guard_allocator() if mode == "guard" else None
    if lib is not None and not _build.checked():
        raise AssertionError("memcheck guard: the checked build is not on")
    fused_main, fused_decode, fused_small, fused_grok = fused_cases()
    partial_main, partial_small = partial_cases()
    split_prefill, split_decode, split_small, split_grok = split_cases()
    if lib is not None:
        fused_small = dict(fused_small, main=fused_main, decode=fused_decode,
                           grok_g6=fused_grok)
        partial_small = dict(partial_small, main=partial_main)
        split_small = {**split_small, **split_grok,
                       ("prefill", "main"): split_prefill,
                       ("decode", "main"): split_decode,
                       ("decode", "fused_decode_only"):
                           _decode_only_as_split(fused_decode)}
    launches, worst = 0, 0.0

    def check(got, want, dtype_name):
        nonlocal launches, worst
        launches += 1
        if lib is None:
            return
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError("memcheck: a kernel output holds NaN "
                                     "(an unwritten element, or a read "
                                     "past a tensor)")
            err = float((g.float() - w.float()).abs().max())
            worst = max(worst, err)
            if not err <= KERNEL_TOL[dtype_name]:
                raise AssertionError(f"memcheck: kernel disagrees ({err})")

    for dtype_name in ("bfloat16", "float32"):
        for case in fused_small.values():
            kernel, plain = _fused_fns(case, dtype_name)
            check([kernel()], [plain()], dtype_name)
        for case in partial_small.values():
            for i in range(case["shards"]):
                kernel, plain = _partial_fns(case, _shard_view(case, i),
                                             dtype_name)
                (o, lse), (wo, wlse) = kernel(), plain()
                seen = wlse > _NO_KEY
                check([o, lse[seen]], [wo, wlse[seen]], dtype_name)
        for (kind, _), case in split_small.items():
            kernel, plain, _ = _split_fns(kind, case, dtype_name)
            check([kernel()], [plain()], dtype_name)
    if lib is not None:
        from repro_torch.kernels.msa import msa_decode_cuda, msa_prefill_cuda
        for kind, case, fn in (("prefill", split_prefill, msa_prefill_cuda),
                               ("decode", split_decode, msa_decode_cuda)):
            _, plain, args = _split_fns(kind, case, "bfloat16")
            for piece_pages in (8, 128):
                check([fn(*args, piece_pages=piece_pages)], [plain()],
                      "bfloat16")
    torch.cuda.synchronize()
    line = {"mode": mode, "launches": launches,
            "checked_build": _build.checked()}
    if lib is not None:
        line.update(bad_guards=int(lib.guard_check_live()),
                    guarded_tensors=int(lib.guard_checked()),
                    max_abs_err=worst)
    print("memcheck_child: " + json.dumps(line), flush=True)
    if lib is not None and line["bad_guards"]:
        raise AssertionError(f"memcheck: {line['bad_guards']} guard zones "
                             "were written")


_PROBE_SRC = r"""
#include <cstdio>
__global__ void fill(float* x) { x[threadIdx.x] = threadIdx.x; }
int main() {
  float* x = nullptr;
  if (cudaMalloc(&x, 32 * sizeof(float)) != cudaSuccess) return 1;
  fill<<<1, 32>>>(x);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def memcheck_phase() -> dict:
    """The memory check of phase 2's cases, in child processes: the small
    ones under ``compute-sanitizer --tool memcheck`` (beside ``nvcc`` in
    the CUDA toolkit; a missing tool raises) with PyTorch's caching
    allocator off, failing on any error it reports, unless it refuses the
    device ("Device not supported", as it does in the machines this script
    has run on: then it says so); and every case through the kernels'
    checked build (``MSA_CHECK_BOUNDS=1``: device bounds asserts) over the
    guard-zone allocator, failing on an assert, a written guard, a NaN or
    a disagreement.  Returns each run's seconds and outcome."""
    import os
    from repro_torch.kernels.msa import _build
    tool = Path(_build._nvcc()).parent / "compute-sanitizer"
    if not tool.exists():
        raise RuntimeError(f"compute-sanitizer not found at {tool}")
    me = str(Path(__file__).resolve())
    # a 10-line CUDA program first: where the tool refuses the device it
    # says so at once, and the Python child under it is not run
    t0 = time.perf_counter()
    probe = _build.BUILD_DIR / "memcheck_probe"
    probe.parent.mkdir(parents=True, exist_ok=True)
    probe.with_suffix(".cu").write_text(_PROBE_SRC)
    subprocess.run([_build._nvcc(), "-o", str(probe),
                    str(probe.with_suffix(".cu"))], check=True, timeout=300)
    first = subprocess.run([str(tool), "--tool", "memcheck", str(probe)],
                           capture_output=True, text=True, timeout=300)
    refused = "Device not supported" in first.stdout + first.stderr
    out = {}
    for mode, cmd, env in (
            ("sanitizer", [str(tool), "--tool", "memcheck",
                           "--error-exitcode", "3", sys.executable, me,
                           "--memcheck", "sanitizer"],
             dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")),
            ("guard", [sys.executable, me, "--memcheck", "guard"],
             dict(os.environ, MSA_CHECK_BOUNDS="1"))):
        if mode == "sanitizer" and refused:
            run = first
        else:
            t0 = time.perf_counter()
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, timeout=600)
        report = (run.stdout + run.stderr).strip().splitlines()
        res = {"returncode": run.returncode,
               "seconds": time.perf_counter() - t0,
               "summary": [ln for ln in report if "ERROR SUMMARY" in ln
                           or "Assertion" in ln
                           or ln.startswith("memcheck_child")]}
        res["outcome"] = (
            "device not supported by the tool"
            if mode == "sanitizer" and refused
            else "ok" if run.returncode == 0 else "failed")
        print(f"memcheck {mode}: " + json.dumps(res), flush=True)
        if res["outcome"] == "failed":
            print("\n".join(report[-60:]), flush=True)
            raise AssertionError(f"memory check ({mode}) failed (exit "
                                 f"{run.returncode})")
        out[mode] = res
    return out


# ---------------------------------------------------------------------------
# phase 3: serve Llama-3.1-8B at full width through the port
# ---------------------------------------------------------------------------

def _kernel_counts():
    """The launch counters of the kernel wrappers: the three kernels and
    the fused kernel's (o, lse) mode."""
    from repro_torch.kernels.msa import (msa_decode_cuda, msa_fused_cuda,
                                         msa_fused_partial_cuda,
                                         msa_prefill_cuda)
    return {"msa_fused": msa_fused_cuda, "msa_prefill": msa_prefill_cuda,
            "msa_decode": msa_decode_cuda,
            "msa_fused_partial": msa_fused_partial_cuda}


def _counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (its result, the launches, its wall seconds)."""
    import torch
    counters = _kernel_counts()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {name: c.launches for name, c in counters.items()}, wall


def _measured_run(srv, serve):
    """Drive one serving run (``serve()``, over ``srv``) with every
    kernel's launch count set to 0 just before and read just after; count
    the prefill chunks whose compute positions have gaps (the
    multi-segment recompute of a history that was partly evicted), and
    keep each step's host assembly seconds (``StepHandle.assembly_time``)
    in ``res["assembly_s"]``."""
    import torch
    dispatch, seg_chunks, assembly = srv.engine.dispatch, [], []

    def counting_dispatch(plan):
        seg_chunks.extend(c for c in plan.prefills
                          if np.any(np.diff(c.positions) > 1))
        handle = dispatch(plan)
        assembly.append(handle.assembly_time)
        return handle

    srv.engine.dispatch = counting_dispatch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches, _ = _counted(serve)
    res["assembly_s"] = assembly
    return res, len(seg_chunks), launches


def _serve_line(wl, res, seg_chunks, launches):
    import torch
    return {
        "requests": len(wl), "finished": res["n_requests"],
        "steps": res["steps"], "evictions": res["evictions"],
        "multi_segment_chunks": seg_chunks,
        "prefill_compute_tokens": res["prefill_compute_tokens"],
        "prompt_tokens": res["prompt_tokens"],
        "bucket_counts": res["bucket_counts"],
        "attn_dispatches_per_step": res["attn_dispatches_per_step"],
        "kernel_launches": launches,
        "ttft_mean_s": res["ttft_mean"], "ttft_p90_s": res["ttft_p90"],
        "tpot_mean_s": res["tpot_mean"], "tpot_p90_s": res["tpot_p90"],
        "wall_s": res["wall_time"],
        "steps_per_s": res["steps"] / res["wall_time"],
        "assembly_mean_s": statistics.mean(res["assembly_s"]),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def llama_weights():
    """Llama-3.1-8B at full width and depth (32 layers, d 4096, bf16),
    random weights from seed 0 on the card, wq/wk at fan-in: phase 3's
    weights.  Returns (config, parameters)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("llama31-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)          # on the card
    # init_params draws wq/wk at 1/sqrt(H) like the reference's init; at
    # head_dim 128 that makes q and k of std ~11 and attention scores of
    # std ~128, a one-hot softmax whose winner flips with the last bf16
    # bit, so two correct bf16 paths disagree completely.  Rescaling both
    # to fan-in 1/sqrt(d_model) gives scores of std ~1 and a logit check
    # that can see a real fault.
    for name in ("wq", "wk"):
        params["blocks"][name].mul_(
            math.sqrt(cfg.n_heads / cfg.d_model))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    print(f"serve: {n_params} random {cfg.dtype} parameters in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def serve_phase():
    import torch
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     ServerConfig, WorkloadConfig,
                                     multi_turn_workload, reference_logits)
    base_bytes = torch.cuda.memory_allocated()
    cfg, params = llama_weights()

    def make_workload(**kw):
        return multi_turn_workload(WorkloadConfig(
            n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(512, 2048),
            output_len=(16, 32), qps=0.5, vocab=cfg.vocab_size, **kw))

    # 256 blocks of 16 tokens hold ~2 sessions' contexts: the workload's
    # later turns find part of their history evicted and recompute it
    num_blocks = 256

    def make_server(attn_mode="fused", clock="wall", n_shards=1, depth=1,
                    **ecfg_kw):
        # n_shards > 1: sharded serving, every shard on this one card;
        # depth: the server's pipeline depth (0: synchronous)
        ecfg = EngineConfig(num_pages=num_blocks, page_size=16,
                            max_prefills=4, max_chunk=128, max_decodes=64,
                            max_blocks_per_seq=128, attn_mode=attn_mode,
                            **ecfg_kw)
        return AsymCacheServer(
            cfg, params, ServerConfig(
                num_blocks=num_blocks, clock=clock, attn_mode=attn_mode,
                n_shards=n_shards, pipeline_depth=depth,
                shard_devices=["cuda:0"] * n_shards if n_shards > 1
                else None), ecfg=ecfg)

    # warm-up on a separate server so that the measured run's TTFT does not
    # carry cuBLAS and allocator start-up
    make_server().run(make_workload(seed=1)[:1])
    torch.cuda.synchronize()

    srv = make_server()
    wl = make_workload(seed=0)
    res, seg_chunks, launches = _measured_run(srv, lambda: srv.run(wl))
    peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    steps = srv.engine.steps_executed
    print("serve: " + json.dumps(_serve_line(wl, res, seg_chunks, launches)),
          flush=True)
    assert all(r.status == "finished" for r in wl), \
        [r.status for r in wl]
    assert res["n_requests"] == len(wl)
    assert res["evictions"] > 0, "the pool never evicted"
    # whether a later turn finds its history evicted with gaps depends on
    # the wall-clock step times; phase 3b requires a multi-segment chunk
    # on the model clock, whose schedule does not
    assert res["attn_dispatches_per_step"] == cfg.n_layers
    assert launches == {"msa_fused": cfg.n_layers * steps, "msa_prefill": 0,
                        "msa_decode": 0, "msa_fused_partial": 0}, \
        (launches, steps)

    worst, refs = 0.0, []
    for r in wl:
        ref = reference_logits(cfg, params, r.prompt_tokens)
        refs.append(ref)
        got = r.first_logits
        assert got is not None and got.shape == ref.shape
        assert np.all(np.isfinite(got))
        rel = _rel(got, ref)
        worst = max(worst, rel)
        print(f"serve: request {r.rid} prompt {len(r.prompt_tokens)} "
              f"rel_err {rel:.3e} argmax_match "
              f"{int(np.argmax(got)) == int(np.argmax(ref))}", flush=True)
    print(f"serve: worst first-logit rel err {worst:.3e} "
          f"(tolerance {LOGIT_REL_TOL})", flush=True)
    assert worst < LOGIT_REL_TOL, worst
    return dict(cfg=cfg, params=params, launches=launches,
                make_server=make_server, make_workload=make_workload, wl=wl,
                refs=refs, peak_bytes=peak_bytes, ecfg=srv.engine.ecfg,
                buckets_used=sorted(srv.engine.buckets_used))


# ---------------------------------------------------------------------------
# phase 3b: serve the same workload in the split layout
# ---------------------------------------------------------------------------

def split_serve_phase(fused):
    """The split layout's serving run (its kernel counts and metrics), and
    split held to fused on the model clock, where both layouts see the
    same arrivals at the same steps and so run the same schedule (the
    workload forces each request's output tokens)."""
    import torch
    cfg, make_server, make_workload = (fused["cfg"], fused["make_server"],
                                       fused["make_workload"])
    L = cfg.n_layers
    make_server("split").run(make_workload(seed=1)[:1])     # warm-up
    torch.cuda.synchronize()
    srv = make_server("split")
    wl = make_workload(seed=0)
    res, seg_chunks, launches = _measured_run(srv, lambda: srv.run(wl))
    steps = srv.engine.steps_executed
    print("serve_split: " + json.dumps(
        _serve_line(wl, res, seg_chunks, launches)), flush=True)
    assert all(r.status == "finished" for r in wl), [r.status for r in wl]
    assert res["n_requests"] == len(wl)
    assert res["attn_dispatches_per_step"] == 2 * L
    assert launches == {"msa_fused": 0, "msa_prefill": L * steps,
                        "msa_decode": L * steps, "msa_fused_partial": 0}, \
        (launches, steps)
    worst = 0.0
    for r, f, ref in zip(wl, fused["wl"], fused["refs"]):
        assert r.prompt_tokens == f.prompt_tokens
        assert r.first_logits is not None and np.all(
            np.isfinite(r.first_logits))
        worst = max(worst, _rel(r.first_logits, ref))
    print(f"serve_split: worst first-logit rel err vs dense {worst:.3e} "
          f"(tolerance {LOGIT_REL_TOL})", flush=True)
    assert worst < LOGIT_REL_TOL, worst

    runs = {}
    for mode in ("fused", "split"):
        s_ = make_server(mode, clock="model")
        w_ = make_workload(seed=0)
        with _HostBytes() as moved:
            r_, seg_, launches_ = _measured_run(s_, lambda: s_.run(w_))
        r_["host_bytes"], r_["fetch_s"] = moved.n, moved.s
        runs[mode] = (w_, r_, seg_)
    line = _agreement(runs["fused"], runs["split"], fused["refs"])
    print("split_vs_fused: " + json.dumps(line), flush=True)
    assert runs["fused"][2] > 0, \
        ("no prefill chunk recomputed a multi-segment history", line)
    return launches, runs["fused"], runs["split"]


class _HostBytes:
    """While active, counts the bytes that ``StepHandle``'s host
    accessors move from the card (each array once, when it is first
    fetched): the ids, and the prefill rows or, under
    ``return_full_logits``, all the step's logits; and the host seconds
    spent in those first fetches (the wait for the device's queue, the
    copy, the host array)."""

    ACCESSORS = (("token_ids_np", "_ids_np"),
                 ("prefill_logits_np", "_pre_np"))

    def __init__(self):
        self.n = 0
        self.s = 0.0

    def __enter__(self):
        from repro_torch.serving.engine import StepHandle
        self._orig = {name: getattr(StepHandle, name)
                      for name, _ in self.ACCESSORS}
        for name, attr in self.ACCESSORS:
            def counted(handle, fn=self._orig[name], attr=attr):
                fresh = getattr(handle, attr) is None
                t0 = time.perf_counter()
                out = fn(handle)
                if fresh:
                    self.s += time.perf_counter() - t0
                    self.n += out.nbytes
                return out
            setattr(StepHandle, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.engine import StepHandle
        for name, fn in self._orig.items():
            setattr(StepHandle, name, fn)


# ---------------------------------------------------------------------------
# phase 3c: the synchronous baseline against the overlapped pipeline
# ---------------------------------------------------------------------------

# the synchronous control plane of the paper's §5.3 (the JAX package's
# benchmarks/pipeline.py baseline): dispatch, wait, postprocess in order;
# per-token Python assembly with one host-to-device copy a field; the
# full (R+B, V) logits moved to the host every step; page copies eager
BASELINE = dict(attn_mode="split", depth=0, assembly="legacy",
                return_full_logits=True, max_instep_copies=0)


def sync_baseline_phase(card, fused, overlapped):
    """Phase 3b's workload on the model clock through the synchronous
    baseline, held to 3b's model-clock split run (``overlapped``: depth 1,
    vectorized assembly, sampling on the card): both launch the split
    kernels on the same inputs, so the schedules, tokens, ids and first
    logits (bits) must be equal.  Prints both arms' wall seconds,
    steps/s, control-plane seconds a step, assembly seconds, bytes moved
    to the host a step and host seconds a step spent fetching them, their
    ratio (one pair), and the full-logits transfer alone from an idle
    device, to a fresh pageable array and to a pinned buffer."""
    import torch
    t0 = time.perf_counter()
    cfg, make_server, make_workload = (fused["cfg"], fused["make_server"],
                                       fused["make_workload"])
    L = cfg.n_layers
    # no warm-up of its own: 3b's runs launched the same kernels and
    # products at the same shapes just before
    srv = make_server(clock="model", **BASELINE)
    wl = make_workload(seed=0)
    e = srv.engine.ecfg
    shapes, dispatch = set(), srv.engine.dispatch

    def shaped(plan):
        handle = dispatch(plan)
        shapes.add(tuple(handle.prefill_logits.shape))
        return handle

    srv.engine.dispatch = shaped
    with _HostBytes() as moved:
        res, seg, launches = _measured_run(srv, lambda: srv.run(wl))
    res["host_bytes"], res["fetch_s"] = moved.n, moved.s
    steps = srv.engine.steps_executed
    ow, ores, oseg = overlapped
    same = {k: (ores[k], res[k]) for k in
            ("steps", "evictions", "prefill_compute_tokens")}
    same["multi_segment_chunks"] = (oseg, seg)
    equal = {
        "generated": all(a.generated == b.generated for a, b in zip(ow, wl)),
        "sampled_ids": all(a.sampled_ids == b.sampled_ids
                           for a, b in zip(ow, wl)),
        "first_logits_bits": all(
            np.array_equal(a.first_logits.view(np.int32),
                           b.first_logits.view(np.int32))
            for a, b in zip(ow, wl))}

    def arm(r):
        return {"wall_s": r["wall_time"],
                "steps_per_s": r["steps"] / r["wall_time"],
                "control_plane_s_per_step":
                    r["control_plane_time"] / r["steps"],
                "assembly_mean_s": statistics.mean(r["assembly_s"]),
                "host_bytes_per_step": r["host_bytes"] / r["steps"],
                "fetch_s_per_step": r["fetch_s"] / r["steps"]}

    base, over = arm(res), arm(ores)
    # the baseline's transfer alone, from an idle device: a step's
    # (R+B, V) bf16 logits to a fresh host array as
    # StepHandle.prefill_logits_np moves them, and into a reused pinned
    # buffer (median wall ms of 7)
    rows = e.max_prefills + e.max_decodes
    lg = torch.randn((rows, cfg.vocab_size), device="cuda",
                     dtype=torch.bfloat16)
    pinned = torch.empty((rows, cfg.vocab_size), dtype=torch.float32,
                         pin_memory=True)

    def fetch_ms(fn):
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times)

    fetch = {"pageable_ms": fetch_ms(lambda: lg.float().cpu().numpy()),
             "pinned_ms": fetch_ms(lambda: pinned.copy_(lg.float()))}
    fetch["pageable_gb_per_s"] = pinned.nbytes / fetch["pageable_ms"] / 1e6
    fetch["pinned_gb_per_s"] = pinned.nbytes / fetch["pinned_ms"] / 1e6
    del lg, pinned
    line = {"card": card, "model": cfg.name, "layers": L,
            "dtype": cfg.dtype, "clock": "model", "schedule": same,
            "equal": equal, "requests": len(wl),
            "kernel_launches": launches, "full_logits_shapes":
                sorted(shapes), "baseline": base, "overlapped": over,
            "full_logits_fetch_idle": fetch,
            "overlapped_over_baseline_steps_per_s":
                over["steps_per_s"] / base["steps_per_s"],
            "baseline_over_overlapped_control_plane":
                base["control_plane_s_per_step"]
                / over["control_plane_s_per_step"],
            "phase_s": time.perf_counter() - t0}
    print("sync_vs_overlapped: " + json.dumps(line), flush=True)
    assert all(r.status == "finished" for r in wl), [r.status for r in wl]
    assert all(a == b for a, b in same.values()), line
    assert all(equal.values()), line
    assert launches == {"msa_fused": 0, "msa_prefill": L * steps,
                        "msa_decode": L * steps, "msa_fused_partial": 0}, \
        (launches, steps)
    assert shapes == {(rows, cfg.vocab_size)}, shapes
    assert srv.engine.jit_traces == len(srv.engine.buckets_used) == 1
    assert res["instep_copies"] == 0
    assert res["host_bytes"] >= steps * rows * cfg.vocab_size * 4, \
        res["host_bytes"]


def _agreement(base, other, refs):
    """Two model-clock runs ``(workload, result, multi-segment chunks)``
    of one workload held to each other: the same steps, evictions,
    computed prefill tokens and multi-segment chunks, every request
    finished, equal first sampled ids, first logits within
    ``LOGIT_REL_TOL`` of the base run's and of the dense reference
    ``refs``; the share of equal sampled ids is reported.  Raises on a
    failed check; returns the line it prints."""
    (wf, rf, segf), (ws, rs, segs) = base, other
    same = {k: (rf[k], rs[k]) for k in
            ("steps", "evictions", "prefill_compute_tokens")}
    same["multi_segment_chunks"] = (segf, segs)
    n_ids = sum(len(a.sampled_ids) for a in wf)
    n_equal = sum(x == y for a, b in zip(wf, ws)
                  for x, y in zip(a.sampled_ids, b.sampled_ids))
    first_equal = [a.sampled_ids[:1] == b.sampled_ids[:1]
                   for a, b in zip(wf, ws)]
    vs_base = [_rel(b.first_logits, a.first_logits) for a, b in zip(wf, ws)]
    vs_dense = [_rel(b.first_logits, ref) for b, ref in zip(ws, refs)]
    line = {"clock": "model", "schedule": same,
            "first_sampled_id_equal": sum(first_equal),
            "requests": len(wf),
            "sampled_ids_equal_share": n_equal / n_ids,
            "sampled_ids": n_ids,
            "worst_first_logit_rel_err_vs_base": max(vs_base),
            "worst_first_logit_rel_err_vs_dense": max(vs_dense)}
    assert all(a == b for a, b in same.values()), line
    assert all(a.status == b.status == "finished" for a, b in zip(wf, ws))
    assert all(first_equal), line
    assert max(vs_base) < LOGIT_REL_TOL and max(vs_dense) < LOGIT_REL_TOL, \
        line
    return line


# ---------------------------------------------------------------------------
# phase 8: sharded serving, its shards on this one card
# ---------------------------------------------------------------------------

# N = 4 serves the first SHARD_CUT_SESSIONS of the workload's four
# sessions: its host runs four shards' ops a layer, about four times a
# single-device step's.  The cut evicts nothing; N = 2 serves the whole
# workload, evictions and the multi-segment chunk included.  (2 sessions
# until phase 3c was added, whose time this cut helps pay for.)
SHARD_CUT_SESSIONS = 1


def _tensor_bytes(tree, spec=None, n=1) -> int:
    """Bytes of a parameter tree; with the serving ``spec`` and ``n``, the
    bytes one of n shards should hold (a tensor split on "model" by n)."""
    return sum(_tensor_bytes(v, spec and spec[k], n) if isinstance(v, dict)
               else v.numel() * v.element_size()
               // (n if spec and "model" in spec[k] else 1)
               for k, v in tree.items())


def sharded_phase(fused, fused_model):
    """Llama-3.1-8B served sharded (page-sharded pools, tensor-parallel
    weights, the partials merged exactly) over 2 and then 4 shards on this
    one card, on the model clock, held to the single-device fused run of
    the same workload (phase 3b's, or the same cut for N = 4): the same
    schedule and first sampled ids, first logits within tolerance of it
    and of the dense reference; one (o, lse) launch a shard a layer a
    step and no fused-mode launch; each shard's weight bytes; the host's
    assembly seconds a step (N work-lists).  Then a profile of one request
    at N = 2.  Returns the N = 2 run's kernel counts."""
    import torch
    from repro_torch.distributed import serving_param_shardings
    cfg, params = fused["cfg"], fused["params"]
    make_server, make_workload = fused["make_server"], fused["make_workload"]
    L = cfg.n_layers
    total = _tensor_bytes(params)
    first = None
    for n in (2, 4):
        if n == 2:
            keep = lambda wl: wl                             # noqa: E731
            base, refs = fused_model, fused["refs"]
        else:
            def keep(wl):
                return [r for r in wl if r.session_id < SHARD_CUT_SESSIONS]
            s1 = make_server(clock="model")
            w1 = keep(make_workload(seed=0))
            r1, seg1, _ = _measured_run(s1, lambda: s1.run(w1))
            base = (w1, r1, seg1)
            refs = [ref for r, ref in zip(fused["wl"], fused["refs"])
                    if r.session_id < SHARD_CUT_SESSIONS]
            del s1
        srv = make_server(clock="model", n_shards=n)
        shard_bytes = [_tensor_bytes(p) for p in srv.engine.params]
        want_bytes = _tensor_bytes(
            params, serving_param_shardings(cfg, n)[1], n)
        wn = keep(make_workload(seed=0))
        rn, segn, launches = _measured_run(srv, lambda: srv.run(wn))
        steps = srv.engine.steps_executed
        line = _agreement(base, (wn, rn, segn), refs)
        line.update({
            "n_shards": n, "devices": [str(d) for d in
                                       srv.engine.group.devices],
            "workload": "whole" if n == 2 else
                        f"first {SHARD_CUT_SESSIONS} of 4 sessions",
            "steps": steps, "kernel_launches": launches,
            "per_shard_used": rn["per_shard_used"],
            "weight_gb_total": total / 1e9,
            "weight_gb_per_shard": [b / 1e9 for b in shard_bytes],
            "assembly_mean_s": statistics.mean(rn["assembly_s"]),
            "base_assembly_mean_s": statistics.mean(base[1]["assembly_s"]),
            "wall_s": rn["wall_time"],
            "base_wall_s": base[1]["wall_time"],
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30})
        print("sharded_vs_single: " + json.dumps(line), flush=True)
        assert launches == {"msa_fused": 0, "msa_prefill": 0,
                            "msa_decode": 0,
                            "msa_fused_partial": n * L * steps}, launches
        assert rn["attn_dispatches_per_step"] == L
        assert shard_bytes == [want_bytes] * n, (shard_bytes, want_bytes)
        first = first or launches
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    profile_phase(lambda mode: make_server(n_shards=2), make_workload,
                  "sharded", n_requests=1)
    return first


# ---------------------------------------------------------------------------
# phase 5: the agentic closed loop with multi-token decode
# ---------------------------------------------------------------------------

ONLINE_K = 8


def _online_run(cfg, params, k, clock, offload=None):
    """One closed-loop run of the agentic scripts through
    ``OnlineFrontend`` with predictive prefetch over a server with a host
    tier and ``max_decode_steps`` k (see ``_measured_run``), and the host
    tier's ``offload`` policy (default: full precision)."""
    from repro_torch.core import OffloadConfig
    from repro_torch.serving import (AgenticConfig, AsymCacheServer,
                                     EngineConfig, FrontendConfig,
                                     OnlineFrontend, SchedulerConfig,
                                     ServerConfig, agentic_session_scripts)
    # a block is 2 MB at these shapes (32 layers, K and V, 8 kv heads of
    # 128, 16 tokens, bf16); 384 device blocks hold about two of the six
    # sessions' histories (up to ~3.9k tokens each), so the sessions
    # suspended in tool calls are evicted to the 512 host blocks and
    # prefetched back before they resume
    num_blocks, host_blocks = 384, 512
    ecfg = EngineConfig(num_pages=num_blocks, page_size=16, max_prefills=4,
                        max_chunk=128, max_decodes=64, max_blocks_per_seq=256)
    srv = AsymCacheServer(cfg, params, ServerConfig(
        num_blocks=num_blocks, host_blocks=host_blocks, clock=clock,
        offload=offload or OffloadConfig(),
        scheduler=SchedulerConfig(max_decode_steps=k)), ecfg=ecfg)
    fe = OnlineFrontend(srv, agentic_session_scripts(AgenticConfig(
        n_jobs=6, tool_calls_per_job=(2, 4), system_prefix_len=512,
        task_len=(256, 1024), tool_result_len=(128, 512),
        output_len=(24, 64), tool_duration=(0.5, 2.0),
        vocab=cfg.vocab_size, seed=0)), FrontendConfig(prefetch=True))
    res, _, launches = _measured_run(srv, fe.run)
    return srv, fe, res, launches


def _online_line(srv, fe, res, launches, k, clock):
    import torch
    return {
        "clock": clock, "max_decode_steps": k,
        "sessions": len(fe.sessions), "turns": res["n_turns"],
        "steps": res["steps"], "kernel_launches": launches,
        "attn_dispatches": srv.engine.attn_dispatches,
        "decode_only_dispatches": res["decode_only_dispatches"],
        "multi_token_dispatches": res["multi_token_dispatches"],
        "multi_token_iterations": res["multi_token_iterations"],
        "multi_token_rollbacks": res["multi_token_rollbacks"],
        "k_counts": res["k_counts"], "bucket_variants": srv.engine.jit_traces,
        "evictions": res["evictions"], "swap_outs": res["swap_outs"],
        "swap_ins": res["swap_ins"],
        "prefetch_swap_ins": res["prefetch_swap_ins"],
        "resume_swap_stalls": res["resume_swap_stalls"],
        "ttft_mean_s": res["online_ttft_mean"],
        "ttft_p90_s": res["online_ttft_p90"],
        "tpot_mean_s": res["online_tpot_mean"],
        "tpot_p90_s": res["online_tpot_p90"],
        "job_latency_mean_s": res["agent_job_latency_mean"],
        "job_latency_p90_s": res["agent_job_latency_p90"],
        "wall_s": res["wall_time"],
        "steps_per_s": res["steps"] / res["wall_time"],
        "assembly_mean_s": statistics.mean(res["assembly_s"]),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}


def _turns(fe):
    return [r for s in fe.sessions for r in s.requests]


def online_phase(fused):
    """The agentic closed loop on the card: ``OnlineFrontend.run`` ->
    ``AsymCacheServer.serve`` (host tier, predictive prefetch,
    ``max_decode_steps`` 8) -> k fused decode iterations a dispatch, each
    through the fused kernel once a layer.  Then the same scripts at k = 1
    on the wall clock (TPOT beside k = 8), and at k = 1 and k = 8 on the
    model clock over the first ``OFFLOAD_LAYERS`` layers, held to each
    other.  Returns the kernel counts of the k = 8 wall-clock run."""
    from repro_torch.serving import SessionState, reference_logits
    cfg, params = fused["cfg"], fused["params"]
    srv, fe, res, launches = _online_run(cfg, params, ONLINE_K, "wall")
    print("online: " + json.dumps(_online_line(srv, fe, res, launches,
                                               ONLINE_K, "wall")), flush=True)
    assert all(s.state is SessionState.FINISHED for s in fe.sessions), \
        [s.state for s in fe.sessions]
    assert res["multi_token_dispatches"] > 0, "no k-step dispatch"
    assert res["prefetch_swap_ins"] > 0, "no prefetch swap-in"
    assert launches == {"msa_fused": srv.engine.attn_dispatches,
                        "msa_prefill": 0, "msa_decode": 0,
                        "msa_fused_partial": 0}, \
        (launches, srv.engine.attn_dispatches)
    assert srv.engine.jit_traces == len(srv.engine.buckets_used)
    worst = 0.0
    for r in _turns(fe):
        ref = reference_logits(cfg, params, r.prompt_tokens)
        assert r.first_logits is not None and np.all(
            np.isfinite(r.first_logits))
        worst = max(worst, _rel(r.first_logits, ref))
    print(f"online: worst first-logit rel err vs dense {worst:.3e} over "
          f"{len(_turns(fe))} turns (tolerance {LOGIT_REL_TOL})", flush=True)
    assert worst < LOGIT_REL_TOL, worst

    one = _online_run(cfg, params, 1, "wall")
    print("online: " + json.dumps(_online_line(*one, 1, "wall")), flush=True)
    assert all(s.state is SessionState.FINISHED for s in one[1].sessions)

    # the model-clock pair on the first OFFLOAD_LAYERS layers (the same
    # weights): the k-vs-1 identity does not depend on the depth
    cut_cfg, cut_params = _first_layers(cfg, params, OFFLOAD_LAYERS)
    runs = {k: _online_run(cut_cfg, cut_params, k, "model")
            for k in (1, ONLINE_K)}
    for k, run in runs.items():
        print("online: " + json.dumps(_online_line(*run, k, "model")),
              flush=True)
    (_, f1, r1, _), (_, fk, rk, _) = runs[1], runs[ONLINE_K]
    t1, tk = _turns(f1), _turns(fk)
    assert len(t1) == len(tk)
    assert all(a.prompt_tokens == b.prompt_tokens
               and a.generated == b.generated for a, b in zip(t1, tk))
    n_ids = sum(len(a.sampled_ids) for a in t1)
    n_equal = sum(x == y for a, b in zip(t1, tk)
                  for x, y in zip(a.sampled_ids, b.sampled_ids))
    first_equal = [a.sampled_ids[:1] == b.sampled_ids[:1]
                   for a, b in zip(t1, tk)]
    vs_one = [_rel(b.first_logits, a.first_logits) for a, b in zip(t1, tk)]
    print("k_vs_1: " + json.dumps({
        "clock": "model", "k": ONLINE_K, "turns": len(t1),
        "n_layers": cut_cfg.n_layers,
        "generated_equal": True,
        "first_sampled_id_equal": sum(first_equal),
        "sampled_ids_equal_share": n_equal / n_ids, "sampled_ids": n_ids,
        "worst_first_logit_rel_err_vs_k1": max(vs_one),
        "decode_only_dispatches": {"k1": r1["decode_only_dispatches"],
                                   f"k{ONLINE_K}":
                                   rk["decode_only_dispatches"]},
        "steps": {"k1": r1["steps"], f"k{ONLINE_K}": rk["steps"]}}),
        flush=True)
    assert all(first_equal), first_equal
    assert max(vs_one) < LOGIT_REL_TOL, max(vs_one)
    assert rk["decode_only_dispatches"] < r1["decode_only_dispatches"]
    return launches


def single_plan_phase(fused):
    """One decode-only plan of four rows as one k = 8 dispatch against 8
    single dispatches of the same rows, on two engines that start from
    the same pools: the same bits in every iteration's ids and in the
    pools.  The rows' contexts cross 1024 keys inside the 8 iterations, so
    the k-step's block table is 256 pages wide and the first single steps'
    64."""
    import torch
    from repro_torch.serving import (AsymCacheServer, Engine, EngineConfig,
                                     SchedulerConfig, ServerConfig, StepPlan,
                                     decode_burst_workload)
    cfg, params = fused["cfg"], fused["params"]
    num_blocks = 4 * 67          # four contexts of 1020 + 40 tokens
    ecfg = EngineConfig(num_pages=num_blocks, page_size=16, max_prefills=4,
                        max_chunk=128, max_decodes=64, max_blocks_per_seq=256)
    srv = AsymCacheServer(cfg, params, ServerConfig(
        num_blocks=num_blocks, clock="model", pipeline_depth=0,
        scheduler=SchedulerConfig(token_budget=512,
                                  max_decode_steps=ONLINE_K)), ecfg=ecfg)
    multi = srv.engine
    captured = []

    class _KStep(Exception):
        pass

    def catch(plan):
        if plan.decode_steps > 1:
            captured.append(plan)
            raise _KStep
        return Engine.dispatch(multi, plan)

    multi.dispatch = catch
    try:
        srv.run(decode_burst_workload(n_requests=4, prompt_len=(1020, 1020),
                                      output_len=(40, 40),
                                      vocab=cfg.vocab_size, seed=0))
    except _KStep:
        pass
    del multi.dispatch
    plan, = captured
    assert plan.decode_iters == [ONLINE_K] * len(plan.decodes)
    single = Engine(cfg, ecfg, params)
    single.k_pools.copy_(multi.k_pools)
    single.v_pools.copy_(multi.v_pools)
    widths = {"k_step": multi.buckets_for(plan)}
    ids_k = multi.execute(plan).token_ids_np()
    same_ids = []
    for i in range(ONLINE_K):
        step = StepPlan(decodes=list(plan.decodes))
        widths[f"single_{i}"] = single.buckets_for(step)
        same_ids.append(bool(np.array_equal(
            single.execute(step).token_ids_np(), ids_k[i])))
        for r in plan.decodes:         # the server's forced next token
            r.generated.append(r.output_script[len(r.generated)])
    torch.cuda.synchronize()
    same_pools = (torch.equal(multi.k_pools, single.k_pools)
                  and torch.equal(multi.v_pools, single.v_pools))
    print("single_plan: " + json.dumps({
        "k": ONLINE_K, "rows": len(plan.decodes),
        "context_keys": [r.prompt_len + len(r.generated) - ONLINE_K
                         for r in plan.decodes],
        "t_np_buckets": widths, "ids_same_bits": same_ids,
        "pools_same_bits": same_pools}), flush=True)
    assert all(same_ids) and same_pools
    assert widths["single_0"][1] < widths["k_step"][1], widths


# ---------------------------------------------------------------------------
# phase 6: quantized offload formats
# ---------------------------------------------------------------------------

def _spill_round_trip(srv):
    """One committed page of ``srv``'s pool (a finished run's) spilled
    through the block manager's encoder (the configured wire format) and
    restored into two other pages, by the eager and by the in-step
    swap-in: whether both come back with the page's bits, in K and in
    V."""
    import torch
    from repro_torch.kernels.msa import apply_swap_ins
    eng, bm = srv.engine, srv.bm
    slot, *others = bm.table.values()
    free = others[-2:]
    raw_k, raw_v = eng.swap_out(slot)
    half_k = bm._encode_half(raw_k, 0, "k")
    half_v = bm._encode_half(raw_v, 0, "v")
    eng.swap_in(free[0], (half_k, half_v))
    eng.queue_swap_in(free[1], (half_k, half_v))
    e = eng.ecfg
    views = {n: np.zeros((e.max_instep_copies,), np.int32)
             for n in ("copy_src", "copy_dst")}
    views.update({n: np.zeros((e.max_instep_swaps,), np.int32)
                  for n in ("swap_k_dst", "swap_v_dst")})
    ops = eng._fold_page_ops(views)
    dev = eng.device
    apply_swap_ins(eng.k_pools, eng.v_pools,
                   torch.from_numpy(views["swap_k_dst"]).to(dev),
                   torch.from_numpy(views["swap_v_dst"]).to(dev),
                   ops["swap_k"], ops["swap_v"], ops["swap_k_scale"],
                   ops["swap_v_scale"])
    torch.cuda.synchronize()
    same = {}
    for name, pools in (("k", eng.k_pools), ("v", eng.v_pools)):
        bits = pools.view(torch.int16)
        same[name] = {"eager": bool(torch.equal(bits[:, free[0]],
                                                bits[:, slot])),
                      "in_step": bool(torch.equal(bits[:, free[1]],
                                                  bits[:, slot]))}
    return {"wire_format": half_k.fmt, "slot": int(slot),
            "half_bytes": half_k.nbytes, "same_bits": same,
            "nonzero": bool(eng.k_pools[:, slot].abs().max() > 0)}


def _f8_cast_check():
    """fp8 codes of all 65536 bf16 bit patterns on the card against the
    CPU: the port's encoder (``f8_codes``) must agree everywhere, torch's
    own cast at least below the overflow boundary (the encoder relies on
    it there), and the decode of all 256 codes to bf16 must agree."""
    import torch
    from repro_torch.core.offload import F8_OVERFLOW, f8_codes, f8_values
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x_cpu = bits.view(torch.bfloat16)
    x_dev = x_cpu.to("cuda")
    enc_cpu, enc_dev = f8_codes(x_cpu), f8_codes(x_dev).cpu()
    raw_cpu = x_cpu.to(torch.float8_e4m3fn).view(torch.uint8)
    raw_dev = x_dev.to(torch.float8_e4m3fn).view(torch.uint8).cpu()
    below = x_cpu.float().abs() <= F8_OVERFLOW
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    dec_cpu = f8_values(codes, torch.bfloat16).float()
    dec_dev = f8_values(codes.to("cuda"), torch.bfloat16).float().cpu()
    line = {
        "bf16_patterns": int(bits.numel()),
        "f8_codes_card_eq_cpu": int((enc_cpu == enc_dev).sum()),
        "torch_cast_card_eq_cpu": int((raw_cpu == raw_dev).sum()),
        "torch_cast_card_eq_cpu_below_overflow":
            int((raw_cpu == raw_dev)[below].sum()),
        "below_overflow": int(below.sum()),
        "decode_256_codes_equal": bool(torch.equal(
            dec_cpu.nan_to_num(7.0), dec_dev.nan_to_num(7.0))
            and torch.equal(dec_cpu.isnan(), dec_dev.isnan()))}
    print("f8_cast: " + json.dumps(line), flush=True)
    assert line["f8_codes_card_eq_cpu"] == line["bf16_patterns"], line
    assert (line["torch_cast_card_eq_cpu_below_overflow"]
            == line["below_overflow"]), line
    assert line["decode_256_codes_equal"], line


# phase 5's model-clock pair serves Llama-3.1-8B's first 4 layers and
# phase 6 its first 2 (the same weights; both 8 until phase 3c was added,
# whose time these cuts help pay for): phase 6's four closed-loop runs
# take ~4 minutes at 32 layers (~1 at 8), and neither the identity of the
# arms nor the byte ratio depends on the depth (a block's payload is the
# layers times one layer's page; the schedules, swap-ins and prefetches
# are those of 8 layers within a step or two)
OFFLOAD_LAYERS = 4
OFFLOAD_PHASE_LAYERS = 2


def _first_layers(cfg, params, n):
    """The model cut to its first ``n`` layers, on views of ``params``."""
    return (dataclasses.replace(cfg, n_layers=n),
            {**params, "blocks": {k: v[:n] for k, v
                                  in params["blocks"].items()}})


def offload_phase(full_cfg, full_params):
    """Quantized host-tier offload on the card: phase 5's agentic scripts
    at k = 8 on the model clock, each quantized arm (int8, fp8) against
    its control arm with full-precision payloads (the pool is snapped to
    the same grid in both): the same bits out, the compressed bytes on
    the wire.  Then a spilled page's round trip and the fp8 codes against
    the CPU.  The model is ``full_cfg`` cut to ``OFFLOAD_PHASE_LAYERS``
    layers, on views of ``full_params``' first layers."""
    from repro_torch.core import OffloadConfig
    from repro_torch.serving import SessionState, reference_logits
    cfg, params = _first_layers(full_cfg, full_params, OFFLOAD_PHASE_LAYERS)
    cuts = {"n_layers": [full_cfg.n_layers, cfg.n_layers]}
    for quant in ("int8", "fp8"):
        arms = {}
        for payload_fp in (True, False):
            offload = OffloadConfig(quant=quant, payload_fp=payload_fp,
                                    retain_host=True)
            srv, fe, res, launches = _online_run(cfg, params, ONLINE_K,
                                                 "model", offload=offload)
            arms[payload_fp] = (srv, fe, res)
            line = _online_line(srv, fe, res, launches, ONLINE_K, "model")
            line.update(quant=quant, wire_format=srv.engine.ecfg.swap_payload,
                        snap=srv.engine.ecfg.snap,
                        swap_bytes_shipped=srv.engine.swap_bytes_shipped,
                        instep_swaps=srv.engine.instep_swaps,
                        eager_swaps=srv.engine.eager_swaps)
            print("offload: " + json.dumps(line), flush=True)
            assert all(s.state is SessionState.FINISHED
                       for s in fe.sessions)
            assert launches == {"msa_fused": srv.engine.attn_dispatches,
                                "msa_prefill": 0, "msa_decode": 0,
                                "msa_fused_partial": 0}, launches
        (sa, fa, ra), (sb, fb, rb) = arms[True], arms[False]
        ta, tb = _turns(fa), _turns(fb)
        same = {
            "generated": all(a.generated == b.generated
                             for a, b in zip(ta, tb)),
            "sampled_ids": all(a.sampled_ids == b.sampled_ids
                               for a, b in zip(ta, tb)),
            "first_logits_bits": all(
                np.array_equal(a.first_logits.view(np.int32),
                               b.first_logits.view(np.int32))
                for a, b in zip(ta, tb))}
        shipped = [sa.engine.swap_bytes_shipped, sb.engine.swap_bytes_shipped]
        ratio = shipped[1] / shipped[0]
        # the snap is quantization-aware serving: its drift from the dense
        # bf16 forward is reported, not held to the losslessness tolerance
        drift = max(_rel(b.first_logits,
                         reference_logits(cfg, params, b.prompt_tokens))
                    for b in tb)
        spill = _spill_round_trip(sb)
        print("offload_pair: " + json.dumps({
            "config": cfg.name, "cuts": cuts, "quant": quant,
            "turns": len(ta), "same": same,
            "swap_ins": [ra["swap_ins"], rb["swap_ins"]],
            "swap_bytes_shipped": shipped,
            "bytes_ratio": ratio, "bytes_ratio_limit": 0.51,
            "worst_first_logit_rel_err_vs_dense_forward": drift,
            "spill_round_trip": spill}), flush=True)
        assert len(ta) == len(tb) and all(same.values()), same
        assert ra["swap_ins"] > 0 and ra["swap_ins"] == rb["swap_ins"]
        assert ratio <= 0.51, ratio
        assert spill["nonzero"] and all(
            v for half in spill["same_bits"].values()
            for v in half.values()), spill
        del arms, sa, sb, fa, fb
        gc.collect()
    _f8_cast_check()


# ---------------------------------------------------------------------------
# phase 7: Grok-1 (MoE) at full width
# ---------------------------------------------------------------------------

GROK_LAYERS = 4
# 128 blocks of 16 tokens (2048 tokens) hold the longest session (~1.6k
# tokens) but not the three first turns (~2.8k), so the second turns find
# part of their history evicted and recompute it
GROK_BLOCKS = 128


def _history_recomputed(wl):
    """Prompt tokens of each later turn computed again although its
    session's previous turn had computed them (evicted history), summed:
    what the turn computed beyond its own new tokens."""
    prev, total = {}, 0
    for r in sorted(wl, key=lambda r: r.rid):
        p = prev.get(r.session_id)
        if p is not None:
            new = len(r.prompt_tokens) - len(p.prompt_tokens) \
                - len(p.generated)
            total += r.n_prefill_compute - new
        prev[r.session_id] = r
    return total


def grok_config():
    """Grok-1 at full width, cut to ``GROK_LAYERS`` layers so that its
    weights fit on one card, with dropless routing (capacity = tokens),
    which lossless serving needs; and the cuts, as (full, served)."""
    from repro_torch.configs import get_config
    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=GROK_LAYERS,
                              moe=dataclasses.replace(full.moe,
                                                      dropless=True))
    cuts = {"n_layers": [full.n_layers, cfg.n_layers],
            "moe.dropless": [full.moe.dropless, cfg.moe.dropless]}
    return cfg, cuts


def grok_workload(cfg, seed):
    from repro_torch.serving import WorkloadConfig, multi_turn_workload
    return multi_turn_workload(WorkloadConfig(
        n_sessions=3, turns_per_session=(2, 2), first_ctx_len=(512, 1536),
        output_len=(16, 16), qps=0.5, vocab=cfg.vocab_size, seed=seed))


def grok_server(cfg, params, attn_mode="fused", clock="wall"):
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     ServerConfig)
    ecfg = EngineConfig(num_pages=GROK_BLOCKS, page_size=16,
                        max_prefills=4, max_chunk=128, max_decodes=64,
                        max_blocks_per_seq=128, attn_mode=attn_mode)
    return AsymCacheServer(cfg, params, ServerConfig(
        num_blocks=GROK_BLOCKS, clock=clock, attn_mode=attn_mode),
        ecfg=ecfg)


def grok_phase():
    """Grok-1's MoE served on the card: the weights (about 43 GB in bf16
    at 4 layers), the fused serving run on the wall clock with its
    launches and losslessness, then fused against split on the model
    clock."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.serving import reference_logits
    cfg, cuts = grok_config()
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)          # on the card
    # wq/wk to fan-in, as phase 3 does for Llama (init_params keeps the
    # reference's 1/sqrt(H))
    for name in ("wq", "wk"):
        params["blocks"][name].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
    torch.cuda.synchronize()
    tensors = list(params["blocks"].values()) + [
        t for k, t in params.items() if k != "blocks"]
    print("grok: " + json.dumps({
        "config": cfg.name, "cuts": cuts, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "experts": cfg.moe.num_experts,
        "top_k": cfg.moe.top_k, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "softcap": cfg.attn_logit_softcap,
        "dtype": cfg.dtype, "params": sum(t.numel() for t in tensors),
        "param_gib": sum(t.numel() * t.element_size()
                         for t in tensors) / 2**30,
        "init_s": time.perf_counter() - t0,
        "device_gib_allocated": torch.cuda.memory_allocated() / 2**30}),
        flush=True)

    grok_server(cfg, params).run(grok_workload(cfg, seed=1)[:1])  # warm-up
    torch.cuda.synchronize()
    srv = grok_server(cfg, params)
    wl = grok_workload(cfg, seed=0)
    res, seg_chunks, launches = _measured_run(srv, lambda: srv.run(wl))
    steps = srv.engine.steps_executed
    line = _serve_line(wl, res, seg_chunks, launches)
    line["attn_dispatches"] = srv.engine.attn_dispatches
    line["history_tokens_recomputed"] = _history_recomputed(wl)
    print("grok_serve: " + json.dumps(line), flush=True)
    assert all(r.status == "finished" for r in wl), [r.status for r in wl]
    assert res["evictions"] > 0, "the pool never evicted"
    assert line["history_tokens_recomputed"] > 0, "no history recomputed"
    assert launches == {"msa_fused": srv.engine.attn_dispatches,
                        "msa_prefill": 0, "msa_decode": 0,
                        "msa_fused_partial": 0}, launches
    assert srv.engine.attn_dispatches == L * steps
    worst, refs = 0.0, []
    for r in wl:
        # one prompt at a time: a dropless dense forward at ~1.7k tokens
        # holds (8, T, 32768) bf16 expert activations of ~0.9 GB each
        ref = reference_logits(cfg, params, r.prompt_tokens)
        refs.append(ref)
        assert r.first_logits is not None and np.all(
            np.isfinite(r.first_logits))
        rel = _rel(r.first_logits, ref)
        worst = max(worst, rel)
        print(f"grok_serve: request {r.rid} prompt {len(r.prompt_tokens)} "
              f"rel_err {rel:.3e} argmax_match "
              f"{int(np.argmax(r.first_logits)) == int(np.argmax(ref))}",
              flush=True)
    print(f"grok_serve: worst first-logit rel err {worst:.3e} "
          f"(tolerance {LOGIT_REL_TOL})", flush=True)
    assert worst < LOGIT_REL_TOL, worst

    runs = {}
    for mode in ("fused", "split"):
        s_ = grok_server(cfg, params, mode, clock="model")
        w_ = grok_workload(cfg, seed=0)
        r_, seg_, launches_ = _measured_run(s_, lambda: s_.run(w_))
        n = s_.engine.steps_executed
        want = ({"msa_fused": L * n, "msa_prefill": 0, "msa_decode": 0,
                 "msa_fused_partial": 0}
                if mode == "fused" else
                {"msa_fused": 0, "msa_prefill": L * n, "msa_decode": L * n,
                 "msa_fused_partial": 0})
        assert launches_ == want, (mode, launches_, want)
        runs[mode] = (w_, r_, seg_, launches_)
    (wf, rf, segf, lf), (ws, rs, segs, ls) = runs["fused"], runs["split"]
    same = {k: (rf[k], rs[k]) for k in
            ("steps", "evictions", "prefill_compute_tokens")}
    same["multi_segment_chunks"] = (segf, segs)
    same["history_tokens_recomputed"] = (_history_recomputed(wf),
                                         _history_recomputed(ws))
    n_ids = sum(len(a.sampled_ids) for a in wf)
    n_equal = sum(x == y for a, b in zip(wf, ws)
                  for x, y in zip(a.sampled_ids, b.sampled_ids))
    first_equal = [a.sampled_ids[:1] == b.sampled_ids[:1]
                   for a, b in zip(wf, ws)]
    vs_fused = [_rel(b.first_logits, a.first_logits) for a, b in zip(wf, ws)]
    vs_dense = [_rel(b.first_logits, ref) for b, ref in zip(ws, refs)]
    print("grok_split_vs_fused: " + json.dumps({
        "clock": "model", "schedule": same, "launches": {"fused": lf,
                                                         "split": ls},
        "first_sampled_id_equal": sum(first_equal), "requests": len(wf),
        "sampled_ids_equal_share": n_equal / n_ids, "sampled_ids": n_ids,
        "worst_first_logit_rel_err_vs_fused": max(vs_fused),
        "worst_first_logit_rel_err_vs_dense": max(vs_dense)}), flush=True)
    assert all(a == b for a, b in same.values()), same
    assert same["history_tokens_recomputed"][0] > 0, same
    assert all(a.status == b.status == "finished" for a, b in zip(wf, ws))
    assert all(first_equal), first_equal
    assert max(vs_fused) < LOGIT_REL_TOL and max(vs_dense) < LOGIT_REL_TOL
    # where a Grok-1 step's device time goes (fused layout)
    profile_phase(lambda mode: grok_server(cfg, params, mode),
                  lambda seed: grok_workload(cfg, seed), "fused")


# ---------------------------------------------------------------------------
# phase 9: the full model (forward and decode_step, every new family)
# ---------------------------------------------------------------------------

# teacher-forced decode against the forward: the JAX package's own bar at
# float32 (tests/test_models.py), the bf16 logit bar at bfloat16
FULL_TOL = {"float32": 2e-3, "bfloat16": LOGIT_REL_TOL}
# where the reference misses the bf16 bar itself: its own bf16 decode's
# max |diff| / max |ref| from its bf16 forward at full width and depth
# (random weights from its seed 0, 2 x 512 tokens), as
# tests/test_torch_full_width.py measured it (the reference jitted on the
# CPU of an NVIDIA H100 80GB HBM3 machine; the port on the same weights
# read 0.314).  A deep SSM's chunked scan and its one-token recurrence
# round in different places, and with random weights the gap grows with
# depth; the port's decode is held to 1.5x the reference's gap, as the
# smoke-size test holds it
REFERENCE_BF16_DRIFT = {"mamba2-780m": 0.27636054158210754}
# (arch, batch, tokens, decode steps, float32 depth, banded check):
# Gemma-3 decodes the last 32 of its 2048 tokens after a prefill of 2016
# (past its window of 1024) and holds its banded forward to the chunked
# one; Mamba-2 crosses chunks of 256; Hymba crosses its window of 2048
# (and pads 2112 to chunks of 256); Whisper's decoder runs 128 tokens
# over a 1500-frame encoder.  The float32 runs of Mamba-2 and Hymba are
# cut to half their depth (full depth until phase 3c was added, whose
# time the cut helps pay for); Hymba's first 16 layers keep its global
# layer 15
FULL_MODELS = (("gemma3-12b", 2, 2048, 32, 12, True),
               ("mamba2-780m", 2, 512, 512, 24, False),
               ("hymba-1.5b", 1, 2112, 2112, 16, False),
               ("whisper-large-v3", 2, 128, 128, None, False))
# eager decode steps a run times on the wall clock before the rest of the
# run replays one captured step (an eager step takes the host 45-125 ms at
# these depths, its thousands of small ops each enqueued from Python: the
# lines' decode_ms_per_token_wall)
EAGER_STEPS = 16


def _trel(got, want) -> float:
    """max |got - want| / max |want| (float32, on the card)."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _full_model(arch, dtype, n_layers=None):
    """``arch`` at full width (``n_layers`` deep if given) in ``dtype``
    and its random weights from seed 0 on the card, wq/wk (and xwq/xwk)
    rescaled to fan-in as phase 3 does (init_params keeps the reference's
    1/sqrt(H))."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed=0)
    for name in ("wq", "wk", "xwq", "xwk"):
        if name in params["blocks"]:
            params["blocks"][name].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
    return cfg, params


def _teacher_forced(params, cfg, tokens, state, start):
    """``decode_step`` over ``tokens[:, start:]`` from ``state`` (at
    position ``start``; its caches are written in place): the first
    ``EAGER_STEPS`` eagerly, timed on the wall clock, then the rest as
    replays of one step captured in a CUDA graph over the same state (the
    same kernels in the same order; the token and position move in
    through the captured step's own input tensors).  Returns the logits
    (B, n, V), the wall ms an eager step and the wall ms a replay."""
    import torch
    from repro_torch.models import decode_step
    b, seq = tokens.shape
    dec = torch.empty((b, seq - start, cfg.vocab_size),
                      dtype=params["embed"].dtype, device="cuda")
    n_eager = min(EAGER_STEPS, seq - start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_eager):
        lg, state = decode_step(params, cfg, state, tokens[:, start + i])
        dec[:, i] = lg
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n_eager
    rest = range(start + n_eager, seq)
    if not rest:
        return dec, eager_ms, None
    tok = tokens[:, rest[0]].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, new = decode_step(params, cfg, state, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in rest:
        tok.copy_(tokens[:, t])
        graph.replay()
        dec[:, t - start] = logits
        state["pos"].copy_(new["pos"])
    torch.cuda.synchronize()
    return dec, eager_ms, (time.perf_counter() - t0) * 1e3 / len(rest)


def _decode_device_ms(params, cfg, state, tokens, n=4):
    """The device's busy ms a ``decode_step`` (torch.profiler, CUDA
    activity: the sum of its kernels' times over ``n`` eager steps / n),
    or None where the profiler records no device time.  Every step
    attends over the whole cache (masked), so any position costs the
    same."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            _, state = decode_step(params, cfg, state, tokens[:, t])
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / n if busy > 0 else None


def full_model_run(card, arch, dtype, batch, seq, steps, n_layers=None,
                   banded=False):
    """One model of phase 9 in ``dtype``: the forward over (batch, seq)
    tokens as the reference (with ``banded``, the banded forward held to
    it); with ``steps < seq`` a prefill of ``seq - steps`` tokens whose
    K/V seed the decode cache, else decode from position 0 (Whisper after
    ``prep_cross_attention`` over random encoder frames).  Then
    ``steps`` teacher-forced ``decode_step``s held to the forward's
    logits at their positions (``FULL_TOL``, or 1.5x the reference's own
    gap where ``REFERENCE_BF16_DRIFT`` has one); prefill and decode timed;
    one JSON line."""
    import torch
    from repro_torch.models import (forward, init_decode_state,
                                    prep_cross_attention)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _full_model(arch, dtype, n_layers)
    torch.cuda.synchronize()
    line = {"card": card, "model": cfg.name, "dtype": dtype,
            "layers": cfg.n_layers, "full_depth": n_layers is None,
            "batch": batch, "tokens": seq, "decode_steps": steps,
            "eager_decode_steps": min(EAGER_STEPS, steps),
            "weights_gib": torch.cuda.memory_allocated() / 2**30,
            "init_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    inputs = {"tokens": tokens}
    if cfg.enc_dec:
        inputs["enc_embeds"] = torch.randn(
            (batch, cfg.encoder_len, cfg.d_model), generator=gen,
            device="cuda")
    start = seq - steps
    tol = FULL_TOL[dtype]
    if dtype == "bfloat16":
        tol = max(tol, 1.5 * REFERENCE_BF16_DRIFT.get(arch, 0.0))
    with torch.inference_mode():
        ref = forward(params, cfg, inputs)
        assert ref.shape == (batch, seq, cfg.vocab_size)
        assert bool(torch.isfinite(ref).all()), "non-finite logits"
        if banded:
            banded = forward(params, cfg, inputs, banded=True,
                             attn_chunk=512)
            line["banded_vs_chunked_rel_err"] = _trel(banded, ref)
            del banded
            assert line["banded_vs_chunked_rel_err"] < tol, line
        pre = {k: (v[:, :start] if k == "tokens" else v)
               for k, v in inputs.items()} if start else inputs

        def prefill():
            return forward(params, cfg, pre, return_kv=True, last_only=True)

        last, kv = prefill()
        line["prefill_tokens"] = batch * (start or seq)
        line["prefill_ms"] = _median_ms(prefill, iters=5, warmup=1,
                                        device_only=False)
        line["decode_ms_per_token_device"] = _decode_device_ms(
            params, cfg, init_decode_state(cfg, batch, seq), tokens)
        state = init_decode_state(cfg, batch, seq)
        if cfg.enc_dec:
            state = prep_cross_attention(params, cfg, inputs["enc_embeds"],
                                         state)
        if start:
            line["prefill_last_vs_forward_rel_err"] = _trel(
                last[:, 0], ref[:, start - 1])
            assert line["prefill_last_vs_forward_rel_err"] < tol, line
            state["k"][:, :, :start] = kv[0]
            state["v"][:, :, :start] = kv[1]
            state["pos"].fill_(start)
        del kv, last
        dec, eager_ms, graph_ms = _teacher_forced(params, cfg, tokens, state,
                                                  start)
        want = ref[:, start:]
        line["decode_vs_forward_rel_err"] = _trel(dec, want)
        line["argmax_equal_share"] = float(
            (dec.argmax(-1) == want.argmax(-1)).float().mean())
        line["decode_ms_per_token_wall"] = eager_ms
        line["decode_ms_per_token_graph_replay"] = graph_ms
    line["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    line["tol"] = tol
    print("full_model: " + json.dumps(line), flush=True)
    assert bool(torch.isfinite(dec).all()), "non-finite decode logits"
    assert line["decode_vs_forward_rel_err"] < tol, line
    del params, ref, dec, want, state
    gc.collect()
    torch.cuda.empty_cache()
    return line


def full_model_phase(card, models=FULL_MODELS):
    """Phase 9: Gemma-3-12B, Mamba2-780m, Hymba-1.5B and Whisper-large-v3
    at full width and depth in bf16 (timed), then each in float32 (full
    depth, or cut to its float32 depth in ``models``)."""
    lines = [full_model_run(card, arch, "bfloat16", b, s, n, banded=band)
             for arch, b, s, n, _, band in models]
    lines += [full_model_run(card, arch, "float32", b, s, n, n_layers=depth,
                             banded=band)
              for arch, b, s, n, depth, band in models]
    return lines


# ---------------------------------------------------------------------------
# phase 10: training (repro_torch.training) at full width
# ---------------------------------------------------------------------------

# the first bf16 step's loss against the loss of a float32 copy of the
# same weights on the same batch, relative: bf16 rounds every product and
# the residual stream (2^-9 a rounding) through 8 layers, and the loss
# (~12 nats at random weights) is a mean over 8192 tokens
TRAIN_LOSS_TOL = 1e-2
# phase 10's runs: (name, arch, layers (None: full depth), seq_len,
# global_batch, grad_accum, steps)
TRAIN_RUNS = (("llama31-8b", 8, 2048, 4, 2, 8),
              ("mamba2-780m", None, 2048, 2, 1, 4))


def _train_flops(cfg, batch, seq):
    """Operations of one train step of a dense attention model: 6 x the
    parameters that enter a product (every layer's projections and MLP and
    the head; the embedding is a gather) x tokens (forward 2, backward 4),
    plus the attention's score and value products over the full S x S
    rectangle, as the port's chunked attention computes it (in float32),
    4 S^2 H hd a sequence and layer forward, 3x with the backward.  The
    remat's second forward is not counted."""
    d = cfg.d_model
    per_layer = (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
                 + 3 * d * cfg.d_ff)
    in_products = cfg.n_layers * per_layer + d * cfg.vocab_size
    attn = (3 * 4 * seq * seq * cfg.n_heads * cfg.head_dim * batch
            * cfg.n_layers)
    return {"in_products_params": in_products,
            "flops_dense": 6.0 * in_products * batch * seq,
            "flops_attention": float(attn)}


def train_run(card, arch, n_layers, seq, batch, grad_accum, steps):
    """``steps`` train steps through ``Trainer.run`` at full width (bf16,
    AdamW by ``for_arch``, lr 3e-4, remat on, weights from seed 0 with
    wq/wk at fan-in, ``DataConfig(seq_len=seq, global_batch=batch,
    seed=17)``), each step's device time from CUDA events around the train
    step; first (dense models) the loss of a float32 copy of the same
    weights on step 0's batch, computed and freed before the optimizer
    state exists.  Checks: every loss and grad norm finite, the last loss
    below the first, the first loss within ``TRAIN_LOSS_TOL`` of the
    float32 copy's.  One ``train:`` JSON line."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.training import DataConfig, TrainConfig, Trainer
    from repro_torch.training.optimizer import leaves, map_leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = _full_model(arch, "bfloat16", n_layers)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, seed=17)
    tr = Trainer(cfg, TrainConfig(steps=steps, grad_accum=grad_accum,
                                  lr=3e-4, seed=0), dcfg)
    n_params = sum(v.numel() for _, v in leaves(params))
    line = {"card": card, "model": cfg.name, "dtype": "bfloat16",
            "layers": cfg.n_layers, "full_depth": n_layers is None,
            "params": n_params, "optimizer": tr.opt.name,
            "seq_len": seq, "global_batch": batch, "grad_accum": grad_accum,
            "steps": steps, "remat": True,
            "tokens_per_step": batch * seq}
    dense = cfg.family == "dense"
    if dense:
        f32 = map_leaves(lambda t: t.float(), params)
        with torch.no_grad():
            line["loss_f32_step0"] = float(loss_fn(
                f32, dataclasses.replace(cfg, dtype="float32"),
                tr.data.batch_at(0)))
        del f32
        gc.collect()
        torch.cuda.empty_cache()
    tr.params = params
    tr.opt_state = tr.opt.init(params)
    del params
    line["init_s"] = time.perf_counter() - t0
    inner, events = tr.step_fn, []

    def timed_step(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = inner(*args)
        end.record()
        events.append((start, end))
        return out

    tr.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = [h for h in tr.run() if "loss" in h]
    torch.cuda.synchronize()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    device_ms = [s.elapsed_time(e) for s, e in events]
    wall = [h["step_time"] for h in hist]
    line.update(
        losses=losses, grad_norms=norms, step_wall_s=wall,
        step_device_ms=device_ms,
        tokens_per_s_wall_after_first=(batch * seq * (steps - 1)
                                       / sum(wall[1:])),
        device_ms_per_step_after_first=statistics.mean(device_ms[1:]),
        first_step_wall_s=wall[0],
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
        stragglers=len(tr.history) - len(hist))
    if dense:
        line.update(_train_flops(cfg, batch, seq))
        flops = line["flops_dense"] + line["flops_attention"]
        line["share_of_bf16_peak"] = (
            flops / (line["device_ms_per_step_after_first"] / 1e3)
            / PEAK_FLOPS["bfloat16"])
        line["first_loss_vs_f32_rel"] = (abs(losses[0]
                                             - line["loss_f32_step0"])
                                         / abs(line["loss_f32_step0"]))
    print("train: " + json.dumps(line), flush=True)
    assert all(math.isfinite(x) for x in losses + norms), line
    assert losses[-1] < losses[0], line
    if dense:
        assert line["first_loss_vs_f32_rel"] <= TRAIN_LOSS_TOL, line
    _profile_train_step(card, cfg.name, tr)
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()
    return line


def _profile_train_step(card, model, tr):
    """One more train step (the step after the run's last) under
    torch.profiler (CUDA activity): the device's busy share of the step's
    wall time, and the kernels that take the most device time, each
    with its share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = tr.data.batch_at(tr.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.step_fn(tr.params, tr.opt_state, batch, tr.step)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print(f"train_profile ({model}): the profiler recorded no device "
              "time (not measured)", flush=True)
        return
    print("train_profile: " + json.dumps({
        "card": card, "model": model, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_names": len(kernels),
        "launches": sum(e.count for e in kernels)}), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print("train_profile_kernel " + json.dumps({
            "model": model, "name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share_of_busy": e.self_device_time_total / busy_us}),
            flush=True)


def _remat_child() -> None:
    """Phase 10 (b), in its own process (started with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, deterministic algorithms on):
    one forward and backward of Llama-3.1-8B's first 8 layers at B 1 x S
    2048 (bf16, seed 0, wq/wk at fan-in) with remat on, then off, then
    each once more: the loss and every gradient leaf of the first two
    must have the same bits; each arm's ms from its second run (host
    clock around a synchronised step; the first run of an arm also grows
    the caching allocator) and its peak device memory."""
    import torch
    from repro_torch.training import DataConfig, SyntheticLM
    from repro_torch.training.train_step import value_and_grad
    torch.use_deterministic_algorithms(True)
    cfg, params = _full_model("llama31-8b", "bfloat16", n_layers=8)
    batch = SyntheticLM(cfg, DataConfig(seq_len=2048, global_batch=1,
                                        seed=17)).batch_at(0)
    line = {"model": cfg.name, "layers": cfg.n_layers, "batch": 1,
            "seq_len": 2048, "deterministic": True}
    arms = {}
    for remat in (True, False, True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(params, cfg, batch, remat=remat)
        torch.cuda.synchronize()
        key = "remat_on" if remat else "remat_off"
        line[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3
        line[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        line[f"{key}_activation_peak_gib"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        if key not in arms:          # the second run of an arm is timed
            arms[key] = (loss, grads)
        del loss, grads
    (l_on, g_on), (l_off, g_off) = arms["remat_on"], arms["remat_off"]
    line["loss"] = float(l_on)
    line["loss_same_bits"] = bool(torch.equal(l_on, l_off))
    line["grad_leaves"] = len(g_on)
    line["grad_leaves_same_bits"] = sum(
        bool(torch.equal(g_on[k], g_off[k])) for k in g_on)
    line["grads_finite"] = all(bool(torch.isfinite(g).all())
                               for g in g_on.values())
    print("train_remat_child: " + json.dumps(line), flush=True)


def train_phase(card):
    """Phase 10: (a) Llama-3.1-8B at full width cut to 8 layers, 8 steps;
    (b) remat on against off in a child process under deterministic
    algorithms; (c) Mamba2-780m at full width and depth, 4 steps."""
    import os
    lines = [train_run(card, *TRAIN_RUNS[0])]
    run = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--train-remat"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    child = [ln for ln in run.stdout.splitlines()
             if ln.startswith("train_remat_child: ")]
    if run.returncode != 0 or not child:
        print((run.stdout + run.stderr)[-6000:], flush=True)
        raise AssertionError(f"phase 10 (b) failed (exit {run.returncode})")
    remat = json.loads(child[-1].split(": ", 1)[1])
    remat["card"] = card
    print("train_remat: " + json.dumps(remat), flush=True)
    if not (remat["loss_same_bits"] and remat["grads_finite"]
            and remat["grad_leaves_same_bits"] == remat["grad_leaves"]):
        raise AssertionError(f"remat on and off differ: {remat}")
    lines.append(train_run(card, *TRAIN_RUNS[1]))
    return lines, remat


# ---------------------------------------------------------------------------
# phase 11: the sharded full model and the launcher
# ---------------------------------------------------------------------------

# (mesh, contexts of the batch's rows): B 4 sequence-sharded over 2 and 4
# shards, and B 1 (32768 tokens) over a (2, 2) mesh, where the batch does
# not divide over data and the cache's sequence takes (data, model)
SHARDED_DECODE_RUNS = (((1, 2), (8192, 6000, 3000, 1)),
                       ((1, 4), (8192, 6000, 3000, 1)),
                       ((2, 2), (32768,)))
SHARDED_DECODE_STEPS = 8
# Kimi-K2's forward: B 4 x 256 tokens over (data 4, model 2)
KIMI_MESH, KIMI_BATCH, KIMI_TOKENS = (4, 2), 4, 256


def _one_card_mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"),
                     devices=["cuda:0"] * math.prod(shape))


def _events_ms(fn):
    """(fn(), its CUDA-event ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _random_decode_state(cfg, contexts, slots, dtype):
    """A decode state at ``contexts`` whose K/V caches hold the same
    random bf16 values on every call (a seeded generator), in ``dtype``
    (float32: the bf16 values, exactly)."""
    import torch
    from repro_torch.models import init_decode_state
    state = init_decode_state(dataclasses.replace(cfg, dtype="bfloat16"),
                              len(contexts), slots)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for key in ("k", "v"):
        state[key] = state[key].normal_(generator=gen).to(
            getattr(torch, dtype))
    state["pos"] = torch.tensor(contexts, dtype=torch.int32, device="cuda")
    return state


def _decode_trajectory(cfg, params, state, tokens, ctx=None):
    """Teacher-forced ``decode_step`` over ``tokens`` (steps, B) from
    ``state`` (under ``ctx`` when given): float32 logits (steps, B, V),
    CUDA-event ms a step, and the collectives of the last step."""
    import torch
    from repro_torch.distributed import use_dist
    from repro_torch.models import decode_step
    logits, ms, counts = [], [], None
    with torch.no_grad():
        for tok in tokens:
            if ctx is None:
                (lg, state), t_ms = _events_ms(
                    lambda: decode_step(params, cfg, state, tok))
            else:
                ctx.mesh.log.clear()
                with use_dist(ctx):
                    (lg, state), t_ms = _events_ms(
                        lambda: decode_step(params, cfg, state, tok))
                counts = ctx.mesh.log.summary(0)
            logits.append(lg.float())
            ms.append(t_ms)
    return torch.stack(logits), ms, counts


def sharded_decode_run(card, models, shape, contexts):
    """(a) One mesh: ``decode_step`` under ``make_context(cfg, mesh,
    "decode", batch_size=B)`` on a state placed by ``shard_decode_state``
    (its pieces views of the cache) against the unsharded ``decode_step``,
    teacher-forced over the same random tokens from the same random
    caches, in bf16 and in float32 (``models``: dtype -> (cfg, params)).
    Float32 is held to ``FULL_TOL``: there the comparison sees the
    sharding. In bf16 a 32-layer decode with random weights is itself
    far from its float32 (the unsharded step 0.05-0.27 from it on this
    card, ``PERF.md`` §6), so the bf16 errors are printed beside the
    unsharded bf16 step's own gap from float32, and held to finite
    logits. ms a step by CUDA events
    (the eager, host-bound step as the device's timeline sees it)."""
    import torch
    from repro_torch.distributed import make_context
    from repro_torch.models import shard_decode_state
    B = len(contexts)
    L = models["bfloat16"][0].n_layers
    S = max(contexts) + SHARDED_DECODE_STEPS
    tokens = torch.randint(
        0, models["bfloat16"][0].vocab_size, (SHARDED_DECODE_STEPS, B),
        generator=torch.Generator(device="cuda").manual_seed(5),
        device="cuda")
    mesh = _one_card_mesh(shape)

    def trajectories():
        out = {}
        for dtype, (cfg, params) in models.items():
            ctx = make_context(cfg, mesh, "decode", batch_size=B)
            state = _random_decode_state(cfg, contexts, S, dtype)
            out[dtype] = _decode_trajectory(cfg, params, state, tokens)
            del state
            state = _random_decode_state(cfg, contexts, S, dtype)
            sharded = shard_decode_state(state, ctx)
            assert all(p.untyped_storage().data_ptr()
                       == state["k"].untyped_storage().data_ptr()
                       for p in sharded["k"].pieces)         # views
            out[dtype + "_sharded"] = _decode_trajectory(
                cfg, params, sharded, tokens, ctx)
            del state, sharded
            torch.cuda.empty_cache()
        return out, ctx

    (out, ctx), launches, _ = _counted(trajectories)

    def worst(a, b):
        return max(_trel(x, y) for x, y in zip(out[a][0], out[b][0]))

    def equal(a, b):
        return float((out[a][0].argmax(-1) == out[b][0].argmax(-1))
                     .float().mean())

    cfg = models["bfloat16"][0]
    kv = 2 * L * cfg.n_kv_heads * cfg.head_dim * 2          # bf16 a token
    counts = out["bfloat16_sharded"][2]
    line = {
        "run": "decode", "card": card, "model": cfg.name, "layers": L,
        "mesh": dict(mesh.shape), "batch": B, "contexts": list(contexts),
        "cache_slots": S, "rules": {k: ctx.rules[k] for k in
                                    ("batch", "kv_seq")},
        "kv_gib_held": sum(contexts) * kv / 2**30,
        "kv_gib_allocated": B * S * kv / 2**30,
        "steps": SHARDED_DECODE_STEPS,
        "f32_worst_rel_err": worst("float32_sharded", "float32"),
        "f32_tolerance": FULL_TOL["float32"],
        "f32_argmax_equal_share": equal("float32_sharded", "float32"),
        "bf16_worst_rel_err": worst("bfloat16_sharded", "bfloat16"),
        "bf16_argmax_equal_share": equal("bfloat16_sharded", "bfloat16"),
        "bf16_sharded_vs_f32": worst("bfloat16_sharded", "float32"),
        "bf16_unsharded_vs_f32": worst("bfloat16", "float32"),
        "ms_per_token": statistics.median(out["bfloat16_sharded"][1][1:]),
        "unsharded_ms_per_token": statistics.median(
            out["bfloat16"][1][1:]),
        "f32_ms_per_token": statistics.median(
            out["float32_sharded"][1][1:]),
        "f32_unsharded_ms_per_token": statistics.median(
            out["float32"][1][1:]),
        "collectives_per_step": counts, "kernel_launches": launches}
    print("sharded_model: " + json.dumps(line), flush=True)
    assert line["f32_worst_rel_err"] < FULL_TOL["float32"], line
    assert all(bool(torch.isfinite(v[0]).all()) for v in out.values())
    for name in ("bfloat16_sharded", "float32_sharded"):
        assert {k: v["count"] for k, v in out[name][2].items()} == {
            "all-reduce": 3 * L}, out[name][2]
    n = mesh.size_of(ctx.rules["kv_seq"])
    assert mesh.log.ops(0) == {("all-reduce", "max", n): L,
                               ("all-reduce", "sum", n): 2 * L}
    assert not any(launches.values()), launches    # plain PyTorch path
    return line


def sharded_decode_phase(card, cfg, params):
    """Phase 11 (a): Llama-3.1-8B (phase 3's weights, and a float32 copy
    of them) decoding over a sequence-sharded cache on each mesh of
    ``SHARDED_DECODE_RUNS``."""
    import torch
    params32 = {k: {n: t.float() for n, t in v.items()}
                if isinstance(v, dict) else v.float()
                for k, v in params.items()}
    models = {"bfloat16": (cfg, params),
              "float32": (dataclasses.replace(cfg, dtype="float32"),
                          params32)}
    lines = []
    for shape, contexts in SHARDED_DECODE_RUNS:
        lines.append(sharded_decode_run(card, models, shape, contexts))
        gc.collect()
        torch.cuda.empty_cache()
    assert lines[-1]["rules"] == {"batch": None,
                                  "kv_seq": ("data", "model")}, lines[-1]
    del models, params32
    gc.collect()
    torch.cuda.empty_cache()
    return lines


def kimi_config():
    """Kimi-K2-1T-A32B at full width (d 7168, 64 heads of 112, 384
    experts of d_ff 2048, top 8, vocab 163840) cut to its first layer, so
    that its weights (36.1 GiB in bf16) fit on one card beside the
    all-to-all's buffers; and the cuts, as (full, run)."""
    from repro_torch.configs import get_config
    full = get_config("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(full, n_layers=1)
    return cfg, {"n_layers": [full.n_layers, cfg.n_layers]}


def kimi_phase(card):
    """Phase 11 (b): Kimi-K2's forward of B 4 x 256 tokens under
    ``moe_alltoall`` on the (data 4, model 2) mesh, every shard on this
    card: dropless, held to the forward through ``moe_ffn_local`` with the
    same attention flags; then at the config's capacity factor 1.25,
    where capacity is counted per data shard (the dropped (token, expert)
    slots of each shard, from its routing), finite logits.  ms (CUDA
    events), peak memory and the collectives of the forward."""
    import torch
    from repro_torch.distributed import make_context, moe_ep, use_dist
    from repro_torch.models import forward, init_params
    cfg, cuts = kimi_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)          # on the card
    for name in ("wq", "wk"):
        params["blocks"][name].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
    torch.cuda.synchronize()
    leaves = list(params["blocks"].items()) + [
        (k, t) for k, t in params.items() if k != "blocks"]
    n_params = sum(t.numel() for _, t in leaves)
    expert_bytes = sum(t.numel() * t.element_size() for k, t in leaves
                       if k in ("we1", "we3", "we2"))
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (KIMI_BATCH, KIMI_TOKENS),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    mesh = _one_card_mesh(KIMI_MESH)
    real_dispatch = moe_ep._dispatch
    lines = []
    for run, moe in (("dropless", dataclasses.replace(cfg.moe,
                                                      dropless=True)),
                     ("capacity", cfg.moe)):
        c = dataclasses.replace(cfg, moe=moe)
        ctx = make_context(c, mesh, "prefill", batch_size=KIMI_BATCH)
        drops = []

        def counting_dispatch(xt, rw, cfg_):
            buf, route = real_dispatch(xt, rw, cfg_)
            drops.append(int((~route["keep"]).sum()))
            return buf, route

        line = {"run": f"kimi_{run}", "card": card, "model": c.name,
                "cuts": dict(cuts, **({"moe.dropless": [
                    cfg.moe.dropless, True]} if run == "dropless" else {})),
                "params_b": n_params / 1e9,
                "weights_gib": sum(t.numel() * t.element_size()
                                   for _, t in leaves) / 2**30,
                "expert_gib": expert_bytes / 2**30, "init_s": init_s,
                "mesh": dict(mesh.shape), "batch": KIMI_BATCH,
                "tokens": KIMI_TOKENS,
                "capacity_factor": moe.capacity_factor,
                "rules": {k: ctx.rules[k] for k in
                          ("batch", "experts", "expert_ffn")}}
        with torch.no_grad():
            if run == "dropless":
                want, line["local_ms"] = _events_ms(lambda: forward(
                    params, c, batch, banded=True, attn_chunk=512))
            torch.cuda.reset_peak_memory_stats()
            mesh.log.clear()
            moe_ep._dispatch = counting_dispatch
            try:
                with use_dist(ctx):
                    got, line["ms"] = _events_ms(
                        lambda: forward(params, c, batch))
            finally:
                moe_ep._dispatch = real_dispatch
        line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counts = mesh.log.summary(0)
        line["collectives"] = counts
        line["dropped_slots_per_data_shard"] = drops
        line["slots_per_data_shard"] = (KIMI_BATCH // KIMI_MESH[0]
                                        * KIMI_TOKENS * moe.top_k)
        assert bool(torch.isfinite(got).all()), line
        assert got.shape == (KIMI_BATCH, KIMI_TOKENS, cfg.vocab_size)
        if run == "dropless":
            line["rel_err_vs_local"] = _trel(got, want)
            line["tolerance"] = FULL_TOL["bfloat16"]
            line["argmax_equal_share"] = float(
                (got.argmax(-1) == want.argmax(-1)).float().mean())
            del want
        print("sharded_model: " + json.dumps(line), flush=True)
        assert len(drops) == KIMI_MESH[0], drops   # one routing a shard
        if run == "dropless":
            assert not any(drops), drops
            assert line["rel_err_vs_local"] < FULL_TOL["bfloat16"], line
        assert {k: v["count"] for k, v in counts.items()} == {
            "all-to-all": 2 * cfg.n_layers,
            "all-reduce": cfg.n_layers}, counts
        del got
        lines.append(line)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return lines


def launcher_phase(card):
    """Phase 11 (c): ``repro_torch.launch.serve`` in process at the JAX
    package's smoke scale on the card: ``real`` and ``online`` (every
    request finishes; the fused kernel once a layer a step), ``sim``, and
    ``--devices 2 --device cuda:0`` (the (o, lse) mode once a shard a
    layer a step); ``--devices 2`` with one card is refused, naming the
    missing card."""
    import contextlib
    import io
    import torch
    from repro_torch.launch.serve import main, parse_args, serve
    from repro_torch.models import init_params
    from repro_torch.serving import RequestState, reference_logits
    lines = []
    for argv in (["--mode", "real"], ["--mode", "online"],
                 ["--mode", "real", "--devices", "2", "--device", "cuda:0"],
                 ["--mode", "sim"]):
        (srv, wl, res), launches, wall = _counted(
            lambda: serve(parse_args(argv)))
        line = {"run": "launcher", "card": card, "argv": argv,
                "requests": res["n_requests"], "failed": res["n_failed"],
                "steps": res["steps"], "wall_s": wall,
                "kernel_launches": launches}
        assert res["n_failed"] == 0 and res["n_requests"] > 0, res
        if argv[1] == "sim":
            assert not any(launches.values()), launches
        else:
            L, steps = srv.cfg.n_layers, srv.engine.steps_executed
            line["engine_steps"] = steps
            if argv[1] == "online":
                assert all(s.requests and all(
                    r.state is RequestState.FINISHED for r in s.requests)
                    for s in wl.sessions)
                want = {"msa_fused": srv.engine.attn_dispatches}
            else:
                assert all(r.state is RequestState.FINISHED for r in wl)
                params = init_params(srv.cfg, seed=0)     # the same draw
                line["worst_rel_err"] = max(
                    _rel(r.first_logits,
                         reference_logits(srv.cfg, params, r.prompt_tokens))
                    for r in wl)
                assert line["worst_rel_err"] < FULL_TOL["float32"], line
                n = srv.engine.n_shards
                want = ({"msa_fused_partial": n * L * steps} if n > 1
                        else {"msa_fused": L * steps})
            want = {k: want.get(k, 0) for k in launches}
            assert launches == want and steps > 0, (launches, want)
        print("sharded_model: " + json.dumps(line), flush=True)
        lines.append(line)
        del srv, wl
    if torch.cuda.device_count() < 2:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["--mode", "real", "--devices", "2"])
        line = {"run": "launcher_refusal", "card": card,
                "argv": ["--mode", "real", "--devices", "2"], "exit": rc,
                "stderr": err.getvalue().strip()}
        print("sharded_model: " + json.dumps(line), flush=True)
        assert rc != 0 and "cuda:1" in line["stderr"], line
        lines.append(line)
    return lines


# ---------------------------------------------------------------------------
# phase 4: where a serving run's device time goes
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: the dry run's predictions held against the card
# ---------------------------------------------------------------------------

# measured peak / the dry run's predicted peak of phase 10's Llama train
# cell, and measured / the lattice's footprint of phase 3's largest
# bucket: the bands PERF.md states, written before the first run on the card
DRYRUN_PEAK_BAND = (0.95, 1.15)
LATTICE_PEAK_BAND = (0.95, 1.10)


def _dryrun_line(card, case, line):
    print(card, flush=True)
    print("dryrun: " + json.dumps(dict(case=case, card=card, **line),
                                  default=float), flush=True)


def _abstract_mesh(shape):
    from repro_torch.launch.mesh import abstract_mesh
    return abstract_mesh(shape, ("data", "model"))


def dryrun_lattice_phase(card, fused):
    """Phase 12 (c): the lattice auditor's footprint of the largest bucket
    phase 3's fused run dispatched (its buffers on the meta device, plus
    the KV pool and the parameters) against phase 3's measured peak (above
    what the card held before its weights)."""
    from repro_torch.analysis import lattice
    cfg, ecfg = fused["cfg"], fused["ecfg"]
    report, _ = lattice.bucket_footprints(cfg, ecfg)
    used = {(t, n) for t, n, _, _ in fused["buckets_used"]}
    rows = [b for b in report["per_bucket"]
            if (b["t_bucket"], b["np_bucket"]) in used and b["k"] == 1]
    big = max(rows, key=lambda b: b["total_bytes"])
    ratio = fused["peak_bytes"] / big["total_bytes"]
    line = {"model": cfg.name,
            "bucket": [big["t_bucket"], big["np_bucket"]],
            "buckets_dispatched": len(fused["buckets_used"]),
            "params_bytes": report["params_bytes"],
            "kv_pool_bytes": report["kv_pool_bytes"],
            "bucket_buffer_bytes": big["buffer_bytes"],
            "predicted_bytes": big["total_bytes"],
            "measured_peak_bytes": fused["peak_bytes"],
            "measured_over_predicted": ratio,
            "band": LATTICE_PEAK_BAND}
    _dryrun_line(card, "lattice", line)
    lo, hi = LATTICE_PEAK_BAND
    assert lo <= ratio <= hi, line


def dryrun_decode_phase(card, cfg, params, decode_lines):
    """Phase 12 (b): Llama-3.1-8B decode at B 4 over phase 11's contexts
    and cache.  At (1, 1) the dry run's FLOPs a step equal
    ``FlopCounterMode``'s count of a real unsharded step on the card; at
    (1, 2) its logged collectives a step equal phase 11's
    ``CollectiveLog`` of the sharded step.  The reckoned ones, which
    GSPMD would add for the tensor-parallel projections and the port's
    path does not issue, are printed beside."""
    import torch
    from repro_torch.configs import SHAPE_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step
    mesh_shape, contexts = SHARDED_DECODE_RUNS[0]
    slots = max(contexts) + SHARDED_DECODE_STEPS
    shape = dataclasses.replace(SHAPE_BY_NAME["decode_32k"], seq_len=slots,
                                global_batch=len(contexts))
    t0 = time.perf_counter()
    one = dryrun.dry_run(cfg, shape, _abstract_mesh((1, 1)))
    two = dryrun.dry_run(cfg, shape, _abstract_mesh(mesh_shape))
    dry_s = time.perf_counter() - t0
    state = _random_decode_state(cfg, contexts, slots, "bfloat16")
    tokens = torch.tensor([3, 5, 7, 9], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        flops = dryrun.count_flops(
            lambda: decode_step(params, cfg, state, tokens))
    del state
    torch.cuda.empty_cache()
    card_line = next(ln for ln in decode_lines
                     if tuple(ln["mesh"].values()) == mesh_shape)
    card_log = card_line["collectives_per_step"]
    tot = two["costs_per_device"]
    logged = {}
    for key, value in tot.items():
        if key.startswith("wire:logged:"):
            kind = key.split(":")[2]
            logged[kind] = {"count": tot[f"count:logged:{kind}"],
                            "wire_bytes": value}
    rf = one["roofline"]
    line = {"model": cfg.name, "layers": cfg.n_layers,
            "contexts": list(contexts), "cache_slots": slots,
            "dry_run_s": dry_s,
            "predicted_flops": one["costs_per_device"]["flops"],
            "measured_flops": flops,
            "predicted_bound_ms": rf["bound_s"] * 1e3,
            "bound_by": rf["bottleneck"],
            "bytes_min": one["costs_per_device"]["bytes_min"],
            "measured_ms_per_token": card_line["unsharded_ms_per_token"],
            "mesh": list(mesh_shape), "predicted_logged": logged,
            "card_log": card_log,
            "reckoned": {k: v for k, v in tot.items() if ":reckoned:" in k}}
    _dryrun_line(card, "decode", line)
    assert line["predicted_flops"] == flops > 0, line
    assert set(logged) == set(card_log), line
    for kind, v in card_log.items():
        assert logged[kind]["count"] == v["count"], line
        assert abs(logged[kind]["wire_bytes"] - v["wire_bytes"]) \
            <= 1e-9 * v["wire_bytes"], line
    assert card_log["all-reduce"]["count"] == 3 * cfg.n_layers, line
    return line


def dryrun_train_phase(card):
    """Phase 12 (a): phase 10's Llama-3.1-8B train cell (8 layers, 4 x
    2048, ``grad_accum`` 2, AdamW, bf16, remat) under its (1, 1) train
    context (the banded attention the dry run's flags give it), against
    the dry run of the same cell: argument bytes equal the step's params,
    optimizer state and int32 batch on the card; the dry run's FLOPs
    equal ``FlopCounterMode``'s count of a real step; the peak above the
    memory held before the model, over the predicted peak, lies in
    ``DRYRUN_PEAK_BAND``.  A first step warms up, a second is counted, a
    third is timed (CUDA events) with the peak statistics reset before
    it."""
    import torch
    from repro_torch.configs import SHAPE_BY_NAME
    from repro_torch.distributed import make_context, use_dist
    from repro_torch.launch import dryrun
    from repro_torch.training import DataConfig, SyntheticLM, make_train_step
    from repro_torch.training.optimizer import for_arch, leaves
    arch, n_layers, seq, batch, accum, _ = TRAIN_RUNS[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg, params = _full_model(arch, "bfloat16", n_layers)
    shape = dataclasses.replace(SHAPE_BY_NAME["train_4k"], seq_len=seq,
                                global_batch=batch)
    t0 = time.perf_counter()
    rec = dryrun.dry_run(cfg, shape, _abstract_mesh((1, 1)),
                         grad_accum=accum)
    dry_s = time.perf_counter() - t0
    opt = for_arch(cfg.param_count())
    state = opt.init(params)
    data = SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch,
                                       seed=17)).batch_at(0)
    data = {k: v.int() for k, v in data.items()}     # the dry run's int32
    held = sum(t.numel() * t.element_size()
               for tree in (params, state, data) for _, t in leaves(tree))
    parts = rec["meta"]["argument_parts"]
    predicted_args = parts["params"] + parts["opt_state"] + parts["batch"]
    step = make_train_step(cfg, opt, grad_accum=accum)
    ctx = make_context(cfg, _one_card_mesh((1, 1)), "train",
                       batch_size=batch)
    with use_dist(ctx):
        step(params, state, data, 0)                  # warm-up
        flops = dryrun.count_flops(lambda: step(params, state, data, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, ms = _events_ms(lambda: step(params, state, data, 2))
    peak = torch.cuda.max_memory_allocated() - base
    mem, rf = rec["memory"], rec["roofline"]
    line = {"model": cfg.name, "layers": n_layers, "seq_len": seq,
            "global_batch": batch, "grad_accum": accum,
            "optimizer": opt.name, "dry_run_s": dry_s,
            "predicted_argument_bytes": predicted_args,
            "measured_argument_bytes": held,
            "predicted_peak_bytes": mem["peak_bytes"],
            "predicted_temp_bytes": mem["temp_bytes"],
            "measured_peak_bytes": peak,
            "measured_over_predicted_peak": peak / mem["peak_bytes"],
            "band": DRYRUN_PEAK_BAND,
            "predicted_flops": rec["costs_per_device"]["flops"],
            "measured_flops": flops,
            "predicted_bound_ms": rf["bound_s"] * 1e3,
            "predicted_compute_ms": rf["compute_s"] * 1e3,
            "predicted_memory_ms": rf["memory_s"] * 1e3,
            "bytes_min": rec["costs_per_device"]["bytes_min"],
            "bytes_unfused": rec["costs_per_device"]["bytes_unfused"],
            "bound_by": rf["bottleneck"], "measured_step_ms": ms,
            "measured_over_bound": ms / (rf["bound_s"] * 1e3),
            "measured_share_of_bf16_peak":
                flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"]}
    _dryrun_line(card, "train", line)
    del params, state, data, step
    gc.collect()
    torch.cuda.empty_cache()
    assert held == predicted_args, line
    assert line["predicted_flops"] == flops > 0, line
    lo, hi = DRYRUN_PEAK_BAND
    assert lo <= line["measured_over_predicted_peak"] <= hi, line
    return line


def profile_phase(make_server, make_workload, mode="fused", n_requests=2):
    """torch.profiler (CUDA activity: the device's kernels and copies; the
    host's ops are not recorded, whose events took minutes to gather over
    a sharded run) over a short serving run of ``n_requests`` requests in
    the ``mode`` layout: device time by kernel, the share
    of each attention kernel (every kernel one wrapper call launches: the
    kernel and its merge), its mean device time a call, and the device's
    idle share of the run's wall time (the profiler's own host cost
    included, so the idle share is an upper bound).  In the split layout,
    also how many prefill launches had no valid row (the steps with no
    prefill chunk launch it over padding rows only).  ``mode`` "sharded":
    a sharded fused server, whose calls are the (o, lse) mode's (the
    profiler names its kernels ``msa_fused_*`` too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    srv = make_server(mode)
    wl = make_workload(seed=2)[:n_requests]
    names = (("msa_prefill", "msa_decode") if mode == "split"
             else ("msa_fused",))
    counters = _kernel_counts()
    if mode == "sharded":
        counters["msa_fused"] = counters["msa_fused_partial"]
    dispatch, no_prefill = srv.engine.dispatch, []

    def counting_dispatch(plan):
        no_prefill.append(not plan.prefills)
        return dispatch(plan)

    srv.engine.dispatch = counting_dispatch
    torch.cuda.synchronize()
    calls0 = {n: counters[n].launches for n in names}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = srv.run(wl)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print(f"profile ({mode}): the profiler recorded no device time "
              "(not measured)", flush=True)
        return
    line = {"model": srv.engine.cfg.name, "layout": mode,
            "n_shards": srv.engine.n_shards,
            "steps": res["steps"], "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_ms_per_step": busy_us / 1e3 / res["steps"]}
    for n in names:
        us = sum(e.self_device_time_total for e in kernels if n in e.key)
        calls = counters[n].launches - calls0[n]
        line[f"{n}_share_of_busy"] = us / busy_us
        line[f"{n}_calls"] = calls
        line[f"{n}_device_ms_per_call"] = us / 1e3 / max(calls, 1)
    if mode == "split":
        line["prefill_launches_without_valid_row"] = (
            sum(no_prefill) * srv.engine.cfg.n_layers)
    print("profile: " + json.dumps(line), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print("profile_kernel " + json.dumps({
            "model": srv.engine.cfg.name, "layout": mode,
            "name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share_of_busy": e.self_device_time_total / busy_us}),
            flush=True)


# ---------------------------------------------------------------------------
# phase 13: the examples (repro_torch.examples) on the card
# ---------------------------------------------------------------------------

# phase 13 (b)'s simulations: their parity with the reference is held on
# the CPU (tests/test_torch_examples_sim.py); here one short run each
SIM_JOBS, SIM_SESSIONS = 3, 4
TRAIN_STEPS, TRAIN_RESUME_STEPS = 20, 30


def _fused_launches(n):
    return {name: n if name == "msa_fused" else 0 for name in _kernel_counts()}


def _all_finished(requests):
    return all(r.status == "finished" for r in requests)


def prefix_sharing_full_phase(card, fused):
    """Phase 13 (a): ``repro_torch.examples.prefix_sharing.run`` on phase
    3's Llama-3.1-8B bf16 weights (full width and depth, no new draw): the
    example's own workload (10 jobs, 80% behind a 280-token preamble) with
    sharing on and then off, 320 blocks, on the model clock.  Every
    request finishes; ``msa_fused`` launches L x the engine steps of both
    arms; the sharing arm forks copy-on-write and computes fewer prefill
    tokens; every request's first logits (both arms) within
    ``FULL_TOL["bfloat16"]`` of the dense reference; the share of equal
    first sampled ids between the arms."""
    from repro_torch.examples import prefix_sharing
    from repro_torch.serving import reference_logits
    cfg, params = fused["cfg"], fused["params"]
    out, launches, wall = _counted(lambda: prefix_sharing.run(
        cfg, params, clock="model", device="cuda"))
    shared, base = out["shared"], out["baseline"]
    wl, base_wl = out["requests"], out["baseline_requests"]
    steps = shared["engine_dispatches"] + base["engine_dispatches"]
    base_worst = max(
        _rel(r.first_logits, reference_logits(cfg, params, r.prompt_tokens))
        for r in base_wl)
    same = [a.sampled_ids[:1] == b.sampled_ids[:1]
            for a, b in zip(wl, base_wl)]
    line = {"run": "prefix_sharing_full", "card": card, "model": cfg.name,
            "layers": cfg.n_layers, "dtype": cfg.dtype, "requests": len(wl),
            "steps_shared": shared["steps"], "steps_baseline": base["steps"],
            "prefill_compute_tokens": shared["prefill_compute_tokens"],
            "baseline_prefill_compute_tokens":
                base["prefill_compute_tokens"],
            "prefix_matched_tokens": shared["prefix_matched_tokens"],
            "cow_forks": shared["cow_forks"],
            "block_hit_rate": shared["block_hit_rate"],
            "kernel_launches": launches, "worst_rel_err": out["worst_rel_err"],
            "baseline_worst_rel_err": base_worst,
            "tolerance": FULL_TOL["bfloat16"],
            "equal_first_sampled_ids": sum(same) / len(same), "wall_s": wall}
    print("example: " + json.dumps(line), flush=True)
    assert _all_finished(wl) and _all_finished(base_wl), line
    assert launches == _fused_launches(cfg.n_layers * steps), line
    assert shared["attn_dispatches"] + base["attn_dispatches"] == \
        cfg.n_layers * steps, line
    assert shared["cow_forks"] > 0, line
    assert shared["prefill_compute_tokens"] < \
        base["prefill_compute_tokens"], line
    assert out["worst_rel_err"] < FULL_TOL["bfloat16"], line
    assert base_worst < FULL_TOL["bfloat16"], line
    return line


def examples_phase(card):
    """Phase 13 (b): the examples in process on the card at the JAX
    package's sizes (the float32 smoke Llama, weights from seed 0):
    ``quickstart`` (its losslessness assert; launches L x steps),
    ``prefix_sharing`` (the same, over both arms; every request of both
    finishes), ``serve_multiturn --real`` (its worst first-logit
    |difference| under 2e-3 x the largest |reference logit|, the CPU
    test's bar), ``serve_online`` (its asserts: every block reference
    released, zero resume stalls; launches ``attn_dispatches``),
    ``train_lm`` (``CONFIG_100M``, 20 steps into a directory under
    ``build/``, then resumed to 30: the resume starts at 20, the loss
    falls, no kernel launch; then one more step under the profiler: the
    device's busy share) and one short run of each simulation (no kernel
    launch).  One ``example:`` JSON line each."""
    import shutil
    import torch
    from repro_torch.examples import (agentic_continuum, prefix_sharing,
                                      quickstart, serve_multiturn,
                                      serve_online, train_lm)
    from repro_torch.examples._smoke import LOSSLESS_REL_TOL, smoke_model
    from repro_torch.serving import reference_logits
    cfg, params, _ = smoke_model(None, None, "cuda")     # seed 0's draw
    L = cfg.n_layers
    lines = []

    def record(name, launches, wall, want, **kw):
        line = {"run": "example", "card": card, "example": name,
                "wall_s": wall, "kernel_launches": launches, **kw}
        print("example: " + json.dumps(line), flush=True)
        assert launches == want, (line, want)
        lines.append(line)
        return line

    out, launches, wall = _counted(lambda: quickstart.run(device="cuda"))
    res = out["summary"]
    record("quickstart", launches, wall,
           _fused_launches(L * res["engine_dispatches"]),
           steps=res["steps"], evictions=res["evictions"],
           ttft_mean_s=res["ttft_mean"], tpot_mean_s=res["tpot_mean"],
           block_hit_rate=res["block_hit_rate"],
           worst_rel_err=out["worst_rel_err"])
    assert _all_finished(out["requests"])
    assert out["worst_rel_err"] < LOSSLESS_REL_TOL

    out, launches, wall = _counted(lambda: prefix_sharing.run(device="cuda"))
    res, base = out["shared"], out["baseline"]
    record("prefix_sharing", launches, wall, _fused_launches(
        L * (res["engine_dispatches"] + base["engine_dispatches"])),
        prefill_compute_tokens=res["prefill_compute_tokens"],
        baseline_prefill_compute_tokens=base["prefill_compute_tokens"],
        prefix_matched_tokens=res["prefix_matched_tokens"],
        cow_forks=res["cow_forks"], worst_rel_err=out["worst_rel_err"])
    assert _all_finished(out["requests"]) and res["cow_forks"] > 0
    assert _all_finished(out["baseline_requests"])
    assert out["worst_rel_err"] < LOSSLESS_REL_TOL

    out, launches, wall = _counted(
        lambda: serve_multiturn.run_real(cfg, params, device="cuda"))
    res = out["summary"]
    scale = max(float(np.max(np.abs(
        reference_logits(cfg, params, r.prompt_tokens))))
        for r in out["requests"])
    record("serve_multiturn --real", launches, wall,
           _fused_launches(L * res["engine_dispatches"]),
           steps=res["steps"], evictions=res["evictions"],
           ttft_mean_s=res["ttft_mean"],
           block_hit_rate=res["block_hit_rate"],
           worst_abs_err=out["worst_abs_err"],
           tolerance=LOSSLESS_REL_TOL * scale)
    assert _all_finished(out["requests"])
    assert out["worst_abs_err"] < LOSSLESS_REL_TOL * scale
    del params

    out, launches, wall = _counted(lambda: serve_online.run(device="cuda"))
    res = out["summary"]
    record("serve_online", launches, wall,
           _fused_launches(res["attn_dispatches"]), steps=res["steps"],
           sessions=[s[:3] for s in out["sessions"]],
           streamed=out["streamed"],
           prefetch_swap_ins=res["prefetch_swap_ins"],
           prefetch_hits=res["prefetch_hits"],
           resume_swap_stalls=res["resume_swap_stalls"],
           job_latency_mean_s=res["agent_job_latency_mean"])
    assert out["released"] and res["resume_swap_stalls"] == 0
    assert out["cancelled_after"] == serve_online.CANCEL_AFTER
    assert res["attn_dispatches"] > 0

    ckpt = Path(__file__).resolve().parent / "build" / "examples_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = []
    for steps in (TRAIN_STEPS, TRAIN_RESUME_STEPS):
        out, launches, wall = _counted(lambda: train_lm.run(
            steps=steps, ckpt_dir=str(ckpt), device="cuda"))
        runs.append(record(
            "train_lm", launches, wall, _fused_launches(0),
            params=train_lm.CONFIG_100M.param_count(), start=out["start"],
            step=out["step"], first_loss=out["losses"][0],
            last_loss=out["losses"][-1],
            step_s_median=statistics.median(
                h["step_time"] for h in out["history"] if "step_time" in h)))
        assert out["step"] == steps and np.all(np.isfinite(out["losses"]))
    assert runs[1]["start"] == TRAIN_STEPS, runs
    assert runs[1]["last_loss"] < runs[0]["first_loss"], runs
    shutil.rmtree(ckpt, ignore_errors=True)
    _profile_train_step(card, train_lm.CONFIG_100M.name, out["trainer"])
    del out

    out, launches, wall = _counted(
        lambda: agentic_continuum.run(n_jobs=SIM_JOBS))
    record("agentic_continuum", launches, wall, _fused_launches(0),
           n_jobs=SIM_JOBS, job_latency_mean_s={
               k: r["job_latency_mean"] for k, r in out.items()})
    assert all(r["n_requests"] > 0 for r in out.values())
    out, launches, wall = _counted(
        lambda: serve_multiturn.run_sim(n_sessions=SIM_SESSIONS))
    record("serve_multiturn", launches, wall, _fused_launches(0),
           n_sessions=SIM_SESSIONS,
           evictions={k: r["evictions"] for k, r in out.items()})
    assert all(r["n_requests"] > 0 for r in out.values())
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# phase 14: the recomputation cost model (Eq. 6) fitted on the card
# ---------------------------------------------------------------------------

# the phase's engine: one prefill chunk of up to 512 tokens over contexts
# up to 4096 tokens (256 pages), a pool that holds one such context and
# the fresh pages of a checked instance's recompute
COST_ENGINE = dict(num_pages=320, page_size=16, max_prefills=1,
                   max_chunk=512, max_decodes=8, max_blocks_per_seq=256)
COST_INSTANCES = 128
COST_CHECKED = 3        # instances held to the dense reference first
COST_RUNS = 3           # timed runs an instance, after one warm-up
COST_SEED = 14
# (lo, hi) of l1, q1, l2, q2 in tokens; the chunk q1 + q2 at most 512
COST_RANGES = ((0, 2048), (16, 384), (0, 1024), (16, 256))
# a page filled with it reads as scores far off the data's, so a read of
# a fresh page that the plan should have written shows in the logits
STALE_PAGE_VALUE = 30.0


def cost_instances(n, seed=COST_SEED, page=16):
    """``n`` page-aligned two-segment instances ``(l1, q1, l2, q2)``
    drawn uniformly from ``COST_RANGES``: a resident prefix of l1 tokens,
    q1 recomputed (the evicted middle), a resident l2 and q2 new tokens,
    one chunk of q1 + q2 <= ``max_chunk`` tokens."""
    rng = np.random.default_rng(seed)
    cap = COST_ENGINE["max_chunk"]
    out = []
    while len(out) < n:
        inst = tuple(page * int(rng.integers(lo // page, hi // page + 1))
                     for lo, hi in COST_RANGES)
        if inst[1] + inst[3] <= cap:
            out.append(inst)
    return out


def two_segment_plan(srv, inst, rid, rng, now=0.0):
    """One instance ``(l1, q1, l2, q2)`` built by hand through the
    server's block manager: a request of l1 + q1 + l2 + q2 random prompt
    tokens with a pool page allocated for each of its blocks, and the plan
    of one prefill chunk that recomputes the q1 tokens after the resident
    l1 and computes the q2 new tokens after the resident l2 (two
    segments).  Returns (request, plan)."""
    from repro_torch.serving import PrefillChunk, Request, StepPlan
    l1, q1, l2, q2 = inst
    bs = srv.scfg.block_size
    n = l1 + q1 + l2 + q2
    assert all(x % bs == 0 for x in inst) and q1 > 0 and q2 > 0, inst
    req = Request(rid=rid, session_id=rid,
                  prompt_tokens=rng.integers(0, srv.cfg.vocab_size,
                                             n).tolist(),
                  output_script=[0], arrival=now)
    req.block_slots = srv.bm.allocate(n // bs, now)
    assert req.block_slots is not None, ("pool too small", inst)
    pos = np.r_[l1:l1 + q1, l1 + q1 + l2:n].astype(np.int32)
    return req, StepPlan(prefills=[PrefillChunk(req, pos, True)])


def make_resident(srv, req, inst, now=0.0):
    """Compute every position of ``req``'s prompt into its pages (chunks
    of the engine's ``max_chunk``), then evict the q1 and q2 segments:
    their blocks get fresh pages from the block manager, filled with
    ``STALE_PAGE_VALUE``, and their old pages are freed.  The instance's
    two-segment plan then recomputes into the fresh pages over the
    resident l1 and l2."""
    import torch
    from repro_torch.serving import PrefillChunk, StepPlan
    eng, bs = srv.engine, srv.scfg.block_size
    n = req.prompt_len
    for s in range(0, n, eng.ecfg.max_chunk):
        pos = np.arange(s, min(s + eng.ecfg.max_chunk, n), dtype=np.int32)
        eng.execute(StepPlan(prefills=[
            PrefillChunk(req, pos, bool(pos[-1] == n - 1))]))
    l1, q1, l2, _ = inst
    blocks = [*range(l1 // bs, (l1 + q1) // bs),
              *range((l1 + q1 + l2) // bs, n // bs)]
    fresh = srv.bm.allocate(len(blocks), now)
    old = [req.block_slots[b] for b in blocks]
    for b, slot in zip(blocks, fresh):
        req.block_slots[b] = slot
    idx = torch.tensor(fresh, device=eng.k_pools.device)
    eng.k_pools[:, idx] = STALE_PAGE_VALUE
    eng.v_pools[:, idx] = STALE_PAGE_VALUE
    srv.bm.release(old, now)
    req.reset_assembly_caches()


def _eq7_slope(cm):
    """Eq. 7's marginal block cost over its constant term: 2·k5 /
    (k2 − k3 + k5), a token's cost growth with its position."""
    k1, k2, k3, k4, k5, k6 = cm.k
    return 2.0 * k5 / (k2 - k3 + k5)


def link_rates(cfg):
    """The card's copy rates at one swap payload's size (one block's K
    and V halves, all layers, in the pool's dtype): pinned host to device
    and device to host (CUDA events, median of 20, the device alone), and
    pageable host to device (the engine ships its payloads from numpy
    buffers), in bytes a second."""
    import torch
    from repro_torch import torch_dtype
    nbytes = (2 * cfg.n_layers * COST_ENGINE["page_size"] * cfg.n_kv_heads
              * cfg.head_dim * torch_dtype(cfg.dtype).itemsize)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d = _median_ms(lambda: dev.copy_(pinned, non_blocking=True))
    d2h = _median_ms(lambda: pinned.copy_(dev, non_blocking=True))
    paged = _median_ms(lambda: dev.copy_(pageable), device_only=False)
    return {"payload_bytes": nbytes,
            "h2d_pinned_bytes_per_s": nbytes / (h2d / 1e3),
            "d2h_pinned_bytes_per_s": nbytes / (d2h / 1e3),
            "h2d_pageable_bytes_per_s": nbytes / (paged / 1e3)}


def cost_model_phase(card, cfg, params):
    """Phase 14 (after 13 a, on phase 3's Llama-3.1-8B bf16 weights): Eq.
    6 fitted on the card.  The ``COST_CHECKED`` deepest instances first
    made resident (every position computed, then the q1 and q2 segments
    evicted to fresh pages) and held to the dense reference (first logits
    within ``LOGIT_REL_TOL``); then each of ``COST_INSTANCES`` instances
    (``cost_instances``) through ``Engine.dispatch``: a warm-up round
    that runs each one's step eager, captures its layer-0 ``msa_fused``
    inputs and times the kernel alone on them (median of ``COST_RUNS``,
    the device alone: MSA's positional cost), a second warm-up round with
    the step's CUDA graphs on (a bucket's graph is captured at its second
    use), then ``COST_RUNS`` rounds that time each step (CUDA events
    around the dispatch and a sync: the whole step, as the server's model
    prices it, replayed from its bucket's graph; the median of an
    instance's rounds).
    Both fitted with ``core.fit``; one ``cost_fit:`` line each with the
    constants, R², Eq. 7's slope and the analytic H100 model's slope and
    median relative error against the measured steps; then the link
    rates (``link_rates``).  ``msa_fused`` launches L x the dispatches
    (its timing launches are not counted)."""
    import torch
    import repro_torch.serving.engine as engine_mod
    from repro_torch.core import H100, analytic_cost_model, fit
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     ServerConfig, reference_logits)
    t0 = time.perf_counter()
    ecfg = EngineConfig(**COST_ENGINE)
    srv = AsymCacheServer(cfg, params, ServerConfig(
        num_blocks=ecfg.num_pages, block_size=ecfg.page_size), ecfg=ecfg)
    eng, fused = srv.engine, engine_mod.msa_fused
    counters = _kernel_counts()
    launches = dict.fromkeys(counters, 0)
    dispatch = eng.dispatch

    def counted_dispatch(plan):
        before = {n: c.launches for n, c in counters.items()}
        handle = dispatch(plan)
        for n, c in counters.items():
            launches[n] += c.launches - before[n]
        return handle

    eng.dispatch = counted_dispatch
    rng = np.random.default_rng(COST_SEED)
    insts = cost_instances(COST_INSTANCES)
    L = cfg.n_layers

    worst = 0.0
    for i, inst in enumerate(sorted(insts, key=sum)[-COST_CHECKED:]):
        req, plan = two_segment_plan(srv, inst, i, rng)
        make_resident(srv, req, inst)
        got = eng.execute(plan).prefill_logits_np()[0]
        ref = reference_logits(cfg, params, req.prompt_tokens)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), inst
        worst = max(worst, _rel(got, ref))
        srv.bm.release(req.block_slots, 0.0)
    checked_s = time.perf_counter() - t0

    # round 0 runs each instance's step eager (and times its kernel on
    # layer 0's captured inputs: a replayed step calls no Python); round 1
    # warms up the buckets' CUDA graphs; rounds 2..COST_RUNS + 1 time the
    # steps, every instance once a round, so that the host's drift over
    # the phase (its step times wander by ~10 ms over tens of instances)
    # falls on all instances alike
    runs = [[] for _ in insts]
    kernel_ms = []
    for rnd in range(COST_RUNS + 2):
        for i, inst in enumerate(insts):
            req, plan = two_segment_plan(srv, inst, COST_CHECKED + i, rng)
            torch.cuda.synchronize()
            if rnd == 0:
                captured = []

                def capture(*a, **kw):
                    if not captured:          # layer 0's call
                        captured.append((a, kw))
                    return fused(*a, **kw)

                engine_mod.msa_fused = capture
                eng._graph_eligible = lambda params: False
                try:
                    eng.dispatch(plan)
                finally:
                    engine_mod.msa_fused = fused
                    del eng._graph_eligible
                a, kw = captured[0]
                kernel_ms.append(_median_ms(lambda: fused(*a, **kw),
                                            iters=COST_RUNS, warmup=1))
            elif rnd == 1:
                eng.dispatch(plan)
            else:
                runs[i].append(_events_ms(lambda: eng.dispatch(plan))[1])
            srv.bm.release(req.block_slots, 0.0)
    step_ms = [statistics.median(r) for r in runs]
    dispatches = eng.steps_executed
    eng.dispatch = dispatch

    analytic = analytic_cost_model(cfg, H100)
    analytic_err = statistics.median(
        abs(analytic.latency(*inst) - t / 1e3) / (t / 1e3)
        for inst, t in zip(insts, step_ms))
    for what, ms in (("step", step_ms), ("kernel", kernel_ms)):
        cm = fit(insts, [t / 1e3 for t in ms])
        line = {"fit": what, "card": card, "model": cfg.name,
                "layers": L, "dtype": cfg.dtype, "instances": len(insts),
                "runs": COST_RUNS,
                "k": list(cm.k), "beta_s": cm.beta, "r2": cm.r2,
                "eq7_slope_per_token": _eq7_slope(cm),
                "analytic_h100_slope_per_token": _eq7_slope(analytic),
                "analytic_h100_median_rel_err_vs_step": analytic_err,
                "ms_min": min(ms), "ms_median": statistics.median(ms),
                "ms_max": max(ms)}
        print("cost_fit: " + json.dumps(line), flush=True)
        assert all(math.isfinite(v) for v in
                   (*cm.k, cm.beta, cm.r2, line["eq7_slope_per_token"])), \
            line
    rates = link_rates(cfg)
    line = {"run": "cost_model", "card": card, "model": cfg.name,
            "instances": len(insts), "checked": COST_CHECKED,
            "checked_worst_rel_err": worst, "tolerance": LOGIT_REL_TOL,
            "dispatches": dispatches, "kernel_launches": launches,
            "link": rates, "checked_s": checked_s,
            "phase_s": time.perf_counter() - t0,
            "instances_ms": [[*inst, s, k] for inst, s, k in
                             zip(insts, step_ms, kernel_ms)]}
    print("cost_model: " + json.dumps(line), flush=True)
    assert len(insts) >= 128 and len(step_ms) == len(kernel_ms) == len(insts)
    assert worst < LOGIT_REL_TOL, line
    assert launches == _fused_launches(L * dispatches), (launches,
                                                         dispatches)
    assert all(v > 0 and math.isfinite(v) for v in rates.values()), rates


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--memcheck"]:     # memcheck_phase's children
        _memcheck_child(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--train-remat"]:  # phase 10 (b)'s child
        _remat_child()
        return 0

    start = time.perf_counter()

    def done(phase):
        print("phase_done " + json.dumps(
            {"phase": phase, "s": time.perf_counter() - start}), flush=True)

    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    from repro_torch.kernels.msa import _build
    names = ("msa_fused", "msa_prefill", "msa_decode")
    # the memory check's checked build compiles beside the release build
    # and phase 2's kernel checks
    pool = concurrent.futures.ThreadPoolExecutor(1)
    checked = pool.submit(_build.build, names, True)
    for name, secs in _build.build(names).items():
        print(f"build: {name}.cu in {secs:.1f} s (built together)",
              flush=True)
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"build: {name}: " + line.strip(), flush=True)

    done("build")
    fused_results, fused_decode = kernel_phase()
    prefill_main, decode_main = split_kernel_phase(fused_results,
                                                   fused_decode)
    partial_main = partial_kernel_phase()[("main", "bfloat16")]
    done("2 kernels")
    for name, secs in checked.result().items():
        print(f"build: {name}.cu, checked build, in {secs:.1f} s",
              flush=True)
    pool.shutdown()
    memcheck_phase()
    done("2 memcheck")
    torch.cuda.empty_cache()
    fused = serve_phase()
    done("3")
    dryrun_lattice_phase(card, fused)
    done("12c")
    split_launches, fused_model, split_model = split_serve_phase(fused)
    done("3b")
    sync_baseline_phase(card, fused, split_model)
    del split_model
    done("3c")
    for mode in ("fused", "split"):
        profile_phase(fused["make_server"], fused["make_workload"], mode,
                      n_requests=1)
    done("4")
    online_launches = online_phase(fused)
    single_plan_phase(fused)
    done("5")
    offload_phase(fused["cfg"], fused["params"])
    done("6")
    sharded_launches = sharded_phase(fused, fused_model)
    del fused_model
    done("8")
    decode_lines = sharded_decode_phase(card, fused["cfg"], fused["params"])
    done("11a")
    dryrun_decode_phase(card, fused["cfg"], fused["params"], decode_lines)
    done("12b")
    prefix_sharing_full_phase(card, fused)
    done("13a")
    cost_model_phase(card, fused["cfg"], fused["params"])
    done("14")
    # Grok-1's ~43 GB of weights must not meet Llama's 16 GB: drop every
    # reference to Llama's weights and pools (the servers hold cycles)
    del fused
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    print(f"grok: {left:.2f} GiB of device memory held before Grok-1",
          flush=True)
    assert left < 2.0, left
    grok_phase()
    done("7")
    # the full model's weights must not meet Grok-1's either
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    print(f"full_model: {left:.2f} GiB of device memory held before "
          "phase 9", flush=True)
    assert left < 2.0, left
    full_model_phase(card)
    done("9")
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    print(f"train: {left:.2f} GiB of device memory held before phase 10",
          flush=True)
    assert left < 2.0, left
    train_phase(card)
    done("10")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_train_phase(card)
    done("12a")
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    print(f"kimi: {left:.2f} GiB of device memory held before phase 11 "
          "(b)", flush=True)
    assert left < 2.0, left
    kimi_phase(card)
    launcher_phase(card)
    done("11")
    gc.collect()
    torch.cuda.empty_cache()
    examples_phase(card)
    done("13b")
    print(f"total: {time.perf_counter() - start:.1f} s of the script's "
          "phases", flush=True)

    fused_main = fused_results[("main", "bfloat16")]
    src = "src/repro_torch/kernels/msa/csrc/"
    rows = [("msa_fused", "msa_fused.py:146", fused_main,
             online_launches["msa_fused"]),
            ("msa_prefill", "msa_prefill.py:36", prefill_main,
             split_launches["msa_prefill"]),
            ("msa_decode", "msa_decode.py:26", decode_main,
             split_launches["msa_decode"])]
    print(card, flush=True)
    # the fused kernel's (o, lse) mode: no Pallas kernel of its own (the
    # JAX package computes the partial in XLA only, ops.py:69)
    print(json.dumps({"kernel_modes": [{
        "name": "msa_fused_partial", "route": "cuda",
        "source": f"{src}msa_fused.cu",
        "replaces": "src/repro/kernels/msa/ops.py:69 (msa_fused_partial, "
                    "XLA only: no Pallas kernel)",
        "launches": sharded_launches["msa_fused_partial"],
        "max_abs_err": partial_main["max_abs_err"],
        "ms": partial_main["ms"], "plain_ms": partial_main["plain_ms"],
        "bound_ms": partial_main["bound_ms"],
        "bound_by": partial_main["bound_by"], "library_ms": None}]}),
        flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"{src}{name}.cu",
        "replaces": f"src/repro/kernels/msa/{where}",
        "launches": n, "max_abs_err": res["max_abs_err"],
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": None} for name, where, res, n in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
