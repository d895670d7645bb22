#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Usage, from the root of a checkout::

    python3 chip_smoke.py

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and the torch
     version, and build the three CUDA kernels from ``src/repro_torch``
     with ``nvcc``, one compiler each, all at once (each timed).
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
       launched twice and must give the same bits.
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
     chunks, equal first sampled ids, first logits within tolerance.
  4. Profile a short serving run (``torch.profiler``) in each layout:
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
     model clock: equal outputs and first sampled ids, the share of equal
     ids, first logits within tolerance, fewer decode-only dispatches at
     k = 8.  Last, one decode-only plan as one k = 8 dispatch against 8
     single dispatches on the same pools: the same bits in ids and pools.

Prints the card line again, the kernel table (all three kernels) as a
JSON line, and, last, ``{"ok": true, "device": {...}}``.  Any failure
raises (non-zero exit).
Needs a CUDA device and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
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
               q_tile, window=0, softcap=0.0):
    """A mixed varlen step in the engine's layout: prefill chunks (each
    ``(ctx, [(lo, hi), ...])`` position runs) packed first, then decode
    rows, then bucket slack.  Every sequence owns disjoint, shuffled
    (non-contiguous) pool pages."""
    from repro_torch.kernels.msa import build_units, build_worklist, \
        pad_worklist
    ctxs = [c for c, _ in prefills] + list(decode_ctx)
    runs = [np.concatenate([np.arange(lo, hi) for lo, hi in segs])
            for _, segs in prefills]
    runs += [np.asarray([c - 1]) for c in decode_ctx]
    n = len(ctxs)
    n_pages = [-(-c // page) for c in ctxs]
    NP = max(n_pages)
    P = sum(n_pages) + 1
    perm = rng.permutation(P)
    bt = np.zeros((n, NP), np.int32)
    off = 0
    for s, k in enumerate(n_pages):
        bt[s, :k] = perm[off:off + k]
        off += k
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
        wl=wl, units=units,
        real=real, window=window, softcap=softcap, q_tile=tq,
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
    return main, decode, small


def kernel_phase():
    main, decode, small = fused_cases()
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        results[("main", dtype_name)] = _run_case(main, dtype_name,
                                                  time_it=True)
        results[("decode", dtype_name)] = _run_case(decode, dtype_name,
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
    return main_prefill, main_decode, small


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
    main_prefill, main_decode, small = split_cases()
    results = {}
    for dtype_name in ("bfloat16", "float32"):
        results[("prefill", "main", dtype_name)] = _run_split_case(
            "prefill", main_prefill, dtype_name, time_it=True)
        results[("decode", "main", dtype_name)] = _run_split_case(
            "decode", main_decode, dtype_name, time_it=True)
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
# phase 3: serve Llama-3.1-8B at full width through the port
# ---------------------------------------------------------------------------

def _kernel_counts():
    """The launch counters of the three kernel wrappers."""
    from repro_torch.kernels.msa import (msa_decode_cuda, msa_fused_cuda,
                                         msa_prefill_cuda)
    return {"msa_fused": msa_fused_cuda, "msa_prefill": msa_prefill_cuda,
            "msa_decode": msa_decode_cuda}


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
    for fn in _kernel_counts().values():
        fn.launches = 0
    res = serve()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _kernel_counts().items()}
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


def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     ServerConfig, WorkloadConfig,
                                     multi_turn_workload, reference_logits)
    cfg = get_config("llama31-8b")             # 32 layers, d 4096, bf16
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

    def make_workload(**kw):
        return multi_turn_workload(WorkloadConfig(
            n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(512, 2048),
            output_len=(16, 32), qps=0.5, vocab=cfg.vocab_size, **kw))

    # 256 blocks of 16 tokens hold ~2 sessions' contexts: the workload's
    # later turns find part of their history evicted and recompute it
    num_blocks = 256

    def make_server(attn_mode="fused", clock="wall"):
        ecfg = EngineConfig(num_pages=num_blocks, page_size=16,
                            max_prefills=4, max_chunk=128, max_decodes=64,
                            max_blocks_per_seq=128, attn_mode=attn_mode)
        return AsymCacheServer(
            cfg, params, ServerConfig(num_blocks=num_blocks, clock=clock,
                                      attn_mode=attn_mode), ecfg=ecfg)

    # warm-up on a separate server so that the measured run's TTFT does not
    # carry cuBLAS and allocator start-up
    make_server().run(make_workload(seed=1)[:1])
    torch.cuda.synchronize()

    srv = make_server()
    wl = make_workload(seed=0)
    res, seg_chunks, launches = _measured_run(srv, lambda: srv.run(wl))
    steps = srv.engine.steps_executed
    print("serve: " + json.dumps(_serve_line(wl, res, seg_chunks, launches)),
          flush=True)
    assert all(r.status == "finished" for r in wl), \
        [r.status for r in wl]
    assert res["n_requests"] == len(wl)
    assert res["evictions"] > 0, "the pool never evicted"
    assert seg_chunks, "no prefill chunk recomputed a multi-segment history"
    assert res["attn_dispatches_per_step"] == cfg.n_layers
    assert launches == {"msa_fused": cfg.n_layers * steps, "msa_prefill": 0,
                        "msa_decode": 0}, (launches, steps)

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
                refs=refs)


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
                        "msa_decode": L * steps}, (launches, steps)
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
        r_, seg_, launches_ = _measured_run(s_, lambda: s_.run(w_))
        runs[mode] = (w_, r_, seg_)
    (wf, rf, segf), (ws, rs, segs) = runs["fused"], runs["split"]
    same = {k: (rf[k], rs[k]) for k in
            ("steps", "evictions", "prefill_compute_tokens")}
    same["multi_segment_chunks"] = (segf, segs)
    n_ids = sum(len(a.sampled_ids) for a in wf)
    n_equal = sum(x == y for a, b in zip(wf, ws)
                  for x, y in zip(a.sampled_ids, b.sampled_ids))
    first_equal = [a.sampled_ids[:1] == b.sampled_ids[:1]
                   for a, b in zip(wf, ws)]
    vs_fused = [_rel(b.first_logits, a.first_logits) for a, b in zip(wf, ws)]
    vs_dense = [_rel(b.first_logits, ref)
                for b, ref in zip(ws, fused["refs"])]
    print("split_vs_fused: " + json.dumps({
        "clock": "model", "schedule": same,
        "first_sampled_id_equal": sum(first_equal),
        "requests": len(wf),
        "sampled_ids_equal_share": n_equal / n_ids,
        "sampled_ids": n_ids,
        "worst_first_logit_rel_err_vs_fused": max(vs_fused),
        "worst_first_logit_rel_err_vs_dense": max(vs_dense)}), flush=True)
    assert all(a == b for a, b in same.values()), same
    assert all(a.status == b.status == "finished" for a, b in zip(wf, ws))
    assert all(first_equal), first_equal
    assert max(vs_fused) < LOGIT_REL_TOL and max(vs_dense) < LOGIT_REL_TOL
    return launches


# ---------------------------------------------------------------------------
# phase 5: the agentic closed loop with multi-token decode
# ---------------------------------------------------------------------------

ONLINE_K = 8


def _online_run(cfg, params, k, clock):
    """One closed-loop run of the agentic scripts through
    ``OnlineFrontend`` with predictive prefetch over a server with a host
    tier and ``max_decode_steps`` k (see ``_measured_run``)."""
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
    model clock, held to each other.  Returns the kernel counts of the
    k = 8 wall-clock run."""
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
                        "msa_prefill": 0, "msa_decode": 0}, \
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

    runs = {k: _online_run(cfg, params, k, "model") for k in (1, ONLINE_K)}
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
# phase 4: where a serving run's device time goes
# ---------------------------------------------------------------------------

def profile_phase(make_server, make_workload, mode="fused"):
    """torch.profiler (CPU and CUDA activity) over a short serving run of
    two requests in the ``mode`` layout: device time by kernel, the share
    of each attention kernel (every kernel one wrapper call launches: the
    kernel and its merge), its mean device time a call, and the device's
    idle share of the run's wall time (the profiler's own host cost
    included, so the idle share is an upper bound).  In the split layout,
    also how many prefill launches had no valid row (the steps with no
    prefill chunk launch it over padding rows only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    srv = make_server(mode)
    wl = make_workload(seed=2)[:2]
    names = (("msa_fused",) if mode == "fused"
             else ("msa_prefill", "msa_decode"))
    counters = _kernel_counts()
    dispatch, no_prefill = srv.engine.dispatch, []

    def counting_dispatch(plan):
        no_prefill.append(not plan.prefills)
        return dispatch(plan)

    srv.engine.dispatch = counting_dispatch
    torch.cuda.synchronize()
    calls0 = {n: counters[n].launches for n in names}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    line = {"layout": mode, "steps": res["steps"], "wall_ms": wall_us / 1e3,
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
            "layout": mode, "name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3,
            "share_of_busy": e.self_device_time_total / busy_us}),
            flush=True)


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

    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    from repro_torch.kernels.msa import _build
    names = ("msa_fused", "msa_prefill", "msa_decode")
    for name, secs in _build.build(names).items():
        print(f"build: {name}.cu in {secs:.1f} s (built together)",
              flush=True)
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"build: {name}: " + line.strip(), flush=True)

    fused_results, fused_decode = kernel_phase()
    prefill_main, decode_main = split_kernel_phase(fused_results,
                                                   fused_decode)
    torch.cuda.empty_cache()
    fused = serve_phase()
    split_launches = split_serve_phase(fused)
    for mode in ("fused", "split"):
        profile_phase(fused["make_server"], fused["make_workload"], mode)
    online_launches = online_phase(fused)
    single_plan_phase(fused)

    fused_main = fused_results[("main", "bfloat16")]
    src = "src/repro_torch/kernels/msa/csrc/"
    rows = [("msa_fused", "msa_fused.py:146", fused_main,
             online_launches["msa_fused"]),
            ("msa_prefill", "msa_prefill.py:36", prefill_main,
             split_launches["msa_prefill"]),
            ("msa_decode", "msa_decode.py:26", decode_main,
             split_launches["msa_decode"])]
    print(card, flush=True)
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
