#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Usage, from the root of a checkout::

    python3 chip_smoke.py

Phases:
  1. Print the card (``nvidia-smi`` name and power limit) and the torch
     version, and build the CUDA kernel from ``src/repro_torch`` with
     ``nvcc`` (timed).
  2. Hold the fused MSA kernel against its plain PyTorch version on the
     card, on the same inputs, at Llama-3.1-8B attention shapes (H 32,
     KH 8, D 128, page 16): one mixed step of two multi-segment prefill
     chunks on non-contiguous block tables plus 32 decode rows with
     contexts up to 4k, in bf16 and f32, and small cases with a sliding
     window, a softcap and all-padding tiles.  Time kernel and plain
     version with CUDA events (median of 20) beside the byte bound.
     A decode-only step of 32 rows (the serving run's commonest bucket)
     is timed as well.
  3. Serve a multi-turn workload through ``AsymCacheServer.run`` with
     Llama-3.1-8B at full width and depth (bf16, random weights from a
     seeded generator) and a KV pool small enough to force evictions;
     check every request finished, one kernel launch per layer per step,
     and each request's first logits against the dense reference.
  4. Profile a short serving run (``torch.profiler``): device time by
     kernel, the attention kernel's share, the device's idle share.

Prints the card line again, the kernel table as a JSON line, and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
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


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    from repro_torch.kernels.msa import build_worklist, pad_worklist, \
        tile_ranges
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
    tile_first = tile_ranges(wl, n_tiles)
    wl = pad_worklist(wl, 1 << (count - 1).bit_length(), sentinel_seq=n)
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
        q_start=q_start, q_len=q_len, wl=wl, tile_first=tile_first,
        real=real, window=window, softcap=softcap, q_tile=tq,
        pages_read=pages_read, flops=4.0 * float(keys.sum()) * H * D)


def _run_case(case, dtype_name, *, time_it=False):
    import torch
    from repro_torch.kernels.msa import WL_FIELDS, msa_fused
    from repro_torch.kernels.msa.ref import msa_fused_ref
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    f = {k: torch.from_numpy(np.asarray(case[k])).to(dev)
         for k in ("bt", "ctx", "q_pos", "seq_ids", "valid", "q_start",
                   "q_len", "tile_first")}
    q = torch.from_numpy(case["q"]).to(dev, dt)
    kp = torch.from_numpy(case["k"]).to(dev, dt)
    vp = torch.from_numpy(case["v"]).to(dev, dt)
    wl = tuple(torch.from_numpy(case["wl"][name]).to(dev)
               for name in WL_FIELDS)
    kw = dict(window=case["window"], softcap=case["softcap"])

    def kernel():
        return msa_fused(q, kp, vp, f["bt"], f["ctx"], f["q_pos"],
                         f["seq_ids"], f["valid"], q_start=f["q_start"],
                         q_len=f["q_len"], worklist=wl,
                         tile_first=f["tile_first"], q_tile=case["q_tile"],
                         **kw)

    def plain():
        return msa_fused_ref(q, kp, vp, f["bt"], f["ctx"], f["q_pos"],
                             f["seq_ids"], f["valid"], **kw)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    slack_zero = bool((got[case["real"]:] == 0).all())
    out = {"max_abs_err": err, "slack_zero": slack_zero,
           "finite": bool(torch.isfinite(got).all())}
    if time_it:
        out["ms"] = _median_ms(kernel)
        out["plain_ms"] = _median_ms(plain)
        itemsize = q.element_size()
        H, D = q.shape[1], q.shape[2]
        _, page, KH, _ = kp.shape
        nbytes = (2 * case["pages_read"] * page * KH * D * itemsize
                  + 2 * q.shape[0] * H * D * itemsize)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = case["flops"] / PEAK_FLOPS[dtype_name] * 1e3
        out["bound_ms"] = max(byte_ms, op_ms)
        out["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
        out["bytes"] = nbytes
    del got, want
    return out


def kernel_phase():
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
                and res["max_abs_err"] <= tol):
            raise AssertionError(f"msa_fused kernel disagrees: {line}")
    return results[("main", "bfloat16")]


# ---------------------------------------------------------------------------
# phase 3: serve Llama-3.1-8B at full width through the port
# ---------------------------------------------------------------------------

def serve_phase():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.msa import msa_fused_cuda
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
    ecfg = EngineConfig(num_pages=num_blocks, page_size=16, max_prefills=4,
                        max_chunk=128, max_decodes=64, max_blocks_per_seq=128)

    def make_server():
        return AsymCacheServer(cfg, params,
                               ServerConfig(num_blocks=num_blocks), ecfg=ecfg)

    # warm-up on a separate server so that the measured run's TTFT does not
    # carry cuBLAS and allocator start-up
    make_server().run(make_workload(seed=1)[:1])
    torch.cuda.synchronize()

    srv = make_server()
    wl = make_workload(seed=0)
    # count the prefill chunks whose compute positions have gaps: the
    # multi-segment recompute of a history that was partly evicted
    dispatch, seg_chunks = srv.engine.dispatch, []

    def counting_dispatch(plan):
        seg_chunks.extend(c for c in plan.prefills
                          if np.any(np.diff(c.positions) > 1))
        return dispatch(plan)

    srv.engine.dispatch = counting_dispatch
    torch.cuda.reset_peak_memory_stats()
    msa_fused_cuda.launches = 0
    res = srv.run(wl)
    torch.cuda.synchronize()
    launches = msa_fused_cuda.launches
    steps = srv.engine.steps_executed
    print("serve: " + json.dumps({
        "requests": len(wl), "finished": res["n_requests"],
        "steps": res["steps"], "evictions": res["evictions"],
        "multi_segment_chunks": len(seg_chunks),
        "prefill_compute_tokens": res["prefill_compute_tokens"],
        "prompt_tokens": res["prompt_tokens"],
        "bucket_counts": res["bucket_counts"],
        "attn_dispatches_per_step": res["attn_dispatches_per_step"],
        "kernel_launches": launches,
        "ttft_mean_s": res["ttft_mean"], "ttft_p90_s": res["ttft_p90"],
        "tpot_mean_s": res["tpot_mean"], "tpot_p90_s": res["tpot_p90"],
        "wall_s": res["wall_time"],
        "steps_per_s": res["steps"] / res["wall_time"],
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}),
        flush=True)
    assert all(r.status == "finished" for r in wl), \
        [r.status for r in wl]
    assert res["n_requests"] == len(wl)
    assert res["evictions"] > 0, "the pool never evicted"
    assert seg_chunks, "no prefill chunk recomputed a multi-segment history"
    assert res["attn_dispatches_per_step"] == cfg.n_layers
    assert launches == cfg.n_layers * steps, (launches, steps)

    worst = 0.0
    for r in wl:
        ref = reference_logits(cfg, params, r.prompt_tokens)
        got = r.first_logits
        assert got is not None and got.shape == ref.shape
        assert np.all(np.isfinite(got))
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        worst = max(worst, rel)
        print(f"serve: request {r.rid} prompt {len(r.prompt_tokens)} "
              f"rel_err {rel:.3e} argmax_match "
              f"{int(np.argmax(got)) == int(np.argmax(ref))}", flush=True)
    print(f"serve: worst first-logit rel err {worst:.3e} "
          f"(tolerance {LOGIT_REL_TOL})", flush=True)
    assert worst < LOGIT_REL_TOL, worst
    return launches, make_server, make_workload


# ---------------------------------------------------------------------------
# phase 4: where a serving run's device time goes
# ---------------------------------------------------------------------------

def profile_phase(make_server, make_workload):
    """torch.profiler (CPU and CUDA activity) over a short serving run of
    two requests: device time by kernel, the attention kernel's share,
    and the device's idle share of the run's wall time (the profiler's
    own host cost included, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    srv = make_server()
    wl = make_workload(seed=2)[:2]
    torch.cuda.synchronize()
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
        print("profile: the profiler recorded no device time "
              "(not measured)", flush=True)
        return
    msa_us = sum(e.self_device_time_total for e in kernels
                 if "msa_fused_kernel" in e.key)
    print("profile: " + json.dumps({
        "steps": res["steps"], "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "msa_fused_share_of_busy": msa_us / busy_us,
        "device_ms_per_step": busy_us / 1e3 / res["steps"]}), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print("profile_kernel " + json.dumps({
            "name": e.key[:90], "calls": e.count,
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
    import importlib
    t0 = time.perf_counter()
    lib = importlib.import_module(
        "repro_torch.kernels.msa.msa_fused").load_library()
    print(f"build: msa_fused.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    log = Path(lib._name).with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("build: " + line.strip(), flush=True)

    kern = kernel_phase()
    torch.cuda.empty_cache()
    launches, make_server, make_workload = serve_phase()
    profile_phase(make_server, make_workload)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "msa_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/msa/csrc/msa_fused.cu",
        "replaces": "src/repro/kernels/msa/msa_fused.py:146",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
