"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--mode real|online|sim --device D --devices N ...]``.

Runs the AsymCache serving stack for real on the architecture's float32
smoke config (``real``: a multi-turn workload on the wall clock;
``online``: agentic sessions through the closed-loop frontend with
host-tier prefetch, on the model clock), or in discrete-event mode at
full scale with no model (``sim``: the analytic cost model of 256 cards
of the given hardware, H100 by default), with the JAX package's
workloads and scheduler settings.

``--device`` (default ``cuda``) is where the model runs; the tensors'
device picks the CUDA kernels or their plain versions, so no other
switch is needed.  ``--devices N`` serves sharded over N shards
(``ServerConfig(n_shards=N)``: page-sharded KV pools, the exact LSE
merge) on the devices ``--device`` names: ``cuda`` means ``cuda:0 ..
cuda:N-1`` and is refused, with the reason, when there are fewer cards;
``cuda:0`` puts every shard on that card; ``cpu`` runs the shards on the
CPU.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 scaled_config)
from repro_torch.core import H100, Hardware, analytic_cost_model
from repro_torch.distributed import make_serving_devices
from repro_torch.models import init_params
from repro_torch.serving import (AgenticConfig, AsymCacheServer,
                                 FrontendConfig, OnlineFrontend,
                                 SchedulerConfig, ServerConfig,
                                 WorkloadConfig, agentic_session_scripts,
                                 multi_turn_workload)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama31-8b",
                    choices=list(ARCH_IDS) + ["llama31-8b", "llama31-70b"])
    ap.add_argument("--policy", default="asymcache")
    ap.add_argument("--mode", default="real",
                    choices=["real", "sim", "online"])
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--host-blocks", type=int, default=32,
                    help="host-tier blocks for online mode (0 = off)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="online mode: disable predictive host-tier "
                         "prefetch of suspended sessions")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda, cuda:<i> or cpu")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the engine over N shards (real mode) on "
                         "the devices --device names")
    args = ap.parse_args(argv)
    if args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    return args


def shard_devices(args: argparse.Namespace) -> Optional[List[torch.device]]:
    """The shards' devices for ``--devices N`` (None for one), after
    checking ``--device`` itself; raises ``RuntimeError``/``ValueError``
    with the reason when they are not there."""
    dev = resolve_device(args.device)
    if args.devices == 1:
        return None
    if args.device == "cuda":
        return make_serving_devices(args.devices)
    return [dev] * args.devices


def _token_lm(cfg, arch: str) -> None:
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"{arch}: the engine serves token LMs "
                         f"(family {cfg.family!r})")


def serve(args: argparse.Namespace, hardware: Hardware = H100
          ) -> Tuple[AsymCacheServer, Any, Dict]:
    """Build the mode's server and run it: (server, its workload (the
    requests, or the online frontend), the run's summary)."""
    if args.mode == "online":
        # closed-loop agent serving: sessions suspend on tool calls, the
        # lifespan predictor prefetches their KV ahead of the resume
        cfg = scaled_config(get_smoke_config(args.arch), dtype="float32")
        _token_lm(cfg, args.arch)
        params = init_params(cfg, seed=0, device=args.device)
        scripts = agentic_session_scripts(AgenticConfig(
            n_jobs=args.sessions, tool_calls_per_job=(2, 4),
            system_prefix_len=32, task_len=(32, 64),
            tool_result_len=(16, 48), output_len=(12, 24),
            tool_duration=(0.6, 1.5), qps=1.5))
        srv = AsymCacheServer(cfg, params, ServerConfig(
            policy=args.policy, num_blocks=args.blocks, block_size=16,
            clock="model", host_blocks=args.host_blocks,
            scheduler=SchedulerConfig(token_budget=160, max_chunk=96,
                                      max_prefills=2, max_decodes=8)),
            device=args.device)
        fe = OnlineFrontend(srv, scripts,
                            FrontendConfig(prefetch=not args.no_prefetch))
        return srv, fe, fe.run()
    if args.mode == "real":
        cfg = scaled_config(get_smoke_config(args.arch), dtype="float32")
        _token_lm(cfg, args.arch)
        params = init_params(cfg, seed=0, device=args.device)
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=args.sessions, first_ctx_len=(96, 200),
            output_len=(16, 40), qps=1.0))
        # shard-divisible pool, never rounded down to zero (at least one
        # page per shard)
        n_dev = max(args.devices, 1)
        blocks = max(n_dev, args.blocks - args.blocks % n_dev)
        if blocks != args.blocks:
            print(f"note: --blocks {args.blocks} adjusted to {blocks} "
                  f"(pool must divide across {n_dev} devices)")
        srv = AsymCacheServer(cfg, params, ServerConfig(
            policy=args.policy, num_blocks=blocks, block_size=16,
            clock="wall", n_shards=args.devices,
            shard_devices=shard_devices(args),
            scheduler=SchedulerConfig(token_budget=128, max_chunk=64,
                                      max_prefills=2, max_decodes=8)),
            device=args.device)
        return srv, wl, srv.run(wl)
    cfg = get_config(args.arch)
    cm = analytic_cost_model(cfg, hardware, n_chips=256)
    wl = multi_turn_workload(WorkloadConfig(
        n_sessions=args.sessions, first_ctx_len=(8_000, 24_000),
        output_len=(400, 1200), vocab=min(cfg.vocab_size, 50_000),
        qps=0.05))
    srv = AsymCacheServer(cfg, None, ServerConfig(
        policy=args.policy, num_blocks=args.blocks * 512, block_size=16,
        clock="model", execute_model=False,
        scheduler=SchedulerConfig(token_budget=4096, max_chunk=2048,
                                  max_prefills=4, max_decodes=64)),
        cost_model=cm, sim_cost_model=cm)
    return srv, wl, srv.run(wl)


def main(argv=None, hardware: Hardware = H100) -> int:
    args = parse_args(argv)
    if args.mode != "sim":
        try:
            shard_devices(args)
        except (RuntimeError, ValueError) as e:
            print(f"repro_torch.launch.serve: {e}", file=sys.stderr)
            return 2
    _, _, res = serve(args, hardware)
    for k, v in res.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
