"""One run of one cell: the model and weights from the seed, the server at
the deployment's sizes, the traffic through the window, the metrics,
then the comparison with the plain reference.

``run`` takes the device as an argument: the benchmark's entry
(``bench/run.py``) passes the card after checking that there is one;
the CPU tests pass the CPU at a smoke size.  ``simulate=True`` runs the
server's discrete-event mode (``execute_model=False``, model clock): the
scheduler, cache manager and evictor for real, the step priced by the
cost model, no weights (the CPU rehearsal of a cell's traffic).
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                 SchedulerConfig, ServerConfig)

from bench.harness import check, flops, trace
from bench.harness.peaks import H100
from bench.harness.sources import SessionSource, WindowedFrontend
from bench.harness.spec import Spec
from bench.harness.traffic import generate
from bench.harness.weights import make_params, model_config
from bench.harness.window import Window


@dataclass
class Run:
    """What the metric readers read (``bench/metrics/<name>.py``)."""
    workload: str
    model: Dict
    deployment: Dict
    peaks: Dict
    window: Dict                    # Window.summary()
    steps: List                     # (server time, wall, StepWork)
    t0: float
    t1: float
    setup_s: float
    requests: List
    trace: Optional[Dict] = None    # trace.summarise() + the stretch
    reference: Any = None           # the configuration's module (spec.py)

    def window_steps(self):
        return [w for now, _, w in self.steps if self.t0 <= now < self.t1]


def max_context(traffic: Dict) -> int:
    """The longest context (prompt and output) the mix can make."""
    hi = lambda k: traffic[k].get("hi", 0)
    n_turns = traffic["turns"]["hi"]
    return (traffic.get("system_prompt", 0) + hi("first_input")
            + (n_turns - 1) * (hi("next_input") + hi("output"))
            + hi("output"))


def build_server(cfg, params, dep: Dict, traffic: Dict, device,
                 simulate: bool = False) -> AsymCacheServer:
    page = dep["block_size"]
    np_max = -(-max_context(traffic) // page) + 1
    sched = SchedulerConfig(block_size=page,
                            token_budget=dep["token_budget"],
                            max_prefills=dep["max_prefills"],
                            max_chunk=dep["max_chunk"],
                            min_chunk=dep["min_chunk"],
                            max_decodes=dep["max_decodes"],
                            decode_threshold=dep["decode_threshold"],
                            max_running=dep["max_running"])
    scfg = ServerConfig(num_blocks=dep["num_blocks"], block_size=page,
                        clock="model" if simulate else "wall",
                        execute_model=not simulate, scheduler=sched)
    ecfg = None if simulate else EngineConfig(
        num_pages=dep["num_blocks"], page_size=page,
        max_prefills=dep["max_prefills"], max_chunk=dep["max_chunk"],
        max_decodes=dep["max_decodes"], max_blocks_per_seq=np_max)
    return AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=device)


def run(spec: Spec, workload: str, seed: int, seconds: float,
        traced: bool, device, t_start: float, control: bool = False,
        rate: Optional[float] = None, simulate: bool = False,
        on_server=None, warm_s: Optional[float] = None,
        every_metric: bool = False) -> Dict:
    """One run; returns the result line's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
    ``breakdown``) and ``check``, the numbers compared and their limits;
    with ``control``, also ``control_correct`` and ``control_check``,
    the fp8 control judged in the program's place.
    ``on_server(server)`` may break the timed path (the fault tests).
    ``rate`` and ``warm_s`` override the traffic file's (the knee sweep);
    ``every_metric`` reads the end-to-end and per-layer metrics both."""
    wl = spec.workload(workload)
    cfg_file = spec.config(wl["config"])
    traffic = spec.traffic(wl["traffic"])
    dep = cfg_file["deployment"]
    model = cfg_file["model"]
    ref = spec.reference(cfg_file)
    cfg = ref.model_config(cfg_file, model_config) \
        if hasattr(ref, "model_config") else model_config(cfg_file)
    cuda = torch.device(device).type == "cuda"
    params = None if simulate else make_params(cfg, seed, device,
                                               ref.leaves(cfg))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    warm = float(traffic["warm_s"] if warm_s is None else warm_s)
    sessions = generate(traffic, seed, cfg.vocab_size, warm + seconds,
                        rate_per_s=rate)
    if cuda:
        # the attention kernel is built (or loaded from ``build/``) here,
        # in set-up, never inside the server's first step
        from repro_torch.kernels.msa.msa_fused import load_library
        load_library()
    server = build_server(cfg, params, dep, traffic, device, simulate)
    if on_server is not None:
        on_server(server)
    tracer = trace.Tracer() if traced else None
    at_start = traffic["arrival"]["process"] == "at_start"
    window = Window(server, warm, seconds, traffic["drain_s"],
                    at_start=at_start, tracer=tracer)
    steps: List = []
    page = dep["block_size"]
    dispatch = server.engine.dispatch

    def recorded(plan):
        steps.append((server.now, time.perf_counter(),
                      flops.step_work(plan, page)))
        return dispatch(plan)
    server.engine.dispatch = recorded
    if traffic["entry"] == "frontend":
        source = WindowedFrontend(server, sessions, window)
        if traced:
            trace.install_spans(server, source)
        source.run()
    else:
        source = SessionSource(server, sessions, window)
        if traced:
            trace.install_spans(server, source)
        server.serve(source)
        source.close()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = window.summary()
    requests = window.requests
    stretch = None
    if tracer is not None and tracer.events is not None:
        stretch = trace.summarise(tracer.events)
        if stretch is not None:
            stretch["steps"] = [w for _, wall, w in steps
                                if tracer.in_stretch(wall)]
    setup_s = (window.wall_t0 - t_start) if window.wall_t0 else math.nan
    r = Run(workload=workload, model=model, deployment=dep, peaks=H100,
            window=summary, steps=steps, t0=window.t0, t1=window.t1,
            setup_s=setup_s, requests=requests, trace=stretch,
            reference=ref)
    metrics = {}
    wanted = spec.metrics(workload, traced)
    if every_metric:
        wanted = spec.metrics(workload, False) + spec.metrics(workload, True)
    for m in wanted:
        v = spec.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the program's state goes before the reference runs
    window.server = None
    server.engine.dispatch = dispatch
    del server, source, window, recorded, dispatch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out = {"attempted": summary["attempted"], "failed": summary["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if stretch is not None:
        out["device"]["busy_s"] = stretch["busy_s"]
        out["device"]["window_s"] = stretch["window_s"]
        out["breakdown"] = stretch["breakdown"]
    if simulate:
        out["correct"] = None
        out["check"] = {}
        out["detail"] = {"window": {k: summary[k] for k in
                                    ("at_t0", "at_t1", "drain_s")}}
        return out
    limits = {k: v for k, v in spec.limits(workload).items()
              if isinstance(v, (int, float))
              and not k.endswith("_reading")}
    t_ref = time.perf_counter()
    chains = check.sample(requests, seed)
    res = check.compare(ref.logits_at, params, model, chains, device,
                        control=control) if chains else None
    out["correct"] = check.verdict(res, limits)
    out["check"] = {k: {"value": None if res is None else res[k],
                        "limit": v} for k, v in limits.items()}
    if control:
        ctl = check.control_stats(res)
        out["control_correct"] = check.verdict(ctl, limits)
        out["control_check"] = {k: {"value": None if ctl is None
                                    else ctl[k], "limit": v}
                                for k, v in limits.items()}
    out["detail"] = {"check": dict(res or {}, seconds=time.perf_counter()
                                   - t_ref),
                     "window": {k: summary[k] for k in
                                ("at_t0", "at_t1", "wall_s", "drain_s",
                                 "tokens")},
                     "steps_window": len(r.window_steps())}
    return out
