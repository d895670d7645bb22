"""The CUDA graphs of the serving step (``Engine._step_impl``) on the CPU,
where no graph is ever captured: which steps may run from one, the
bookkeeping that runs a bucket eager at its first use, captures it at
its second and replays it from then on (checked with a stand-in capture
and replay that run the step eager), the counters that split the steps
between the three, and a CPU engine that runs every step eager and
serves what the eager step serves.  The card's side, the replays against
the eager steps bit for bit, is ``tests/test_torch_cuda_graphs.py``.
One intra-op thread."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.models import init_params
from repro_torch.serving import (AsymCacheServer, Engine, EngineConfig,
                                 SchedulerConfig, ServerConfig,
                                 WorkloadConfig, decode_burst_workload,
                                 multi_turn_workload)

COUNTERS = ("graph_captures", "graph_replays", "graph_eager_steps")


@pytest.fixture(autouse=True)
def _no_profiler_left_recording():
    if torch.autograd._profiler_enabled():
        torch.autograd._disable_profiler()
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(_one_thread):
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _server(model, layout="fused", k=1):
    """A CPU server: the fused layout, the split layout, or the
    synchronous baseline (legacy assembly, full logits, depth 0)."""
    cfg, params = model
    split = layout != "fused"
    sync = layout == "sync_baseline"
    scfg = ServerConfig(num_blocks=64, block_size=16, clock="model",
                        pipeline_depth=0 if sync else 1,
                        attn_mode="split" if split else "fused",
                        scheduler=SchedulerConfig(
                            token_budget=128, max_chunk=64, max_prefills=2,
                            max_decodes=8, max_decode_steps=k))
    ecfg = EngineConfig(num_pages=64, page_size=16, max_prefills=2,
                        max_chunk=64, max_decodes=8,
                        attn_mode="split" if split else "fused",
                        assembly="legacy" if sync else "vectorized",
                        return_full_logits=sync,
                        max_instep_copies=0 if sync else 8)
    return AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device="cpu")


def _workload(k=1):
    if k > 1:
        return decode_burst_workload(n_requests=6, seed=4)
    return multi_turn_workload(WorkloadConfig(
        n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(96, 180),
        output_len=(12, 30), qps=2.0, seed=3))


def _stand_in_graphs(eng):
    """Let a CPU engine's steps take the graph path: every step of its own
    weights eligible, a capture that only names its bucket, and a replay
    that runs the bucket's step eager.  Returns the log of both."""
    log = []
    eng._graph_eligible = lambda params: params is eng.params

    def capture(params, inp, key):
        log.append(("capture", key))
        return SimpleNamespace(key=key)

    def replay(g, inp):
        log.append(("replay", g.key))
        return eng._step_eager(eng.params, inp, *g.key)
    eng._capture, eng._replay = capture, replay
    return log


def _modes_by_step(srv):
    """Run the server's engine with each dispatch's bucket and its share
    of the three counters recorded: (key, counter that moved) a step."""
    eng = srv.engine
    steps = []
    impl = eng._step_impl

    def recorded(params, inp, t_b, np_b, w_b, k=1):
        before = [getattr(eng, c) for c in COUNTERS]
        out = impl(params, inp, t_b, np_b, w_b, k)
        moved = [c for c, b in zip(COUNTERS, before) if getattr(eng, c) != b]
        steps.append(((t_b, np_b, w_b, k), moved))
        return out
    eng._step_impl = recorded
    return steps


@pytest.mark.parametrize("case,eligible", [
    ("fused", True), ("cpu", False), ("split", False), ("legacy", False),
    ("full_logits", False), ("sharded", False), ("checked_build", False),
    ("other_weights", False)])
def test_which_steps_may_run_from_a_graph(model, monkeypatch, case,
                                          eligible):
    """The fused single-device layout on the card with vectorized
    assembly, sampled ids, the release kernels and the engine's own
    weights; every other case runs eager (the card is stood in for by
    the engine's device type, which is all the rule reads of it)."""
    cfg, params = model
    kw = dict(num_pages=64, max_prefills=2, max_chunk=64, max_decodes=8)
    if case in ("split", "legacy"):
        kw["attn_mode"] = "split"
    if case == "legacy":
        kw["assembly"] = "legacy"
    if case == "full_logits":
        kw["return_full_logits"] = True
    shards = ["cpu", "cpu"] if case == "sharded" else None
    eng = Engine(cfg, EngineConfig(**kw), params, device="cpu",
                 shard_devices=shards)
    if case != "cpu":
        eng.device = torch.device("cuda")
    if case == "checked_build":
        monkeypatch.setenv("MSA_CHECK_BOUNDS", "1")
    weights = dict(params) if case == "other_weights" else eng.params
    assert eng._graph_eligible(weights) is eligible


@pytest.mark.parametrize("k", [1, 4])
def test_a_bucket_runs_eager_then_captures_then_replays(model, k):
    """Each bucket's first step runs eager, its second captures (and
    replays at once), the rest replay; one counter moves a step, and they
    sum to the dispatches.  The served ids are those of a run that never
    takes the graph path."""
    srv = _server(model, k=k)
    log = _stand_in_graphs(srv.engine)
    steps = _modes_by_step(srv)
    wl = _workload(k)
    res = srv.run(wl)
    seen = {}
    want_log = []
    for key, moved in steps:
        n = seen[key] = seen.get(key, 0) + 1
        want = ("graph_eager_steps" if n == 1 else "graph_captures"
                if n == 2 else "graph_replays")
        assert moved == [want], (key, n, moved)
        if n == 2:
            want_log.append(("capture", key))
        if n >= 2:
            want_log.append(("replay", key))
    assert log == want_log
    uses = list(seen.values())
    assert res["graph_eager_steps"] == len(uses)
    assert res["graph_captures"] == sum(n >= 2 for n in uses) > 0
    assert res["graph_replays"] == sum(max(0, n - 2) for n in uses) > 0
    assert sum(res[c] for c in COUNTERS) == res["engine_dispatches"] \
        == len(steps)
    if k > 1:
        assert any(key[3] == k for key in srv.engine._graphs)
    eager = _server(model, k=k)
    wl_eager = _workload(k)
    eager.run(wl_eager)
    for a, b in zip(wl, wl_eager):
        assert a.sampled_ids == b.sampled_ids
        np.testing.assert_array_equal(a.first_logits, b.first_logits)


def test_no_capture_while_a_profiler_records(model):
    """Under a profiler an eligible step never captures: a bucket met
    twice there runs eager both times, and is captured at its next use
    once the profiler has stopped."""
    srv = _server(model)
    log = _stand_in_graphs(srv.engine)
    steps = _modes_by_step(srv)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        srv.run(_workload())
    eng = srv.engine
    assert eng.graph_captures == eng.graph_replays == 0 and log == []
    assert eng.graph_eager_steps == eng.steps_executed == len(steps)
    keys = {key for key, _ in steps}
    assert len(steps) > len(keys)            # buckets met more than once
    n1 = len(steps)
    srv.run(_workload())
    met = set()
    for key, moved in steps[n1:]:
        if key not in met:
            met.add(key)
            assert moved == ["graph_captures" if key in keys
                             else "graph_eager_steps"], (key, moved)
    assert met & keys and eng.graph_captures > 0


def test_reset_zeroes_the_counts_and_keeps_the_graphs(model):
    srv = _server(model)
    _stand_in_graphs(srv.engine)
    srv.run(_workload())
    eng = srv.engine
    graphs = dict(eng._graphs)
    assert graphs and eng.graph_replays > 0
    eng.reset_perf_counters()
    pc = eng.perf_counters()
    assert all(pc[c] == 0 for c in COUNTERS)
    assert eng._graphs == graphs
    steps = _modes_by_step(srv)
    srv.run(_workload())
    # a bucket captured before the reset replays at its first use after it
    assert any(moved == ["graph_replays"] for key, moved in steps
               if key in graphs)
    pc = eng.perf_counters()
    assert sum(pc[c] for c in COUNTERS) == pc["engine_dispatches"]


@pytest.mark.parametrize("layout", ["fused", "split", "sync_baseline"])
def test_cpu_engine_never_captures_and_serves_the_eager_step(model,
                                                             layout):
    """On the CPU every step runs eager, whatever the layout: no capture,
    no replay, one eager count a dispatch, and the same ids and first
    logits, bit for bit, as a server whose engine calls the eager step
    directly."""
    srv = _server(model, layout)
    wl = _workload()
    res = srv.run(wl)
    assert res["graph_captures"] == res["graph_replays"] == 0
    assert res["graph_eager_steps"] == res["engine_dispatches"] > 0
    assert srv.engine._graphs == {}
    direct = _server(model, layout)
    direct.engine._step_impl = direct.engine._step_eager
    wl_direct = _workload()
    res_direct = direct.run(wl_direct)
    assert res_direct["graph_eager_steps"] == 0
    assert res["steps"] == res_direct["steps"]
    for a, b in zip(wl, wl_direct):
        assert a.status == b.status == "finished"
        assert a.sampled_ids == b.sampled_ids
        np.testing.assert_array_equal(a.first_logits, b.first_logits)
