"""The CUDA graphs of the serving step on an NVIDIA card: a server whose
fused steps replay their buckets' graphs against the same server with
every step run eager (``Engine._graph_eligible`` answering no), step for
step.  Over scripted runs that move between buckets (k = 1 and k = 8):
each step's ids and prefill logit rows the same bits, read only after
the run, so a replay that left its outputs in the graph's memory would
show the last replay's instead; the launch counters as eager; a
``replay`` span inside ``enqueue`` for each step run from a graph.  A
step with in-step swap-ins (fp and q8 payloads) and copy-on-write
copies, replayed from a graph captured on a step without them, and the
swap-free replay after it: the pool bytes of the eager step.  Two
dispatches before the first retire: each handle keeps its own ids.  No
automatic collection inside a capture (one could free another engine's
graphs there, which ends the capture).

Marked ``cuda``; each test skips without a card.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``.
Imports no JAX."""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.core.offload import quantize_half
from repro_torch.kernels.msa import msa_fused_cuda
from repro_torch.models import init_params
from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                 SchedulerConfig, ServerConfig,
                                 WorkloadConfig, decode_burst_workload,
                                 multi_turn_workload)

pytestmark = pytest.mark.cuda

NB = 44


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def model(dev):
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="bfloat16")
    return cfg, init_params(cfg, seed=0, device=dev)


def _server(cfg, params, dev, *, graphs, k=1, swap_payload="fp"):
    scfg = ServerConfig(num_blocks=NB, block_size=16, clock="model",
                        host_blocks=32, scheduler=SchedulerConfig(
                            token_budget=128, max_chunk=64, max_prefills=2,
                            max_decodes=8, max_decode_steps=k))
    ecfg = EngineConfig(num_pages=NB, page_size=16, max_prefills=2,
                        max_chunk=64, max_decodes=8,
                        swap_payload=swap_payload)
    srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=dev)
    if not graphs:
        srv.engine._graph_eligible = lambda params: False
    return srv


def _workload(k):
    if k > 1:
        return decode_burst_workload(n_requests=6, seed=4)
    return multi_turn_workload(WorkloadConfig(
        n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(96, 180),
        output_len=(12, 30), qps=2.0, seed=3))


@pytest.mark.parametrize("k", [1, 8])
def test_replayed_steps_are_the_eager_steps_bit_for_bit(dev, model, k):
    cfg, params = model
    runs = []
    for graphs in (True, False):
        srv = _server(cfg, params, dev, graphs=graphs, k=k)
        if graphs:
            srv.enable_tracing()
        handles = []
        dispatch = srv.engine.dispatch

        def recorded(plan, _d=dispatch, _h=handles):
            h = _d(plan)
            _h.append(h)
            return h
        srv.engine.dispatch = recorded
        before = msa_fused_cuda.launches
        wl = _workload(k)
        res = srv.run(wl)
        runs.append((srv, res, handles, msa_fused_cuda.launches - before,
                     wl))
    (gs, gr, gh, gl, gw), (es, er, eh, el, ew) = runs
    assert gr["graph_replays"] > 0 and gr["graph_captures"] > 0
    assert gr["graph_eager_steps"] == len(gs.engine.buckets_used)
    assert er["graph_captures"] == er["graph_replays"] == 0
    for r in (gr, er):
        assert sum(r[c] for c in ("graph_captures", "graph_replays",
                                  "graph_eager_steps")) \
            == r["engine_dispatches"] == r["steps"]
    assert gr["steps"] == er["steps"] and len(gh) == len(eh)
    assert gl == el == gs.engine.attn_dispatches > 0
    if k > 1:
        assert gr["multi_token_dispatches"] > 0
        assert any(key[3] == k for key in gs.engine._graphs)
    # read every step's outputs only now, after the whole run
    for a, b in zip(gh, eh):
        assert torch.equal(a.token_ids.cpu(), b.token_ids.cpu())
        assert torch.equal(a.prefill_logits.cpu(), b.prefill_logits.cpu())
    for a, b in zip(gw, ew):
        assert a.sampled_ids == b.sampled_ids
        assert np.array_equal(a.first_logits, b.first_logits)
    # one replay span, inside the step's enqueue, a step run from a graph
    ex = gs.trace_export()
    names = np.asarray(ex["names"])[ex["name"]]
    rep = np.flatnonzero(names == "replay")
    assert len(rep) == gr["graph_captures"] + gr["graph_replays"]
    assert (names[ex["parent"][rep]] == "enqueue").all()
    cap = np.flatnonzero(names == "capture")
    assert len(cap) == gr["graph_captures"]
    assert (names[ex["parent"][cap]] == "enqueue").all()


def _page_op_plan(cfg, params, dev, swap_payload):
    """Two servers (graphs, eager) over the same random bf16 pools and
    one mixed plan of the first's scheduler."""
    a = _server(cfg, params, dev, graphs=True, swap_payload=swap_payload)
    b = _server(cfg, params, dev, graphs=False, swap_payload=swap_payload)
    for r in _workload(1):
        a._on_arrival(r)
    plan = a.sched.schedule(now=1e9)
    assert plan.prefills
    gen = torch.Generator(device=dev).manual_seed(0)
    ea, eb = a.engine, b.engine
    for pa, pb in ((ea.k_pools, eb.k_pools), (ea.v_pools, eb.v_pools)):
        pa.copy_(torch.randn(pa.shape, generator=gen, device=dev))
        pb.copy_(pa)
    return ea, eb, plan


def _same(ea, eb, ha, hb):
    assert torch.equal(ea.k_pools[:, :NB], eb.k_pools[:, :NB])
    assert torch.equal(ea.v_pools[:, :NB], eb.v_pools[:, :NB])
    assert np.array_equal(ha.token_ids_np(), hb.token_ids_np())
    assert np.array_equal(ha.prefill_logits_np(), hb.prefill_logits_np())


@pytest.mark.parametrize("swap_payload", ["fp", "q8"])
def test_replayed_page_ops_leave_the_eager_pool_bytes(dev, model,
                                                      swap_payload):
    cfg, params = model
    ea, eb, plan = _page_op_plan(cfg, params, dev, swap_payload)
    for _ in range(2):            # eager; then captured and replayed
        _same(ea, eb, ea.execute(plan), eb.execute(plan))
    assert ea.graph_captures == 1
    used = {int(s) for c in plan.prefills for s in c.req.slot_array()}
    free = sorted(set(range(NB)) - used)
    kh, vh = ea.swap_out(free[0])
    if swap_payload == "q8":
        kh, vh = quantize_half(kh, "q8"), quantize_half(vh, "q8")
    pairs = [(free[1], free[2]), (free[3], free[4])]
    for eng in (ea, eb):
        eng.queue_swap_in(free[5], (kh, vh))
        eng.queue_swap_in(free[6], (None, vh))        # V-only half
        eng.queue_copies(pairs)
    _same(ea, eb, ea.execute(plan), eb.execute(plan))
    assert ea.instep_swaps == eb.instep_swaps == 3
    assert ea.instep_copies == eb.instep_copies == 2
    if swap_payload == "fp":                  # the V half restored whole
        assert torch.equal(ea.v_pools[:, free[6]], ea.v_pools[:, free[0]])
    # a swap-free replay after it: the static payload's stale bytes land
    # in the drop page only
    _same(ea, eb, ea.execute(plan), eb.execute(plan))
    assert ea.graph_replays == 2 and ea.graph_eager_steps == 1
    assert eb.graph_eager_steps == 4


def test_two_dispatches_before_the_first_retire_keep_their_own_ids(dev,
                                                                  model):
    cfg, params = model
    ea, eb, plan = _page_op_plan(cfg, params, dev, "fp")
    for _ in range(2):
        _same(ea, eb, ea.execute(plan), eb.execute(plan))
    out = []
    for eng in (ea, eb):
        h1 = eng.dispatch(plan)
        # the second step runs on other weights (in place, where the
        # graph reads them), set back after it is queued
        eng.params["embed"].neg_()
        h2 = eng.dispatch(plan)
        eng.params["embed"].neg_()
        out.append((h1.token_ids_np(), h2.token_ids_np(),
                    h1.prefill_logits_np(), h2.prefill_logits_np()))
    assert ea.graph_captures == 1 and ea.graph_replays == 2
    for x, y in zip(*out):
        assert np.array_equal(x, y)
    assert not np.array_equal(out[1][2], out[1][3])


def test_no_collection_runs_inside_a_capture(dev, model):
    cfg, params = model
    old = _server(cfg, params, dev, graphs=True)
    old.run(_workload(1))
    assert old.engine._graphs
    del old                       # unreachable, its graphs not yet freed
    srv = _server(cfg, params, dev, graphs=True)
    eng = srv.engine
    step = eng._step_eager
    collecting = []

    def watched(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            collecting.append(gc.isenabled())
        return step(*a, **kw)
    eng._step_eager = watched
    res = srv.run(_workload(1))
    assert res["graph_captures"] == len(collecting) > 0
    assert not any(collecting) and gc.isenabled()
