"""The online (closed-loop) agent-serving frontend in the port against the
JAX package: the reference's closed-loop-vs-scripted equivalence run
through both packages, with the real engine at one token a dispatch and
at k = 8, and its discrete-event prefetch tests (``execute_model=False``),
with k = 8 prefetch pins among them, in both packages.

The control plane is a copy, so every per-turn prompt, output, sampled id
and arrival time, and every counter of a run, must be equal (the smoke
model at float32 through the weight bridge; greedy ids compared
exactly)."""
import jax
import numpy as np
import pytest

import repro.configs as JC
import repro.core as JK
import repro.serving as J
import repro_torch.configs as PC
import repro_torch.core as PK
import repro_torch.serving as P
from conftest import assert_drained
from _h100_costs import PCIE_BW, cost_model
from repro.models import init_params as j_init
from repro_torch.bridge import params_from_numpy

ACFG = dict(tool_calls_per_job=(2, 3), system_prefix_len=32,
            task_len=(32, 64), tool_result_len=(16, 48),
            output_len=(12, 24), tool_duration=(0.6, 1.5), qps=1.5)
PACKAGES = {"jax": (J, JC, JK), "port": (P, PC, PK)}


@pytest.fixture(scope="module")
def small_model():
    cfg = JC.scaled_config(JC.get_smoke_config("llama31-8b"),
                           dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, {"jax": jp, "port": tp}


def _real_server(pkg, cfg, params, k):
    M = PACKAGES[pkg][0]
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=256, block_size=16, clock="model",
        pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=160, max_chunk=96,
                                    max_prefills=2, max_decodes=8,
                                    max_decode_steps=k))
    ecfg = M.EngineConfig(num_pages=256, page_size=16, max_prefills=2,
                          max_chunk=96, max_decodes=8, max_blocks_per_seq=32)
    kw = dict(device="cpu") if pkg == "port" else {}
    return M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg,
                             cost_model=cost_model(M, cfg), **kw)


def _sim_server(pkg, num_blocks, host_blocks=0, max_decode_steps=1):
    M, C, K = PACKAGES[pkg]
    cfg = C.get_config("llama31-8b")
    cm = K.analytic_cost_model(cfg, K.H20)
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=num_blocks, block_size=16,
        clock="model", execute_model=False, host_blocks=host_blocks,
        pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=192, max_chunk=96,
                                    max_prefills=2, max_decodes=16,
                                    max_decode_steps=max_decode_steps))
    return M.AsymCacheServer(cfg, None, scfg, cost_model=cm,
                             sim_cost_model=cm)


def _turns(fe):
    return [(s.sid, [(r.prompt_tokens, r.generated, r.sampled_ids,
                      r.arrival) for r in s.requests]) for s in fe.sessions]


def _host_independent(res):
    """A run's summary without the host's own seconds (wall time and the
    control plane's time, measured on the host's clock) and without the
    port's CUDA-graph counters, which the reference has no counterpart of
    (on the CPU every step runs eager: they are checked here)."""
    if "graph_eager_steps" in res:
        assert res["graph_captures"] == res["graph_replays"] == 0
        assert res["graph_eager_steps"] == res["engine_dispatches"]
    return {k: v for k, v in res.items()
            if k not in ("wall_time", "control_plane_time", "graph_captures",
                         "graph_replays", "graph_eager_steps")}


@pytest.mark.parametrize("k", [1, 8])
def test_closed_loop_matches_scripted_in_both_packages(small_model, k):
    """In each package the closed loop changes when turns happen, never
    what is computed (the reference's test_closed_loop_matches_scripted);
    across the packages every (session, turn) has the same prompt,
    teacher-forced output, device-side greedy samples and arrival time."""
    cfg, params = small_model
    acfg = dict(n_jobs=3, seed=5, **ACFG)
    turns, results = {}, {}
    for pkg, (M, _, _) in PACKAGES.items():
        srv_a = _real_server(pkg, cfg, params[pkg], k)
        wl = M.requests_from_scripts(M.agentic_session_scripts(
            M.AgenticConfig(**acfg)))
        srv_a.run(wl)
        assert_drained(srv_a)
        by_sid = {}
        for r in sorted(wl, key=lambda r: r.rid):
            by_sid.setdefault(r.session_id, []).append(r)

        srv_b = _real_server(pkg, cfg, params[pkg], k)
        fe = M.OnlineFrontend(
            srv_b, M.agentic_session_scripts(M.AgenticConfig(**acfg)),
            M.FrontendConfig(prefetch=False, admission="fcfs"))
        res = fe.run()
        assert_drained(srv_b)
        assert res["closed_loop"] and res["n_turns"] == len(wl)
        for sess in fe.sessions:
            assert sess.state is M.SessionState.FINISHED
            assert len(by_sid[sess.sid]) == len(sess.requests)
            for a, b in zip(by_sid[sess.sid], sess.requests):
                assert a.prompt_tokens == b.prompt_tokens
                assert a.generated == b.generated
                assert a.sampled_ids == b.sampled_ids
            for prev, nxt in zip(sess.requests, sess.requests[1:]):
                assert nxt.arrival == pytest.approx(
                    prev.finished_at + prev.tool_duration)
        assert srv_b.engine.jit_traces == len(srv_b.engine.buckets_used)
        turns[pkg], results[pkg] = _turns(fe), _host_independent(res)
    assert turns["port"] == turns["jax"]
    assert results["port"] == results["jax"]
    assert (results["port"]["multi_token_dispatches"] > 0) == (k > 1)


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_counters_match_in_both_packages(prefetch):
    """The reference's test_prefetch_eliminates_resume_stalls, in both
    packages: the same run summary, counters and outputs; with prefetch
    no resume stalls, without it some."""
    acfg = dict(n_jobs=8, seed=3, **ACFG)
    res, outs = {}, {}
    for pkg, (M, _, _) in PACKAGES.items():
        srv = _sim_server(pkg, num_blocks=48, host_blocks=32)
        fe = M.OnlineFrontend(srv, M.agentic_session_scripts(
            M.AgenticConfig(**acfg)), M.FrontendConfig(
                prefetch=prefetch, prefetch_lead=0.3))
        res[pkg] = _host_independent(fe.run())
        outs[pkg] = _turns(fe)
        assert_drained(srv)
    assert res["port"] == res["jax"]
    assert outs["port"] == outs["jax"]
    if prefetch:
        assert res["port"]["resume_swap_stalls"] == 0
        assert res["port"]["prefetch_swap_ins"] > 0
        assert res["port"]["prefetch_hits"] > 0
    else:
        assert res["port"]["resume_swap_stalls"] > 0


def test_prefetch_pins_survive_multi_token_dispatch_in_both_packages():
    """The reference's test_prefetch_pins_survive_multi_token_dispatch, in
    both packages: at k = 8 every pinned block stays in the block table
    through each k-step dispatch, every resume lands without a stall, the
    outputs equal the k = 1 run's, and both packages count the same."""
    acfg = dict(n_jobs=8, seed=3, **ACFG)
    res, outs = {}, {}
    for pkg, (M, _, _) in PACKAGES.items():
        for k in (1, 8):
            srv = _sim_server(pkg, num_blocks=48, host_blocks=32,
                              max_decode_steps=k)
            violations = []
            orig = srv.engine.dispatch

            def snapping(plan, _srv=srv, _orig=orig, _v=violations):
                if plan.decode_steps > 1:
                    for blk in _srv.bm.blocks:
                        if blk.pinned_until > _srv.now \
                                and blk.key is not None:
                            _v.append(_srv.bm.table.get(blk.key) != blk.slot)
                return _orig(plan)

            srv.engine.dispatch = snapping
            fe = M.OnlineFrontend(srv, M.agentic_session_scripts(
                M.AgenticConfig(**acfg)), M.FrontendConfig(
                    prefetch=True, prefetch_lead=0.3))
            res[pkg, k] = _host_independent(fe.run())
            outs[pkg, k] = [(sid, [(p, g) for p, g, _, _ in t])
                            for sid, t in _turns(fe)]
            if k == 8:
                assert violations and not any(violations)
        r8 = res[pkg, 8]
        assert r8["multi_token_dispatches"] > 0 and r8["prefetch_pins"] > 0
        assert r8["resume_swap_stalls"] == 0 and r8["prefetch_swap_ins"] > 0
        assert outs[pkg, 8] == outs[pkg, 1]
    for k in (1, 8):
        assert res["port", k] == res["jax", k]
        assert outs["port", k] == outs["jax", k]
