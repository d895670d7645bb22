"""The port's recomputation cost model on the CPU: its defaults are the
H100's (``core.H100``, whose ``kernel_launch`` was fitted on the card, and
the measured ``H100_HOST_LINK_BW``), never the copied TPU v5e constants;
its Eq.-6 ``fit`` equals the JAX package's and recovers known constants;
``chip_smoke.py`` phase 14's hand-built two-segment instances are what
they say and run through the port's engine as through the reference's;
and the model-clock schedules of phases 3b, 5, 8 and 13a, which the
defaults price, still show what those phases require (the discrete-event
server, ``execute_model=False``, at Llama-3.1-8B's configuration; run
with ``-s`` for the counts)."""
import dataclasses
import importlib
import importlib.util
import inspect
import math
import os
import pkgutil

import jax
import numpy as np
import pytest

import repro.core.cost_model as jcm
import repro.serving as J
import repro_torch
import repro_torch.core.cost_model as tcm
import repro_torch.serving as P
from _h100_costs import H100_RATES, PCIE_BW
from repro.configs import get_smoke_config, scaled_config
from repro.models import init_params as j_init
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import BlockManager
from repro_torch.serving.engine import derive_bucket_lattice

REPO = os.path.join(os.path.dirname(__file__), "..")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LLAMA = get_config("llama31-8b")


# ---------------------------------------------------------------------------
# the defaults


def test_port_constants_are_the_written_out_h100():
    assert dataclasses.asdict(tcm.H100) == H100_RATES
    assert tcm.H100_HOST_LINK_BW == PCIE_BW
    # set, not inherited from the TPU's per-step overhead
    assert tcm.H100.kernel_launch != tcm.TPU_V5E.kernel_launch


@pytest.mark.parametrize("arch", ["llama31-8b", "gemma3-12b", "grok-1-314b"])
def test_default_server_prices_with_the_h100(arch):
    cfg = get_config(arch)
    srv = P.AsymCacheServer(cfg, None, P.ServerConfig(
        clock="model", execute_model=False))
    assert srv.cost_model == tcm.analytic_cost_model(cfg, tcm.H100)
    assert srv.sim_cost_model is srv.cost_model
    assert srv.scfg.pcie_bw == srv.bm.pcie_bw == tcm.H100_HOST_LINK_BW
    assert tcm.mixed_window_cost_model(cfg) == \
        tcm.mixed_window_cost_model(cfg, tcm.H100)
    assert srv.cost_model != tcm.analytic_cost_model(cfg, tcm.TPU_V5E)


def _port_callables():
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        if info.name.endswith("__main__"):
            continue
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) == info.name and (
                    inspect.isfunction(obj) or inspect.isclass(obj)):
                yield info.name, obj


def test_no_port_default_reaches_the_tpu():
    """No parameter default or dataclass field of any port module is the
    TPU v5e hardware, or the reference's unmeasured 1.2e10 link rate."""
    seen = 0
    for name, obj in _port_callables():
        fn = obj.__init__ if inspect.isclass(obj) else obj
        try:
            params = inspect.signature(fn).parameters.values()
        except (TypeError, ValueError):
            continue
        for p in params:
            seen += 1
            assert p.default is not tcm.TPU_V5E, (name, obj, p.name)
            if p.name == "pcie_bw":
                assert p.default == tcm.H100_HOST_LINK_BW, (name, obj)
    assert seen > 500
    assert inspect.signature(BlockManager).parameters["pcie_bw"].default \
        == tcm.H100_HOST_LINK_BW


# ---------------------------------------------------------------------------
# the fit


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(float(x) for x in rng.integers(0, 2048, 4)) for _ in
            range(n)]


@pytest.mark.parametrize("window", [math.inf, 512.0])
def test_fit_equals_the_reference_fit(window):
    rows = _rows(200, 0)
    rng = np.random.default_rng(1)
    lat = [1e-3 + 1e-6 * sum(r) + 1e-9 * r[0] * r[1] + rng.normal(0, 1e-4)
           for r in rows]
    got, want = tcm.fit(rows, lat, window), jcm.fit(rows, lat, window)
    for a, b in zip((*got.k, got.beta, got.r2),
                    (*want.k, want.beta, want.r2)):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-300)
    assert got.eff_window == want.eff_window == window


@pytest.mark.parametrize("window", [math.inf, 1024.0])
def test_fit_recovers_known_constants(window):
    """Phase 14's instances priced by a known Eq. 6 (the analytic H100
    model's constants) give those constants back, R² > 0.999."""
    truth = dataclasses.replace(tcm.analytic_cost_model(LLAMA, tcm.H100),
                                eff_window=window)
    rows = smoke.cost_instances(smoke.COST_INSTANCES)
    cm = tcm.fit(rows, [truth.latency(*r) for r in rows], window)
    assert cm.r2 > 0.999
    for a, b in zip((*cm.k, cm.beta), (*truth.k, truth.beta)):
        assert a == pytest.approx(b, rel=1e-6)
    assert smoke._eq7_slope(cm) == pytest.approx(smoke._eq7_slope(truth),
                                                 rel=1e-6)


# ---------------------------------------------------------------------------
# phase 14's instances


def test_phase14_instances_cover_the_stated_ranges():
    insts = smoke.cost_instances(smoke.COST_INSTANCES)
    assert len(insts) == smoke.COST_INSTANCES >= 128
    assert len(set(insts)) > 120
    e = smoke.COST_ENGINE
    for inst in insts:
        assert all(x % e["page_size"] == 0 for x in inst), inst
        for x, (lo, hi) in zip(inst, smoke.COST_RANGES):
            assert lo <= x <= hi, inst
        assert inst[1] + inst[3] <= e["max_chunk"]
        assert sum(inst) <= e["max_blocks_per_seq"] * e["page_size"]
    assert smoke.cost_instances(smoke.COST_INSTANCES) == insts


@pytest.fixture(scope="module")
def small():
    """The llama31-8b smoke model at float32: the JAX weights and their
    bridged copy, and a port server with phase 14's engine."""
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _phase14_server(cfg, tp):
    ecfg = P.EngineConfig(**smoke.COST_ENGINE)
    return P.AsymCacheServer(cfg, tp, P.ServerConfig(
        num_blocks=ecfg.num_pages, block_size=ecfg.page_size), ecfg=ecfg,
        device="cpu")


@pytest.mark.parametrize("inst", [(48, 32, 32, 16), (0, 16, 0, 16),
                                  (32, 16, 0, 48), (1792, 240, 944, 224)])
def test_two_segment_plan_has_the_intended_segments(small, inst):
    cfg, _, tp = small
    srv = _phase14_server(cfg, tp)
    l1, q1, l2, q2 = inst
    n = sum(inst)
    req, plan = smoke.two_segment_plan(srv, inst, 0,
                                       np.random.default_rng(0))
    assert req.prompt_len == n and len(plan.prefills) == 1
    assert not plan.decodes
    (chunk,) = plan.prefills
    assert chunk.req is req and chunk.completes_prefill
    pos = chunk.positions
    np.testing.assert_array_equal(pos, np.concatenate(
        [np.arange(l1, l1 + q1), np.arange(l1 + q1 + l2, n)]))
    segments = np.split(pos, np.flatnonzero(np.diff(pos) > 1) + 1)
    want = [(l1, q1), (l1 + q1 + l2, q2)] if l2 else [(l1, q1 + q2)]
    assert [(int(s[0]), len(s)) for s in segments] == want
    slots = list(req.block_slots)
    assert len(slots) == n // 16 == len(set(slots))
    assert srv.bm.num_free() == srv.bm.num_blocks - len(slots)


def test_two_segment_plan_matches_the_reference_engine(small):
    """An instance made resident (its q1 and q2 segments evicted to
    fresh pages), then its two-segment plan through the port's engine and
    the JAX package's engine on the same pools: the same greedy ids,
    logits within the fixed-plan test's 1e-5, both within the
    losslessness bar of the dense reference."""
    cfg, jp, tp = small
    srv = _phase14_server(cfg, tp)
    inst = (48, 32, 32, 16)
    l1, q1, l2, _ = inst
    req, plan = smoke.two_segment_plan(srv, inst, 0,
                                       np.random.default_rng(0))
    before = list(req.block_slots)
    smoke.make_resident(srv, req, inst)
    moved = [b for b, (x, y) in enumerate(zip(before, req.block_slots))
             if x != y]
    assert moved == [*range(l1 // 16, (l1 + q1) // 16),
                     *range((l1 + q1 + l2) // 16, sum(inst) // 16)]
    teng = srv.engine
    nb = teng.ecfg.num_pages
    jeng = J.Engine(cfg, J.EngineConfig(**smoke.COST_ENGINE), jp)
    jeng.k_pools = jax.numpy.asarray(teng.k_pools[:, :nb].numpy())
    jeng.v_pools = jax.numpy.asarray(teng.v_pools[:, :nb].numpy())
    jh = jeng.execute(plan)
    th = teng.execute(plan)
    np.testing.assert_array_equal(th.token_ids_np(),
                                  np.asarray(jh.token_ids))
    np.testing.assert_allclose(th.prefill_logits_np(),
                               np.asarray(jh.prefill_logits), rtol=0,
                               atol=1e-5)
    ref = P.reference_logits(cfg, tp, req.prompt_tokens)
    assert smoke._rel(th.prefill_logits_np()[0], ref) < 2e-3


# ---------------------------------------------------------------------------
# the chip phases' model-clock schedules under the defaults


def _sim(cfg, scfg, ecfg):
    """The discrete-event server of ``scfg`` at the port's default cost
    model, its scheduler on ``ecfg``'s lattice as the real engine sets
    it; returns it and the list its multi-segment chunks collect in."""
    srv = P.AsymCacheServer(cfg, None, dataclasses.replace(
        scfg, clock="model", execute_model=False))
    srv.sched.cfg.token_buckets, srv.sched.cfg.page_buckets = \
        derive_bucket_lattice(ecfg)
    seg, dispatch = [], srv.engine.dispatch

    def counting(plan):
        seg.extend(c for c in plan.prefills
                   if np.any(np.diff(c.positions) > 1))
        return dispatch(plan)

    srv.engine.dispatch = counting
    return srv, seg


def _counts(res, seg, *keys):
    out = {k: res[k] for k in ("steps", "evictions",
                               "prefill_compute_tokens", *keys)}
    out["multi_segment_chunks"] = len(seg)
    return out


def _phase3(sessions=None):
    """Phases 3b and 8's workload and server (``chip_smoke.serve_phase``
    at the model clock): 4 sessions over a 256-block pool."""
    ecfg = P.EngineConfig(num_pages=256, page_size=16, max_prefills=4,
                          max_chunk=128, max_decodes=64,
                          max_blocks_per_seq=128)
    srv, seg = _sim(LLAMA, P.ServerConfig(num_blocks=256), ecfg)
    wl = P.multi_turn_workload(P.WorkloadConfig(
        n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(512, 2048),
        output_len=(16, 32), qps=0.5, vocab=LLAMA.vocab_size, seed=0))
    if sessions:
        wl = [r for r in wl if r.session_id < sessions]
    res = srv.run(wl)
    assert all(r.status == "finished" for r in wl)
    return res, seg


def _phase5(k):
    """Phase 5's model-clock arm (``chip_smoke._online_run``) over the
    first ``OFFLOAD_LAYERS`` layers."""
    cfg = dataclasses.replace(LLAMA, n_layers=smoke.OFFLOAD_LAYERS)
    ecfg = P.EngineConfig(num_pages=384, page_size=16, max_prefills=4,
                          max_chunk=128, max_decodes=64,
                          max_blocks_per_seq=256)
    srv, seg = _sim(cfg, P.ServerConfig(
        num_blocks=384, host_blocks=512,
        scheduler=P.SchedulerConfig(max_decode_steps=k)), ecfg)
    fe = P.OnlineFrontend(srv, P.agentic_session_scripts(P.AgenticConfig(
        n_jobs=6, tool_calls_per_job=(2, 4), system_prefix_len=512,
        task_len=(256, 1024), tool_result_len=(128, 512),
        output_len=(24, 64), tool_duration=(0.5, 2.0),
        vocab=cfg.vocab_size, seed=0)), P.FrontendConfig(prefetch=True))
    res = fe.run()
    assert all(s.state is P.SessionState.FINISHED for s in fe.sessions)
    return res, seg


def _phase13a(sharing):
    """Phase 13 (a): ``repro_torch.examples.prefix_sharing``'s server and
    workload at Llama-3.1-8B's configuration."""
    from repro_torch.examples import prefix_sharing
    ecfg = P.EngineConfig(num_pages=prefix_sharing.NUM_BLOCKS, page_size=16,
                          max_prefills=2, max_chunk=128, max_decodes=8)
    srv, seg = _sim(LLAMA, P.ServerConfig(
        policy="asymcache", num_blocks=prefix_sharing.NUM_BLOCKS,
        block_size=16, prefix_sharing=sharing,
        scheduler=P.SchedulerConfig(token_budget=256, max_chunk=128,
                                    max_prefills=2, max_decodes=8)), ecfg)
    wl = P.shared_prefix_workload(prefix_sharing.WORKLOAD)
    res = srv.run(wl)
    assert all(r.status == "finished" for r in wl)
    return res, seg


def test_phase3b_model_clock_finds_a_multi_segment_chunk():
    """Phase 3b requires a prefill chunk that recomputes a gapped
    history on the model clock; phase 8 serves the same schedule sharded
    (its N = 4 run on the first ``SHARD_CUT_SESSIONS`` sessions)."""
    res, seg = _phase3()
    print("phase 3b / 8 (N = 2):", _counts(res, seg))
    assert len(seg) >= 1 and res["evictions"] > 0
    res, seg = _phase3(sessions=smoke.SHARD_CUT_SESSIONS)
    print(f"phase 8 (N = 4, {smoke.SHARD_CUT_SESSIONS} sessions):",
          _counts(res, seg))


def test_phase5_model_clock_pair_drops_decode_dispatches():
    runs = {k: _phase5(k) for k in (1, 8)}
    for k, (res, seg) in runs.items():
        print(f"phase 5 (k = {k}):", _counts(
            res, seg, "decode_only_dispatches", "multi_token_dispatches",
            "swap_ins", "prefetch_swap_ins"))
    (r1, _), (r8, _) = runs[1], runs[8]
    assert r8["multi_token_dispatches"] > 0
    assert r8["decode_only_dispatches"] < r1["decode_only_dispatches"]


def test_phase13a_model_clock_shares_the_preamble():
    shared, seg = _phase13a(True)
    base, base_seg = _phase13a(False)
    print("phase 13a (sharing):", _counts(shared, seg, "cow_forks"))
    print("phase 13a (no sharing):", _counts(base, base_seg))
    assert shared["cow_forks"] > 0
    assert shared["prefill_compute_tokens"] < base["prefill_compute_tokens"]
