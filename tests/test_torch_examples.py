"""The serving examples of the port (``repro_torch.examples``) against
the JAX package: each example's ``run`` at a reduced size, on the model
clock, with the JAX package's smoke weights carried across by the weight
bridge, and the reference side built through ``repro.serving`` with the
example's own settings (the settings of ``examples/*.py``).

The control plane is a copy, so schedules and counters must be equal
(steps, evictions, hit rate, computed prefill tokens, trie matches,
copy-on-write forks, greedy sampled ids, session states, streamed and
prefetch counts); ``first_logits`` agree within 1e-4 of their scale
(float32 through two frameworks' matmul and softmax orders)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as P
from _h100_costs import PCIE_BW, cost_model
from repro.configs import get_smoke_config, scaled_config
from repro.models import init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import scaled_config as t_scaled
from repro_torch.examples import (_smoke, prefix_sharing, quickstart,
                                  serve_multiturn, serve_online)

LOGIT_REL_TOL = 1e-4
LOSSLESS_REL_TOL = 2e-3       # the repo-wide losslessness bar
COUNTERS = ("steps", "n_requests", "evictions", "block_hit_rate",
            "prefill_compute_tokens", "prefix_matched_tokens", "cow_forks",
            "swap_ins", "swap_outs", "attn_dispatches", "bucket_counts")

# the settings of examples/*.py, written out: the reference side is built
# from these, never from the port's constants, so a drifted port setting
# shows as a different schedule or a different config
QUICKSTART_WL = dict(n_sessions=4, turns_per_session=(2, 3),
                     first_ctx_len=(96, 200), output_len=(16, 40), qps=1.0,
                     seed=0)
PREFIX_WL = dict(n_jobs=10, shared_fraction=0.8, system_prefix_len=280,
                 qps=0.8, seed=3)
ONLINE_JOBS = dict(n_jobs=5, tool_calls_per_job=(2, 3), system_prefix_len=32,
                   task_len=(32, 64), tool_result_len=(16, 48),
                   output_len=(12, 24), tool_duration=(0.6, 1.5), qps=1.5,
                   seed=7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model():
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return t_scaled(t_smoke("llama31-8b"), dtype="float32"), cfg, jp, tp


@pytest.fixture
def port_servers(monkeypatch):
    """Every server the examples build, recorded."""
    made = []

    class Recording(P.AsymCacheServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    for mod in (_smoke, prefix_sharing, serve_online):
        monkeypatch.setattr(mod, "AsymCacheServer", Recording)
    return made


# rows of a work-list q tile: the port's default is its CUDA kernel's
# tile (16), the reference's its TPU kernel's (128); no example sets it
PORT_DEFAULTS = {"q_tile"}


def _same_config(port_srv, ref_srv):
    """The port's server and engine configs equal the reference's on every
    field both packages have but ``PORT_DEFAULTS``."""
    for a, b in ((port_srv.scfg, ref_srv.scfg),
                 (port_srv.engine.ecfg, ref_srv.engine.ecfg)):
        pa, ra = dataclasses.asdict(a), dataclasses.asdict(b)
        shared = (pa.keys() & ra.keys()) - PORT_DEFAULTS
        assert {k: pa[k] for k in shared} == {k: ra[k] for k in shared}


def _ref_server(cfg, params, num_blocks, **kw):
    return J.AsymCacheServer(cfg, params, J.ServerConfig(
        policy="asymcache", num_blocks=num_blocks, block_size=16,
        clock="model", pcie_bw=PCIE_BW,
        scheduler=J.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8), **kw),
        cost_model=cost_model(J, cfg))


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


def _same_run(port_res, port_wl, ref_res, ref_wl):
    for key in COUNTERS:
        assert port_res[key] == ref_res[key], (key, port_res[key],
                                               ref_res[key])
    assert len(port_wl) == len(ref_wl)
    for p, r in zip(port_wl, ref_wl):
        assert p.status == r.status == "finished"
        assert p.prompt_tokens == r.prompt_tokens
        assert p.sampled_ids == r.sampled_ids, p.rid
        assert _rel(p.first_logits, r.first_logits) < LOGIT_REL_TOL, p.rid


def test_quickstart_matches_reference(small_model, port_servers):
    pcfg, cfg, jp, tp = small_model
    assert dataclasses.asdict(quickstart.WORKLOAD) == \
        dataclasses.asdict(J.WorkloadConfig(**QUICKSTART_WL))
    out = quickstart.run(
        pcfg, tp, workload_cfg=dataclasses.replace(quickstart.WORKLOAD,
                                                   n_sessions=2),
        clock="model", device="cpu")
    ref_wl = J.multi_turn_workload(
        J.WorkloadConfig(**{**QUICKSTART_WL, "n_sessions": 2}))
    ref_srv = _ref_server(cfg, jp, 64)
    ref = ref_srv.run(ref_wl)
    _same_config(port_servers[0], ref_srv)
    _same_run(out["summary"], out["requests"], ref, ref_wl)
    assert out["worst_rel_err"] < LOSSLESS_REL_TOL


def test_prefix_sharing_matches_reference(small_model, port_servers):
    pcfg, cfg, jp, tp = small_model
    assert dataclasses.asdict(prefix_sharing.WORKLOAD) == \
        dataclasses.asdict(J.SharedPrefixConfig(**PREFIX_WL))
    out = prefix_sharing.run(
        pcfg, tp, workload_cfg=dataclasses.replace(prefix_sharing.WORKLOAD,
                                                   n_jobs=4),
        clock="model", device="cpu")
    arms = ((True, out["shared"], out["requests"]),
            (False, out["baseline"], out["baseline_requests"]))
    for port_srv, (sharing, res, wl) in zip(port_servers, arms):
        ref_wl = J.shared_prefix_workload(
            J.SharedPrefixConfig(**{**PREFIX_WL, "n_jobs": 4}))
        ref_srv = J.AsymCacheServer(cfg, jp, J.ServerConfig(
            policy="asymcache", num_blocks=320, block_size=16,
            clock="model", prefix_sharing=sharing, pcie_bw=PCIE_BW,
            scheduler=J.SchedulerConfig(token_budget=256, max_chunk=128,
                                        max_prefills=2, max_decodes=8)),
            cost_model=cost_model(J, cfg))
        ref = ref_srv.run(ref_wl)
        _same_config(port_srv, ref_srv)
        _same_run(res, wl, ref, ref_wl)
    assert out["shared"]["cow_forks"] > 0
    assert out["shared"]["prefix_matched_tokens"] > 0
    assert (out["shared"]["prefill_compute_tokens"]
            < out["baseline"]["prefill_compute_tokens"])
    assert out["worst_rel_err"] < LOSSLESS_REL_TOL


def test_serve_multiturn_real_matches_reference(small_model, port_servers):
    pcfg, cfg, jp, tp = small_model
    assert dataclasses.asdict(serve_multiturn.WORKLOAD) == \
        dataclasses.asdict(J.WorkloadConfig(**QUICKSTART_WL))
    # three sessions: the smallest cut at which the 56-block pool evicts
    out = serve_multiturn.run_real(
        pcfg, tp, workload_cfg=dataclasses.replace(serve_multiturn.WORKLOAD,
                                                   n_sessions=3),
        clock="model", device="cpu")
    ref_wl = J.multi_turn_workload(
        J.WorkloadConfig(**{**QUICKSTART_WL, "n_sessions": 3}))
    ref_srv = _ref_server(cfg, jp, 56)
    ref = ref_srv.run(ref_wl)
    _same_config(port_servers[0], ref_srv)
    _same_run(out["summary"], out["requests"], ref, ref_wl)
    assert ref["evictions"] > 0
    scale = max(float(np.max(np.abs(r.first_logits))) for r in ref_wl)
    assert out["worst_abs_err"] < LOSSLESS_REL_TOL * scale


def _ref_online(cfg, jp, n_jobs, cancel_sid):
    """``examples/serve_online.py``'s run through the JAX package."""
    srv = J.AsymCacheServer(cfg, jp, J.ServerConfig(
        policy="asymcache", num_blocks=40, block_size=16, clock="model",
        host_blocks=24, pcie_bw=PCIE_BW,
        scheduler=J.SchedulerConfig(token_budget=160, max_chunk=96,
                                    max_prefills=2, max_decodes=8)),
        ecfg=J.EngineConfig(num_pages=40, page_size=16, max_prefills=2,
                            max_chunk=96, max_decodes=8,
                            max_blocks_per_seq=32),
        cost_model=cost_model(J, cfg))
    streamed = {}

    def on_token(req, tok):
        streamed[req.session_id] = streamed.get(req.session_id, 0) + 1
        if req.session_id == cancel_sid and streamed[cancel_sid] == 5:
            fe.cancel_session(cancel_sid)

    scripts = J.agentic_session_scripts(
        J.AgenticConfig(**{**ONLINE_JOBS, "n_jobs": n_jobs}))
    fe = J.OnlineFrontend(srv, scripts, J.FrontendConfig(prefetch=True),
                          on_token=on_token)
    res = fe.run()
    return srv, fe, res, dict(sorted(streamed.items()))


def test_serve_online_matches_reference(small_model, port_servers):
    pcfg, cfg, jp, tp = small_model
    assert dataclasses.asdict(serve_online.JOBS) == \
        dataclasses.asdict(J.AgenticConfig(**ONLINE_JOBS))
    assert (serve_online.CANCEL_SID, serve_online.CANCEL_AFTER) == (4, 5)
    out = serve_online.run(
        pcfg, tp, jobs=dataclasses.replace(serve_online.JOBS, n_jobs=3),
        cancel_sid=2, device="cpu")
    srv, fe, ref, streamed = _ref_online(cfg, jp, n_jobs=3, cancel_sid=2)
    _same_config(port_servers[0], srv)
    assert out["streamed"] == streamed
    assert out["cancelled_after"] == 5
    assert [s[:3] for s in out["sessions"]] == [
        (s.sid, len(s.requests), s.state.name) for s in fe.sessions]
    assert out["sessions"][2][2] == "CANCELLED"
    for (_, _, _, lat), s in zip(out["sessions"], fe.sessions):
        assert lat == s.job_latency or (lat != lat and s.job_latency
                                        != s.job_latency)
    for key in COUNTERS + ("prefetch_swap_ins", "prefetch_pins",
                           "prefetch_hits", "resume_swap_stalls",
                           "agent_job_latency_mean",
                           "agent_job_latency_p90"):
        assert out["summary"][key] == ref[key], key
    assert out["summary"]["resume_swap_stalls"] == 0
    assert out["released"]
    assert all(b.ref_count == 0 for b in srv.bm.blocks)
