"""The port's synchronous serving baseline (the paper's §5.3 control
plane: ``pipeline_depth=0``, ``assembly="legacy"`` — per-token Python
assembly, one host-to-device copy a field — ``return_full_logits`` —
the full (R+B, V) logits moved to the host every step — and eager page
copies, ``max_instep_copies=0``) against the JAX package's, and inside
the port against the overlapped pipeline.  The counterpart of
``tests/test_pipeline.py``'s assembly and baseline tests.

The float32 smoke Llama, the JAX weights through the weight bridge, the
H100 cost model on both sides (``_h100_costs``), the model clock: both
packages run the same schedule.  Across the packages ``first_logits``
agree within 1e-4 of their scale (two frameworks' matmul and softmax
orders); inside the port the baseline and the overlapped split run
launch the same ops on the same inputs, so they agree bit for bit, and
the baseline holds to the fused run in tokens and ids with logits within
1e-4.  One intra-op thread."""
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

LOGIT_REL_TOL = 1e-4
SPLIT_FIELDS = ("tokens", "positions", "valid", "write_slot", "write_off",
                "bt_pre", "ctx_pre", "qlens", "bt_dec", "ctx_dec", "sel")
# the baseline of benchmarks/pipeline.py: every option that the
# overlapped pipeline removes
BASELINE = dict(depth=0, attn_mode="split", assembly="legacy",
                return_full_logits=True, max_instep_copies=0)
COUNTERS = ("steps", "n_requests", "evictions", "swap_ins", "swap_outs",
            "cow_forks_manager", "prefix_matches", "attn_dispatches",
            "bucket_counts", "instep_copies", "eager_copies",
            "instep_swaps", "eager_swaps", "prefill_compute_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model(_one_thread):
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _mk_server(M, cfg, params, *, depth, attn_mode="fused", num_blocks=64,
               host_blocks=0, **ecfg_kw):
    """``tests/test_pipeline.py``'s server, at the H100's prices."""
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=num_blocks, block_size=16,
        clock="model", pipeline_depth=depth, attn_mode=attn_mode,
        host_blocks=host_blocks, pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8))
    ecfg = M.EngineConfig(num_pages=num_blocks, page_size=16,
                          max_prefills=2, max_chunk=64, max_decodes=8,
                          attn_mode=attn_mode, **ecfg_kw)
    kw = {"device": "cpu"} if M is P else {}
    return M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg,
                             cost_model=cost_model(M, cfg), **kw)


def _wl(M, n_sessions=3, seed=7):
    return M.multi_turn_workload(M.WorkloadConfig(
        n_sessions=n_sessions, turns_per_session=(2, 3),
        first_ctx_len=(96, 180), output_len=(12, 30), qps=1.0, seed=seed))


# the runs' workloads and pools: a multi-turn workload whose later turns
# recompute evicted history, and ``test_torch_server.py``'s shared-prefix
# jobs over a pool with a host tier (copy-on-write forks, which the
# baseline copies eagerly, and swap-ins folded into the step)
WORKLOADS = {
    "multi_turn": (lambda M: _wl(M), dict(num_blocks=48)),
    "shared_prefix": (lambda M: M.shared_prefix_workload(
        M.SharedPrefixConfig(n_jobs=4, qps=0.2, seed=1)),
        dict(num_blocks=32, host_blocks=16)),
}


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


def _record(srv, handles=None):
    """Keep every step's legacy fields (``_assemble_legacy``'s output, a
    copy) and, with ``handles``, every dispatched handle."""
    eng = srv.engine
    fields = []
    if eng.ecfg.assembly == "legacy":
        inner = eng._assemble_legacy

        def spy(plan):
            out = inner(plan)
            fields.append({k: np.array(v) for k, v in out.items()})
            return out
        eng._assemble_legacy = spy
    if handles is not None:
        dispatch = eng.dispatch

        def keep(plan):
            h = dispatch(plan)
            handles.append(h)
            return h
        eng.dispatch = keep
    return fields


def _serve(M, cfg, params, kind, handles=None, **kw):
    make_wl, pool = WORKLOADS[kind]
    srv = _mk_server(M, cfg, params, **pool, **kw)
    wl = make_wl(M)
    fields = _record(srv, handles)
    res = srv.run(wl)
    return dict(srv=srv, wl=wl, res=res, fields=fields, handles=handles,
                kind=kind)


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def runs(small_model, request):
    """One workload served by the reference's baseline, the port's
    baseline, and the port's overlapped split and fused pipelines
    (depth 1, vectorized, device-side sampling)."""
    cfg, jp, tp = small_model
    kind = request.param
    return {
        "ref_baseline": _serve(J, cfg, jp, kind, **BASELINE),
        "baseline": _serve(P, cfg, tp, kind, handles=[], **BASELINE),
        "split": _serve(P, cfg, tp, kind, handles=[], depth=1,
                        attn_mode="split"),
        "fused": _serve(P, cfg, tp, kind, depth=1),
    }


# ---------------------------------------------------------------------------
# (a) one engine: legacy and vectorized assembly fill the same fields

def _assert_pack_equals_legacy(eng, inp, key, legacy):
    buf = inp["pack"].numpy()
    layout, _ = eng.pack_layout(*key)
    names = [name for name, _, _ in layout if name in legacy]
    assert sorted(names) == sorted(SPLIT_FIELDS)
    for name, off, size in layout:
        if name not in legacy:          # page-op fields have no legacy twin
            continue
        want = np.asarray(legacy[name]).reshape(-1).astype(np.int32)
        assert np.array_equal(buf[off:off + size], want), name


def test_assembly_paths_build_identical_inputs(small_model):
    """The counterpart of the reference's test of the same name: one
    split engine, its first plan, both assembly paths."""
    cfg, _, tp = small_model
    srv = _mk_server(P, cfg, tp, depth=1, attn_mode="split")
    for r in _wl(P, n_sessions=2, seed=1):
        srv._on_arrival(r)
    plan = srv.sched.schedule(now=1e9)
    assert plan.prefills
    eng = srv.engine
    legacy = eng._assemble_legacy(plan)
    inp, key = eng.build_inputs(plan)
    _assert_pack_equals_legacy(eng, inp, key, legacy)


def test_assembly_paths_agree_on_every_plan_of_a_run(small_model):
    """Every plan of a whole run (chunks with gaps, decode rows,
    prefill and decode in one step): the legacy fields equal the
    vectorized pack's."""
    cfg, _, tp = small_model
    srv = _mk_server(P, cfg, tp, depth=1, attn_mode="split", num_blocks=48)
    eng = srv.engine
    inner, seen = eng.build_inputs, []

    def check(plan):
        legacy = eng._assemble_legacy(plan)
        inp, key = inner(plan)
        _assert_pack_equals_legacy(eng, inp, key, legacy)
        seen.append((bool(plan.prefills), bool(plan.decodes),
                     any(np.any(np.diff(c.positions) > 1)
                         for c in plan.prefills)))
        return inp, key
    eng.build_inputs = check
    res = srv.run(_wl(P))
    assert len(seen) == res["steps"] > 10
    assert any(p and d for p, d, _ in seen)         # mixed steps
    assert any(d and not p for p, d, _ in seen)     # decode-only steps
    assert res["evictions"] > 0


# ---------------------------------------------------------------------------
# (b), (c) the port's baseline against the reference's

def test_legacy_assembly_matches_reference(runs):
    """The port's ``_assemble_legacy`` gives the reference's fields, step
    by step, over the whole baseline run."""
    got, want = runs["baseline"]["fields"], runs["ref_baseline"]["fields"]
    assert len(got) == len(want) == runs["baseline"]["res"]["steps"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(SPLIT_FIELDS)
        for name in SPLIT_FIELDS:
            assert g[name].dtype == w[name].dtype, name
            assert np.array_equal(g[name], w[name]), name


def test_baseline_matches_reference_baseline(runs):
    """Depth 0, legacy, split, full logits, eager copies: the same
    schedule, counters, tokens and sampled ids as the reference's
    baseline, first logits within 1e-4."""
    t, j = runs["baseline"], runs["ref_baseline"]
    for key in COUNTERS:
        assert t["res"][key] == j["res"][key], key
    assert t["res"]["eager_copies"] == t["res"]["cow_forks_manager"]
    assert t["res"]["instep_copies"] == 0
    assert t["res"]["evictions"] > 0
    if t["kind"] == "shared_prefix":
        assert t["res"]["eager_copies"] > 0 and t["res"]["swap_ins"] > 0
    assert t["srv"].engine.jit_traces == len(t["srv"].engine.buckets_used) \
        == 1
    for a, b in zip(t["wl"], j["wl"]):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids and a.sampled_ids
        assert _rel(a.first_logits, b.first_logits) < LOGIT_REL_TOL


# ---------------------------------------------------------------------------
# (d) inside the port: the baseline against the overlapped pipeline

@pytest.mark.parametrize("other", ["split", "fused"])
def test_baseline_matches_overlapped(runs, other):
    """Against the overlapped split run, the baseline launches the same
    kernels on the same inputs: the same bits.  Against the fused run:
    the same schedule, tokens and ids, logits within 1e-4 (three kernels
    sum the keys in different orders)."""
    b, o = runs["baseline"], runs[other]
    for key in ("steps", "evictions", "prefill_compute_tokens",
                "cow_forks_manager", "prefix_matches"):
        assert b["res"][key] == o["res"][key], key
    assert b["res"]["eager_copies"] + b["res"]["instep_copies"] == \
        o["res"]["eager_copies"] + o["res"]["instep_copies"]
    for x, y in zip(b["wl"], o["wl"]):
        assert x.status == y.status == "finished"
        assert x.generated == y.generated
        assert x.sampled_ids == y.sampled_ids and x.sampled_ids
        if other == "split":
            assert np.array_equal(x.first_logits, y.first_logits)
        else:
            assert _rel(x.first_logits, y.first_logits) < LOGIT_REL_TOL


# ---------------------------------------------------------------------------
# (e) the full-logits interface

def test_full_logits_handles(runs, small_model):
    """Every baseline handle holds (R+B, V) logits, moved to the host by
    ``block`` (the synchronous loop's transfer); their first R rows have
    the bits of the overlapped split run's (R, V) rows at the same step."""
    cfg = small_model[0]
    full, rows = runs["baseline"]["handles"], runs["split"]["handles"]
    e = runs["baseline"]["srv"].engine.ecfg
    R, B = e.max_prefills, e.max_decodes
    assert len(full) == len(rows) == runs["baseline"]["res"]["steps"]
    for hf, hr in zip(full, rows):
        assert hf.full_logits and not hr.full_logits
        assert tuple(hf.prefill_logits.shape) == (R + B, cfg.vocab_size)
        assert tuple(hr.prefill_logits.shape) == (R, cfg.vocab_size)
        assert hf._pre_np is not None and hf._ids_np is not None
        assert hf._pre_np.shape == (R + B, cfg.vocab_size)
        assert np.array_equal(hf.prefill_logits_np()[:R],
                              hr.prefill_logits_np())
        assert np.array_equal(hf.token_ids_np(), hr.token_ids_np())


def test_full_logits_in_the_fused_layout(small_model):
    """``return_full_logits`` is not tied to the split layout: a fused
    engine's step hands back (R+B, V) rows whose first R are the default
    engine's, and the same ids."""
    cfg, _, tp = small_model
    plans, out = [], {}
    for full in (False, True):
        srv = _mk_server(P, cfg, tp, depth=0, return_full_logits=full)
        for r in _wl(P, n_sessions=2, seed=1):
            srv._on_arrival(r)
        plan = srv.sched.schedule(now=1e9)
        plans.append(len(plan.prefills))
        out[full] = srv.engine.execute(plan)
    assert plans[0] == plans[1] > 0
    R = srv.engine.ecfg.max_prefills
    assert out[True].prefill_logits_np().shape == (
        R + srv.engine.ecfg.max_decodes, cfg.vocab_size)
    assert np.array_equal(out[True].prefill_logits_np()[:R],
                          out[False].prefill_logits_np())
    assert np.array_equal(out[True].token_ids_np(),
                          out[False].token_ids_np())


# ---------------------------------------------------------------------------
# (f) what the reference refuses

def _legacy_decode_plan():
    """A two-iteration decode plan over one request of the workload."""
    req = _wl(P, n_sessions=1, seed=2)[0]
    return P.StepPlan(decodes=[req], decode_steps=2, decode_iters=[2])


@pytest.mark.parametrize("case", ["fused", "sharded", "multi_token",
                                  "unknown"])
def test_legacy_refusals(small_model, case):
    cfg, _, tp = small_model
    kw = dict(num_pages=64, page_size=16, max_prefills=2, max_chunk=64,
              max_decodes=8)
    if case == "fused":
        with pytest.raises(ValueError, match="split"):
            P.Engine(cfg, P.EngineConfig(**kw, assembly="legacy"), tp,
                     device="cpu")
    elif case == "sharded":
        with pytest.raises(ValueError, match="single-device"):
            P.Engine(cfg, P.EngineConfig(**kw, assembly="legacy",
                                         attn_mode="split"),
                     tp, shard_devices=["cpu", "cpu"])
    elif case == "multi_token":
        eng = P.Engine(cfg, P.EngineConfig(**kw, assembly="legacy",
                                           attn_mode="split"),
                       tp, device="cpu")
        with pytest.raises(ValueError, match="multi-token"):
            eng.build_inputs(_legacy_decode_plan())
        assert eng.steps_executed == 0
    else:
        with pytest.raises(ValueError, match="assembly"):
            P.Engine(cfg, P.EngineConfig(**kw, assembly="packed",
                                         attn_mode="split"),
                     tp, device="cpu")


def test_server_forces_one_decode_step_under_legacy(small_model):
    cfg, _, tp = small_model
    scfg = P.ServerConfig(
        num_blocks=64, block_size=16, clock="model", attn_mode="split",
        scheduler=P.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8,
                                    max_decode_steps=8))
    ecfg = P.EngineConfig(num_pages=64, page_size=16, max_prefills=2,
                          max_chunk=64, max_decodes=8, attn_mode="split",
                          assembly="legacy")
    srv = P.AsymCacheServer(cfg, tp, scfg, ecfg=ecfg, device="cpu")
    assert srv.scfg.scheduler.max_decode_steps == 1


# ---------------------------------------------------------------------------
# (g) the lattice of a legacy engine

def test_legacy_lattice_matches_reference():
    from repro.analysis import lattice as j_lattice
    from repro.serving.engine import EngineConfig as JE
    from repro_torch.analysis import lattice
    from repro_torch.serving.engine import EngineConfig as TE
    args = dict(num_pages=64, page_size=16, max_prefills=2, max_chunk=64,
                max_decodes=16, max_blocks_per_seq=24, attn_mode="split",
                assembly="legacy")
    for steps in (1, 4):
        got = lattice.enumerate_lattice(TE(**args), max_decode_steps=steps)
        want = j_lattice.enumerate_lattice(JE(**args),
                                           max_decode_steps=steps)
        for key in ("token_buckets", "np_buckets", "w_buckets", "k_values",
                    "max_trace_keys"):
            assert got[key] == want[key], key
        assert got["k_values"] == [1] and got["max_trace_keys"] == 1


def test_legacy_trace_keys_match_reference_and_engine(runs, small_model):
    """The replay's predicted keys for the baseline's configuration equal
    the reference's prediction and the port baseline engine's
    ``buckets_used``: one key, (R*QP + B, NP, 0, 1)."""
    import repro.serving.server as j_server
    from repro.analysis import lattice as j_lattice
    from repro_torch.analysis import lattice
    cfg = small_model[0]
    t_srv = runs["baseline"]["srv"]
    j_srv = runs["ref_baseline"]["srv"]
    make_wl = WORKLOADS[runs["baseline"]["kind"]][0]
    pred = lattice.predict_trace_keys(cfg, t_srv.scfg, [make_wl(P)],
                                      ecfg=t_srv.engine.ecfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_server, "analytic_cost_model",
                   lambda c: cost_model(j_server, c))
        ref = j_lattice.predict_trace_keys(
            cfg, j_srv.scfg, [make_wl(J)], ecfg=j_srv.engine.ecfg)
    e = t_srv.engine.ecfg
    key = (e.max_prefills * e.max_chunk + e.max_decodes,
           e.max_blocks_per_seq, 0, 1)
    assert pred == ref == sorted(t_srv.engine.buckets_used) == [key]
