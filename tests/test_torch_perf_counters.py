"""Schema freeze of the port's deterministic counter surfaces (the
counterpart of ``tests/test_perf_counters.py``): ``Engine.perf_counters()``
of the port's engine, ``_SimEngine.perf_counters()``,
``BlockManager.counters()``/``control_plane_counts()`` and
``PrefixStore.counters()``.  The frozensets below are what
``repro_torch.analysis.registry`` holds the emitters to; a test holds
them equal to the reference's, and the others hold the port's emitters
to them on a served burst (the port's engine on the CPU, multi-token
decode on), with the reference's monotonicity and reset semantics.  One
intra-op thread."""
import pytest
import torch

import test_perf_counters as ref_pc
from repro_torch.configs import get_config, get_smoke_config, scaled_config
from repro_torch.core import H20, PrefixStoreConfig, analytic_cost_model
from repro_torch.models import init_params
from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                 SchedulerConfig, ServerConfig,
                                 decode_burst_workload)
from repro_torch.serving.server import _SimEngine

BLOCK = 16

# frozen key set of Engine.perf_counters() — additions are fine but must
# be added HERE too (and to the reference's, whose sets these equal)
ENGINE_COUNTER_KEYS = frozenset({
    "attn_dispatches",
    "attn_dispatches_per_step",
    "padded_token_fraction",
    "bucket_counts",
    "instep_copies",
    "eager_copies",
    "instep_swaps",
    "eager_swaps",
    "swap_bytes_shipped",
    "engine_dispatches",
    "decode_only_dispatches",
    "decode_tokens_emitted",
    "multi_token_dispatches",
    "multi_token_iterations",
    "multi_token_rollbacks",
    "k_counts",
})

# cumulative integer counters that must never decrease across dispatches
MONOTONIC_KEYS = (
    "attn_dispatches",
    "engine_dispatches",
    "decode_only_dispatches",
    "decode_tokens_emitted",
    "multi_token_dispatches",
    "multi_token_iterations",
    "multi_token_rollbacks",
    "instep_copies",
    "eager_copies",
    "instep_swaps",
    "eager_swaps",
    "swap_bytes_shipped",
)

# the sim engine mirrors this subset so stress-benchmark gates read the
# same names from either engine
SIM_ENGINE_KEYS = frozenset({
    "engine_dispatches",
    "decode_only_dispatches",
    "decode_tokens_emitted",
    "multi_token_dispatches",
    "multi_token_iterations",
    "multi_token_rollbacks",
    "k_counts",
})

CONTROL_PLANE_KEYS = frozenset({
    "treap_ops",
    "evictor_adds",
    "evictor_removes",
    "evictor_evicts",
    "evictor_reranks",
    "trie_nodes_visited",
    "pin_heap_ops",
})

# frozen key set of BlockManager.counters() — the asymmetric-offload
# accounting serve() merges verbatim into every result dict, and what
# benchmarks/offload.py's bytes-moved gates read
BM_COUNTER_KEYS = frozenset({
    "swap_ins",
    "swap_outs",
    "evictions",
    "bytes_swapped_in_k",
    "bytes_swapped_in_v",
    "bytes_swapped_out_k",
    "bytes_swapped_out_v",
    "host_resident_bytes",
    "host_entries",
    "n_host_evictions",
    "n_host_half_drops",
    "clean_half_spills",
    "v_half_streams",
    "k_early_prefetches",
    "pending_purges",
})

# frozen key set of PrefixStore.counters() — the content-addressed
# store/tenancy accounting serve() merges into every result (zeros when
# the store is disabled), read by benchmarks/prefix_store.py's gates
STORE_COUNTER_KEYS = frozenset({
    "store_entries",
    "store_bytes",
    "store_puts",
    "store_hits",
    "store_misses",
    "store_evictions",
    "store_expired",
    "store_restored",
    "store_corrupt_drops",
    "store_fingerprint_drops",
    "store_quota_rejects",
    "store_preflight_reports",
    "store_preflight_dup_blocks",
    "store_preflight_holds",
    "tenant_count",
    "tenant_quota_evictions",
    "tenant_shed_ownerships",
})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(_one_thread):
    """One burst served by the port's engine on the CPU with multi-token
    dispatch on: the engine's counters after each dispatch."""
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    scfg = ServerConfig(
        policy="asymcache", num_blocks=256, block_size=BLOCK, clock="model",
        scheduler=SchedulerConfig(token_budget=160, max_chunk=96,
                                  max_prefills=2, max_decodes=8,
                                  max_decode_steps=4))
    ecfg = EngineConfig(num_pages=256, page_size=BLOCK, max_prefills=2,
                        max_chunk=96, max_decodes=8, max_blocks_per_seq=32)
    srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device="cpu")
    snapshots = []
    orig = srv.engine.dispatch

    def snapping(plan):
        handle = orig(plan)
        snapshots.append(srv.engine.perf_counters())
        return handle

    srv.engine.dispatch = snapping
    srv.run(decode_burst_workload(n_requests=6, seed=4))
    return srv, snapshots


@pytest.mark.parametrize("name", ["ENGINE_COUNTER_KEYS", "MONOTONIC_KEYS",
                                  "SIM_ENGINE_KEYS", "CONTROL_PLANE_KEYS",
                                  "BM_COUNTER_KEYS", "STORE_COUNTER_KEYS"])
def test_frozen_sets_equal_the_reference(name):
    assert globals()[name] == getattr(ref_pc, name)


def test_engine_counter_schema(served):
    srv, _ = served
    pc = srv.engine.perf_counters()
    assert set(pc) == ENGINE_COUNTER_KEYS
    for key in MONOTONIC_KEYS:
        assert isinstance(pc[key], int) and pc[key] >= 0
    assert isinstance(pc["bucket_counts"], dict)
    assert isinstance(pc["k_counts"], dict)
    assert pc["multi_token_dispatches"] > 0
    assert pc["multi_token_iterations"] > pc["multi_token_dispatches"]
    assert pc["decode_only_dispatches"] > 0
    assert all(k.startswith("k") for k in pc["k_counts"])


def test_engine_counters_monotonic(served):
    _, snapshots = served
    assert len(snapshots) >= 2
    for a, b in zip(snapshots, snapshots[1:]):
        for key in MONOTONIC_KEYS:
            assert b[key] >= a[key], f"{key} decreased mid-run"


def test_reset_semantics(served):
    srv, _ = served
    eng = srv.engine
    traces, buckets = eng.jit_traces, set(eng.buckets_used)
    assert traces == len(buckets) > 0
    eng.reset_perf_counters()
    pc = eng.perf_counters()
    for key in MONOTONIC_KEYS:
        assert pc[key] == 0, f"{key} survived reset"
    assert pc["bucket_counts"] == {} and pc["k_counts"] == {}
    assert eng.jit_traces == traces
    assert set(eng.buckets_used) == buckets
    assert all(len(b) == 4 for b in buckets)
    assert any(b[3] > 1 for b in buckets)


def test_sim_engine_counter_parity():
    pc = _SimEngine(SchedulerConfig()).perf_counters()
    assert set(pc) == SIM_ENGINE_KEYS
    assert SIM_ENGINE_KEYS <= ENGINE_COUNTER_KEYS


def test_bm_counter_schema_and_server_result(served):
    srv, _ = served
    bc = srv.bm.counters()
    assert set(bc) == BM_COUNTER_KEYS
    for key in BM_COUNTER_KEYS:
        assert isinstance(bc[key], int) and bc[key] >= 0, key
    cfg = get_config("llama31-8b")
    cm = analytic_cost_model(cfg, H20)
    for host_blocks in (0, 64):
        scfg = ServerConfig(
            policy="asymcache", num_blocks=128, block_size=BLOCK,
            clock="model", execute_model=False, host_blocks=host_blocks,
            scheduler=SchedulerConfig(token_budget=256, max_chunk=96,
                                      max_prefills=2, max_decodes=8))
        sim = AsymCacheServer(cfg, None, scfg, cost_model=cm,
                              sim_cost_model=cm)
        res = sim.run(decode_burst_workload(n_requests=6, seed=5))
        assert BM_COUNTER_KEYS <= set(res)
        if host_blocks == 0:
            assert res["bytes_swapped_out_k"] == 0
            assert res["host_entries"] == 0


def test_store_counter_schema_and_server_result():
    cfg = get_config("llama31-8b")
    cm = analytic_cost_model(cfg, H20)
    for pscfg in (None, PrefixStoreConfig(capacity_bytes=1 << 20,
                                          tenant_quota_bytes=1 << 18)):
        scfg = ServerConfig(
            policy="asymcache", num_blocks=128, block_size=BLOCK,
            clock="model", execute_model=False, prefix_store=pscfg,
            scheduler=SchedulerConfig(token_budget=256, max_chunk=96,
                                      max_prefills=2, max_decodes=8))
        sim = AsymCacheServer(cfg, None, scfg, cost_model=cm,
                              sim_cost_model=cm)
        assert set(sim.store.counters()) == STORE_COUNTER_KEYS
        res = sim.run(decode_burst_workload(n_requests=6, seed=5))
        assert STORE_COUNTER_KEYS <= set(res)
        for key in STORE_COUNTER_KEYS:
            assert isinstance(res[key], int) and res[key] >= 0, key
        if pscfg is None:
            assert all(res[k] == 0 for k in STORE_COUNTER_KEYS)


def test_control_plane_counts_schema():
    cfg = get_config("llama31-8b")
    cm = analytic_cost_model(cfg, H20)
    scfg = ServerConfig(
        policy="asymcache", num_blocks=512, block_size=BLOCK,
        clock="model", execute_model=False,
        scheduler=SchedulerConfig(token_budget=256, max_chunk=96,
                                  max_prefills=2, max_decodes=8))
    srv = AsymCacheServer(cfg, None, scfg, cost_model=cm, sim_cost_model=cm)
    before = srv.bm.control_plane_counts()
    assert set(before) == CONTROL_PLANE_KEYS
    res = srv.run(decode_burst_workload(n_requests=6, seed=5))
    after = srv.bm.control_plane_counts()
    assert set(after) == CONTROL_PLANE_KEYS
    for key in CONTROL_PLANE_KEYS:
        assert isinstance(after[key], int)
        assert after[key] >= before[key]
    assert after["treap_ops"] > 0 and after["evictor_adds"] > 0
    assert CONTROL_PLANE_KEYS <= set(res)
