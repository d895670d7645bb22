"""The slices as a whole: the JAX server and the port's server serve the
same workload with the smoke model at float32 on the same weights (the
port's through the weight bridge), in the fused and in the split
attention layout.  The control plane is a copy, so the
runs must agree exactly on greedy tokens, sampled ids, step counts,
bucket counts and page-op counters; ``first_logits`` agree within 1e-4
of their scale (float32 through two frameworks' matmul and softmax
orders — not bitwise: the reference itself is not bitwise across layouts
under jax 0.9).  Each port run also passes the repo's losslessness check
against its own dense reference."""
import jax
import numpy as np
import pytest

import repro.serving as J
import repro_torch.serving as P
from repro.configs import get_smoke_config, scaled_config
from repro.models import init_params
from _h100_costs import PCIE_BW, cost_model
from repro_torch.bridge import params_from_numpy

LOGIT_REL_TOL = 1e-4
LOSSLESS_REL_TOL = 2e-3       # the repo-wide losslessness bar


@pytest.fixture(scope="module")
def small_model():
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jp = init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _mk_server(M, cfg, params, *, depth, num_blocks, host_blocks,
               attn_mode, **kw):
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=num_blocks, block_size=16,
        clock="model", pipeline_depth=depth, host_blocks=host_blocks,
        attn_mode=attn_mode, pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8))
    ecfg = M.EngineConfig(num_pages=num_blocks, page_size=16,
                          max_prefills=2, max_chunk=64, max_decodes=8,
                          attn_mode=attn_mode)
    return M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg,
                             cost_model=cost_model(M, cfg), **kw)


def _workload(M, kind):
    if kind == "multi_turn":
        return M.multi_turn_workload(M.WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
            output_len=(12, 30), qps=1.0, seed=3))
    # 0.2 jobs a second: at the H100's 52 ms a step (``_h100_costs``) the
    # default 2 overlaps the four jobs so that no spilled block comes back
    return M.shared_prefix_workload(M.SharedPrefixConfig(n_jobs=4, qps=0.2,
                                                         seed=1))


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


COUNTERS = ("steps", "n_requests", "evictions", "swap_ins", "swap_outs",
            "cow_forks_manager", "prefix_matches", "attn_dispatches",
            "attn_dispatches_per_step", "padded_token_fraction",
            "bucket_counts", "instep_copies", "eager_copies",
            "instep_swaps", "eager_swaps", "swap_bytes_shipped")


CASES = [
    ("multi_turn", 1, 64, 0),          # the _mk_server/_wl settings
    ("shared_prefix", 0, 32, 16),      # evictions, swaps, COW forks
]


# the fused cases keep their ids from before the split layout was ported
@pytest.mark.parametrize("kind,depth,num_blocks,host_blocks,attn_mode", [
    pytest.param(*case, mode,
                 id="-".join(map(str, case if mode == "fused"
                                 else (mode,) + case)))
    for mode in ("fused", "split") for case in CASES])
def test_port_server_matches_reference(small_model, kind, depth, num_blocks,
                                       host_blocks, attn_mode):
    cfg, jp, tp = small_model
    kw = dict(depth=depth, num_blocks=num_blocks, host_blocks=host_blocks,
              attn_mode=attn_mode)
    wj, wt = _workload(J, kind), _workload(P, kind)
    rj = _mk_server(J, cfg, jp, **kw).run(wj)
    rt = _mk_server(P, cfg, tp, device="cpu", **kw).run(wt)
    for key in COUNTERS:
        assert rt[key] == rj[key], key
    assert rt["attn_dispatches_per_step"] == cfg.n_layers * (
        1 if attn_mode == "fused" else 2)
    if kind == "shared_prefix":
        assert rt["evictions"] and rt["swap_ins"] and rt["instep_copies"]
    for a, b in zip(wt, wj):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids and a.sampled_ids
        assert _rel(a.first_logits, b.first_logits) < LOGIT_REL_TOL
        ref = P.reference_logits(cfg, tp, a.prompt_tokens)
        assert _rel(a.first_logits, ref) < LOSSLESS_REL_TOL


def test_dense_reference_matches_jax(small_model):
    cfg, jp, tp = small_model
    rng = np.random.RandomState(0)
    for n in (37, 150):
        toks = [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
        want = J.reference_logits(cfg, jp, toks)
        got = P.reference_logits(cfg, tp, toks)
        assert _rel(got, np.asarray(want)) < LOGIT_REL_TOL
