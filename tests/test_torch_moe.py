"""Port vs reference for MoE serving: the routing and dispatch functions
(``topk_route`` with deliberate ties, ``capacity_dispatch``,
``expand_virtual_experts``), ``moe_ffn_local`` with and without drops,
the MoE parameters through the weight bridge and ``init_params``, the
dense MoE forward, and the Grok-1 smoke model served by both packages.

Inputs come from numpy seeds and go through both packages.  Tolerances:
1e-5 of the output's scale at float32 and 2e-2 at bfloat16 (those of
``tests/test_kernels.py``); expert ids, positions and keep masks exactly.
Served runs agree exactly on tokens, sampled ids and counters, and on
``first_logits`` within 1e-4 of their scale (float32 through two
frameworks' matmul orders), as ``tests/test_torch_server.py`` holds the
dense model."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as P
from _h100_costs import PCIE_BW, cost_model
from repro.configs import get_smoke_config, scaled_config
from repro.models import init_params as j_init
from repro.models import layers as jlayers
from repro_torch.bridge import params_from_numpy
from repro_torch.models import init_params as t_init
from repro_torch.models import layers as tlayers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_REL_TOL = 1e-4
LOSSLESS_REL_TOL = 2e-3       # the repo-wide losslessness bar


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = max(1.0, float(np.max(np.abs(want))))
    return float(np.max(np.abs(got.float().numpy() - want))) / scale


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,ties", [("float32", False),
                                        ("bfloat16", False),
                                        ("bfloat16", True)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_route_matches_jax(dtype, ties, k):
    rng = np.random.RandomState(11)
    T, E = 64, 8
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        # a handful of levels: most rows hold equal logits, often among
        # their top k (lax.top_k puts the lower expert first)
        logits = rng.randint(-2, 3, (T, E)).astype(np.float32) * 0.5
    jw, ji = jlayers.topk_route(jnp.asarray(logits, getattr(jnp, dtype)), k)
    tw, ti = tlayers.topk_route(
        torch.from_numpy(logits).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == torch.float32
    assert _err(tw, jw) < TOL["float32"]
    if ties:
        row_ties = [len(set(r)) < E for r in logits]
        assert sum(row_ties) == T


@pytest.mark.parametrize("seed,E,capacity", [(0, 4, 3), (1, 8, 5),
                                             (2, 8, 64), (3, 16, 1)])
def test_capacity_dispatch_matches_jax(seed, E, capacity):
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, E, 64).astype(np.int32)
    jpos, jkeep = jlayers.capacity_dispatch(jnp.asarray(flat), E, capacity)
    tpos, tkeep = tlayers.capacity_dispatch(torch.from_numpy(flat), E,
                                            capacity)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    # each expert's slots rank 0, 1, 2, ... in slot order
    for e in range(E):
        np.testing.assert_array_equal(tpos.numpy()[flat == e],
                                      np.arange((flat == e).sum()))


@pytest.mark.parametrize("split", [1, 2])
def test_expand_virtual_experts_matches_jax(split):
    rng = np.random.RandomState(4)
    T, E, k = 12, 4, 2
    w = rng.rand(T, k).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]
                   ).astype(np.int32)
    jw, ji = jlayers.expand_virtual_experts(jnp.asarray(w), jnp.asarray(idx),
                                            split)
    tw, ti = tlayers.expand_virtual_experts(torch.from_numpy(w),
                                            torch.from_numpy(idx), split)
    assert tuple(ti.shape) == (T, k * split)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# the MoE sublayer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropless,split", [(True, 1), (False, 1),
                                            (True, 2), (False, 2)])
def test_moe_ffn_local_matches_jax(dtype, dropless, split):
    """The same T with and without drops: capacity_factor 0.5 leaves
    about half the routed slots without a place."""
    rng = np.random.RandomState(5)
    T, d, f, E_phys, k = 40, 32, 48, 4, 2
    E = E_phys * split
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = (rng.standard_normal((d, E_phys)) / math.sqrt(d)).astype(
        np.float32)
    we1, we3 = (rng.standard_normal((2, E, d, f // split))
                / math.sqrt(d)).astype(np.float32)
    we2 = (rng.standard_normal((E, f // split, d))
           / math.sqrt(f)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=0.5, dropless=dropless,
              expert_split=split)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.moe_ffn_local(*(jnp.asarray(a, jd) for a in
                                   (x, router, we1, we3, we2)), **kw)
    got = tlayers.moe_ffn_local(*(torch.from_numpy(a).to(td) for a in
                                  (x, router, we1, we3, we2)), **kw)
    assert got.dtype == td and tuple(got.shape) == (T, d)
    assert _err(got, want) < TOL[dtype]
    # the drops are exercised: without dropless some slots have no place
    _, idx = tlayers.topk_route(torch.from_numpy(x) @ torch.from_numpy(
        router), k)
    _, idx = tlayers.expand_virtual_experts(torch.zeros(idx.shape), idx,
                                            split)
    cap = T if dropless else math.ceil(T * k * split / E * 0.5)
    _, keep = tlayers.capacity_dispatch(idx.reshape(-1), E, cap)
    assert bool(keep.all()) == dropless


# ---------------------------------------------------------------------------
# parameters and the dense forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grok():
    """The Grok-1 smoke config at float32 (4 experts, top 2, dropless)
    with the JAX weights and their bridged copy."""
    cfg = scaled_config(get_smoke_config("grok-1-314b"), dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_cross_the_bridge_and_init_matches_their_layout(dtype):
    cfg = scaled_config(get_smoke_config("grok-1-314b"), dtype=dtype)
    jp = jax.tree.map(np.asarray, j_init(cfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, device="cpu")
    own = t_init(cfg, seed=0, device="cpu")
    assert {"router", "we1", "we3", "we2"} <= set(jp["blocks"])
    assert not {"w1", "w3", "w2"} & set(own["blocks"])
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in own.values())
    for path, arr in flat_j:
        t, o = tp, own
        for key in (p.key for p in path):
            t, o = t[key], o[key]
        assert t.dtype == getattr(torch, dtype) == o.dtype
        assert tuple(t.shape) == arr.shape == tuple(o.shape)
        np.testing.assert_array_equal(t.float().numpy(),
                                      arr.astype(np.float32))
        # same init scale: std within 20% (zeros stay zeros)
        js, ts = float(np.std(arr.astype(np.float32))), float(o.float().std())
        assert abs(js - ts) <= 0.2 * js + 1e-12, (path, js, ts)
    # the expert stack is drawn one (layer, expert) matrix at a time:
    # no two matrices repeat a draw
    we1 = own["blocks"]["we1"].float()
    assert not torch.equal(we1[0, 0], we1[0, 1])
    assert not torch.equal(we1[0, 0], we1[1, 0])


def test_moe_dense_forward_matches_jax(grok):
    cfg, jp, tp = grok
    rng = np.random.RandomState(0)
    for n in (37, 150):
        toks = [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
        want = J.reference_logits(cfg, jp, toks)
        got = P.reference_logits(cfg, tp, toks)
        assert _rel(got, np.asarray(want)) < LOGIT_REL_TOL


# ---------------------------------------------------------------------------
# Grok-1 (smoke) served by both packages
# ---------------------------------------------------------------------------

COUNTERS = ("steps", "n_requests", "evictions", "swap_ins", "swap_outs",
            "attn_dispatches", "attn_dispatches_per_step",
            "padded_token_fraction", "bucket_counts", "instep_copies",
            "eager_copies", "instep_swaps", "eager_swaps",
            "swap_bytes_shipped")


def _server(M, cfg, params, attn_mode, **kw):
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=40, block_size=16, clock="model",
        host_blocks=16, attn_mode=attn_mode, pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8))
    ecfg = M.EngineConfig(num_pages=40, page_size=16, max_prefills=2,
                          max_chunk=64, max_decodes=8, attn_mode=attn_mode)
    return M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg,
                             cost_model=cost_model(M, cfg), **kw)


def _workload(M):
    return M.multi_turn_workload(M.WorkloadConfig(
        n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
        output_len=(12, 24), qps=1.0, vocab=256, seed=3))


@pytest.mark.parametrize("attn_mode", ["fused", "split"])
def test_grok_smoke_served_by_both_packages(grok, attn_mode):
    """A pool of 40 blocks with a host tier: later turns find part of
    their history evicted or on the host, and the MoE runs over mixed
    steps of prefill chunks and decode rows."""
    cfg, jp, tp = grok
    wj, wt = _workload(J), _workload(P)
    rj = _server(J, cfg, jp, attn_mode).run(wj)
    rt = _server(P, cfg, tp, attn_mode, device="cpu").run(wt)
    for key in COUNTERS:
        assert rt[key] == rj[key], key
    assert rt["evictions"] > 0
    for a, b in zip(wt, wj):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids and a.sampled_ids
        assert _rel(a.first_logits, b.first_logits) < LOGIT_REL_TOL
        ref = P.reference_logits(cfg, tp, a.prompt_tokens)
        assert _rel(a.first_logits, ref) < LOSSLESS_REL_TOL
