"""Port vs reference for the serving engine: the occupancy lattice and the
packed layout (fused and split), one fixed mixed StepPlan (a
multi-segment prefill chunk plus decode rows) through both engines on the
same weights and pools in each layout, the port's fused and split
layouts on one plan, in-step vs eager page ops inside the port, and the
paths a later slice brings, which raise."""
import jax
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as P
from repro.configs import get_smoke_config as j_smoke, scaled_config as j_scaled
from repro.kernels.msa import build_worklist as j_build_worklist
from repro.models import init_params as j_init
from repro.serving.engine import pack_layout_for as j_pack_layout_for
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.core.offload import OffloadConfig
from repro_torch.kernels.msa import (UNIT_FIELDS, WL_FIELDS, build_units,
                                     pad_worklist)
from repro_torch.models import init_params
from repro_torch.serving.engine import (derive_bucket_lattice,
                                        pack_layout_for, unit_bucket)

NB = 44


@pytest.fixture(scope="module")
def small():
    """The tests' small model (llama31-8b smoke config at float32) with
    the JAX weights and their bridged copy."""
    cfg = j_scaled(j_smoke("llama31-8b"), dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _server(M, cfg, params, attn_mode="fused", **kw):
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=NB, block_size=16, clock="model",
        attn_mode=attn_mode,
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8))
    ecfg = M.EngineConfig(num_pages=NB, page_size=16, max_prefills=2,
                          max_chunk=64, max_decodes=8, attn_mode=attn_mode)
    return M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg, **kw)


def _mixed_plan(cfg, tp, attn_mode):
    """A port server driven to a step whose plan mixes a multi-segment
    prefill chunk (gapped positions) with decode rows."""
    tsrv = _server(P, cfg, tp, attn_mode=attn_mode, device="cpu")
    tsrv.run(_workload(P), max_steps=72)
    plan = tsrv.sched.schedule(tsrv.now)
    assert plan.prefills and plan.decodes
    assert any(np.any(np.diff(c.positions) > 1) for c in plan.prefills)
    return tsrv, plan


def _workload(M):
    return M.multi_turn_workload(M.WorkloadConfig(
        n_sessions=4, turns_per_session=(2, 3), first_ctx_len=(96, 180),
        output_len=(12, 30), qps=1e6, seed=3))


@pytest.mark.parametrize("kw", [
    dict(num_pages=64), dict(num_pages=64, max_decodes=5, q_tile=16),
    dict(num_pages=96, max_prefills=2, max_chunk=64, max_decodes=8,
         max_blocks_per_seq=16, token_buckets=(8, 40), np_buckets=(4,)),
    dict(num_pages=96, max_prefills=2, max_chunk=64, max_decodes=8,
         max_blocks_per_seq=16, attn_mode="split")])
def test_bucket_lattice_and_pack_layout_match_jax(kw):
    tcfg, jcfg = P.EngineConfig(**kw), J.EngineConfig(**kw)
    assert derive_bucket_lattice(tcfg) == J.engine.derive_bucket_lattice(
        jcfg)
    tbs, nbs = derive_bucket_lattice(tcfg)
    split = tcfg.attn_mode == "split"
    if split:
        assert (tbs, nbs) == ((2 * 64 + 8,), (16,))
    for t_b in tbs:
        for np_b in nbs:
            got, _ = pack_layout_for(tcfg, t_b, np_b, 0 if split else 64)
            want, _ = j_pack_layout_for(jcfg, 1, t_b, np_b,
                                        0 if split else 64)
            if split:       # the reference's split layout as it is
                assert got == want
                continue
            sizes = {name: size for name, _, size in got}
            tq = min(tcfg.q_tile, t_b)
            u_b = unit_bucket(64, -(-t_b // tq))
            for f in UNIT_FIELDS:     # the port's work units
                assert sizes.pop(f) == (2 if f == "unit_counts" else
                                        u_b // 2 if f.startswith("mg_")
                                        else u_b)
            assert sizes == {name: size for name, _, size in want}


def test_fixed_step_plan_through_both_engines(small):
    """Drive the port to a step whose plan mixes a multi-segment prefill
    chunk with decode rows, hand the reference engine the same pools, and
    run that one plan through both engines: same assembly and work-list,
    same greedy ids, logits and written pools within float32 tolerance."""
    cfg, jp, tp = small
    tsrv, plan = _mixed_plan(cfg, tp, "fused")
    teng = tsrv.engine
    jeng = J.Engine(cfg, J.EngineConfig(
        num_pages=NB, page_size=16, max_prefills=2, max_chunk=64,
        max_decodes=8), jp)
    jeng.k_pools = jax.numpy.asarray(teng.k_pools[:, :NB].numpy())
    jeng.v_pools = jax.numpy.asarray(teng.v_pools[:, :NB].numpy())
    copies = tsrv.bm.drain_pending_copies()
    jeng.queue_copies(copies)
    teng.queue_copies(copies)

    t_b, np_b = jeng.buckets_for(plan)
    assert teng.buckets_for(plan) == (t_b, np_b)
    jf = jeng._assemble_fused(plan, t_b, np_b)
    tf = teng._assemble_fused(plan, t_b, np_b)
    assert jf.keys() == tf.keys()
    for f in jf:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
    inp, (_, _, w_b) = teng.build_inputs(plan)
    got = teng._unpack(inp, t_b, np_b, w_b)
    tq = min(teng.ecfg.q_tile, t_b)
    wl, n_items = j_build_worklist(
        jf["qstart"], jf["qlen"], jf["ctx"], jf["bt"], jf["positions"],
        page=16, q_tile=tq, n_tiles=-(-t_b // tq), window=0)
    assert w_b == max(64, 1 << (n_items - 1).bit_length())
    wl = pad_worklist(wl, w_b, sentinel_seq=teng.n_seqs)
    for f in WL_FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), wl[f], err_msg=f)
    n_tiles = -(-t_b // tq)
    units = build_units(wl, jf["qstart"], jf["qlen"], n_rows=t_b, q_tile=tq,
                        n_tiles=n_tiles, pad_to=unit_bucket(w_b, n_tiles))
    for f in UNIT_FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), units[f], err_msg=f)

    jh = jeng.execute(plan)
    with torch.no_grad():
        ids, logits = teng._step_impl(tp, inp, t_b, np_b, w_b)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jh.token_ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jh.prefill_logits),
                               rtol=0, atol=1e-5)
    # pool entries reach |x| ~ 5; rope angles pos * freq round in float32
    # at positions of several hundred, so the two frameworks' written K
    # differ by up to ~2e-5 of that scale
    for tpool, jpool in ((teng.k_pools, jeng.k_pools),
                         (teng.v_pools, jeng.v_pools)):
        np.testing.assert_allclose(tpool[:, :NB].numpy(), np.asarray(jpool),
                                   rtol=0, atol=2e-4)


def _jax_engine_with_pools(cfg, jp, teng, attn_mode):
    jeng = J.Engine(cfg, J.EngineConfig(
        num_pages=NB, page_size=16, max_prefills=2, max_chunk=64,
        max_decodes=8, attn_mode=attn_mode), jp)
    jeng.k_pools = jax.numpy.asarray(teng.k_pools[:, :NB].numpy())
    jeng.v_pools = jax.numpy.asarray(teng.v_pools[:, :NB].numpy())
    return jeng


def test_fixed_split_step_plan_through_both_engines(small):
    """The split layout: a plan mixing a multi-segment prefill chunk with
    decode rows (and padding decode rows: ctx 1, slot 0) through the
    port's and the reference's split engines on the same pools: the same
    packed buffer, greedy ids, logits and written pools."""
    cfg, jp, tp = small
    tsrv, plan = _mixed_plan(cfg, tp, "split")
    teng = tsrv.engine
    assert len(plan.decodes) < teng.ecfg.max_decodes
    jeng = _jax_engine_with_pools(cfg, jp, teng, "split")
    copies = tsrv.bm.drain_pending_copies()
    jeng.queue_copies(copies)
    teng.queue_copies(copies)

    assert teng.buckets_for(plan) == jeng.buckets_for(plan) == (136, 64)
    inp, bucket = teng.build_inputs(plan)
    jinp, jbucket = jeng.build_inputs(plan)
    assert bucket == jbucket == (136, 64, 0)
    np.testing.assert_array_equal(inp["pack"].numpy(),
                                  np.asarray(jinp["pack"]))
    got = teng._unpack(inp, *bucket)
    assert np.all(got["ctx_dec"].numpy()[len(plan.decodes):] == 1)

    jids, jlogits, jk, jv = jeng._step(jeng.params, jeng.k_pools,
                                       jeng.v_pools, jinp, *bucket, 1)
    with torch.no_grad():
        ids, logits = teng._step_impl(tp, inp, *bucket)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    # the same rope rounding as in the fused case above
    for tpool, jpool in ((teng.k_pools, jk), (teng.v_pools, jv)):
        np.testing.assert_allclose(tpool[:, :NB].numpy(), np.asarray(jpool),
                                   rtol=0, atol=2e-4)


def test_port_fused_and_split_engines_agree_on_one_plan(small):
    """Inside the port, the fused and the split layouts run one mixed plan
    on the same pools: equal greedy ids, logits and written pools within
    float32 tolerance (the attention paths sum in different orders, so
    bit identity is not promised)."""
    cfg, _, tp = small
    fsrv, plan = _mixed_plan(cfg, tp, "fused")
    copies = fsrv.bm.drain_pending_copies()
    split = P.Engine(cfg, P.EngineConfig(
        num_pages=NB, page_size=16, max_prefills=2, max_chunk=64,
        max_decodes=8, attn_mode="split"), tp, device="cpu")
    split.k_pools.copy_(fsrv.engine.k_pools)
    split.v_pools.copy_(fsrv.engine.v_pools)
    outs = []
    for eng in (fsrv.engine, split):
        eng.queue_copies(copies)
        h = eng.execute(plan)
        outs.append((h.token_ids_np(), h.prefill_logits_np()))
    (fid, flog), (sid, slog) = outs
    R, nd = split.ecfg.max_prefills, len(plan.decodes)
    np.testing.assert_array_equal(fid[:R + nd], sid[:R + nd])
    n_pre = len(plan.prefills)
    np.testing.assert_allclose(flog[:n_pre], slog[:n_pre], rtol=0, atol=1e-5)
    assert split.attn_dispatches == 2 * fsrv.engine.cfg.n_layers
    for a, b in ((fsrv.engine.k_pools, split.k_pools),
                 (fsrv.engine.v_pools, split.v_pools)):
        np.testing.assert_allclose(a[:, :NB].numpy(), b[:, :NB].numpy(),
                                   rtol=0, atol=1e-5)


def test_instep_and_eager_page_ops_leave_identical_pools():
    """Inside the port, COW copies and swap-ins folded into the step land
    the same pool bytes as the eager paths run before it (bf16 pools:
    host payloads travel as raw 16-bit patterns)."""
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="bfloat16")
    params = init_params(cfg, seed=1, device="cpu")
    srv = _server(P, cfg, params, device="cpu")
    other = _server(P, cfg, params, device="cpu")
    for r in _workload(P):
        srv._on_arrival(r)
    plan = srv.sched.schedule(now=1e9)
    a, b = srv.engine, other.engine
    gen = torch.Generator().manual_seed(0)
    a.k_pools.copy_(torch.randn(a.k_pools.shape, generator=gen))
    a.v_pools.copy_(torch.randn(a.v_pools.shape, generator=gen))
    b.k_pools.copy_(a.k_pools)
    b.v_pools.copy_(a.v_pools)
    used = {int(s) for c in plan.prefills for s in c.req.slot_array()}
    free = sorted(set(range(NB)) - used)
    kh, vh = a.swap_out(free[0])
    assert kh.dtype == np.int16                 # the bf16 bit carrier
    pairs = [(free[1], free[2]), (free[3], free[4])]
    a.queue_swap_in(free[5], (kh, vh))
    a.queue_swap_in(free[6], (None, vh))        # V-only half
    a.queue_copies(pairs)
    b.swap_in(free[5], (kh, vh))
    b.swap_in(free[6], (None, vh))
    b.copy_pages(pairs)
    ha, hb = a.execute(plan), b.execute(plan)
    assert a.instep_swaps == 3 and a.instep_copies == 2    # halves
    assert torch.equal(a.k_pools[:, :NB], b.k_pools[:, :NB])
    assert torch.equal(a.v_pools[:, :NB], b.v_pools[:, :NB])
    assert torch.equal(a.v_pools[:, free[6]], a.v_pools[:, free[0]])
    np.testing.assert_array_equal(ha.token_ids_np(), hb.token_ids_np())


def test_later_slices_raise_not_implemented(small):
    cfg, _, tp = small
    for kw in (dict(swap_payload="q8"), dict(snap="int8", snap_scale=0.1)):
        with pytest.raises(NotImplementedError):
            P.Engine(cfg, P.EngineConfig(num_pages=8, **kw), tp,
                     device="cpu")
    moe = get_smoke_config("grok-1-314b")
    with pytest.raises(NotImplementedError):
        P.Engine(moe, P.EngineConfig(num_pages=8), tp, device="cpu")
    with pytest.raises(NotImplementedError):
        init_params(moe, device="cpu")
    for scfg in (P.ServerConfig(n_shards=2),
                 P.ServerConfig(offload=OffloadConfig(quant="int8"))):
        with pytest.raises(NotImplementedError):
            P.AsymCacheServer(cfg, tp, scfg, device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card, the entry points refuse the default device instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    with pytest.raises(RuntimeError):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        P.Engine(cfg, P.EngineConfig(num_pages=8), params)
    with pytest.raises(RuntimeError):
        P.AsymCacheServer(cfg, params, P.ServerConfig(num_blocks=8))
