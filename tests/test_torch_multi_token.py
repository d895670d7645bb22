"""Multi-token decode in the port against the JAX package: the
per-iteration pack layout, one fixed decode-only k-step plan (one row
masked after its first iteration) through both engines on the same
weights and pools, a k-step dispatch against k single dispatches inside
the port, the work units of an iteration with holes (rows masked between
live ones), and the port's server against the JAX server at the same
``max_decode_steps``.

Tolerances: greedy ids, generated tokens and counters exactly; logits
within 1e-5 (float32, ``tests/test_kernels.py``); the written pools
within 1e-5 of their scale (the smoke model's K/V entries reach ~25, and
two frameworks' float32 GEMMs differ in their last bits there)."""
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
from repro_torch.models import init_params
from repro_torch.kernels.msa import (UNIT_FIELDS, WL_FIELDS, build_units,
                                     build_worklist, msa_fused, pad_worklist)
from repro_torch.serving.engine import pack_layout_for, unit_bucket
from repro_torch.serving.request import Request
from test_torch_kernels import _unit_walk

NB = 64
TOL = 1e-5


@pytest.fixture(scope="module")
def small():
    """The tests' small model (llama31-8b smoke config at float32) with
    the JAX weights and their bridged copy."""
    cfg = j_scaled(j_smoke("llama31-8b"), dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _configs(M, k):
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=NB, block_size=16, clock="model",
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8,
                                    max_decode_steps=k))
    ecfg = M.EngineConfig(num_pages=NB, page_size=16, max_prefills=2,
                          max_chunk=64, max_decodes=8)
    return scfg, ecfg


def _k_plan(cfg, tp, k):
    """A port server driven through the burst's prefill to its first
    decode-only k-step plan; the plan's first row is then cut to one
    iteration, so that it is masked from the second on."""
    scfg, ecfg = _configs(P, k)
    srv = P.AsymCacheServer(cfg, tp, scfg, ecfg=ecfg, device="cpu")
    srv.run(P.decode_burst_workload(n_requests=5, seed=4), max_steps=3)
    plan = srv.sched.schedule(srv.now)
    assert plan.decode_steps == k and not plan.prefills
    assert min(plan.decode_iters) == k
    plan.decode_iters[0] = 1
    return srv.engine, plan


def _pools_close(tpool, jpool):
    want = np.asarray(jpool)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(tpool[:, :NB].numpy(), want, rtol=0,
                               atol=TOL * scale)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kw", [
    dict(num_pages=64), dict(num_pages=96, max_prefills=2, max_chunk=64,
                             max_decodes=8, max_blocks_per_seq=16,
                             token_buckets=(8, 40), np_buckets=(4,))])
def test_pack_layout_per_iteration_matches_jax(kw, k):
    """The k-step layout is the reference's field for field and offset
    for offset once the port's work units are taken out; the units come
    k times each, at the single step's sizes; k = 1 is the single step's
    layout."""
    tcfg, jcfg = P.EngineConfig(**kw), J.EngineConfig(**kw)
    tbs, nbs = P.engine.derive_bucket_lattice(tcfg)
    for t_b in tbs:
        for np_b in nbs:
            got, size = pack_layout_for(tcfg, t_b, np_b, 64, k)
            want, _ = j_pack_layout_for(jcfg, 1, t_b, np_b, 64, k)
            if k == 1:
                assert (got, size) == pack_layout_for(tcfg, t_b, np_b, 64)
            n_tiles = -(-t_b // min(tcfg.q_tile, t_b))
            u_b = unit_bucket(64, n_tiles)
            units = [(f, s) for f, _, s in got if f in UNIT_FIELDS]
            assert units == [(f, k * (2 if f == "unit_counts" else u_b // 2
                                      if f.startswith("mg_") else u_b))
                             for f in UNIT_FIELDS]
            rest = [(f, s) for f, _, s in got if f not in UNIT_FIELDS]
            assert rest == [(f, s) for f, _, s in want]
            # the port's units sit between the work-list and the page ops
            offs = {f: o for f, o, _ in got}
            jofs = {f: o for f, o, _ in want}
            shift = sum(s for _, s in units)
            for f in jofs:
                assert offs[f] == jofs[f] + (shift if f.startswith(
                    ("copy_", "swap_")) else 0), f


@pytest.mark.parametrize("k,forced", [(2, True), (4, True), (4, False)])
def test_k_step_plan_through_both_engines(small, k, forced):
    """One decode-only k-step plan, its first row masked after one
    iteration, through the JAX engine (``_multi_decode_steps``) and the
    port on the same pools: the same per-iteration assembly and
    work-lists, the same (k, R+B) ids, prefill logits and written pools
    within tolerance, and the same multi-token counters.  Unforced, every
    iteration after the first takes the token id -1, so its tokens are
    the previous iteration's samples, gathered on the device."""
    cfg, jp, tp = small
    teng, plan = _k_plan(cfg, tp, k)
    jeng = J.Engine(cfg, _configs(J, k)[1], jp)
    jeng.k_pools = jax.numpy.asarray(teng.k_pools[:, :NB].numpy())
    jeng.v_pools = jax.numpy.asarray(teng.v_pools[:, :NB].numpy())
    teng.reset_perf_counters()

    t_b, np_b = jeng.buckets_for(plan)
    assert teng.buckets_for(plan) == (t_b, np_b)
    jf = jeng._assemble_fused_multi(plan, t_b, np_b, k)
    tf = teng._assemble_fused_multi(plan, t_b, np_b, k)
    assert jf.keys() == tf.keys()
    for f in jf:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
    assert tf["qlen"][1:, 2].sum() == 0 and tf["valid"][1:, 0].sum() == 0
    inp, (_, _, w_b) = teng.build_inputs(plan)
    got = teng._unpack(inp, t_b, np_b, w_b, k)
    tq = min(teng.ecfg.q_tile, t_b)
    n_tiles = -(-t_b // tq)
    for i in range(k):
        wl, _ = j_build_worklist(
            jf["qstart"], jf["qlen"][i], jf["ctx"][i], jf["bt"],
            jf["positions"][i], page=16, q_tile=tq, n_tiles=n_tiles,
            window=0)
        wl = pad_worklist(wl, w_b, sentinel_seq=teng.n_seqs)
        units = build_units(wl, jf["qstart"], jf["qlen"][i], n_rows=t_b,
                            q_tile=tq, n_tiles=n_tiles,
                            pad_to=unit_bucket(w_b, n_tiles))
        for f in WL_FIELDS + UNIT_FIELDS:
            np.testing.assert_array_equal(
                got[f][i].numpy(), {**wl, **units}[f], err_msg=f"{f}[{i}]")

    jinp, jbucket = jeng.build_inputs(plan)
    if not forced:       # tokens lead both packs: (k, t) ids
        inp["pack"][t_b:k * t_b] = -1
        jinp["pack"] = jinp["pack"].at[t_b:k * t_b].set(-1)
    jids, jlogits, jk, jv = jeng._step(jeng.params, jeng.k_pools,
                                       jeng.v_pools, jinp, *jbucket, k)
    with torch.no_grad():
        ids, logits = teng._step_impl(tp, inp, t_b, np_b, w_b, k)
    assert ids.shape == (k, teng.n_seqs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=TOL)
    _pools_close(teng.k_pools, jk)
    _pools_close(teng.v_pools, jv)
    jeng.k_pools, jeng.v_pools = jk, jv        # the step donated the old
    jeng.dispatch(plan)            # the counters of one k-step dispatch
    teng.dispatch(plan)
    want = jeng.perf_counters()
    for key in ("multi_token_dispatches", "multi_token_iterations",
                "multi_token_rollbacks", "k_counts", "attn_dispatches",
                "padded_token_fraction", "decode_only_dispatches",
                "decode_tokens_emitted"):
        assert teng.perf_counters()[key] == want[key], key
    assert teng.multi_token_rollbacks == k - 1
    assert teng.buckets_used >= {(t_b, np_b, w_b, k)}


@pytest.mark.parametrize("k", [2, 4])
def test_k_step_equals_k_single_steps(small, k):
    """Inside the port, one k-step dispatch and k single dispatches of
    the same decode rows (every row live in every iteration, tokens
    forced) give identical ids and identical pools."""
    cfg, _, tp = small
    multi, plan = _k_plan(cfg, tp, k)
    plan.decode_iters[0] = k
    single = P.Engine(cfg, _configs(P, k)[1], tp, device="cpu")
    single.k_pools.copy_(multi.k_pools)
    single.v_pools.copy_(multi.v_pools)
    saved = [list(r.generated) for r in plan.decodes]

    multi.reset_perf_counters()
    ids_k = multi.execute(plan).token_ids_np()
    for i in range(k):
        step = P.StepPlan(decodes=list(plan.decodes))
        assert single.buckets_for(step)[0] == multi.buckets_for(plan)[0]
        np.testing.assert_array_equal(single.execute(step).token_ids_np(),
                                      ids_k[i], err_msg=f"iteration {i}")
        for r in plan.decodes:         # the server's forced next token
            r.generated.append(r.output_script[len(r.generated)])
    for r, g in zip(plan.decodes, saved):
        r.generated[:] = g
    assert torch.equal(multi.k_pools, single.k_pools)
    assert torch.equal(multi.v_pools, single.v_pools)
    assert multi.attn_dispatches == single.attn_dispatches == \
        k * cfg.n_layers


def _hole_plan(n_rows, page, k):
    """A decode-only k-step plan of ``n_rows`` one-page contexts, every
    other row cut to one iteration; the live rows cross into a second
    page in their second iteration."""
    reqs = []
    for j in range(n_rows):
        prompt = [1 + j % 7] * (page - 1)
        r = Request(rid=j, session_id=j, prompt_tokens=prompt,
                    output_script=[2 + (j + i) % 5 for i in range(k + 1)],
                    arrival=0.0)
        r.generated = [r.output_script[0]]
        r.block_slots = [2 * j, 2 * j + 1]
        reqs.append(r)
    plan = P.StepPlan(decodes=reqs, decode_steps=k,
                      decode_iters=[k if j % 2 == 0 else 1
                                    for j in range(n_rows)])
    return plan


def test_k_step_holes_fit_the_unit_bucket():
    """An iteration whose live rows alternate with masked ones (each
    masked row a hole the work units must cover with a zero unit), at
    short contexts where the work-list is as full as the bucket allows:
    the step assembles, its unit counts stay within the bucket, and the
    kernel's unit walk (emulated in numpy) writes exact zeros on the
    masked rows and the plain version's values on the live ones."""
    page, k, n = 16, 2, 64
    cfg = j_scaled(j_smoke("llama31-8b"), dtype="float32")
    ecfg = P.EngineConfig(num_pages=2 * n, page_size=page, max_prefills=1,
                          max_chunk=8, max_decodes=n, max_blocks_per_seq=4,
                          q_tile=16, token_buckets=(n,))
    eng = P.Engine(cfg, ecfg, init_params(cfg, seed=0, device="cpu"),
                   device="cpu")
    plan = _hole_plan(n, page, k)
    inp, (t_b, np_b, w_b) = eng.build_inputs(plan)
    assert (t_b, w_b) == (n, n)
    f = eng._unpack(inp, t_b, np_b, w_b, k)
    n_tiles = t_b // 16
    counts = f["unit_counts"].numpy()
    # iteration 1: 32 live rows of two pages each, 32 holes
    assert f["wl_seq"][1].numpy().tolist().count(eng.n_seqs) == 0
    assert counts[1, 0] == n == w_b and counts[1, 0] <= unit_bucket(
        w_b, n_tiles)
    rng = np.random.default_rng(0)
    H, KH, D = 4, 2, 16
    kp = rng.standard_normal((2 * n + 1, page, KH, D)).astype(np.float32)
    vp = rng.standard_normal((2 * n + 1, page, KH, D)).astype(np.float32)
    R = ecfg.max_prefills
    for i in range(k):
        wl = {name: f[name][i].numpy() for name in WL_FIELDS}
        units = {name: f[name][i].numpy() for name in UNIT_FIELDS}
        c = dict(q=rng.standard_normal((t_b, H, D)).astype(np.float32),
                 k_pages=kp, v_pages=vp, q_pos=f["positions"][i].numpy(),
                 ctx=f["ctx"][i].numpy())
        got = _unit_walk(c, wl, units, page=page, window=0, softcap=0.0)
        live = f["valid"][i].numpy()
        assert not np.isnan(got).any()
        assert live.sum() == (n if i == 0 else n // 2)
        assert np.all(got[~live] == 0), "a masked row is not exact zeros"
        tt = torch.from_numpy
        want = msa_fused(tt(c["q"]), tt(kp), tt(vp), f["bt"], f["ctx"][i],
                         f["positions"][i], f["seq_ids"],
                         f["valid"][i]).numpy()
        assert np.max(np.abs(got - want)) < TOL
        assert np.all(f["seq_ids"].numpy()[:n] == R + np.arange(n))


@pytest.mark.parametrize("seed", range(3))
def test_k_step_unit_counts_never_pass_the_bucket(seed):
    """Random decode-only k-step iterations (masked rows anywhere, one- to
    many-page contexts, contexts that cross a page boundary, tiles of 4-32
    rows): every iteration's work units fit ``unit_bucket`` of the most
    real items any iteration has, so of the shared W too."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        page = int(rng.choice([8, 16]))
        nd, k = int(rng.integers(1, 80)), int(rng.choice([2, 4, 8]))
        R = int(rng.integers(0, 3))
        n = R + nd
        t = nd + int(rng.integers(0, 40))
        tq = min(int(rng.choice([4, 8, 16, 32])), t)
        n_tiles = -(-t // tq)
        iters = rng.integers(1, k + 1, nd)
        iters[rng.integers(nd)] = k
        ctx0 = [rng.integers(1, 3 * page, nd),
                rng.integers(1, 3, nd) * page,
                rng.integers(1, 80 * page, nd)][int(rng.integers(3))]
        bt = rng.integers(0, 1000, (n, int(ctx0.max() + k) // page + 2))
        qstart = np.zeros(n, np.int32)
        qstart[R:] = np.arange(nd)
        its = []
        for i in range(k):
            act = i < iters
            qlen = np.zeros(n, np.int32)
            qlen[R:] = act
            ctx = np.zeros(n, np.int32)
            ctx[R:] = np.where(act, ctx0 + i, 0)
            pos = np.zeros(t, np.int32)
            pos[:nd] = np.where(act, ctx0 + i - 1, 0)
            wl, _ = build_worklist(qstart, qlen, ctx, bt.astype(np.int32),
                                   pos, page=page, q_tile=tq,
                                   n_tiles=n_tiles)
            its.append((wl, qlen))
        w = max(wl["wl_seq"].shape[0] for wl, _ in its)
        for wl, qlen in its:
            units = build_units(pad_worklist(wl, w, sentinel_seq=n), qstart,
                                qlen, n_rows=t, q_tile=tq, n_tiles=n_tiles)
            assert units["unit_counts"][0] <= unit_bucket(w, n_tiles)


@pytest.mark.parametrize("k", [4, 8])
def test_port_server_matches_reference_at_k(small, k):
    """One burst of decodes through the port's server and the JAX server
    at ``max_decode_steps`` k: equal generated tokens and sampled ids per
    request, equal multi-token counters and step counts."""
    cfg, jp, tp = small
    runs = []
    for M, params, kw in ((J, jp, {}), (P, tp, dict(device="cpu"))):
        scfg, ecfg = _configs(M, k)
        wl = M.decode_burst_workload(n_requests=6, seed=4)
        srv = M.AsymCacheServer(cfg, params, scfg, ecfg=ecfg, **kw)
        runs.append((wl, srv.run(wl), srv.engine))
    (wj, rj, ej), (wt, rt, et) = runs
    assert rt["multi_token_dispatches"] > 0
    assert rt["multi_token_rollbacks"] > 0
    for key in ("steps", "multi_token_dispatches", "multi_token_iterations",
                "multi_token_rollbacks", "k_counts", "attn_dispatches",
                "decode_only_dispatches", "decode_tokens_emitted",
                "bucket_counts", "padded_token_fraction"):
        assert rt[key] == rj[key], key
    assert et.jit_traces == len(et.buckets_used) == len(ej.buckets_used)
    for a, b in zip(wt, wj):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids and a.sampled_ids
