"""Port vs reference for the kernel modules: the plain PyTorch fused,
prefill and decode MSA against the JAX oracles and the JAX Pallas kernels
(interpret mode), the MSA contract (Eq. 2) on the port's plain prefill,
the host work-list item for item, the work units the fused CUDA kernel
runs (their partition of the work-list, and their cut-and-merge
arithmetic against the plain version), the page ops, the serving layers,
and the weight bridge.

Tolerances are those of ``tests/test_kernels.py``: 1e-5 at float32, 2e-2
at bfloat16 (the two frameworks round bf16 at different places).  Inputs
come from numpy seeds and go through both packages."""
import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.msa import (WL_FIELDS as JWL_FIELDS,
                               apply_page_copies as j_apply_page_copies,
                               apply_swap_ins as j_apply_swap_ins,
                               build_worklist as j_build_worklist,
                               msa_decode as j_msa_decode,
                               msa_fused as j_msa_fused,
                               msa_prefill as j_msa_prefill,
                               write_kv_pages as j_write_kv_pages)
from repro.models import layers as jlayers
from repro_torch.kernels.msa import (UNIT_FIELDS, WL_FIELDS,
                                     apply_page_copies, apply_swap_ins,
                                     build_units, build_worklist,
                                     msa_decode, msa_decode_cuda, msa_fused,
                                     msa_fused_cuda, msa_prefill,
                                     msa_prefill_cuda, pad_worklist,
                                     tile_ranges, write_kv_pages)
from repro_torch.kernels.msa import _build
from repro_torch.kernels.msa.msa_fused import RUN_UNITS, UNIT_PAGES
from repro_torch.kernels.msa.ref import NEG_INF
from repro_torch.models import layers as tlayers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
REPO = os.path.join(os.path.dirname(__file__), "..")


def _varlen_case(rng, *, n_pre, n_dec, page, NP, P, H, KH, D, max_run=14):
    """Random mixed varlen batch (numpy): ragged multi-segment prefill
    runs plus decode rows, flattened into one (T, H, D) stream."""
    n = n_pre + n_dec
    q_lens, q_pos, ctx = [], [], []
    for _ in range(n_pre):
        c = rng.randint(4, NP * page)
        ln = rng.randint(1, min(max_run, c) + 1)
        pos = np.sort(rng.choice(c, size=ln, replace=False))
        pos[-1] = c - 1
        pos = np.unique(pos)
        q_lens.append(len(pos))
        q_pos.append(pos)
        ctx.append(c)
    for _ in range(n_dec):
        c = rng.randint(1, NP * page)
        q_lens.append(1)
        q_pos.append(np.asarray([c - 1]))
        ctx.append(c)
    T = int(np.sum(q_lens))
    q_start = np.concatenate([[0], np.cumsum(q_lens)[:-1]]).astype(np.int32)
    return dict(
        q=rng.standard_normal((T, H, D)).astype(np.float32),
        k_pages=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        v_pages=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        bt=rng.randint(0, P, (n, NP)).astype(np.int32),
        ctx=np.asarray(ctx, np.int32),
        q_pos=np.concatenate(q_pos).astype(np.int32),
        seq_ids=np.repeat(np.arange(n, dtype=np.int32),
                          np.asarray(q_lens, np.int64)),
        valid=np.ones((T,), bool),
        q_start=q_start,
        q_len=np.asarray(q_lens, np.int32),
        n=n, T=T)


def _pad_stream(c, t_bucket):
    """Extend the stream with bucket slack rows (invalid, position 0)."""
    pad = t_bucket - c["T"]
    c = dict(c)
    c["q"] = np.concatenate([c["q"], np.zeros((pad,) + c["q"].shape[1:],
                                              np.float32)])
    for f in ("q_pos", "seq_ids"):
        c[f] = np.concatenate([c[f], np.zeros((pad,), np.int32)])
    c["valid"] = np.concatenate([c["valid"], np.zeros((pad,), bool)])
    c["T"] = t_bucket
    return c


def _worklist(c, *, page, q_tile):
    tq = min(q_tile, c["T"])
    n_tiles = -(-c["T"] // tq)
    wl, _ = build_worklist(c["q_start"], c["q_len"], c["ctx"], c["bt"],
                           c["q_pos"], page=page, q_tile=tq,
                           n_tiles=n_tiles, window=0)
    return wl, tq, n_tiles


def _port_plain(c, dtype, window, softcap):
    tt = lambda a: torch.from_numpy(np.asarray(a))
    return msa_fused(
        tt(c["q"]).to(dtype), tt(c["k_pages"]).to(dtype),
        tt(c["v_pages"]).to(dtype), tt(c["bt"]), tt(c["ctx"]),
        tt(c["q_pos"]), tt(c["seq_ids"]), tt(c["valid"]),
        window=window, softcap=softcap).float().numpy()


def _jax_fused(c, dtype, window, softcap, impl, q_tile=8, page=8):
    kw = {}
    if impl != "xla":
        wl, tq, _ = _worklist(c, page=page, q_tile=q_tile)
        kw = dict(q_start=jnp.asarray(c["q_start"]),
                  q_len=jnp.asarray(c["q_len"]),
                  worklist=tuple(jnp.asarray(wl[f]) for f in JWL_FIELDS),
                  q_tile=tq)
    jd = getattr(jnp, dtype)
    o = j_msa_fused(jnp.asarray(c["q"], jd), jnp.asarray(c["k_pages"], jd),
                    jnp.asarray(c["v_pages"], jd), jnp.asarray(c["bt"]),
                    jnp.asarray(c["ctx"]), jnp.asarray(c["q_pos"]),
                    jnp.asarray(c["seq_ids"]), jnp.asarray(c["valid"]),
                    window=window, softcap=softcap, impl=impl, **kw)
    return np.asarray(o.astype(jnp.float32))


# the tests/test_fused.py:122 sweep: GQA ratios, window, softcap, q tiles
SWEEP = [(0, (4, 2), 0, 0.0, 4), (1, (4, 4), 9, 20.0, 8),
         (2, (8, 1), 9, 20.0, 16)]


@pytest.mark.parametrize("seed,h_kh,window,softcap,q_tile", SWEEP)
def test_plain_msa_fused_matches_jax_kernel_and_oracle(
        seed, h_kh, window, softcap, q_tile):
    rng = np.random.RandomState(seed)
    H, KH = h_kh
    c = _varlen_case(rng, n_pre=rng.randint(1, 4), n_dec=rng.randint(0, 4),
                     page=8, NP=5, P=24, H=H, KH=KH, D=16)
    got = _port_plain(c, torch.float32, window, softcap)
    for impl in ("xla", "pallas_interpret"):
        want = _jax_fused(c, "float32", window, softcap, impl, q_tile)
        assert np.max(np.abs(got - want)) < TOL["float32"], impl


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 20.0)])
def test_plain_msa_fused_bf16_matches_jax(window, softcap):
    rng = np.random.RandomState(11)
    c = _varlen_case(rng, n_pre=2, n_dec=3, page=8, NP=5, P=24, H=4, KH=2,
                     D=16)
    got = _port_plain(c, torch.bfloat16, window, softcap)
    want = _jax_fused(c, "bfloat16", window, softcap, "xla")
    assert np.max(np.abs(got - want)) < TOL["bfloat16"]


def test_plain_msa_fused_zeroes_slack_rows():
    """Bucket slack (invalid rows, whole padding tiles included) comes
    out as exact zeros in the port, as in the JAX Pallas kernel."""
    rng = np.random.RandomState(3)
    c = _varlen_case(rng, n_pre=1, n_dec=2, page=8, NP=5, P=24, H=4, KH=2,
                     D=16)
    real = c["T"]
    c = _pad_stream(c, real + 2 * 8 + 3)     # > 2 wholly-empty tail tiles
    got = _port_plain(c, torch.float32, 0, 0.0)
    assert np.all(got[real:] == 0.0)
    want = _jax_fused(c, "float32", 0, 0.0, "pallas_interpret", q_tile=8)
    assert np.max(np.abs(got - want)) < TOL["float32"]


# ---------------------------------------------------------------------------
# split layout: padded prefill and paged decode
# ---------------------------------------------------------------------------

def _pools(rng, P, page, KH, D):
    return (rng.standard_normal((P, page, KH, D)).astype(np.float32),
            rng.standard_normal((P, page, KH, D)).astype(np.float32))


def _both(dtype, *arrays):
    """The same numpy arrays as JAX arrays and as torch tensors (float
    arrays cast to ``dtype``, index arrays kept int32)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js, ts = [], []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.float32:
            js.append(jnp.asarray(a, jd))
            ts.append(torch.from_numpy(a).to(td))
        else:
            js.append(jnp.asarray(a))
            ts.append(torch.from_numpy(a))
    return js, ts


def _impls(dtype, representative):
    """The JAX sides a case is held to: the xla oracle always, and the
    Pallas kernel (interpret mode, seconds a case) at float32, where the
    comparison sees the algorithm, on a representative case only."""
    if dtype == "float32" and representative:
        return ("xla", "pallas_interpret")
    return ("xla",)


# the JAX side compiled once per shape (its eager oracle compiles op by op)
_j_prefill = jax.jit(j_msa_prefill, static_argnames=(
    "window", "softcap", "q_tile", "impl"))
_j_decode = jax.jit(j_msa_decode, static_argnames=(
    "window", "softcap", "impl"))


def _prefill_case(rng, *, h, kh, d, page, R=2, QP=16, NP=5, P=32):
    """The tests/test_kernels.py:37 case: a two-segment chunk reaching the
    end of a full context and a ragged contiguous one."""
    q = rng.standard_normal((R, QP, h, d)).astype(np.float32)
    kp, vp = _pools(rng, P, page, kh, d)
    bt = rng.randint(0, P, (R, NP)).astype(np.int32)
    ctx = np.asarray([NP * page, 2 * page + 3], np.int32)
    q_pos = np.stack([
        np.concatenate([np.arange(3, 3 + QP // 2),
                        np.arange(NP * page - QP // 2, NP * page)]),
        np.arange(QP)]).astype(np.int32)
    q_lens = np.asarray([QP, QP - 3], np.int32)
    return q, kp, vp, bt, ctx, q_pos, q_lens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 32), (4, 4, 16), (8, 2, 64)])
@pytest.mark.parametrize("page,q_tile", [(8, 8), (16, 4)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 0.0), (0, 30.0)])
def test_plain_msa_prefill_matches_jax(dtype, h, kh, d, page, q_tile, window,
                                       softcap):
    """The tests/test_kernels.py:34 sweep: GQA ratios, pages and q tiles,
    window and softcap, a two-segment chunk and a ragged one; every row,
    padding included.  The Pallas kernel sees the GQA-4 cases with a
    window or a softcap (``_impls``)."""
    rng = np.random.RandomState(h * 100 + d + page)
    args = _prefill_case(rng, h=h, kh=kh, d=d, page=page)
    (jq, jk, jv, *jidx), (tq, tk, tv, *tidx) = _both(dtype, *args)
    kw = dict(window=window, softcap=softcap)
    got = _f32(msa_prefill(tq, tk, tv, *tidx, **kw))
    representative = (h, kh, page) == (8, 2, 16) and (window or softcap)
    for impl in _impls(dtype, representative):
        want = _f32(_j_prefill(jq, jk, jv, *jidx, q_tile=q_tile, impl=impl,
                               **kw))
        assert np.max(np.abs(got - want)) < TOL[dtype], impl
    assert np.all(got[1, args[6][1]:] == 0.0)     # padding rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 32), (8, 8, 16), (8, 1, 64)])
@pytest.mark.parametrize("window", [0, 10])
def test_plain_msa_decode_matches_jax(dtype, h, kh, d, window):
    """The tests/test_kernels.py:63 sweep, with a ctx = 1 row (the serving
    engine's padding decode rows); the Pallas kernel sees the GQA-8
    cases."""
    B, NP, P, page = 3, 6, 24, 8
    rng = np.random.RandomState(h * 10 + d + window)
    q = rng.standard_normal((B, h, d)).astype(np.float32)
    kp, vp = _pools(rng, P, page, kh, d)
    bt = rng.randint(0, P, (B, NP)).astype(np.int32)
    ctx = np.asarray([NP * page, 17, 1], np.int32)
    (jq, jk, jv, jbt, jctx), ts = _both(dtype, q, kp, vp, bt, ctx)
    got = _f32(msa_decode(*ts, window=window))
    for impl in _impls(dtype, kh == 1):
        want = _f32(_j_decode(jq, jk, jv, jbt, jctx, window=window,
                              impl=impl))
        assert np.max(np.abs(got - want)) < TOL[dtype], impl


@pytest.mark.parametrize("window", [0, 12])
def test_plain_msa_prefill_masks_invalid_q_rows(window):
    """The tests/test_fused.py:196 regression: padded rows (past q_lens,
    q_pos 0) neither attend nor move the tile's page range, and come out
    as exact zeros, against the Pallas kernel on every row."""
    rng = np.random.RandomState(21)
    q, kp, vp, bt, ctx, _, _ = _prefill_case(rng, h=4, kh=2, d=32, page=8)
    QP = q.shape[1]
    q_pos = np.stack([
        np.concatenate([np.arange(30, 30 + QP // 2),
                        np.arange(5 * 8 - QP // 2, 5 * 8)]),
        np.arange(QP)]).astype(np.int32)
    q_lens = np.asarray([QP - 6, 3], np.int32)
    q_pos = np.where(np.arange(QP)[None, :] < q_lens[:, None], q_pos, 0)
    js, ts = _both("float32", q, kp, vp, bt, ctx, q_pos, q_lens)
    got = _f32(msa_prefill(*ts, window=window))
    want = _f32(j_msa_prefill(*js, window=window, q_tile=8,
                              impl="pallas_interpret"))
    assert np.max(np.abs(got - want)) < TOL["float32"]
    assert np.all(got[0, QP - 6:] == 0.0) and np.all(got[1, 3:] == 0.0)


@pytest.mark.parametrize("qp,q_tile", [(20, 16), (5, 128), (13, 8)])
def test_plain_msa_prefill_takes_ragged_qp(qp, q_tile):
    """The tests/test_fused.py:229 case: a QP that is no multiple of the
    tile is legal (the Pallas wrapper rounds it up; the port needs no
    round-up) and gives the Pallas kernel's result."""
    R, NP, P, page, H, KH, D = 2, 4, 16, 8, 4, 2, 16
    rng = np.random.RandomState(qp)
    q = rng.standard_normal((R, qp, H, D)).astype(np.float32)
    kp, vp = _pools(rng, P, page, KH, D)
    bt = rng.randint(0, P, (R, NP)).astype(np.int32)
    ctx = np.asarray([NP * page, 2 * page + 1], np.int32)
    q_pos = np.stack([np.arange(qp), np.arange(qp)]).astype(np.int32)
    q_lens = np.asarray([qp, max(1, qp - 2)], np.int32)
    js, ts = _both("float32", q, kp, vp, bt, ctx, q_pos, q_lens)
    got = msa_prefill(*ts)
    want = _f32(j_msa_prefill(*js, q_tile=q_tile, impl="pallas_interpret"))
    assert tuple(got.shape) == want.shape
    assert np.max(np.abs(_f32(got) - want)) < TOL["float32"]


def _paged(rng, k_full, v_full, page, n_pool):
    """Scatter contiguous (S, KH, D) K/V into shuffled pool pages; the
    block table of the one sequence."""
    S, KH, D = k_full.shape
    NP = S // page
    perm = rng.permutation(n_pool)[:NP]
    kp = np.zeros((n_pool, page, KH, D), np.float32)
    vp = np.zeros((n_pool, page, KH, D), np.float32)
    for j in range(NP):
        kp[perm[j]] = k_full[j * page:(j + 1) * page]
        vp[perm[j]] = v_full[j * page:(j + 1) * page]
    return kp, vp, perm[None, :].astype(np.int32)


def test_plain_msa_equals_contiguous_attention():
    """Eq. 2 (tests/test_kernels.py:86): attention over a paged context in
    shuffled pool pages equals causal attention over the contiguous
    sequence (the JAX package's dense flash attention)."""
    S, H, KH, D, page = 48, 4, 2, 32, 8
    rng = np.random.RandomState(0)
    k_full = rng.standard_normal((S, KH, D)).astype(np.float32)
    v_full = rng.standard_normal((S, KH, D)).astype(np.float32)
    q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k_full[None]), jnp.asarray(v_full[None]),
        jnp.asarray(pos), jnp.asarray(pos), chunk_size=16)
    kp, vp, bt = _paged(rng, k_full, v_full, page, 16)
    got = msa_prefill(*map(torch.from_numpy, (
        q, kp, vp, bt, np.asarray([S], np.int32), pos,
        np.asarray([S], np.int32))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n_seg,seed", [(1, 0), (2, 1), (3, 2), (4, 3)])
def test_plain_msa_segment_merge_property(n_seg, seed):
    """Eq. 2 generalised (tests/test_kernels.py:120): q rows whose
    positions form ``n_seg`` separate runs (the gaps a recompute of an
    evicted history leaves) attend exactly as the same positions do over
    the contiguous sequence."""
    rng = np.random.RandomState(seed)
    page, KH, H, D, S = 4, 2, 4, 16, 40
    k_full = rng.standard_normal((S, KH, D)).astype(np.float32)
    v_full = rng.standard_normal((S, KH, D)).astype(np.float32)
    starts = np.sort(rng.choice(np.arange(0, S, 5), n_seg, replace=False))
    idx = np.unique(np.concatenate(
        [np.arange(a, min(S, a + rng.randint(1, 5))) for a in starts]))
    q_pos = idx.astype(np.int32)[None]
    q = rng.standard_normal((1, len(idx), H, D)).astype(np.float32)
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k_full[None]), jnp.asarray(v_full[None]),
        jnp.asarray(q_pos), jnp.arange(S, dtype=jnp.int32)[None],
        chunk_size=8)
    kp, vp, bt = _paged(rng, k_full, v_full, page, S // page + 4)
    got = msa_prefill(*map(torch.from_numpy, (
        q, kp, vp, bt, np.asarray([S], np.int32), q_pos,
        np.asarray([len(idx)], np.int32))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# host work-list and the per-tile ranges the CUDA kernel walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("q_tile,window", [(4, 0), (8, 9), (16, 0)])
def test_worklist_matches_jax_item_for_item(seed, q_tile, window):
    rng = np.random.RandomState(100 + seed)
    c = _varlen_case(rng, n_pre=rng.randint(1, 4), n_dec=rng.randint(0, 5),
                     page=8, NP=6, P=32, H=4, KH=2, D=16)
    c = _pad_stream(c, c["T"] + rng.randint(0, 2 * q_tile))
    tq = min(q_tile, c["T"])
    n_tiles = -(-c["T"] // tq)
    args = (c["q_start"], c["q_len"], c["ctx"], c["bt"], c["q_pos"])
    kw = dict(page=8, q_tile=tq, n_tiles=n_tiles, window=window)
    got, n_got = build_worklist(*args, **kw)
    want, n_want = j_build_worklist(*args, **kw)
    assert n_got == n_want and WL_FIELDS == JWL_FIELDS
    for f in WL_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    w = 1 << int(n_got).bit_length()
    padded = pad_worklist(got, w, sentinel_seq=c["n"])
    wpad, _ = j_build_worklist(*args, **kw, pad_to=w)
    for f in WL_FIELDS:
        np.testing.assert_array_equal(padded[f], wpad[f], err_msg=f)
    tf = tile_ranges(padded, n_tiles)
    assert tf[0] == 0 and tf[-1] == n_got and np.all(np.diff(tf) >= 1)
    for t in range(n_tiles):
        assert np.all(padded["wl_qtile"][tf[t]:tf[t + 1]] == t)


def test_tile_ranges_rejects_a_broken_worklist():
    rng = np.random.RandomState(5)
    c = _varlen_case(rng, n_pre=2, n_dec=2, page=8, NP=5, P=24, H=4, KH=2,
                     D=16)
    wl, _, n_tiles = _worklist(c, page=8, q_tile=4)
    with pytest.raises(ValueError):
        tile_ranges(wl, n_tiles + 1)


def _unit_walk(c, wl, units, *, page, window, softcap):
    """The CUDA kernel's algorithm written out in numpy: each work unit,
    for each kv head, runs the unit's rows times the group's G heads
    through its keys in stages of 32 key slots with f32 online softmax
    (a masked key's p set to 0), and writes the output (a run that was
    not cut), partial k of its rows (the k-th unit of a cut run), or
    exact zeros (a unit of no item); then each cut run's partials are
    merged in unit order.  Holds the decomposition and the cut-and-merge
    arithmetic (not the kernel's summation order) against the plain
    version on the CPU.  Rows nothing writes stay NaN."""
    T, H, D = c["q"].shape
    KH = c["k_pages"].shape[2]
    G = H // KH
    out = np.full((T, H, D), np.nan, np.float32)
    part_o = np.zeros((RUN_UNITS, T, H, D), np.float32)
    part_m = np.zeros((RUN_UNITS, T, H), np.float32)
    part_l = np.zeros((RUN_UNITS, T, H), np.float32)
    stage = max(1, 32 // page) * page if page <= 32 else 32
    n_units, n_merges = units["unit_counts"]
    for u in range(n_units):
        r0, nr = units["u_row0"][u], units["u_rows"][u]
        it0, items = units["u_item0"][u], units["u_items"][u]
        rows = slice(r0, r0 + nr)
        if items == 0:
            out[rows] = 0.0
            continue
        slots = wl["wl_slot"][it0:it0 + items]
        kv = (wl["wl_kvbase"][it0:it0 + items, None]
              + np.arange(page)).reshape(-1)
        qp = c["q_pos"][rows]
        vis = (kv[None] <= qp[:, None]) & (kv[None] < c["ctx"][
            units["u_seq"][u]])
        if window > 0:
            vis &= qp[:, None] - kv[None] < window
        for g in range(KH):
            heads = slice(g * G, (g + 1) * G)
            k = c["k_pages"][slots, :, g].reshape(-1, D)
            v = c["v_pages"][slots, :, g].reshape(-1, D)
            sc = np.einsum("rhd,kd->rhk",
                           c["q"][rows, heads] / np.float32(math.sqrt(D)),
                           k).astype(np.float32)
            if softcap > 0:
                sc = np.float32(softcap) * np.tanh(sc / np.float32(softcap))
            m = np.full((nr, G), NEG_INF, np.float32)
            l = np.zeros((nr, G), np.float32)
            acc = np.zeros((nr, G, D), np.float32)
            for k0 in range(0, kv.shape[0], stage):
                ks = slice(k0, k0 + stage)
                ok = vis[:, None, ks]
                s_ = np.where(ok, sc[:, :, ks], np.float32(NEG_INF))
                m_new = np.maximum(m, s_.max(-1))
                alpha = np.exp(m - m_new)
                p = np.where(ok, np.exp(s_ - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ v[ks]
                m = m_new
            part = units["u_part"][u]
            if part < 0:
                out[rows, heads] = acc / np.maximum(l, 1e-30)[..., None]
            else:
                part_o[part, rows, heads] = acc
                part_m[part, rows, heads] = m
                part_l[part, rows, heads] = l
    for j in range(n_merges):
        r0, nr, nu = (units[f][j] for f in ("mg_row0", "mg_rows",
                                            "mg_units"))
        rows = slice(r0, r0 + nr)
        m = part_m[:nu, rows].max(0)
        w = np.exp(part_m[:nu, rows] - m)
        l = (part_l[:nu, rows] * w).sum(0)
        o = (part_o[:nu, rows] * w[..., None]).sum(0)
        out[rows] = o / np.maximum(l, 1e-30)[..., None]
    return out


def _long_case(rng, *, window=0, page=8, slack=5, q_tile=8):
    """A varlen step whose runs are long enough to be cut into several
    work units (contexts up to ~2.4k keys at page 8), padded with slack
    rows, with its work-list and units."""
    c = _varlen_case(rng, n_pre=2, n_dec=4, page=page, NP=300, P=400,
                     H=4, KH=2, D=16, max_run=20)
    c = _pad_stream(c, c["T"] + slack)
    wl, tq, n_tiles = _worklist(c, page=page, q_tile=q_tile)
    if window:
        wl, _ = build_worklist(c["q_start"], c["q_len"], c["ctx"], c["bt"],
                               c["q_pos"], page=page, q_tile=tq,
                               n_tiles=n_tiles, window=window)
    wl = pad_worklist(wl, 1 << wl["wl_seq"].shape[0].bit_length(),
                      sentinel_seq=c["n"])
    units = build_units(wl, c["q_start"], c["q_len"], n_rows=c["T"],
                        q_tile=tq, n_tiles=n_tiles)
    return c, wl, units, tq, n_tiles


@pytest.mark.parametrize("seed,window,softcap,q_tile",
                         [(0, 0, 0.0, 4), (1, 9, 0.0, 8), (2, 0, 20.0, 16),
                          (3, 300, 0.0, 8), (4, 0, 0.0, 16)])
def test_kernel_tile_walk_matches_plain(seed, window, softcap, q_tile):
    rng = np.random.RandomState(200 + seed)
    if seed < 3:        # short runs: one unit a run, as before
        c = _varlen_case(rng, n_pre=2, n_dec=3, page=8, NP=5, P=24, H=4,
                         KH=2, D=16)
        c = _pad_stream(c, c["T"] + q_tile + 1)
        wl, tq, n_tiles = _worklist(c, page=8, q_tile=q_tile)
        wl = pad_worklist(wl, 1 << wl["wl_seq"].shape[0].bit_length(),
                          sentinel_seq=c["n"])
        units = build_units(wl, c["q_start"], c["q_len"], n_rows=c["T"],
                            q_tile=tq, n_tiles=n_tiles)
    else:               # long runs, cut into several units and merged
        c, wl, units, tq, _ = _long_case(rng, window=window, q_tile=q_tile,
                                         slack=q_tile + 3)
        assert units["unit_counts"][1] > 0, "no run was cut"
    got = _unit_walk(c, wl, units, page=8, window=window, softcap=softcap)
    want = _port_plain(c, torch.float32, window, softcap)
    assert not np.isnan(got).any(), "a row was never written"
    assert np.all(got[~c["valid"]] == 0), "slack rows not exact zeros"
    assert np.max(np.abs(got - want)) < 1e-5


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("q_tile,window,page", [(4, 0, 8), (8, 300, 8),
                                                (16, 0, 16), (8, 0, 32),
                                                (16, 0, 12), (8, 0, 64)])
def test_work_units_partition_the_worklist(seed, q_tile, window, page):
    """Every real item lies in exactly one unit; a unit holds items of one
    (q tile, sequence) run and at most UNIT_PAGES pages (a run of more
    than RUN_UNITS * UNIT_PAGES pages: its pages shared evenly); every
    stream row is written by exactly one run or one zero unit; each cut
    run has one merge; units come in a fixed order; padding units and
    merges have no row."""
    rng = np.random.RandomState(300 + seed)
    c, wl, units, tq, n_tiles = _long_case(rng, window=window, page=page,
                                           q_tile=q_tile,
                                           slack=2 * q_tile + 1)
    n_units, n_merges = units["unit_counts"]
    assert set(units) == set(UNIT_FIELDS)
    real = np.flatnonzero(wl["wl_seq"] < c["n"])
    seen = np.zeros(wl["wl_seq"].shape[0], np.int64)
    run_units, written = {}, np.zeros(c["T"], np.int64)
    for u in range(n_units):
        a, n = units["u_item0"][u], units["u_items"][u]
        r0, nr = units["u_row0"][u], units["u_rows"][u]
        assert 0 < nr <= tq and r0 // tq == (r0 + nr - 1) // tq
        seen[a:a + n] += 1
        if n == 0:                          # rows no item covers
            assert units["u_part"][u] == -1
            written[r0:r0 + nr] += 1
            continue
        s = units["u_seq"][u]
        assert np.all(wl["wl_seq"][a:a + n] == s)
        assert np.all(wl["wl_qtile"][a:a + n] == r0 // tq)
        lo, hi = c["q_start"][s], c["q_start"][s] + c["q_len"][s]
        assert lo <= r0 and r0 + nr <= hi
        run_units.setdefault((r0, nr), []).append(u)
    assert np.array_equal(np.flatnonzero(seen), real)
    assert np.all(seen[real] == 1)
    merges = {(units["mg_row0"][j], units["mg_rows"][j]):
              units["mg_units"][j] for j in range(n_merges)}
    for (r0, nr), us in run_units.items():
        pages = units["u_items"][us].sum()
        limit = max(UNIT_PAGES, -(-pages // RUN_UNITS))
        assert units["u_items"][us].max() <= limit
        assert len(us) == min(RUN_UNITS, -(-pages // UNIT_PAGES))
        written[r0:r0 + nr] += 1
        if len(us) == 1:
            assert units["u_part"][us[0]] == -1
        else:
            assert list(units["u_part"][us]) == list(range(len(us)))
            assert merges.pop((r0, nr)) == len(us)
    assert not merges
    assert np.all(written == 1)
    # the order: units of runs by first item, then zero units by row
    items = units["u_items"][:n_units]
    key = np.where(items > 0, units["u_item0"][:n_units], -1)
    assert np.all(np.diff(key[items > 0]) > 0)
    z = np.flatnonzero(items == 0)
    assert np.all(z >= np.count_nonzero(items)) \
        and np.all(np.diff(units["u_row0"][z]) > 0)
    # a second build gives the same units, and padding only appends
    w = int(n_units) + 5
    padded = build_units(wl, c["q_start"], c["q_len"], n_rows=c["T"],
                         q_tile=tq, n_tiles=n_tiles, pad_to=w)
    for f in UNIT_FIELDS[:6]:
        assert padded[f].shape == (w,)
        np.testing.assert_array_equal(padded[f][:n_units], units[f])
    assert np.all(padded["u_rows"][n_units:] == 0)
    for f in UNIT_FIELDS[6:9]:
        assert padded[f].shape == (w // 2,)
        np.testing.assert_array_equal(padded[f][:n_merges], units[f])
    assert np.all(padded["mg_units"][n_merges:] == 0)
    np.testing.assert_array_equal(padded["unit_counts"],
                                  units["unit_counts"])
    with pytest.raises(ValueError):
        build_units(wl, c["q_start"], c["q_len"], n_rows=c["T"], q_tile=tq,
                    n_tiles=n_tiles, pad_to=int(n_units) - 1)


def test_work_units_of_all_padding_tiles_read_no_page():
    """A step of 5 real rows in a 64-row bucket: the all-padding tiles
    (one sentinel item each in the work-list) become units of no item."""
    rng = np.random.RandomState(9)
    c = _varlen_case(rng, n_pre=1, n_dec=2, page=8, NP=6, P=24, H=4, KH=2,
                     D=16, max_run=3)
    c = _pad_stream(c, 64)
    wl, tq, n_tiles = _worklist(c, page=8, q_tile=16)
    units = build_units(wl, c["q_start"], c["q_len"], n_rows=64, q_tile=tq,
                        n_tiles=n_tiles)
    n_units = units["unit_counts"][0]
    for u in range(n_units):
        if units["u_row0"][u] >= 16:
            assert units["u_items"][u] == 0
    tiles = {units["u_row0"][u] // 16 for u in range(n_units)}
    assert tiles == {0, 1, 2, 3}
    got = _unit_walk(c, wl, units, page=8, window=0, softcap=0.0)
    assert np.all(got[c["valid"].sum():] == 0)


# ---------------------------------------------------------------------------
# the split kernels' pieces (csrc/msa_prefill.cu, csrc/msa_decode.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("np_,piece_pages,want", [
    (0, 32, 1), (1, 32, 1), (32, 32, 1), (33, 32, 2), (128, 32, 4),
    (256, 32, 8), (4096, 32, 8), (5, 1, 5), (5, 2, 3), (256, 64, 4)])
def test_split_piece_count_follows_the_block_table_width(np_, piece_pages,
                                                         want):
    """The pieces a split kernel's grid gives a range come from NP alone:
    ceil(NP / piece_pages), at least 1, at most MAX_PIECES."""
    assert _build.n_pieces(np_, piece_pages) == want


def test_split_scratch_follows_the_piece_count():
    """The partial scratch is (pieces, rows, H, D) f32 and (pieces, rows,
    H, 2), and empty when no range can be cut; a piece needs a page."""
    o, ml = _build.split_scratch(4, 10, 8, 16, torch.device("cpu"))
    assert o.shape == (4, 10, 8, 16) and ml.shape == (4, 10, 8, 2)
    assert o.dtype == ml.dtype == torch.float32
    o, ml = _build.split_scratch(1, 10, 8, 16, torch.device("cpu"))
    assert o.numel() == 0 and ml.numel() == 0
    with pytest.raises(ValueError):
        _build.n_pieces(8, 0)


def _split_walk(q, kp, vp, bt, ctx, q_pos, q_lens, *, window, softcap,
                piece_pages):
    """The split kernels' algorithm written out in numpy: each chunk's q
    tiles of M_ROWS // G rows, each tile's page range from its valid rows
    (window's low edge to min(max q_pos, ctx - 1), by page), the range cut
    into min(n_pieces(NP), ceil(n / piece_pages)) even pieces, each piece
    an f32 online softmax over stages of 32 key slots (a masked key's p
    set to 0), and a cut range's partials merged in piece order; padding
    rows, and every row of a tile that reads no page, exact zeros.  The
    decode kernel is this with one row a chunk at ctx - 1.  Holds the
    decomposition and its arithmetic (not the kernel's summation order)
    against the plain version on the CPU.  Returns the output and the
    number of cut ranges."""
    R, QP, H, D = q.shape
    _, page, KH, _ = kp.shape
    G, NP = H // KH, bt.shape[1]
    tq = max(1, _build.M_ROWS // G)
    most = _build.n_pieces(NP, piece_pages)
    ipp = max(1, 32 // page)
    out = np.full(q.shape, np.nan, np.float32)
    n_cut = 0
    for r in range(R):
        for t0 in range(0, QP, tq):
            nv = int(np.clip(q_lens[r] - t0, 0, min(tq, QP - t0)))
            pos = q_pos[r, t0:t0 + nv].astype(np.int64)
            out[r, t0:t0 + tq] = 0.0
            if nv == 0:
                continue
            last = min(pos.max(), ctx[r] - 1, NP * page - 1)
            first = max(pos.min() - window + 1, 0) if window > 0 else 0
            j0 = first // page
            n_pages = last // page - j0 + 1 if last >= first else 0
            if n_pages <= 0:
                continue
            pieces = min(most, -(-n_pages // piece_pages))
            n_cut += pieces > 1
            qs = q[r, t0:t0 + nv] / np.float32(math.sqrt(D))
            parts = []
            for pc in range(pieces):
                a = j0 + pc * n_pages // pieces
                b = j0 + (pc + 1) * n_pages // pieces
                k = np.repeat(kp[bt[r, a:b]].reshape(-1, KH, D), G, axis=1)
                v = np.repeat(vp[bt[r, a:b]].reshape(-1, KH, D), G, axis=1)
                kv = (np.arange(a, b)[:, None] * page
                      + np.arange(page)).reshape(-1)
                vis = (kv[None] <= pos[:, None]) & (kv[None] < ctx[r])
                if window > 0:
                    vis &= pos[:, None] - kv[None] < window
                sc = np.einsum("rhd,khd->rhk", qs, k).astype(np.float32)
                if softcap > 0:
                    sc = np.float32(softcap) * np.tanh(
                        sc / np.float32(softcap))
                # stages: ipp whole pages, or 32-key pieces of a longer page
                starts = (range(0, len(kv), ipp * page) if page <= 32 else
                          [j + c for j in range(0, len(kv), page)
                           for c in range(0, page, 32)])
                m = np.full((nv, H), NEG_INF, np.float32)
                l = np.zeros((nv, H), np.float32)
                acc = np.zeros((nv, H, D), np.float32)
                for k0 in starts:
                    ks = slice(k0, min(k0 + (ipp * page if page <= 32
                                             else 32), len(kv)))
                    ok = vis[:, None, ks]
                    s_ = np.where(ok, sc[:, :, ks], np.float32(NEG_INF))
                    m_new = np.maximum(m, s_.max(-1))
                    alpha = np.exp(m - m_new)
                    p = np.where(ok, np.exp(s_ - m_new[..., None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + np.einsum(
                        "rhk,khd->rhd", p, v[ks])
                    m = m_new
                parts.append((acc, m, l))
            mm = np.max([m for _, m, _ in parts], axis=0)
            w = [np.exp(m - mm) for _, m, _ in parts]
            o = sum(a * wk[..., None] for (a, _, _), wk in zip(parts, w))
            ll = sum(lk * wk for (_, _, lk), wk in zip(parts, w))
            out[r, t0:t0 + nv] = o / np.maximum(ll, 1e-30)[..., None]
    return out, n_cut


def _split_case(rng, *, G, page, NP=24, P=40, R=3, QP=70, D=16):
    """Three padded chunks (a multi-segment one with a gap reaching the end
    of its context, a ragged one, an all-padding one) and the decode rows
    of the same pools (two padding rows: ctx 1 and ctx 0)."""
    H, KH = 2 * G, 2
    q = rng.standard_normal((R, QP, H, D)).astype(np.float32)
    kp, vp = _pools(rng, P, page, KH, D)
    bt = rng.randint(0, P, (R, NP)).astype(np.int32)
    c0, c1 = NP * page, NP * page - page // 2
    ctx = np.asarray([c0, c1, 5], np.int32)
    q_pos = np.zeros((R, QP), np.int32)
    q_pos[0] = np.concatenate([np.arange(4, 4 + QP // 2),
                               np.arange(c0 - (QP - QP // 2), c0)])
    q_pos[1, :QP - 9] = np.arange(c1 - (QP - 9), c1)
    q_lens = np.asarray([QP, QP - 9, 0], np.int32)
    B = 6
    dec = (rng.standard_normal((B, H, D)).astype(np.float32),
           rng.randint(0, P, (B, NP)).astype(np.int32),
           np.asarray([NP * page, 3 * page + 1, 17 * page - 3, 40, 1, 0],
                      np.int32))
    return (q, kp, vp, bt, ctx, q_pos, q_lens), dec


@pytest.mark.parametrize("G,page,piece_pages,window,softcap", [
    (1, 8, 3, 0, 0.0), (2, 16, 2, 0, 30.0), (4, 8, 1, 20, 0.0),
    (4, 16, 32, 0, 0.0), (8, 8, 4, 37, 20.0), (8, 64, 1, 0, 0.0),
    (4, 64, 1, 100, 0.0)])
def test_split_piece_walk_matches_plain(G, page, piece_pages, window,
                                        softcap):
    """The split kernels' decomposition and cut-and-merge arithmetic
    (``_split_walk``) against the plain prefill and decode versions, GQA
    groups of 1-8 heads, pages shorter and longer than a stage, a window
    whose first visible key lies in a later piece; padding rows exact
    zeros.  Every prefill case but the uncut one (piece_pages 32) cuts a
    range, and so does every decode case without a window."""
    rng = np.random.RandomState(G * 10 + page + piece_pages)
    pre, (qd, btd, ctxd) = _split_case(rng, G=G, page=page)
    kw = dict(window=window, softcap=softcap)
    tt = [torch.from_numpy(a) for a in pre]
    want = msa_prefill(*tt, **kw).numpy()
    got, n_cut = _split_walk(*pre, piece_pages=piece_pages, **kw)
    assert (n_cut > 0) == (piece_pages < 24)
    assert np.max(np.abs(got - want)) < TOL["float32"]
    q_lens = pre[6]
    assert np.all(got[0, q_lens[0]:] == 0) and np.all(got[1, q_lens[1]:] == 0)
    assert np.all(got[2] == 0)

    kp, vp = pre[1], pre[2]
    want = msa_decode(*(torch.from_numpy(a) for a in (qd, kp, vp, btd,
                                                      ctxd)), **kw).numpy()
    dec_pos = (ctxd - 1)[:, None]
    got, n_cut = _split_walk(qd[:, None], kp, vp, btd, ctxd, dec_pos,
                             np.ones(len(ctxd), np.int32),
                             piece_pages=piece_pages, **kw)
    assert n_cut > 0 or piece_pages >= 24 or window
    assert np.max(np.abs(got[:, 0] - want)) < TOL["float32"]
    assert np.all(got[-1] == 0)                  # ctx 0: no key at all


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: they raise."""
    q = torch.zeros((4, 2, 16))
    pages = torch.zeros((3, 8, 1, 16))
    i32 = torch.zeros((1,), dtype=torch.int32)
    bt = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        msa_fused_cuda(q, pages, pages, i32, i32, (i32,) * 6, (i32,) * 10)
    with pytest.raises(ValueError):
        msa_fused(q.to("meta"), pages, pages, None, None, None, None, None)
    with pytest.raises(ValueError):
        msa_prefill_cuda(q[None], pages, pages, bt, i32, i32[None], i32)
    with pytest.raises(ValueError):
        msa_decode_cuda(q, pages, pages, bt, i32)
    with pytest.raises(ValueError):
        msa_prefill(q[None].to("meta"), pages, pages, bt, i32, i32, i32)
    with pytest.raises(ValueError):
        msa_decode(q.to("meta"), pages, pages, bt, i32)


# ---------------------------------------------------------------------------
# page ops: in place in the port, functional in JAX
# ---------------------------------------------------------------------------

def test_write_kv_pages_matches_jax():
    rng = np.random.RandomState(7)
    P, page, KH, D, T = 6, 8, 2, 16, 12
    kp = rng.standard_normal((P, page, KH, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KH, D)).astype(np.float32)
    flat = rng.choice(P * page, T, replace=False)
    slot, off = (flat // page).astype(np.int32), (flat % page).astype(np.int32)
    valid = rng.rand(T) < 0.7
    kn = rng.standard_normal((T, KH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KH, D)).astype(np.float32)
    jk, jv = j_write_kv_pages(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(slot), jnp.asarray(off),
                              jnp.asarray(valid))
    # the port's pools carry one extra drop page for the padding rows
    drop = np.zeros((1, page, KH, D), np.float32)
    tk = torch.from_numpy(np.concatenate([kp, drop]))
    tv = torch.from_numpy(np.concatenate([vp, drop]))
    write_kv_pages(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                   torch.from_numpy(slot), torch.from_numpy(off),
                   torch.from_numpy(valid))
    np.testing.assert_array_equal(tk[:P].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:P].numpy(), np.asarray(jv))


def test_page_copies_and_swap_ins_match_jax():
    rng = np.random.RandomState(8)
    L, P, page, KH, D, S = 2, 8, 4, 2, 8, 3
    k = rng.standard_normal((L, P, page, KH, D)).astype(np.float32)
    v = rng.standard_normal((L, P, page, KH, D)).astype(np.float32)
    swap_k = rng.standard_normal((L, S, page, KH, D)).astype(np.float32)
    swap_v = rng.standard_normal((L, S, page, KH, D)).astype(np.float32)
    k_dst = np.asarray([5, P, P], np.int32)      # P = padding
    v_dst = np.asarray([5, 6, P], np.int32)
    src = np.asarray([1, 2, 2], np.int32)        # padding repeats the last
    dst = np.asarray([3, 4, 4], np.int32)
    jk, jv = j_apply_swap_ins(*map(jnp.asarray, (k, v, k_dst, v_dst,
                                                 swap_k, swap_v)))
    jk, jv = j_apply_page_copies(jk, jv, jnp.asarray(src), jnp.asarray(dst))
    drop = np.zeros((L, 1, page, KH, D), np.float32)
    tk = torch.from_numpy(np.concatenate([k, drop], axis=1))
    tv = torch.from_numpy(np.concatenate([v, drop], axis=1))
    apply_swap_ins(tk, tv, *map(torch.from_numpy, (k_dst, v_dst, swap_k,
                                                   swap_v)))
    apply_page_copies(tk, tv, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:, :P].numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# serving layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = np.random.RandomState(9)
    T, H, hd, d, f = 7, 4, 16, 32, 48
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    qh = rng.standard_normal((T, H, hd)).astype(np.float32)
    pos = rng.randint(0, 5000, (T,)).astype(np.int32)
    w1, w3 = (rng.standard_normal((2, d, f)) / math.sqrt(d)).astype(
        np.float32)
    w2 = (rng.standard_normal((f, d)) / math.sqrt(f)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, jd)
    Tt = lambda a: torch.from_numpy(a).to(td)
    cases = [
        (jlayers.rms_norm(J(x), J(w), 1e-5),
         tlayers.rms_norm(Tt(x), Tt(w), 1e-5)),
        (jlayers.apply_rope(J(qh), jnp.asarray(pos), 500_000.0),
         tlayers.apply_rope(Tt(qh), torch.from_numpy(pos), 500_000.0)),
        (jlayers.swiglu_mlp(J(x), J(w1), J(w3), J(w2)),
         tlayers.swiglu_mlp(Tt(x), Tt(w1), Tt(w3), Tt(w2))),
    ]
    for want, got in cases:
        want = np.asarray(want.astype(jnp.float32))
        scale = max(1.0, float(np.max(np.abs(want))))
        err = np.max(np.abs(got.float().numpy() - want)) / scale
        assert err < TOL[dtype], err


# ---------------------------------------------------------------------------
# weight bridge and package boundary
# ---------------------------------------------------------------------------

BRIDGE_ARCHS = ("kimi-k2-1t-a32b", "grok-1-314b", "chatglm3-6b",
                "minitron-8b", "granite-3-8b", "gemma3-12b", "mamba2-780m",
                "llava-next-34b", "hymba-1.5b", "whisper-large-v3",
                "llama31-8b", "llama31-70b")


@pytest.mark.parametrize("arch", BRIDGE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_keeps_layout_and_values(dtype, arch):
    """The JAX package's parameters cross the bridge bit for bit, and the
    port's own ``init_params`` builds the same tree (every family's keys,
    shapes, dtypes) at the same init scales: std within 20%, or within
    five standard errors of a sample std (std / sqrt(2n)) for the small
    tensors (the SSM's per-head ``A_log``, ``D``, ``dt_bias``), where two
    draws of a few dozen values differ by more than 20% by chance."""
    from repro.configs import get_smoke_config, scaled_config
    from repro.models import init_params as j_init
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import init_params as t_init
    cfg = scaled_config(get_smoke_config(arch), dtype=dtype)
    jp = jax.tree.map(np.asarray, j_init(cfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, device="cpu")
    own = t_init(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in own.values())
    for path, arr in flat_j:
        keys = [p.key for p in path]
        t = tp
        o = own
        for key in keys:
            t, o = t[key], o[key]
        assert t.dtype == getattr(torch, dtype) == o.dtype
        assert tuple(t.shape) == arr.shape == tuple(o.shape)
        np.testing.assert_array_equal(
            t.float().numpy(), arr.astype(np.float32))
        # same init scale (zeros stay zeros)
        js, ts = float(np.std(arr.astype(np.float32))), float(o.float().std())
        tol = max(0.2, 5.0 / math.sqrt(2.0 * arr.size))
        assert abs(js - ts) <= tol * js + 1e-12, (keys, js, ts)


@pytest.mark.parametrize("arch", BRIDGE_ARCHS)
def test_param_axes_match_the_jax_package(arch):
    """Every family's parameters carry the reference's logical axes."""
    from repro.configs import get_smoke_config
    from repro.models.model import param_axes as j_param_axes
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.distributed import param_axes
    assert param_axes(t_smoke(arch)) == j_param_axes(get_smoke_config(arch))


def _import_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    assert any(os.path.basename(os.path.dirname(f)) == "examples"
               for f in files)
    for path in files:
        bad = {m for m in _import_roots(path)
               if m in ("jax", "jaxlib", "repro", "benchmarks")}
        assert not bad, (path, bad)
