"""Port vs reference for the kernel modules: the plain PyTorch fused MSA
against the JAX oracle and the JAX Pallas kernel (interpret mode), the
host work-list item for item, the per-tile item ranges the CUDA kernel
walks, the page ops, the serving layers, and the weight bridge.

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
                               msa_fused as j_msa_fused,
                               write_kv_pages as j_write_kv_pages)
from repro.models import layers as jlayers
from repro_torch.kernels.msa import (WL_FIELDS, apply_page_copies,
                                     apply_swap_ins, build_worklist,
                                     msa_fused, msa_fused_cuda,
                                     pad_worklist, tile_ranges,
                                     write_kv_pages)
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


def _tile_walk(c, wl, tile_first, *, page, q_tile, window, softcap):
    """The CUDA kernel's algorithm written out in numpy: one program per
    (q tile, q head) walks [tile_first[t], tile_first[t+1]), each item
    touching only its own sequence's rows, with f32 online softmax, and
    writes the whole tile at the end.  Holds the kernel's walk (not its
    arithmetic order) against the plain version on the CPU."""
    T, H, D = c["q"].shape
    KH = c["k_pages"].shape[2]
    out = np.empty_like(c["q"])
    n = c["n"]
    for t in range(len(tile_first) - 1):
        r0 = t * q_tile
        for h in range(H):
            g = h // (H // KH)
            acc = np.zeros((q_tile, D), np.float32)
            m = np.full((q_tile,), NEG_INF, np.float32)
            l = np.zeros((q_tile,), np.float32)
            for w in range(tile_first[t], tile_first[t + 1]):
                s = wl["wl_seq"][w]
                if s >= n:
                    continue
                lo = max(c["q_start"][s], r0)
                hi = min(c["q_start"][s] + c["q_len"][s], r0 + q_tile, T)
                kv = wl["wl_kvbase"][w] + np.arange(page)
                k = c["k_pages"][wl["wl_slot"][w], :, g]
                v = c["v_pages"][wl["wl_slot"][w], :, g]
                for r in range(lo, hi):
                    qp = c["q_pos"][r]
                    ok = (kv <= qp) & (kv < c["ctx"][s])
                    if window > 0:
                        ok &= qp - kv < window
                    sc = k @ (c["q"][r, h] / math.sqrt(D))
                    if softcap > 0:
                        sc = softcap * np.tanh(sc / softcap)
                    sc = np.where(ok, sc, NEG_INF)
                    rr = r - r0
                    m_new = max(m[rr], sc.max())
                    p = np.where(ok, np.exp(sc - m_new), 0.0)
                    alpha = np.exp(m[rr] - m_new)
                    l[rr] = l[rr] * alpha + p.sum()
                    acc[rr] = acc[rr] * alpha + p @ v
                    m[rr] = m_new
            rows = min(q_tile, T - r0)
            out[r0:r0 + rows, h] = (acc / np.maximum(l, 1e-30)[:, None])[:rows]
    return out


@pytest.mark.parametrize("seed,window,softcap,q_tile",
                         [(0, 0, 0.0, 4), (1, 9, 0.0, 8), (2, 0, 20.0, 16)])
def test_kernel_tile_walk_matches_plain(seed, window, softcap, q_tile):
    rng = np.random.RandomState(200 + seed)
    c = _varlen_case(rng, n_pre=2, n_dec=3, page=8, NP=5, P=24, H=4, KH=2,
                     D=16)
    c = _pad_stream(c, c["T"] + q_tile + 1)
    wl, tq, n_tiles = _worklist(c, page=8, q_tile=q_tile)
    wl = pad_worklist(wl, 1 << wl["wl_seq"].shape[0].bit_length(),
                      sentinel_seq=c["n"])
    got = _tile_walk(c, wl, tile_ranges(wl, n_tiles), page=8, q_tile=tq,
                     window=window, softcap=softcap)
    want = _port_plain(c, torch.float32, window, softcap)
    assert np.max(np.abs(got - want)) < 1e-5


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it raises."""
    q = torch.zeros((4, 2, 16))
    pages = torch.zeros((3, 8, 1, 16))
    i32 = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError):
        msa_fused_cuda(q, pages, pages, i32, i32, i32, i32, (i32,) * 6,
                       i32)
    with pytest.raises(ValueError):
        msa_fused(q.to("meta"), pages, pages, None, None, None, None, None)


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

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_keeps_layout_and_values(dtype):
    from repro.configs import get_smoke_config, scaled_config
    from repro.models import init_params as j_init
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import init_params as t_init
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype=dtype)
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
        # same init scale: std within 20% (zeros stay zeros)
        js, ts = float(np.std(arr.astype(np.float32))), float(o.float().std())
        assert abs(js - ts) <= 0.2 * js + 1e-12, (keys, js, ts)


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
    for path in files:
        bad = {m for m in _import_roots(path)
               if m in ("jax", "jaxlib", "repro")}
        assert not bad, (path, bad)
