"""The port on an NVIDIA card: the hand-written MSA kernels against their
plain PyTorch versions on the same inputs, and the whole engine on the
card against the same engine on the CPU, in the fused and the split
layout.  The fused kernel runs over the shapes of the JAX package's
kernel sweep (``tests/test_fused.py``: page 8, head_dim 16, q tiles
4/8/16, GQA ratios, window, softcap, bucket slack), then with contexts
up to 4096 keys, so that runs are cut into work units and merged (head
dims 16-256, pages 8-64, GQA groups of 1-8 heads, a window whose first
visible key lies in a later unit), each case launched twice for the
same bits; the prefill and
decode kernels over those of ``tests/test_kernels.py`` (GQA ratios, head
dims 16-64, pages 8/16, window, softcap, ragged chunks, a ctx 1 row),
then at head dims 64/128/256 and pages 8/16/32 with all-padding chunks
and padding decode rows (ctx 1, slot 0) as the serving engine makes
them, then with contexts of more than 32 pages, so that page ranges are
cut into pieces and merged (head dims 16-256, pages 8-64, GQA groups of
1-8 heads, a window whose first visible key lies in a later piece), each
at the wrapper's piece size (launched twice for the same bits) and at a
smaller one.  Last, the MoE engine (Grok-1 smoke) on the card against
the CPU, quantized offload on the card against its full-precision-
payload control arm, and the full model (forward, banded forward and
teacher-forced decode of the SSM, hybrid, encoder-decoder and
local/global smoke models) on the card against the CPU, a train step of
the Llama, Grok-1 (Adafactor) and Mamba-2 smoke models on the card
against the CPU, a checkpoint resume on the card that continues with
the same bits, and the sharded full model's pieces (the sequence-sharded
decode attention and the all-to-all MoE) with every shard of a mesh on
the card against the same mesh on the CPU.

Marked ``cuda``; each test skips without a card.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Imports no JAX,
so it runs where only PyTorch is installed.

Tolerances are those of ``tests/test_kernels.py``: 1e-5 at float32 (the
kernel and the plain version both accumulate in float32 and differ only
in summation order), 2e-2 at bfloat16 (both round the same float32
result to bf16 once)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.msa import (UNIT_FIELDS, WL_FIELDS, _build,
                                     build_units, build_worklist, msa_decode,
                                     msa_decode_cuda, msa_fused,
                                     msa_fused_cuda, msa_prefill,
                                     msa_prefill_cuda, pad_worklist)
from repro_torch.kernels.msa.ref import (msa_decode_ref, msa_fused_ref,
                                         msa_prefill_ref)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _step(rng, runs, ctx, *, page, P, H, KH, D, slack, q_tile, window=0):
    """A varlen step (numpy) from per-sequence position runs and contexts,
    then ``slack`` padding rows; block tables draw from a pool of P pages;
    its work-list (built with ``window``) and work units (padded)."""
    n = len(runs)
    NP = max(-(-int(c) // page) for c in ctx)
    q_len = np.asarray([len(r) for r in runs], np.int32)
    real = int(q_len.sum())
    T = real + slack
    q_pos = np.zeros((T,), np.int32)
    q_pos[:real] = np.concatenate(runs)
    seq_ids = np.zeros((T,), np.int32)
    seq_ids[:real] = np.repeat(np.arange(n), q_len)
    valid = np.arange(T) < real
    q_start = np.concatenate([[0], np.cumsum(q_len)[:-1]]).astype(np.int32)
    bt = rng.integers(0, P, (n, NP)).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    tq = min(q_tile, T)
    n_tiles = -(-T // tq)
    wl, count = build_worklist(q_start, q_len, ctx, bt, q_pos, page=page,
                               q_tile=tq, n_tiles=n_tiles, window=window)
    wl = pad_worklist(wl, 1 << count.bit_length(), sentinel_seq=n)
    units = build_units(wl, q_start, q_len, n_rows=T, q_tile=tq,
                        n_tiles=n_tiles, pad_to=2 * count + n_tiles)
    return dict(
        q=rng.standard_normal((T, H, D)).astype(np.float32),
        k=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        v=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        bt=bt, ctx=ctx, q_pos=q_pos, seq_ids=seq_ids, valid=valid,
        wl=wl, units=units, q_tile=tq, real=real, q_start=q_start,
        q_len=q_len)


def _case(rng, *, n_pre, n_dec, page, NP, P, H, KH, D, slack, q_tile,
          max_run=14, min_ctx=1):
    """Random mixed varlen step: multi-segment prefill runs (at most
    ``max_run`` positions each, the last at ctx - 1), decode rows, then
    ``slack`` padding rows; contexts of ``min_ctx`` to NP * page keys."""
    runs, ctx = [], []
    for _ in range(n_pre):
        c = int(rng.integers(max(4, min_ctx), NP * page))
        pos = np.unique(np.append(
            rng.choice(c, size=int(rng.integers(1, min(max_run, c) + 1)),
                       replace=False), c - 1))
        runs.append(pos)
        ctx.append(c)
    for _ in range(n_dec):
        c = int(rng.integers(min_ctx, NP * page))
        runs.append(np.asarray([c - 1]))
        ctx.append(c)
    return _step(rng, runs, ctx, page=page, P=P, H=H, KH=KH, D=D,
                 slack=slack, q_tile=q_tile)


def _kernel_vs_plain(c, dtype, dev, *, window, softcap):
    """Kernel vs plain version on the card: slack rows exact zeros, and
    the same bits on a second launch."""
    t = {k: torch.from_numpy(np.asarray(c[k])).to(dev)
         for k in ("bt", "ctx", "q_pos", "seq_ids", "valid")}
    q, kp, vp = (torch.from_numpy(c[k]).to(dev, dtype)
                 for k in ("q", "k", "v"))
    wl = tuple(torch.from_numpy(c["wl"][f]).to(dev) for f in WL_FIELDS)
    units = tuple(torch.from_numpy(c["units"][f]).to(dev)
                  for f in UNIT_FIELDS)
    before = msa_fused_cuda.launches

    def kernel():
        return msa_fused(q, kp, vp, t["bt"], t["ctx"], t["q_pos"],
                         t["seq_ids"], t["valid"], worklist=wl, units=units,
                         q_tile=c["q_tile"], window=window, softcap=softcap)

    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert msa_fused_cuda.launches == before + 2
    assert torch.equal(got, again), "two launches disagree"
    want = msa_fused_ref(q, kp, vp, t["bt"], t["ctx"], t["q_pos"],
                         t["seq_ids"], t["valid"], window=window,
                         softcap=softcap)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.all(got[c["real"]:] == 0), "slack rows not exact zeros"
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h_kh", [(4, 2), (4, 4), (8, 1)],
                         ids=["gqa2", "mha", "mqa"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 0.0), (0, 20.0),
                                            (9, 20.0)])
@pytest.mark.parametrize("q_tile", [4, 8, 16])
def test_kernel_matches_plain_on_card(dev, dtype, h_kh, window, softcap,
                                      q_tile):
    rng = np.random.default_rng(q_tile * 100 + window + int(softcap))
    H, KH = h_kh
    c = _case(rng, n_pre=int(rng.integers(1, 4)),
              n_dec=int(rng.integers(0, 5)),
              page=8, NP=5, P=24, H=H, KH=KH, D=16,
              slack=2 * q_tile + 3, q_tile=q_tile)
    err = _kernel_vs_plain(c, dtype, dev, window=window, softcap=softcap)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D,page,q_tile", [(128, 16, 128), (64, 16, 32),
                                           (256, 8, 16), (80, 32, 64)])
def test_kernel_head_dims_and_pages_on_card(dev, dtype, D, page, q_tile):
    """The lane layouts of every head-dim class (D <= 64, <= 128, <= 256,
    and one not a multiple of 64) and pages longer than one chunk of
    scored keys."""
    rng = np.random.default_rng(D + page)
    c = _case(rng, n_pre=3, n_dec=12, page=page, NP=12, P=64, H=8, KH=2,
              D=D, slack=q_tile + 5, q_tile=q_tile)
    err = _kernel_vs_plain(c, dtype, dev, window=0, softcap=0.0)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("page", [8, 12, 16, 32, 64])
def test_kernel_long_runs_head_dims_and_pages_on_card(dev, dtype, D, page):
    """Contexts of 2049 to 4096 keys, so that every run is longer than a
    unit (32 pages: 2048 keys at page 64) and is cut into several work
    units and merged, at every head-dim class (16 and 80 padded in shared
    memory), pages 8/16/32, a page that leaves stage slots empty (12) and
    one longer than a stage (64); a softcap on the f32 cases."""
    rng = np.random.default_rng(7 * D + page)
    c = _case(rng, n_pre=2, n_dec=6, page=page, NP=4096 // page, P=96,
              H=8, KH=2, D=D, slack=21, q_tile=16, max_run=40,
              min_ctx=2049)
    assert c["units"]["unit_counts"][1] > 0, "no run was cut"
    softcap = 30.0 if dtype == torch.float32 else 0.0
    err = _kernel_vs_plain(c, dtype, dev, window=0, softcap=softcap)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["decode_only", "mixed"])
def test_kernel_long_contexts_and_gqa_groups_on_card(dev, dtype, G, kind):
    """Llama-3.1-8B's head dim and page (128, 16) with contexts of 64 to
    4096 keys: a decode-only step (16 rows) and a mixed one (two
    multi-segment chunks of up to 80 rows and 8 decode rows), at GQA
    groups of 1, 2, 4 and 8 heads (M rows of a unit: rows x G)."""
    rng = np.random.default_rng(G * 10 + len(kind))
    runs, ctx = [], []
    if kind == "mixed":
        for c in rng.integers(1024, 4097, 2):
            c = int(c)
            runs.append(np.concatenate([np.arange(100, 140),
                                        np.arange(c - 40, c)]))
            ctx.append(c)
    for c in rng.integers(64, 4097, 16 if kind == "decode_only" else 8):
        runs.append(np.asarray([c - 1]))
        ctx.append(int(c))
    c = _step(rng, runs, ctx, page=16, P=300, H=2 * G, KH=2, D=128,
              slack=11, q_tile=16)
    assert c["units"]["unit_counts"][1] > 0, "no run was cut"
    err = _kernel_vs_plain(c, dtype, dev, window=0, softcap=0.0)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("wl_window", [0, 64], ids=["full_wl", "window_wl"])
def test_kernel_first_visible_key_in_a_later_unit_on_card(dev, dtype,
                                                          wl_window):
    """A window of 64 and a chunk with a gap: the rows at 3000-3010 see
    only keys 2937-3010, so every unit before the last of their run is
    masked for them (m stays NEG_INF, l 0, and the merge must not turn
    that into garbage); the rows at 5-8 see keys 0-8 only, so the later
    units are masked for them.  The work-list is built without the window
    (as the serving engine builds it) and with it."""
    rng = np.random.default_rng(11)
    runs = [np.concatenate([np.arange(5, 9), np.arange(3000, 3011)]),
            np.asarray([2047]), np.asarray([40])]
    c = _step(rng, runs, [3011, 2048, 41], page=16, P=200, H=8, KH=2,
              D=128, slack=9, q_tile=16, window=wl_window)
    assert c["units"]["unit_counts"][1] > 0, "no run was cut"
    err = _kernel_vs_plain(c, dtype, dev, window=64, softcap=0.0)
    assert err <= TOL[dtype], err


# ---------------------------------------------------------------------------
# the split layout's kernels
# ---------------------------------------------------------------------------

def _to(dev, dtype, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev, dtype)
            if np.asarray(a).dtype == np.float32
            else torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


def _prefill_vs_plain(dev, dtype, q, kp, vp, bt, ctx, q_pos, q_lens, *,
                      window=0, softcap=0.0, piece_pages=2):
    """Kernel vs plain version on the card, at the wrapper's piece size
    (the same bits on a second launch) and at ``piece_pages``; padding
    rows exact zeros.  The larger of the two errors."""
    args = _to(dev, dtype, q, kp, vp, bt, ctx, q_pos, q_lens)
    kw = dict(window=window, softcap=softcap)
    before = msa_prefill_cuda.launches
    got = msa_prefill(*args, **kw)          # the wrapper's piece size
    again = msa_prefill(*args, **kw)
    other = msa_prefill_cuda(*args, piece_pages=piece_pages, **kw)
    torch.cuda.synchronize()
    assert msa_prefill_cuda.launches == before + 3
    assert torch.equal(got, again), "two launches disagree"
    want = msa_prefill_ref(*args, **kw)
    pad = torch.arange(q.shape[1], device=dev)[None, :] \
        >= args[6][:, None]
    err = 0.0
    for out in (got, other):
        assert out.dtype == dtype and out.shape == want.shape
        assert torch.all(out[pad] == 0), "padding rows not exact zeros"
        err = max(err, float((out.float() - want.float()).abs().max()))
    return err


def _decode_vs_plain(dev, dtype, q, kp, vp, bt, ctx, *, window=0,
                     softcap=0.0, piece_pages=2):
    """As ``_prefill_vs_plain``, for the decode kernel."""
    args = _to(dev, dtype, q, kp, vp, bt, ctx)
    kw = dict(window=window, softcap=softcap)
    before = msa_decode_cuda.launches
    got = msa_decode(*args, **kw)
    again = msa_decode(*args, **kw)
    other = msa_decode_cuda(*args, piece_pages=piece_pages, **kw)
    torch.cuda.synchronize()
    assert msa_decode_cuda.launches == before + 3
    assert torch.equal(got, again), "two launches disagree"
    want = msa_decode_ref(*args, **kw)
    err = 0.0
    for out in (got, other):
        assert out.dtype == dtype and out.shape == want.shape
        err = max(err, float((out.float() - want.float()).abs().max()))
    return err


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 32), (4, 4, 16), (8, 2, 64)])
@pytest.mark.parametrize("page,piece_pages", [(8, 1), (16, 2)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (12, 0.0), (0, 30.0)])
def test_prefill_kernel_matches_plain_on_card(dev, dtype, h, kh, d, page,
                                              piece_pages, window, softcap):
    """The tests/test_kernels.py:34 sweep: a two-segment chunk reaching
    the end of a full context and a ragged contiguous one; its 5-page
    ranges also cut into pieces of ``piece_pages`` pages."""
    rng = np.random.default_rng(h * 100 + d + page)
    R, QP, NP, P = 2, 16, 5, 32
    q_pos = np.stack([
        np.concatenate([np.arange(3, 3 + QP // 2),
                        np.arange(NP * page - QP // 2, NP * page)]),
        np.arange(QP)]).astype(np.int32)
    err = _prefill_vs_plain(
        dev, dtype, _f32(rng, R, QP, h, d), _f32(rng, P, page, kh, d),
        _f32(rng, P, page, kh, d),
        rng.integers(0, P, (R, NP)).astype(np.int32),
        np.asarray([NP * page, 2 * page + 3], np.int32), q_pos,
        np.asarray([QP, QP - 3], np.int32), window=window, softcap=softcap,
        piece_pages=piece_pages)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 32), (8, 8, 16), (8, 1, 64)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (10, 0.0), (0, 30.0)])
def test_decode_kernel_matches_plain_on_card(dev, dtype, h, kh, d, window,
                                             softcap):
    """The tests/test_kernels.py:63 sweep, with a ctx 1 row."""
    rng = np.random.default_rng(h * 10 + d + window)
    B, NP, P, page = 3, 6, 24, 8
    err = _decode_vs_plain(
        dev, dtype, _f32(rng, B, h, d), _f32(rng, P, page, kh, d),
        _f32(rng, P, page, kh, d),
        rng.integers(0, P, (B, NP)).astype(np.int32),
        np.asarray([NP * page, 17, 1], np.int32), window=window,
        softcap=softcap)
    assert err <= TOL[dtype], err


def _serving_split_case(rng, *, R, QP, B, n_dec, H, KH, D, page, NP):
    """A split step as the engine builds it, at larger shapes: multi-segment
    chunks on disjoint shuffled pages (one ragged, one all padding with
    q_lens 0), then n_dec decode rows and B - n_dec padding decode rows
    (ctx 1, an all-zero block table)."""
    ctxs = rng.integers(QP, NP * page + 1, R + n_dec)
    n_pages = -(-ctxs // page)
    P = int(n_pages.sum()) + 1
    perm = rng.permutation(P)
    tables = np.zeros((R + n_dec, NP), np.int32)
    off = 0
    for s, k in enumerate(n_pages):
        tables[s, :k] = perm[off:off + k]
        off += k
    q_pos = np.zeros((R, QP), np.int32)
    q_lens = np.full((R,), QP, np.int32)
    q_lens[1] = QP // 2 + 3
    q_lens[2] = 0
    for r in range(R):
        c = int(ctxs[r])
        # two segments: a recompute of an evicted stretch and the tail
        n = int(q_lens[r])
        a = rng.integers(0, max(1, c - QP))
        head = n // 3
        pos = np.concatenate([np.arange(a, a + head),
                              np.arange(c - (n - head), c)])
        q_pos[r, :n] = np.unique(pos)[:n] if n else pos
    bt_dec = np.zeros((B, NP), np.int32)
    bt_dec[:n_dec] = tables[R:]
    ctx_dec = np.ones((B,), np.int32)
    ctx_dec[:n_dec] = ctxs[R:]
    return dict(
        pre=(_f32(rng, R, QP, H, D), _f32(rng, P, page, KH, D),
             _f32(rng, P, page, KH, D), tables[:R],
             ctxs[:R].astype(np.int32), q_pos, q_lens),
        dec=(_f32(rng, B, H, D), bt_dec, ctx_dec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("page", [8, 16, 32])
def test_split_kernels_head_dims_and_pages_on_card(dev, dtype, D, page):
    """Both split kernels at the serving engine's layout: head dims 64,
    128, 256 (every lane layout), pages 8/16/32, Llama's GQA ratio, an
    all-padding chunk and padding decode rows, a window and a softcap."""
    rng = np.random.default_rng(D + page)
    c = _serving_split_case(rng, R=4, QP=48, B=24, n_dec=13, H=8, KH=2, D=D,
                            page=page, NP=256 // page)
    q, kp, vp = c["pre"][:3]
    for window, softcap in ((0, 0.0), (40, 0.0), (0, 30.0)):
        err = _prefill_vs_plain(dev, dtype, *c["pre"], window=window,
                                softcap=softcap)
        assert err <= TOL[dtype], (window, softcap, err)
        qd, bt_dec, ctx_dec = c["dec"]
        err = _decode_vs_plain(dev, dtype, qd, kp, vp, bt_dec, ctx_dec,
                               window=window, softcap=softcap)
        assert err <= TOL[dtype], (window, softcap, err)


def test_prefill_kernel_all_padding_reads_nothing_and_writes_zeros(dev):
    """A decode-only step's prefill dispatch: every chunk is padding
    (q_lens 0, block tables pointing far outside the pool).  The kernel
    reads no page (an out-of-pool slot would fault) and writes exact
    zeros."""
    rng = np.random.default_rng(7)
    R, QP, H, KH, D, page, NP = 4, 128, 32, 8, 128, 16, 256
    q = torch.from_numpy(_f32(rng, R, QP, H, D)).to(dev, torch.bfloat16)
    kp = torch.zeros((2, page, KH, D), dtype=torch.bfloat16, device=dev)
    bt = torch.full((R, NP), 1 << 30, dtype=torch.int32, device=dev)
    ctx = torch.full((R,), 4096, dtype=torch.int32, device=dev)
    q_pos = torch.zeros((R, QP), dtype=torch.int32, device=dev)
    q_lens = torch.zeros((R,), dtype=torch.int32, device=dev)
    out = msa_prefill_cuda(q, kp, kp, bt, ctx, q_pos, q_lens)
    torch.cuda.synchronize()
    assert torch.all(out == 0)


def _long_split_case(rng, *, H, KH, D, page, P, ctx_pre, ctx_dec, QP=40):
    """Chunks and decode rows with contexts of more than PIECE_PAGES pages,
    so that the wrapper's pieces cut their ranges: a multi-segment chunk
    (rows at 5-9, then the last 30 positions), a ragged contiguous one at
    the end of its context, an all-padding one; decode rows at those
    contexts, then a padding row (ctx 1, slot 0).  Block tables draw from
    a pool of P pages."""
    ctx_pre = np.asarray(ctx_pre, np.int32)
    ctx_dec = np.asarray(list(ctx_dec) + [1], np.int32)
    NP = -(-int(max(ctx_pre.max(), ctx_dec.max())) // page)
    assert (max(ctx_pre.max(), ctx_dec.max()) - 1) // page + 1 \
        > _build.PIECE_PAGES, "no range is cut"
    R = len(ctx_pre) + 1
    q_pos = np.zeros((R, QP), np.int32)
    q_lens = np.zeros((R,), np.int32)
    for r, c in enumerate(ctx_pre):
        pos = (np.concatenate([np.arange(5, 10), np.arange(c - 30, c)])
               if r == 0 else np.arange(c - QP + 7, c))
        q_pos[r, :len(pos)] = pos
        q_lens[r] = len(pos)
    ctx = np.append(ctx_pre, 2048).astype(np.int32)   # the padding chunk
    bt_dec = rng.integers(0, P, (len(ctx_dec), NP)).astype(np.int32)
    bt_dec[-1] = 0
    return dict(
        pre=(_f32(rng, R, QP, H, D), _f32(rng, P, page, KH, D),
             _f32(rng, P, page, KH, D),
             rng.integers(0, P, (R, NP)).astype(np.int32), ctx, q_pos,
             q_lens),
        dec=(_f32(rng, len(ctx_dec), H, D), bt_dec, ctx_dec))


def _both_split(dev, dtype, c, *, window=0, softcap=0.0, piece_pages=3):
    q, kp, vp = c["pre"][:3]
    err = _prefill_vs_plain(dev, dtype, *c["pre"], window=window,
                            softcap=softcap, piece_pages=piece_pages)
    assert err <= TOL[dtype], ("prefill", err)
    qd, bt_dec, ctx_dec = c["dec"]
    err = _decode_vs_plain(dev, dtype, qd, kp, vp, bt_dec, ctx_dec,
                           window=window, softcap=softcap,
                           piece_pages=piece_pages)
    assert err <= TOL[dtype], ("decode", err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("page", [8, 12, 16, 32, 64])
def test_split_kernels_long_ranges_cut_into_pieces_on_card(dev, dtype, D,
                                                           page):
    """Both split kernels with contexts of 33 pages to 4096 keys, so that
    the wrapper's pieces (32 pages) cut the long ranges and the merge runs,
    at every head-dim class (16 and 80 padded in shared memory), pages
    8/16/32, a page that leaves stage slots empty (12) and one longer than
    a stage (64); a softcap on the f32 cases; the same bits twice."""
    rng = np.random.default_rng(11 * D + page)
    lo = 33 * page + 1
    c = _long_split_case(rng, H=8, KH=2, D=D, page=page, P=96,
                         ctx_pre=rng.integers(lo, 4097, 2),
                         ctx_dec=rng.integers(lo, 4097, 5))
    softcap = 30.0 if dtype == torch.float32 else 0.0
    _both_split(dev, dtype, c, softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_kernels_first_visible_key_in_a_later_piece_on_card(dev,
                                                                  dtype):
    """A window with a gap: a tile holds the rows at 5-9 and at 3981-4010
    of a 4011-key context, so its range (pages 0-249) is cut into 8
    pieces; with a window of 64 the late rows see only keys from 3918,
    every piece before the last is masked for them (m stays NEG_INF, l 0,
    and the merge must weigh it by 0), and the early rows see only the
    first piece.  Decode rows with a window of 1000 over 4011 keys: a
    range of 63 pages cut in two, its first page partly masked."""
    rng = np.random.default_rng(5)
    c = _long_split_case(rng, H=8, KH=2, D=128, page=16, P=300,
                         ctx_pre=[4011, 3000], ctx_dec=[4011, 2500, 1001])
    assert c["pre"][5][0, 0] == 5 and c["pre"][5][0, 5] == 3981
    for window in (64, 1000):
        _both_split(dev, dtype, c, window=window, piece_pages=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_split_kernels_gqa_groups_on_card(dev, dtype, G):
    """GQA groups of 1, 2, 4 and 8 heads (q tiles of 64, 32, 16 and 8
    rows; decode items of G live M rows), a QP of 37 (ragged against every
    tile), contexts of 64 to 4096 keys at Llama's head dim and page, an
    all-padding chunk and a decode padding row."""
    rng = np.random.default_rng(G)
    c = _long_split_case(rng, H=2 * G, KH=2, D=128, page=16, P=300, QP=37,
                         ctx_pre=[4096, int(rng.integers(64, 4097))],
                         ctx_dec=rng.integers(64, 4097, 6))
    _both_split(dev, dtype, c)


def test_split_kernels_refuse_groups_above_64_heads(dev):
    """A work item stacks a GQA group into 64 rows: both split wrappers
    refuse a group of 65 heads before any launch."""
    q = torch.zeros((2, 65, 16), dtype=torch.float32, device=dev)
    pages = torch.zeros((2, 8, 1, 16), dtype=torch.float32, device=dev)
    i32 = torch.zeros((2,), dtype=torch.int32, device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="GQA group"):
        msa_decode_cuda(q, pages, pages, bt, i32)
    with pytest.raises(ValueError, match="GQA group"):
        msa_prefill_cuda(q[:, None], pages, pages, bt, i32,
                         torch.zeros((2, 1), dtype=torch.int32, device=dev),
                         i32)


def test_engine_on_card_matches_cpu(dev):
    """The port's server on the card and on the CPU, same weights and
    workload (float32 smoke model): the same greedy tokens and step
    counts, every layer through the kernel on the card, first logits
    within 1e-4 of their scale."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     SchedulerConfig, ServerConfig,
                                     WorkloadConfig, multi_turn_workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
               else v.to(dev)) for k, v in cpu.items()}
    runs = []
    for params, device in ((cpu, "cpu"), (gpu, dev)):
        scfg = ServerConfig(num_blocks=32, block_size=16, clock="model",
                            host_blocks=16, scheduler=SchedulerConfig(
                                token_budget=128, max_chunk=64,
                                max_prefills=2, max_decodes=8))
        ecfg = EngineConfig(num_pages=32, page_size=16, max_prefills=2,
                            max_chunk=64, max_decodes=8)
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
            output_len=(12, 30), qps=1.0, seed=3))
        srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=device)
        before = msa_fused_cuda.launches
        res = srv.run(wl)
        runs.append((wl, res, msa_fused_cuda.launches - before))
    (wc, rc, lc), (wg, rg, lg) = runs
    assert lc == 0 and lg == cfg.n_layers * rg["steps"]
    assert rg["steps"] == rc["steps"] and rg["evictions"] == rc["evictions"]
    _same_results(wg, wc)


def _same_results(wg, wc):
    for a, b in zip(wg, wc):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        scale = float(np.max(np.abs(b.first_logits)))
        assert float(np.max(np.abs(a.first_logits - b.first_logits))) \
            <= 1e-4 * scale


def test_split_engine_on_card_matches_cpu(dev):
    """The split layout on the card against the split layout on the CPU
    (float32 smoke model, evictions and host-tier swaps): the same greedy
    tokens and step counts, each layer through one prefill
    and one decode kernel launch a step on the card, and never the fused
    kernel; first logits within 1e-4 of their scale."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     SchedulerConfig, ServerConfig,
                                     WorkloadConfig, multi_turn_workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
               else v.to(dev)) for k, v in cpu.items()}
    runs = []
    for params, device in ((cpu, "cpu"), (gpu, dev)):
        scfg = ServerConfig(num_blocks=32, block_size=16, clock="model",
                            host_blocks=16, attn_mode="split",
                            scheduler=SchedulerConfig(
                                token_budget=128, max_chunk=64,
                                max_prefills=2, max_decodes=8))
        ecfg = EngineConfig(num_pages=32, page_size=16, max_prefills=2,
                            max_chunk=64, max_decodes=8, attn_mode="split")
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
            output_len=(12, 30), qps=1.0, seed=3))
        srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=device)
        before = (msa_prefill_cuda.launches, msa_decode_cuda.launches,
                  msa_fused_cuda.launches)
        res = srv.run(wl)
        after = (msa_prefill_cuda.launches, msa_decode_cuda.launches,
                 msa_fused_cuda.launches)
        runs.append((wl, res, [a - b for a, b in zip(after, before)]))
    (wc, rc, lc), (wg, rg, lg) = runs
    assert lc == [0, 0, 0]
    assert lg == [cfg.n_layers * rg["steps"]] * 2 + [0]
    assert rg["steps"] == rc["steps"] and rg["evictions"] == rc["evictions"]
    assert rg["attn_dispatches_per_step"] == 2 * cfg.n_layers
    _same_results(wg, wc)


def test_multi_token_engine_on_card_matches_cpu(dev):
    """Multi-token decode (``max_decode_steps`` 8) on the card against the
    same server on the CPU (float32 smoke model, a burst of decodes whose
    outputs end at different iterations): the same schedule, k-step
    counts and greedy tokens, the fused kernel once a layer an iteration
    on the card, first logits within 1e-4 of their scale; and the sampled
    ids of every iteration equal."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     SchedulerConfig, ServerConfig,
                                     decode_burst_workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
               else v.to(dev)) for k, v in cpu.items()}
    runs = []
    for params, device in ((cpu, "cpu"), (gpu, dev)):
        scfg = ServerConfig(num_blocks=64, block_size=16, clock="model",
                            scheduler=SchedulerConfig(
                                token_budget=128, max_chunk=64,
                                max_prefills=2, max_decodes=8,
                                max_decode_steps=8))
        ecfg = EngineConfig(num_pages=64, page_size=16, max_prefills=2,
                            max_chunk=64, max_decodes=8)
        wl = decode_burst_workload(n_requests=6, seed=4)
        srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=device)
        before = msa_fused_cuda.launches
        res = srv.run(wl)
        runs.append((wl, res, msa_fused_cuda.launches - before,
                     srv.engine.attn_dispatches))
    (wc, rc, lc, _), (wg, rg, lg, ag) = runs
    assert lc == 0 and lg == ag
    assert rg["multi_token_dispatches"] > 0 and rg["multi_token_rollbacks"] > 0
    for key in ("steps", "multi_token_dispatches", "multi_token_iterations",
                "multi_token_rollbacks", "k_counts"):
        assert rg[key] == rc[key], key
    _same_results(wg, wc)
    for a, b in zip(wg, wc):
        assert a.sampled_ids == b.sampled_ids


def test_moe_engine_on_card_matches_cpu(dev):
    """The Grok-1 smoke model (MoE, 4 experts, top 2, dropless, softcap
    30) served on the card and on the CPU, fused layout, float32: the same
    greedy tokens and step counts, first logits within 1e-4 of their
    scale."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     SchedulerConfig, ServerConfig,
                                     WorkloadConfig, multi_turn_workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config("grok-1-314b"), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
               else v.to(dev)) for k, v in cpu.items()}
    runs = []
    for params, device in ((cpu, "cpu"), (gpu, dev)):
        scfg = ServerConfig(num_blocks=40, block_size=16, clock="model",
                            host_blocks=16, scheduler=SchedulerConfig(
                                token_budget=128, max_chunk=64,
                                max_prefills=2, max_decodes=8))
        ecfg = EngineConfig(num_pages=40, page_size=16, max_prefills=2,
                            max_chunk=64, max_decodes=8)
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
            output_len=(12, 24), qps=1.0, vocab=256, seed=3))
        srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=device)
        before = msa_fused_cuda.launches
        res = srv.run(wl)
        runs.append((wl, res, msa_fused_cuda.launches - before))
    (wc, rc, lc), (wg, rg, lg) = runs
    assert lc == 0 and lg == cfg.n_layers * rg["steps"]
    assert rg["steps"] == rc["steps"] and rg["evictions"] == rc["evictions"]
    _same_results(wg, wc)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_offload_on_card_is_bit_identical(dev, quant):
    """On the card, bf16 smoke model: serving with quantized swap payloads
    gives the same bits as its full-precision-payload control arm (the
    pool snapped to the same grid in both), with the same swap-ins and at
    most 0.51x its swap bytes."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.core import OffloadConfig
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, SchedulerConfig,
                                     ServerConfig, WorkloadConfig,
                                     multi_turn_workload)
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="bfloat16")
    params = init_params(cfg, seed=0, device=dev)
    runs = []
    for payload_fp in (True, False):
        scfg = ServerConfig(
            num_blocks=40, block_size=16, clock="model", host_blocks=128,
            offload=OffloadConfig(quant=quant, payload_fp=payload_fp,
                                  retain_host=True),
            scheduler=SchedulerConfig(token_budget=128, max_chunk=64,
                                      max_prefills=2, max_decodes=8))
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 200),
            output_len=(12, 24), qps=1.0, seed=0))
        srv = AsymCacheServer(cfg, params, scfg, device=dev)
        runs.append((wl, srv.run(wl), srv.engine.swap_bytes_shipped))
    (wa, ra, ba), (wb, rb, bb) = runs
    assert ra["swap_ins"] > 0 and rb["swap_ins"] == ra["swap_ins"]
    for a, b in zip(wa, wb):
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids
        assert np.array_equal(a.first_logits, b.first_logits)
    assert 0 < bb <= 0.51 * ba


# ---------------------------------------------------------------------------
# sharded serving: the fused kernel's (o, lse) mode
# ---------------------------------------------------------------------------

def _partial_vs_plain(c, n, dtype, dev, *, window, softcap):
    """Each of n shards' (o, lse) on the card (the shard's pages of a
    P-page pool cut into n runs, its work-list built with ``page_valid``)
    against ``msa_fused_partial_ref``: o and lse within the tolerance,
    NEG_INF lse on the same rows, slack rows o = 0 and lse NEG_INF, the
    same bits on a second launch; then the shards merged against the
    full fused kernel.  Returns the worst error."""
    from repro_torch.distributed import ShardGroup, lse_merge
    from repro_torch.kernels.msa import msa_fused_partial
    from repro_torch.kernels.msa.msa_fused import msa_fused_partial_cuda
    from repro_torch.kernels.msa.ref import msa_fused_partial_ref
    P = c["k"].shape[0]
    assert P % n == 0
    p_loc, page = P // n, c["k"].shape[1]
    t = {k: torch.from_numpy(np.asarray(c[k])).to(dev)
         for k in ("ctx", "q_pos", "seq_ids", "valid")}
    q = torch.from_numpy(c["q"]).to(dev, dtype)
    T, N = q.shape[0], c["bt"].shape[0]
    tq = c["q_tile"]
    n_tiles = -(-T // tq)
    worst, parts, lses = 0.0, [], []
    for i in range(n):
        lo = i * p_loc
        pv = (c["bt"] >= lo) & (c["bt"] < lo + p_loc)
        table = np.where(pv, c["bt"] - lo, 0).astype(np.int32)
        wl, count = build_worklist(c["q_start"], c["q_len"], c["ctx"], table,
                                   c["q_pos"], page=page, q_tile=tq,
                                   n_tiles=n_tiles, page_valid=pv)
        wl = pad_worklist(wl, 1 << count.bit_length(), sentinel_seq=N)
        units = build_units(wl, c["q_start"], c["q_len"], n_rows=T,
                            q_tile=tq, n_tiles=n_tiles,
                            pad_to=2 * count + n_tiles)
        kp, vp = (torch.from_numpy(c[k][lo:lo + p_loc]).to(dev, dtype)
                  for k in ("k", "v"))
        args = (q, kp, vp, torch.from_numpy(table).to(dev), t["ctx"],
                t["q_pos"], t["seq_ids"], t["valid"],
                torch.from_numpy(pv).to(dev))
        kw = dict(window=window, softcap=softcap)
        wlt = tuple(torch.from_numpy(wl[f]).to(dev) for f in WL_FIELDS)
        ut = tuple(torch.from_numpy(units[f]).to(dev) for f in UNIT_FIELDS)
        before = msa_fused_partial_cuda.launches
        (o, lse), (o2, lse2) = (msa_fused_partial(
            *args, worklist=wlt, units=ut, q_tile=tq, **kw)
            for _ in range(2))
        torch.cuda.synchronize()
        assert msa_fused_partial_cuda.launches == before + 2
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        wo, wlse = msa_fused_partial_ref(*args, **kw)
        assert o.dtype == lse.dtype == torch.float32
        none = wlse <= -1e38
        assert torch.equal(lse <= -1e38, none)
        assert torch.all(o[c["real"]:] == 0) and torch.all(
            lse[c["real"]:] <= -1e38)
        worst = max(worst, float((o - wo).abs().max()),
                    float((lse - wlse).abs()[~none].max())
                    if (~none).any() else 0.0)
        parts.append(o)
        lses.append(lse)
    merged = lse_merge(ShardGroup([dev] * n), parts, lses)[0].to(dtype)
    full = msa_fused_ref(q, *(torch.from_numpy(c[k]).to(dev, dtype)
                              for k in ("k", "v")),
                         torch.from_numpy(c["bt"]).to(dev), t["ctx"],
                         t["q_pos"], t["seq_ids"], t["valid"],
                         window=window, softcap=softcap)
    return max(worst, float((merged.float() - full.float()).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 20.0)])
@pytest.mark.parametrize("D,page", [(16, 8), (128, 16)])
def test_partial_kernel_matches_plain_on_card(dev, dtype, n, window,
                                              softcap, D, page):
    """Small steps (window 6 below a page: rows whose local keys are all
    masked; one-page sequences: shards with no page of theirs) and
    contexts long enough to cut runs into work units."""
    rng = np.random.default_rng(n * 10 + window + D)
    c = _case(rng, n_pre=2, n_dec=4, page=page, NP=40, P=160, H=8, KH=2,
              D=D, slack=11, q_tile=16)
    err = _partial_vs_plain(c, n, dtype, dev, window=window,
                            softcap=softcap)
    assert err <= TOL[dtype], err


def test_sharded_engine_on_card_matches_single_device(dev):
    """The port's server sharded 2 ways over this card against the
    single-device server on it (float32 smoke model, evictions and
    host-tier swaps): the same tokens and steps, each shard's attention
    through the (o, lse) mode once a layer a step and the fused mode
    never, first logits within 1e-4 of their scale."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.kernels.msa.msa_fused import msa_fused_partial_cuda
    from repro_torch.models import init_params
    from repro_torch.serving import (AsymCacheServer, EngineConfig,
                                     SchedulerConfig, ServerConfig,
                                     WorkloadConfig, multi_turn_workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    runs = []
    for n in (1, 2):
        scfg = ServerConfig(num_blocks=32, block_size=16, clock="model",
                            host_blocks=16, n_shards=n,
                            shard_devices=[dev] * n if n > 1 else None,
                            scheduler=SchedulerConfig(
                                token_budget=128, max_chunk=64,
                                max_prefills=2, max_decodes=8))
        ecfg = EngineConfig(num_pages=32, page_size=16, max_prefills=2,
                            max_chunk=64, max_decodes=8)
        wl = multi_turn_workload(WorkloadConfig(
            n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 180),
            output_len=(12, 30), qps=1.0, seed=3))
        srv = AsymCacheServer(cfg, params, scfg, ecfg=ecfg, device=dev)
        fused0 = msa_fused_cuda.launches
        part0 = msa_fused_partial_cuda.launches
        res = srv.run(wl)
        runs.append((wl, res, msa_fused_cuda.launches - fused0,
                     msa_fused_partial_cuda.launches - part0))
    (w1, r1, f1, p1), (w2, r2, f2, p2) = runs
    assert r2["steps"] == r1["steps"] and r2["evictions"] == r1["evictions"]
    assert (f1, p1) == (cfg.n_layers * r1["steps"], 0)
    assert (f2, p2) == (0, 2 * cfg.n_layers * r2["steps"])
    _same_results(w2, w1)


# ---------------------------------------------------------------------------
# the full model (plain PyTorch: no kernel of its own) on the card
# ---------------------------------------------------------------------------

def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "whisper-large-v3", "gemma3-12b"])
def test_full_model_on_card_matches_cpu(dev, arch):
    """The SSM, hybrid, encoder-decoder and local/global smoke models
    (float32, wq/wk at fan-in) on the card and on the CPU, same weights
    and inputs: the forward's logits and K/V (also banded: the local
    layers' tiles of 16 divide 48), and 48 teacher-forced decode steps
    (past the smoke windows of 16 and Mamba's chunks of 16), logits and every state tensor, within 1e-5 of their
    scale; on the card the steps hold to its forward within 2e-3."""
    import math
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params, prep_cross_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config(arch), dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    for name in ("wq", "wk", "xwq", "xwk"):
        if name in cpu["blocks"]:
            cpu["blocks"][name].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
    B, S = 2, 48
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.enc_dec:
        batch["enc_embeds"] = torch.randn((B, cfg.encoder_len, cfg.d_model),
                                          generator=gen)

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / max(
            1e-30, float(b.abs().max()))

    runs = {}
    for device, params in (("cpu", cpu), (dev, _tree_to(cpu, dev))):
        b = _tree_to(batch, device)
        with torch.no_grad():
            logits, kv = forward(params, cfg, b, return_kv=True)
            banded = forward(params, cfg, b, banded=True)
            st = init_decode_state(cfg, B, S, device=device)
            if cfg.enc_dec:
                st = prep_cross_attention(params, cfg, b["enc_embeds"], st)
            steps = []
            for t in range(S):
                lg, st = decode_step(params, cfg, st, b["tokens"][:, t])
                steps.append(lg)
        runs[str(device)] = (logits, kv, banded, torch.stack(steps, 1), st)
    (lc, kvc, bc, dc, sc), (lg, kvg, bg, dg, sg) = runs["cpu"], runs[str(dev)]
    assert lg.device.type == "cuda" and dg.device.type == "cuda"
    for got, want in [(lg, lc), (bg, bc), (dg, dc)] + (
            [] if kvc is None else list(zip(kvg, kvc))):
        assert rel(got, want) < 1e-5
    for key, want in sc.items():
        assert sg[key].device.type == "cuda"
        if key == "pos":
            assert torch.equal(sg[key].cpu(), want)
        else:
            assert rel(sg[key], want) < 1e-5, key
    assert rel(dg, lg.cpu()) < 2e-3


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b",
                                  "whisper-large-v3", "gemma3-12b",
                                  "grok-1-314b"])
def test_init_params_on_card_puts_every_tensor_there(dev, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_decode_state, init_params

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    state = init_decode_state(cfg, 2, 8, device=dev)
    assert all(t.device.type == "cuda"
               for t in list(leaves(params)) + list(state.values()))


# ---------------------------------------------------------------------------
# Training (repro_torch.training) on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,opt_name", [("llama31-8b", "adamw"),
                                           ("grok-1-314b", "adafactor"),
                                           ("mamba2-780m", "adamw")])
def test_train_step_on_card_matches_cpu(dev, arch, opt_name):
    """One train step (grad_accum 2, each layer remat'd) of the smoke
    model at float32 on the card and on the CPU, the same weights and
    batch (Grok-1's MoE with Adafactor forced): the loss within 1e-5
    relative, the grad norm within 1e-4, every optimizer-state leaf
    within 1e-4 of its scale, every parameter within 5e-5 (the JAX
    package's own bound after an AdamW step, ``tests/test_training.py``)."""
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.models import init_params
    from repro_torch.training import (DataConfig, SyntheticLM, adafactor,
                                      adamw, make_train_step)
    from repro_torch.training.optimizer import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = scaled_config(get_smoke_config(arch), dtype="float32")
    opt = adamw(lr=1e-3) if opt_name == "adamw" else adafactor(lr=1e-3)
    step = make_train_step(cfg, opt, grad_accum=2)
    runs = {}
    for device in ("cpu", dev):
        params = _tree_to(init_params(cfg, seed=0, device="cpu"), device)
        state = opt.init(params)
        batch = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4,
                                            seed=5), device).batch_at(0)
        runs[str(device)] = step(params, state, batch, 0)
    (pc, sc, mc), (pg, sg, mg) = runs["cpu"], runs[str(dev)]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5 * abs(
        float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * (
        float(mc["grad_norm"]))
    got_s, got_p = dict(leaves(sg)), dict(leaves(pg))
    for name, want in leaves(sc):
        assert got_s[name].device.type == "cuda"
        err = float((got_s[name].cpu() - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), 1e-30), name
    for name, want in leaves(pc):
        assert got_p[name].device.type == "cuda"
        assert float((got_p[name].cpu() - want).abs().max()) < 5e-5, name


_RESUME_CHILD = r"""
import os, shutil, sys, tempfile
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.training import DataConfig, TrainConfig, Trainer, adamw
from repro_torch.training.optimizer import leaves
cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="bfloat16")
d = tempfile.mkdtemp()
try:
    def trainer():
        return Trainer(cfg, TrainConfig(steps=4, ckpt_every=2, ckpt_dir=d,
                                        seed=3, grad_accum=2),
                       DataConfig(seq_len=32, global_batch=4),
                       opt=adamw(lr=1e-3), device="cuda")
    t1 = trainer()
    h1 = t1.run()
    shutil.rmtree(os.path.join(d, "step_000000004"))
    t2 = trainer()
    assert t2.init_or_resume() == 2
    h2 = t2.run()
    assert [h["loss"] for h in h2] == [h["loss"] for h in h1[2:]], (h1, h2)
    for a, b in ((t1.params, t2.params), (t1.opt_state, t2.opt_state)):
        got = dict(leaves(b))
        for name, want in leaves(a):
            assert got[name].device.type == "cuda", name
            assert got[name].dtype == want.dtype, name
            assert torch.equal(got[name], want), name
finally:
    shutil.rmtree(d, ignore_errors=True)
print("resume_same_bits")
"""


def test_checkpoint_resume_on_card_continues_with_same_bits(dev):
    """A bf16 smoke model trained 4 steps on the card against 2 steps, a
    checkpoint, a fresh trainer resuming from it and 2 more: the same
    losses and the same bits in every parameter and moment.  In a child
    process with deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set
    before CUDA starts): the embedding's backward accumulates with
    atomics otherwise."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run([sys.executable, "-c", _RESUME_CHILD], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert "resume_same_bits" in run.stdout


# ---------------------------------------------------------------------------
# the sharded full model (plain PyTorch) with its shards on the card
# ---------------------------------------------------------------------------

def _card_and_cpu_meshes(dev, shape):
    from repro_torch.launch.mesh import make_mesh
    n = int(np.prod(shape))
    return (make_mesh(shape, ("data", "model"), devices=[dev] * n),
            make_mesh(shape, ("data", "model"), devices=["cpu"] * n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,rules,B", [
    ((2, 4), {"batch": "data", "kv_seq": "model"}, 4),
    ((2, 2), {"batch": None, "kv_seq": ("data", "model")}, 1)])
@pytest.mark.parametrize("S,window,softcap", [(64, None, 0.0),
                                              (30, None, 0.0),
                                              (64, 9, 20.0)])
def test_sharded_decode_attention_on_card_matches_cpu(dev, dtype, shape,
                                                      rules, B, S, window,
                                                      softcap):
    """The sequence-sharded decode attention with every shard on the card
    against the same shards on the CPU (S 30 over 4 shards: the cache
    whole on every shard)."""
    from repro_torch.distributed import (DistContext,
                                         sharded_decode_attention, use_dist)
    rng = np.random.default_rng(S + B)
    H, KH, D = 8, 2, 64
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(
        np.float32)).to(dtype) for _ in range(2))
    q = q.to(dtype)
    kv_len = torch.tensor([S, 40, 9, 1][:B], dtype=torch.int32).clamp_max(S)
    outs = []
    for mesh in _card_and_cpu_meshes(dev, shape):
        d = mesh.device(0)
        with use_dist(DistContext(mesh, rules, {})):
            outs.append(sharded_decode_attention(
                q.to(d), k.to(d), v.to(d), kv_len.to(d), window=window,
                softcap=softcap).float().cpu())
        n = mesh.size_of(rules["kv_seq"])
        assert mesh.log.ops(0) == {("all-reduce", "max", n): 1,
                                   ("all-reduce", "sum", n): 2}
    err = float((outs[0] - outs[1]).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(outs[1].abs().max())), err


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_alltoall_on_card_matches_cpu(dev, dropless):
    """Kimi-K2's smoke MoE through the all-to-all on a (data 4, model 2)
    mesh of the card against the same mesh on the CPU, dropless and at
    capacity factor 1.25 (routing decided per data shard in both), in
    float32: in bf16 a router logit that rounds the other way on the other
    device picks another expert, which no tolerance covers."""
    dtype = torch.float32
    import dataclasses
    from repro_torch.configs import get_smoke_config, scaled_config
    from repro_torch.distributed import make_context, moe_ffn_alltoall, \
        use_dist
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    base = scaled_config(get_smoke_config("kimi-k2-1t-a32b"),
                         dtype="float32")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dropless=dropless, capacity_factor=1.25))
    blk = {k: v[0].to(dtype) for k, v in
           init_params(cfg, seed=0, device="cpu")["blocks"].items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)).to(dtype)
    outs = []
    for mesh in _card_and_cpu_meshes(dev, (4, 2)):
        d = mesh.device(0)
        with use_dist(make_context(cfg, mesh, "train", batch_size=4)):
            outs.append(moe_ffn_alltoall(
                x.to(d), *(blk[k].to(d) for k in
                           ("router", "we1", "we3", "we2")),
                cfg).float().cpu())
        assert mesh.log.ops(0) == {("all-to-all", "", 4): 2,
                                   ("all-reduce", "sum", 2): 1}
    scale = float(outs[1].abs().max())
    err = float((outs[0] - outs[1]).abs().max()) / scale
    assert err <= TOL[dtype], err
