"""The port on an NVIDIA card: the hand-written fused MSA kernel against its
plain PyTorch version on the same inputs, over the shapes of the JAX
package's kernel sweep (``tests/test_fused.py``: page 8, head_dim 16, q
tiles 4/8/16, GQA ratios, window, softcap, bucket slack), and the whole
engine on the card against the same engine on the CPU.

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

from repro_torch.kernels.msa import (WL_FIELDS, build_worklist, msa_fused,
                                     msa_fused_cuda, pad_worklist,
                                     tile_ranges)
from repro_torch.kernels.msa.ref import msa_fused_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, *, n_pre, n_dec, page, NP, P, H, KH, D, slack, q_tile):
    """Random mixed varlen step (numpy): multi-segment prefill runs, decode
    rows, then ``slack`` padding rows; its work-list and tile ranges."""
    runs, ctx = [], []
    for _ in range(n_pre):
        c = int(rng.integers(4, NP * page))
        pos = np.unique(np.append(
            rng.choice(c, size=int(rng.integers(1, min(14, c) + 1)),
                       replace=False), c - 1))
        runs.append(pos)
        ctx.append(c)
    for _ in range(n_dec):
        c = int(rng.integers(1, NP * page))
        runs.append(np.asarray([c - 1]))
        ctx.append(c)
    n = len(runs)
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
                               q_tile=tq, n_tiles=n_tiles, window=0)
    tile_first = tile_ranges(wl, n_tiles)
    wl = pad_worklist(wl, 1 << count.bit_length(), sentinel_seq=n)
    return dict(
        q=rng.standard_normal((T, H, D)).astype(np.float32),
        k=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        v=rng.standard_normal((P, page, KH, D)).astype(np.float32),
        bt=bt, ctx=ctx, q_pos=q_pos, seq_ids=seq_ids, valid=valid,
        q_start=q_start, q_len=q_len, wl=wl, tile_first=tile_first,
        q_tile=tq, real=real)


def _kernel_vs_plain(c, dtype, dev, *, window, softcap):
    t = {k: torch.from_numpy(np.asarray(c[k])).to(dev)
         for k in ("bt", "ctx", "q_pos", "seq_ids", "valid", "q_start",
                   "q_len", "tile_first")}
    q, kp, vp = (torch.from_numpy(c[k]).to(dev, dtype)
                 for k in ("q", "k", "v"))
    wl = tuple(torch.from_numpy(c["wl"][f]).to(dev) for f in WL_FIELDS)
    before = msa_fused_cuda.launches
    got = msa_fused(q, kp, vp, t["bt"], t["ctx"], t["q_pos"], t["seq_ids"],
                    t["valid"], q_start=t["q_start"], q_len=t["q_len"],
                    worklist=wl, tile_first=t["tile_first"],
                    q_tile=c["q_tile"], window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert msa_fused_cuda.launches == before + 1
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
    for a, b in zip(wg, wc):
        assert a.status == b.status == "finished"
        assert a.generated == b.generated
        scale = float(np.max(np.abs(b.first_logits)))
        assert float(np.max(np.abs(a.first_logits - b.first_logits))) \
            <= 1e-4 * scale
