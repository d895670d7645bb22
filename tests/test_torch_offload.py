"""Port vs reference for quantized offload: the fp8 codes against
``ml_dtypes`` (every code, every bf16 bit pattern, and a float sweep
across the overflow boundary), the engine's write-time snap (int8 and
fp8), the host-side encode and decode of the q8/f8 wire halves, the
in-step dequantization of the swap payloads, quantized serving against
the JAX server, and inside the port: quantized serving bit-identical to
its full-precision-payload control arm (``tests/test_offload.py``'s
identity, with bf16 pools carried as int16 as well), and a spilled page
restored with the same bits by the eager and the in-step swap-in.

Codes, snapped values and pool pages are compared bit for bit; served
runs agree exactly on tokens, sampled ids and counters, and on
``first_logits`` within 1e-4 of their scale (float32 through two
frameworks)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as JK
import repro.serving as J
import repro_torch.core as PK
import repro_torch.serving as P
from conftest import assert_drained
from _h100_costs import PCIE_BW, cost_model
from repro.configs import get_smoke_config, scaled_config
from repro.kernels.msa import apply_swap_ins as j_apply_swap_ins
from repro.models import init_params as j_init
from repro_torch.bridge import params_from_numpy
from repro_torch.core.offload import f8_codes, f8_values
from repro_torch.kernels.msa import apply_swap_ins

GRID = 8.0 / 127.0             # OffloadConfig's default clip / 127
LOGIT_REL_TOL = 1e-4
F8 = np.dtype(ml_dtypes.float8_e4m3fn)


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits, comparable across dtypes numpy lacks."""
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()]).numpy()


def _sweep() -> np.ndarray:
    """Floats across the fp8 range: random values, ±448..±512 (the
    overflow boundary at 464), subnormals and their ties, ±0, ±inf."""
    rng = np.random.RandomState(0)
    edge = np.linspace(448.0, 512.0, 257)
    sub = np.arange(-16, 17) * 2.0 ** -10            # half-subnormal steps
    special = [0.0, -0.0, np.inf, -np.inf, 240.0, 464.0, 2.0 ** -6,
               2.0 ** -9, 3 * 2.0 ** -10, 1e-30]
    return np.concatenate([rng.standard_normal(4096) * 50.0, edge, -edge,
                           sub, special, [-v for v in special]]
                          ).astype(np.float32)


# ---------------------------------------------------------------------------
# fp8 codes
# ---------------------------------------------------------------------------

def test_f8_codes_match_ml_dtypes():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        f8_values(torch.from_numpy(codes), torch.float32).numpy(),
        codes.view(F8).astype(np.float32))
    x = _sweep()
    with np.errstate(invalid="ignore"):
        want = x.astype(F8).view(np.uint8)
    np.testing.assert_array_equal(f8_codes(torch.from_numpy(x)).numpy(),
                                  want)
    # every bf16 bit pattern, NaNs and infinities included
    bits = np.arange(65536, dtype=np.uint16).view(np.int16)
    with np.errstate(invalid="ignore"):
        want = bits.view(ml_dtypes.bfloat16).astype(F8).view(np.uint8)
    got = f8_codes(torch.from_numpy(bits).view(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the engine's write-time snap and the host halves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = scaled_config(get_smoke_config("llama31-8b"), dtype="float32")
    jp = j_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("snap", ["int8", "fp8"])
def test_snap_matches_jax(small, snap, dtype):
    cfg, jp, tp = small
    kw = dict(num_pages=8, snap=snap, snap_scale=GRID)
    je = J.Engine(cfg, J.EngineConfig(**kw), jp)
    te = P.Engine(cfg, P.EngineConfig(**kw), tp, device="cpu")
    rng = np.random.RandomState(1)
    # past the int8 grid's clip (±8), its ties ((k + 0.5) * s) and the
    # fp8 sweep
    ties = (np.arange(-130, 130) + 0.5) * np.float32(GRID)
    x = np.concatenate([rng.standard_normal(2048) * 4.0, ties, _sweep()
                        ]).astype(np.float32)
    x = x[np.isfinite(x)]
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(je._snap(jx).astype(jnp.float32))
    got = te._snap(tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    # equal values in the same dtype are equal bits, but for NaN payloads
    # (fp8 overflow: both NaN) and the sign of zero: fp8 keeps -0, the
    # port's int8 grid writes +0 where JAX writes -0
    np.testing.assert_array_equal(got, want)
    real = ~np.isnan(want)
    assert np.isnan(want).sum() == (snap == "fp8") * np.sum(
        np.abs(tx.float().numpy()) > 464.0)
    np.testing.assert_array_equal(
        np.signbit(got[real]),
        np.signbit(want[real]) & ((want[real] != 0) | (snap == "fp8")))
    if dtype == "float32":
        np.testing.assert_array_equal(
            PK.snap_to_grid_np(x, snap, GRID),
            JK.snap_to_grid_np(x, snap, GRID))


@pytest.mark.parametrize("fmt,static", [("q8", GRID), ("q8", 0.0),
                                        ("f8", 0.0)])
def test_wire_halves_match_jax(fmt, static):
    """Encode and decode of one (L, page, KH, D) half: the same codes and
    scales, and the same decoded values in f32 and bf16."""
    rng = np.random.RandomState(2)
    arr = (rng.standard_normal((2, 16, 2, 16)) * 3.0).astype(np.float32)
    jh = JK.quantize_half(arr, fmt, static_scale=static)
    th = PK.quantize_half(arr, fmt, static_scale=static)
    assert th.fmt == jh.fmt and th.nbytes == jh.nbytes
    np.testing.assert_array_equal(th.data.view(np.uint8),
                                  np.asarray(jh.data).view(np.uint8))
    if fmt == "q8":
        np.testing.assert_array_equal(th.scale, jh.scale)
        # a given scale (requantization) wins over the static one
        again = PK.quantize_half(arr, "q8", scale=th.scale * 2)
        np.testing.assert_array_equal(
            again.data, JK.quantize_half(arr, "q8", scale=jh.scale * 2).data)
    for tdt, jdt in ((torch.float32, np.float32),
                     (torch.bfloat16, ml_dtypes.bfloat16)):
        got = PK.dequantize_half(th, tdt)
        want = np.asarray(JK.dequantize_half(jh, np.dtype(jdt)))
        assert got.dtype == tdt
        np.testing.assert_array_equal(_bits(got),
                                      want.view(_bits(got).dtype))
    # bf16 pages travel as int16 bits: they are not values to quantize
    with pytest.raises(TypeError):
        PK.quantize_half(arr.view(np.int16), fmt, static_scale=static)


@pytest.mark.parametrize("fmt", ["q8", "f8"])
def test_in_step_swap_in_dequantizes_as_jax(fmt):
    rng = np.random.RandomState(3)
    L, Pn, page, KH, D, S = 2, 8, 4, 2, 8, 3
    k = rng.standard_normal((L, Pn, page, KH, D)).astype(np.float32)
    v = rng.standard_normal((L, Pn, page, KH, D)).astype(np.float32)
    halves = [rng.standard_normal((L, S, page, KH, D)).astype(np.float32)
              for _ in range(2)]
    k_dst = np.asarray([5, Pn, Pn], np.int32)     # Pn = padding
    v_dst = np.asarray([5, 6, Pn], np.int32)
    if fmt == "q8":
        scales = [np.abs(rng.standard_normal((L, S, KH))).astype(np.float32)
                  for _ in range(2)]
        payloads = [np.clip(np.round(h / s[:, :, None, :, None]), -127, 127
                            ).astype(np.int8) for h, s in zip(halves, scales)]
        j_pay = [jnp.asarray(p) for p in payloads]
        t_pay = [torch.from_numpy(p) for p in payloads]
    else:
        scales = [None, None]
        payloads = [f8_codes(torch.from_numpy(h)).numpy() for h in halves]
        j_pay = [jnp.asarray(p.view(F8)) for p in payloads]
        t_pay = [torch.from_numpy(p).view(torch.float8_e4m3fn)
                 for p in payloads]
    jk, jv = j_apply_swap_ins(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_dst),
        jnp.asarray(v_dst), *j_pay,
        *(None if s is None else jnp.asarray(s) for s in scales))
    drop = np.zeros((L, 1, page, KH, D), np.float32)
    tk = torch.from_numpy(np.concatenate([k, drop], axis=1))
    tv = torch.from_numpy(np.concatenate([v, drop], axis=1))
    apply_swap_ins(tk, tv, torch.from_numpy(k_dst), torch.from_numpy(v_dst),
                   *t_pay, *(None if s is None else torch.from_numpy(s)
                             for s in scales))
    np.testing.assert_array_equal(tk[:, :Pn].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:, :Pn].numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# quantized serving
# ---------------------------------------------------------------------------

COUNTERS = ("steps", "n_requests", "evictions", "swap_ins", "swap_outs",
            "attn_dispatches", "bucket_counts", "instep_swaps",
            "eager_swaps", "swap_bytes_shipped")
WL = dict(n_sessions=3, turns_per_session=(2, 3), first_ctx_len=(96, 200),
          output_len=(12, 24), qps=1.0, seed=0)


def _server(M, cfg, params, offload, **kw):
    scfg = M.ServerConfig(
        policy="asymcache", num_blocks=40, block_size=16, clock="model",
        host_blocks=128, pipeline_depth=1, offload=offload, pcie_bw=PCIE_BW,
        scheduler=M.SchedulerConfig(token_budget=128, max_chunk=64,
                                    max_prefills=2, max_decodes=8))
    return M.AsymCacheServer(cfg, params, scfg,
                             cost_model=cost_model(M, cfg), **kw)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_serving_matches_jax(small, quant):
    cfg, jp, tp = small
    wj = J.multi_turn_workload(J.WorkloadConfig(**WL))
    wt = P.multi_turn_workload(P.WorkloadConfig(**WL))
    rj = _server(J, cfg, jp, JK.OffloadConfig(quant=quant, retain_host=True)
                 ).run(wj)
    rt = _server(P, cfg, tp, PK.OffloadConfig(quant=quant, retain_host=True),
                 device="cpu").run(wt)
    assert rt["swap_ins"] > 0
    for key in COUNTERS:
        assert rt[key] == rj[key], key
    for a, b in zip(wt, wj):
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids
        assert _rel(a.first_logits, b.first_logits) < LOGIT_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_offload_serving_byte_identical(small, quant, dtype):
    """Same snapped numerics, different wire format: shipping int8 codes
    and scales (or fp8 codes) instead of the pool's own bits changes no
    bit of any output, while the engine ships a quarter (f32 pools) or
    about half (bf16 pools: codes of half the bytes, plus 4 bytes of
    scale a page and kv head) of the control arm's swap bytes."""
    cfg = scaled_config(small[0], dtype=dtype)
    tp = params_from_numpy(jax.tree.map(
        np.asarray, j_init(cfg, jax.random.PRNGKey(0))), device="cpu")
    runs = []
    for payload_fp in (True, False):
        wl = P.multi_turn_workload(P.WorkloadConfig(**WL))
        srv = _server(P, cfg, tp, PK.OffloadConfig(
            quant=quant, payload_fp=payload_fp, retain_host=True),
            device="cpu")
        runs.append((wl, srv.run(wl), srv))
        assert_drained(srv)
    (wa, ra, sa), (wb, rb, sb) = runs
    assert sa.engine.ecfg.swap_payload == "fp"
    assert sb.engine.ecfg.swap_payload == {"int8": "q8", "fp8": "f8"}[quant]
    assert ra["swap_ins"] > 0 and rb["swap_ins"] == ra["swap_ins"]
    for a, b in zip(wa, wb):
        assert a.generated == b.generated
        assert a.sampled_ids == b.sampled_ids
        assert np.array_equal(a.first_logits, b.first_logits)
    bytes_a = sa.engine.perf_counters()["swap_bytes_shipped"]
    bytes_b = sb.engine.perf_counters()["swap_bytes_shipped"]
    assert bytes_a > 0
    assert bytes_b <= (0.26 if dtype == "float32" else 0.51) * bytes_a
    assert sb.engine.jit_traces == len(sb.engine.buckets_used)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_spilled_page_restores_same_bits(small, quant, dtype):
    """A committed page, spilled through the block manager's encoder and
    restored by the eager and by the in-step swap-in, comes back with the
    same bits in both halves."""
    cfg = scaled_config(small[0], dtype=dtype)
    tp = params_from_numpy(jax.tree.map(
        np.asarray, j_init(cfg, jax.random.PRNGKey(0))), device="cpu")
    srv = _server(P, cfg, tp, PK.OffloadConfig(quant=quant), device="cpu")
    srv.run(P.multi_turn_workload(P.WorkloadConfig(**WL))[:2])
    eng, bm = srv.engine, srv.bm
    slot = next(iter(bm.table.values()))      # a committed page
    free = [s for s in range(bm.num_blocks) if s not in bm.table.values()]
    raw_k, raw_v = eng.swap_out(slot)
    assert raw_k.dtype == np.float32          # values, not bf16 bits
    half_k = bm._encode_half(raw_k, 0, "k")
    half_v = bm._encode_half(raw_v, 0, "v")
    assert half_k.fmt == eng.ecfg.swap_payload != "fp"
    eng.swap_in(free[0], (half_k, half_v))
    eng.queue_swap_in(free[1], (half_k, half_v))
    e = eng.ecfg
    views = {n: np.zeros((e.max_instep_copies,), np.int32)
             for n in ("copy_src", "copy_dst")}
    views.update({n: np.zeros((e.max_instep_swaps,), np.int32)
                  for n in ("swap_k_dst", "swap_v_dst")})
    ops = eng._fold_page_ops(views)
    apply_swap_ins(eng.k_pools, eng.v_pools,
                   torch.from_numpy(views["swap_k_dst"]),
                   torch.from_numpy(views["swap_v_dst"]), ops["swap_k"],
                   ops["swap_v"], ops["swap_k_scale"], ops["swap_v_scale"])
    for pools in (eng.k_pools, eng.v_pools):
        assert pools[:, slot].abs().max() > 0
        for dst in free[:2]:
            np.testing.assert_array_equal(_bits(pools[:, dst]),
                                          _bits(pools[:, slot]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("payload", ["fp", "q8"])
def test_swap_out_hands_a_copy_of_the_page(small, payload, dtype):
    """At one layer a pool page is one contiguous slice: what ``swap_out``
    hands the host tier must still be a copy, or the next KV write into
    the reallocated page would change the host's payload."""
    import dataclasses
    cfg = dataclasses.replace(scaled_config(small[0], dtype=dtype),
                              n_layers=1)
    tp = params_from_numpy(jax.tree.map(
        np.asarray, j_init(cfg, jax.random.PRNGKey(0))), device="cpu")
    eng = P.Engine(cfg, P.EngineConfig(num_pages=8, swap_payload=payload),
                   tp, device="cpu")
    eng.k_pools[:, 3] = 1.0
    eng.v_pools[:, 3] = 2.0
    k, v = eng.swap_out(3)
    before = (k.copy(), v.copy())
    eng.k_pools.zero_()
    eng.v_pools.zero_()
    np.testing.assert_array_equal(k, before[0])
    np.testing.assert_array_equal(v, before[1])
    assert (k.dtype == np.float32) == (payload == "q8" or dtype == "float32")
