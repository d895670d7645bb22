"""Port vs reference for the full model (``repro_torch.models`` against
``repro.models``) on every architecture's smoke config: the same JAX
weights through the weight bridge, the same inputs made from a numpy
seed; the full-sequence forward (logits, each layer's K/V, last-position
logits), the loss, 24 teacher-forced decode steps (logits and every state
tensor), the banded forward under the reference's ``banded_attention``
flag, and the layers underneath (chunked, banded and decode attention,
the Mamba-2 SSD and its convolution, sinusoidal positions).

Tolerances, as max |diff| / max |ref|: 1e-5 at float32 (the repo's kernel
tolerance, ``tests/test_kernels.py``: the same float32 algorithm, summed
in another order), 2e-2 at bfloat16 (forward only: both round to bf16 at
every step, in places that differ by a rounding).  The reference runs
jitted on the CPU.  One intra-op thread, as ``test_torch_sharded.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs import scaled_config as j_scaled
from repro.distributed.context import DistContext, use_dist
from repro.launch.mesh import make_debug_mesh
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_smoke_config, scaled_config
from repro_torch.models import (decode_step, forward, init_decode_state,
                                loss_fn, prep_cross_attention)
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

ARCHS = ARCH_IDS + ("llama31-8b", "llama31-70b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        1e-30, float(np.max(np.abs(want))))


def _models(arch, dtype="float32"):
    """(cfg, JAX params, the bridged copy), with wq/wk (and xwq/xwk)
    rescaled to fan-in."""
    cfg = j_scaled(j_smoke(arch), dtype=dtype)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    fan_in = float(np.sqrt(max(cfg.n_heads, 1) / cfg.d_model))
    for name in ("wq", "wk", "xwq", "xwk"):
        if name in jp["blocks"]:
            jp["blocks"][name] = (jp["blocks"][name] * fan_in).astype(
                jp["blocks"][name].dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _batch(cfg, seed=0, s=S):
    """Numpy inputs for one forward: tokens (or embeddings for a
    VLM), the encoder's embeddings for an encoder-decoder, labels."""
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    b["labels"][0, :3] = -1                      # ignored positions
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal(
            (B, s, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    out["labels"] = out["labels"].long()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_kv_and_loss_match_jax(arch):
    cfg, jp, tp = _models(arch)
    batch = _batch(cfg)
    want, want_kv = jax.jit(
        lambda p, b: jm.forward(p, cfg, b, return_kv=True))(jp, _jax(batch))
    want_loss = jax.jit(lambda p, b: jm.loss_fn(p, cfg, b))(jp, _jax(batch))
    with torch.no_grad():
        got, got_kv = forward(tp, cfg, _torch(batch), return_kv=True)
        last = forward(tp, cfg, _torch(batch), last_only=True)
        loss = loss_fn(tp, cfg, _torch(batch))
    assert got.shape == (B, S, cfg.vocab_size)
    assert _rel(got, want) < TOL["float32"]
    assert _rel(last, np.asarray(want)[:, -1:]) < TOL["float32"]
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    if cfg.family == "ssm":
        assert got_kv is None and want_kv is None
    else:
        for g, w in zip(got_kv, want_kv):
            assert g.shape == (cfg.n_layers, B, S, cfg.n_kv_heads,
                               cfg.head_dim)
            assert _rel(g, w) < TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    """bf16 logits against the reference's: within 2e-2, or within 1.5x
    the reference's own bf16 error where that is larger (its distance
    from its float32 forward on the same bf16 weights: 2.1e-2 on the
    Mamba-2 smoke model, where the two packages' bf16 logits are 2.3e-2
    apart; XLA's CPU backend also rounds each sigmoid to bf16 after each
    of its exp, add and divide); and no further than that bar from the
    float32 forward."""
    cfg, jp, tp = _models(arch, "bfloat16")
    batch = _batch(cfg, seed=1)
    want = jax.jit(lambda p, b: jm.forward(p, cfg, b))(jp, _jax(batch))
    cfg32 = j_scaled(cfg, dtype="float32")
    exact = jax.jit(lambda p, b: jm.forward(p, cfg32, b))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), _jax(batch))
    want = np.asarray(want.astype(jnp.float32))
    bar = max(TOL["bfloat16"], 1.5 * _rel(want, exact))
    with torch.no_grad():
        got = forward(tp, cfg, _torch(batch))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < bar
    assert _rel(got, exact) < bar


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """24 teacher-forced steps from position 0 in both packages: the
    logits of each step and, after the last, every state tensor; the
    steps also hold to the port's own forward (the reference's bar,
    ``tests/test_models.py``: 2e-3)."""
    cfg, jp, tp = _models(arch)
    batch = _batch(cfg, seed=2)
    toks = batch["tokens"]
    jst = jm.init_decode_state(cfg, B, S + 4)
    tst = init_decode_state(cfg, B, S + 4, device="cpu")
    assert set(tst) == set(jst)
    with torch.no_grad():
        if cfg.enc_dec:
            jst = jm.prep_cross_attention(
                jp, cfg, jnp.asarray(batch["enc_embeds"]), jst)
            tst = prep_cross_attention(
                tp, cfg, torch.from_numpy(batch["enc_embeds"]), tst)
        step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
        outs = []
        for t in range(S):
            want, jst = step(jp, jst, jnp.asarray(toks[:, t]))
            got, tst = decode_step(tp, cfg, tst,
                                   torch.from_numpy(toks[:, t]).long())
            assert _rel(got, want) < TOL["float32"], t
            outs.append(got)
        full = forward(tp, cfg, {k: v for k, v in _torch(batch).items()
                                 if k != "embeds"})
    for key, w in jst.items():
        g = tst[key]
        assert g.dtype == getattr(torch, str(w.dtype)), key
        if key == "pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert _rel(g, w) < TOL["float32"], key
    assert _rel(torch.stack(outs, 1), full.numpy()) < 2e-3


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_bf16_decode_drifts_no_more_than_the_reference(arch):
    """At bf16 an SSM's chunked scan (the forward) and its one-token
    recurrence (``decode_step``) round in different places, so their
    logits drift apart in the reference too: the port's 24 teacher-forced
    bf16 steps stay within 1.5x the reference's own drift from its
    forward (or within 2e-2)."""
    cfg, jp, tp = _models(arch, "bfloat16")
    toks = _batch(cfg, seed=5)["tokens"]
    jfull = jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
    jst = jm.init_decode_state(cfg, B, S)
    tst = init_decode_state(cfg, B, S, device="cpu")
    jdec, tdec = [], []
    with torch.no_grad():
        tfull = forward(tp, cfg, {"tokens": torch.from_numpy(toks).long()})
        for t in range(S):
            lg, jst = step(jp, jst, jnp.asarray(toks[:, t]))
            jdec.append(np.asarray(lg.astype(jnp.float32)))
            lg, tst = decode_step(tp, cfg, tst,
                                  torch.from_numpy(toks[:, t]).long())
            tdec.append(lg)
    drift = _rel(np.stack(jdec, 1), np.asarray(jfull.astype(jnp.float32)))
    assert _rel(torch.stack(tdec, 1), tfull.float().numpy()) < max(
        TOL["bfloat16"], 1.5 * drift)


@pytest.mark.parametrize("arch,s", [("gemma3-12b", 48), ("hymba-1.5b", 48),
                                    ("hymba-1.5b", 1024)])
def test_banded_forward_matches_jax(arch, s, monkeypatch):
    """``banded=True`` against the reference under its
    ``banded_attention`` flag: local layers take the banded path at every
    length here (window 16, tile 16); a global layer at 1024 (tile 1024),
    the chunked path at 48."""
    cfg, jp, tp = _models(arch)
    b = 1 if s > 64 else B
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (b, s))
    with use_dist(DistContext(make_debug_mesh((1, 1)), {},
                              {"banded_attention": True})):
        want = jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t}))(
            jp, jnp.asarray(toks, jnp.int32))
    calls = []
    banded = tm.banded_flash_attention
    monkeypatch.setattr(tm, "banded_flash_attention",
                        lambda *a, **kw: calls.append(kw) or banded(*a, **kw))
    with torch.no_grad():
        t = {"tokens": torch.from_numpy(toks).long()}
        got = forward(tp, cfg, t, banded=True)
        plain = forward(tp, cfg, t, attn_chunk=64)
    windows = [w for w in tm._layer_windows(cfg, cfg.n_layers)
               if w > 0 or s % 1024 == 0]
    assert [kw["window"] for kw in calls] == windows
    assert _rel(got, want) < TOL["float32"]
    assert _rel(got, plain.numpy()) < TOL["float32"]


def test_loss_masks_the_padded_vocab():
    cfg, jp, tp = _models("llama31-8b")
    cfg = j_scaled(cfg, real_vocab=200)
    batch = _batch(cfg, seed=4)
    batch["labels"] %= 200
    want = jm.loss_fn(jp, cfg, _jax(batch))
    with torch.no_grad():
        got = loss_fn(tp, cfg, _torch(batch))
        unmasked = loss_fn(tp, j_scaled(cfg, real_vocab=0), _torch(batch))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(got) < float(unmasked)


def test_pure_sliding_window_cache_is_refused():
    """A window on every layer and no local:global ratio: the reference
    sizes the cache at the window and then overwrites its last slot once
    the position passes it (no ring buffer), so the port refuses a cache
    longer than the window.  Up to the window no slot is overwritten, and
    the port decodes such a cache as the reference does."""
    cfg, jp, tp = _models("llama31-8b")
    cfg = j_scaled(cfg, sliding_window=16, local_global_ratio=0)
    with pytest.raises(ValueError, match="sliding-window"):
        init_decode_state(cfg, 2, 64, device="cpu")
    for arch in ARCHS:                    # no config of the repo is one
        init_decode_state(get_smoke_config(arch), 1, 8, device="cpu")
    toks = _batch(cfg, seed=3, s=16)["tokens"]
    jst = jm.init_decode_state(cfg, B, 16)
    tst = init_decode_state(cfg, B, 16, device="cpu")
    assert tst["k"].shape == jst["k"].shape
    step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
    with torch.no_grad():
        for t in range(16):
            want, jst = step(jp, jst, jnp.asarray(toks[:, t]))
            got, tst = decode_step(tp, cfg, tst,
                                   torch.from_numpy(toks[:, t]).long())
            assert _rel(got, want) < TOL["float32"], t


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_flash_attention_matches_jax(chunk):
    """GQA (H 4 over KH 2), multi-segment positions (gaps), a padded kv
    tail (``kv_len``), causal with and without a window, softcap, and
    bidirectional; Sk not a multiple of the chunk."""
    rng = np.random.RandomState(chunk)
    b, sq, sk, h, kh, d = 2, 11, 37, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    kv_pos = np.sort(rng.choice(60, (b, sk), replace=True), axis=1).astype(
        np.int32)
    q_pos = kv_pos[:, -sq:] + rng.randint(0, 3, (b, sq)).astype(np.int32)
    kv_len = np.array([sk, sk - 5], np.int32)
    for causal, window, cap in [(True, None, 0.0), (True, 9, 0.0),
                                (True, 5, 30.0), (False, None, 5.0)]:
        want = jl.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
            window=None if window is None else jnp.int32(window),
            softcap=cap, kv_len=jnp.asarray(kv_len), chunk_size=chunk)
        got = tl.flash_attention(
            _t(q), _t(k), _t(v), _t(q_pos).long(), _t(kv_pos).long(),
            causal=causal, window=window, softcap=cap, kv_len=_t(kv_len),
            chunk_size=chunk)
        assert _rel(got, want) < TOL["float32"], (causal, window, cap)


@pytest.mark.parametrize("window,tile", [(0, 8), (0, 16), (12, 8),
                                         (16, 16)])
def test_banded_flash_attention_matches_jax(window, tile):
    rng = np.random.RandomState(window + tile)
    b, s, h, kh, d = 2, 48, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    want = jl.banded_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        softcap=20.0, q_tile=tile, kv_tile=tile)
    got = tl.banded_flash_attention(_t(q), _t(k), _t(v), window=window,
                                    softcap=20.0, q_tile=tile, kv_tile=tile)
    assert _rel(got, want) < TOL["float32"]
    pos = torch.arange(s)[None].expand(b, s)
    chunked = tl.flash_attention(_t(q), _t(k), _t(v), pos, pos,
                                 window=window or None, softcap=20.0,
                                 chunk_size=16)
    assert _rel(got, chunked.numpy()) < TOL["float32"]


def test_decode_attention_matches_jax():
    """A window (the slots ``idx >= kv_len - window``), window 0 (full),
    no window, softcap, rows of other lengths."""
    rng = np.random.RandomState(5)
    b, s, h, kh, d = 3, 40, 6, 2, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([1, 17, 40], np.int32)
    for window, cap in [(None, 0.0), (0, 0.0), (8, 0.0), (8, 10.0)]:
        want = jl.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kv_len),
            window=None if window is None else jnp.int32(window),
            softcap=cap)
        got = tl.decode_attention(_t(q), _t(k), _t(v), _t(kv_len),
                                  window=window, softcap=cap)
        assert _rel(got, want) < TOL["float32"], (window, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax_and_its_decode_steps(dtype):
    """Three chunks with an initial state, two heads a group: the chunked
    scan against the reference's, and against the one-token recurrence
    run over the same sequence (float32)."""
    rng = np.random.RandomState(6)
    b, l, h, p, g, n, chunk = 2, 24, 4, 8, 2, 6, 8
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B_, C_ = (rng.standard_normal((b, l, g, n)).astype(np.float32)
              for _ in range(2))
    st0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_st = jl.ssd_chunked(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(B_, jd), jnp.asarray(C_, jd), chunk,
        init_state=jnp.asarray(st0))
    y, st = tl.ssd_chunked(_t(x).to(td), _t(dt), _t(A), _t(B_).to(td),
                           _t(C_).to(td), chunk, init_state=_t(st0))
    assert y.dtype == td and st.dtype == torch.float32
    assert _rel(y, np.asarray(want_y.astype(jnp.float32))) < TOL[dtype]
    assert _rel(st, want_st) < TOL[dtype]
    if dtype == "float32":
        state, ys = _t(st0), []
        for t in range(l):
            yt, state = tl.ssd_decode_step(_t(x[:, t]), _t(dt[:, t]), _t(A),
                                           _t(B_[:, t]), _t(C_[:, t]), state)
            ys.append(yt)
        assert _rel(torch.stack(ys, 1), y.numpy()) < 1e-4
        assert _rel(state, st.numpy()) < 1e-4
        jy, jst = jl.ssd_decode_step(
            jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]), jnp.asarray(A),
            jnp.asarray(B_[:, 0]), jnp.asarray(C_[:, 0]), jnp.asarray(st0))
        ty, tst = tl.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A),
                                     _t(B_[:, 0]), _t(C_[:, 0]), _t(st0))
        assert _rel(ty, jy) < TOL[dtype] and _rel(tst, jst) < TOL[dtype]


def test_segsum_and_causal_conv1d_match_jax():
    rng = np.random.RandomState(7)
    a = rng.standard_normal((2, 3, 9)).astype(np.float32)
    want = np.asarray(jl.segsum(jnp.asarray(a)))
    got = tl.segsum(_t(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)
    b, l, c, k = 2, 10, 12, 4
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((c, k)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    want = jl.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = tl.causal_conv1d(_t(x), _t(w), _t(bias))
    assert _rel(got, want) < TOL["float32"]
    conv = torch.zeros((b, k - 1, c))
    jconv = jnp.zeros((b, k - 1, c))
    for t in range(l):
        yt, conv = tl.causal_conv1d_step(_t(x[:, t]), conv, _t(w), _t(bias))
        jy, jconv = jl.causal_conv1d_step(jnp.asarray(x[:, t]), jconv,
                                          jnp.asarray(w), jnp.asarray(bias))
        assert _rel(yt, jy) < TOL["float32"]
        assert _rel(yt, got[:, t].numpy()) < TOL["float32"]
    assert _rel(conv, jconv) < TOL["float32"]


def test_sinusoidal_positions_match_jax():
    """Each angle is position x frequency in float32 in both packages, so
    where an ``exp`` differs by an ulp the sines differ by up to the
    angle's own rounding: a few ulps of the angle, 2^-23 |angle| each."""
    pos = np.array([[0, 1, 5, 1499], [7, 300, 2, 3]], np.int32)
    for d in (64, 1280):
        want = np.asarray(jl.sinusoidal_positions(jnp.asarray(pos), d))
        got = tl.sinusoidal_positions(_t(pos), d)
        assert got.dtype == torch.float32
        half = d // 2
        freqs = np.exp(-np.log(10_000.0) * np.arange(half) / max(half - 1, 1))
        ang = np.abs(pos[..., None] * freqs)
        bound = 1e-6 + 4 * 2.0**-23 * np.concatenate([ang, ang], axis=-1)
        assert np.all(np.abs(got.numpy() - want) <= bound)
