"""Mamba2-780m at full width and depth (48 layers, d 1536, 2 x 512
tokens), the port on the card against the reference on the same weights:
the reference's seed-0 ``init_params`` in bf16, carried over by the
weight bridge.

In bf16 a deep SSM's chunked scan (``forward``) and its one-token
recurrence (``decode_step``) round in different places, and with random
weights the gap grows with depth, in the reference as in the port.  This
test measures that gap in both packages on the same weights and inputs,
and holds the port's to the reference's (1.5x, as the smoke-size test
``test_ssm_bf16_decode_drifts_no_more_than_the_reference`` does); the
reference's reading is the bar of ``chip_smoke.py`` phase 9 for this
model in bf16.  It prints one JSON line with both packages' readings.

The reference runs jitted on the host's CPU (its float32 copy of the
weights and its scans take ~10 GB of host memory, and a 512-step decode
of 48 layers takes minutes); the port runs on the card, with TF32 off.
Marked ``cuda``: it skips without a card.  Run on the card's machine
with ``JAX_PLATFORMS=cpu python -m pytest -q -s
tests/test_torch_full_width.py``."""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.models import model as jm
from repro_torch.bridge import params_from_numpy
from repro_torch.models import decode_step, forward, init_decode_state

pytestmark = pytest.mark.cuda

B, S = 2, 512


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _reference(cfg, jp, toks):
    """The reference's bf16 forward, its float32 forward on the same
    (upcast) weights, and its bf16 teacher-forced decode from position 0,
    as float32 numpy (B, S, V); and the seconds each took."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    t = jnp.asarray(toks)
    secs = {}
    t0 = time.perf_counter()
    fwd = np.asarray(jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t}))(
        jp, t).astype(jnp.float32))
    secs["forward"] = time.perf_counter() - t0
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    exact = np.asarray(jax.jit(
        lambda p, t: jm.forward(p, f32, {"tokens": t}))(jp32, t))
    del jp32
    t0 = time.perf_counter()
    step = jax.jit(lambda p, st, t: jm.decode_step(p, cfg, st, t))
    st, dec = jm.init_decode_state(cfg, B, S), []
    for i in range(S):
        lg, st = step(jp, st, t[:, i])
        dec.append(np.asarray(lg.astype(jnp.float32)))
    secs["decode"] = time.perf_counter() - t0
    return fwd, exact, np.stack(dec, 1), secs


def _port(cfg, weights, toks):
    """The same three on the card, as float32 numpy."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    t = torch.from_numpy(toks).long().cuda()
    with torch.inference_mode():
        tp = params_from_numpy(weights, device="cuda")
        fwd = forward(tp, cfg, {"tokens": t}).float().cpu().numpy()
        st, dec = init_decode_state(cfg, B, S, device="cuda"), []
        for i in range(S):
            lg, st = decode_step(tp, cfg, st, t[:, i])
            dec.append(lg.float())
        dec = torch.stack(dec, 1).cpu().numpy()
        del tp, st
        tp32 = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), weights),
            device="cuda")
        exact = forward(tp32, f32, {"tokens": t}).cpu().numpy()
    del tp32
    torch.cuda.empty_cache()
    return fwd, exact, dec


def test_mamba2_bf16_drift_at_full_width_matches_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(j_get("mamba2-780m"), dtype="bfloat16")
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        jp = jm.init_params(cfg, jax.random.PRNGKey(0))
        weights = jax.tree.map(np.asarray, jp)
        j_fwd, j_exact, j_dec, secs = _reference(cfg, jp, toks)
    del jp
    t_fwd, t_exact, t_dec = _port(cfg, weights, toks)
    line = {"model": cfg.name, "layers": cfg.n_layers, "batch": B,
            "tokens": S, "device": torch.cuda.get_device_name(0),
            "reference_seconds": secs}
    for name, (fwd, exact, dec) in (("reference", (j_fwd, j_exact, j_dec)),
                                    ("port", (t_fwd, t_exact, t_dec))):
        line[name] = {
            "forward_vs_float32": _rel(fwd, exact),
            "decode_vs_forward": _rel(dec, fwd),
            "decode_vs_float32": _rel(dec, exact),
            "argmax_equal_share": float(
                (dec.argmax(-1) == fwd.argmax(-1)).mean())}
    line["float32_forward_port_vs_reference"] = _rel(t_exact, j_exact)
    print("full_width_ssm: " + json.dumps(line), flush=True)
    ref, got = line["reference"], line["port"]
    # float32: the JAX package's own bar (tests/test_models.py)
    assert line["float32_forward_port_vs_reference"] < 2e-3, line
    for key in ("forward_vs_float32", "decode_vs_forward"):
        assert got[key] < max(2e-2, 1.5 * ref[key]), (key, line)
