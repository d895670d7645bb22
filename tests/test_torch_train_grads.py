"""Gradients of the port's loss (``repro_torch.models.loss_fn`` under
autograd) against the JAX package's ``jax.value_and_grad(loss_fn)`` on
every architecture's smoke config at float32: the same JAX weights
through the weight bridge (wq/wk rescaled to fan-in, as
``test_torch_models.py`` does), the same numpy batch, both with each
layer remat'd.  And remat on against off in the port, bit for bit.

Tolerances: the loss within 1e-5 relative; every gradient leaf within
max |diff| / max |ref| <= 1e-4 (float32 gradients of a 2-6 layer model,
summed in another order: ten times the forward's 1e-5, for the backward's
longer chains of sums).  One intra-op thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs import scaled_config as j_scaled
from repro.models import model as jm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS
from repro_torch.training.optimizer import leaves
from repro_torch.training.train_step import value_and_grad

ARCHS = ARCH_IDS + ("llama31-8b", "llama31-70b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    """(cfg, JAX params, the bridged copy) at float32, wq/wk (and
    xwq/xwk) rescaled to fan-in."""
    cfg = j_scaled(j_smoke(arch), dtype="float32")
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    fan_in = float(np.sqrt(max(cfg.n_heads, 1) / cfg.d_model))
    for name in ("wq", "wk", "xwq", "xwk"):
        if name in jp["blocks"]:
            jp["blocks"][name] = jp["blocks"][name] * fan_in
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"][0, :3] = -1                      # ignored positions
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg, jp, tp = _models(arch)
    batch = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, cfg, b)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = dict(leaves(jax.tree.map(np.asarray, want)))
    loss, got = value_and_grad(tp, cfg, _torch_batch(batch), remat=True)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_same_bits(arch):
    cfg, _, tp = _models(arch)
    batch = _torch_batch(_batch(cfg, seed=1))
    loss_on, on = value_and_grad(tp, cfg, batch, remat=True)
    loss_off, off = value_and_grad(tp, cfg, batch, remat=False)
    assert torch.equal(loss_on, loss_off)
    for name in on:
        assert torch.equal(on[name], off[name]), name
