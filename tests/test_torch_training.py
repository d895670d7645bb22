"""The port's training substrate (``repro_torch.training``, the launcher
``repro_torch.launch.train``) against the JAX package's
(``repro.training``), and the JAX package's own training tests as port
tests.  Everything on the CPU at float32 unless a test says otherwise.

Tolerances:
  * one AdamW / Adafactor update from the same params, grads and state
    (the state carried across by the weight bridge): params, moments and
    factored statistics within 1e-6 of max |ref| (float32 elementwise
    arithmetic in another order);
  * grad_accum 2 against 1: the loss within 1e-5 relative, params within
    5e-5 (the JAX package's own bounds, ``tests/test_training.py``);
  * the bf16 accumulator against the JAX package's bf16 accumulator:
    every gradient leaf within 1e-2 of max |ref| (a bf16 step is 2^-8
    relative; float32 gradients 1e-6 apart can round to neighbouring
    bf16 values); the float32 accumulator's within 1e-4, as
    ``test_torch_train_grads.py``;
  * data, float32 checkpoints across the packages and bf16 checkpoints
    in the port: the same bits.
One intra-op thread."""
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs import scaled_config as j_scaled
from repro.models import init_params as j_init_params
from repro import training as jt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config, scaled_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.training import (DataConfig, Optimizer, SyntheticLM,
                                  TrainConfig, Trainer, adafactor, adamw,
                                  checkpoint, for_arch, make_train_step)
from repro_torch.training.optimizer import leaves

TINY_FIELDS = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
                   tie_embeddings=True, dtype="float32")
TINY = ModelConfig(**TINY_FIELDS)
J_TINY = JModelConfig(**TINY_FIELDS)
OPT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{path: numpy array} of a JAX or port tree."""
    return {k: (v.detach().float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32)) for k, v in leaves(tree)}


def _assert_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = float(np.max(np.abs(got[k] - w))) if w.size else 0.0
        assert err <= tol * max(float(np.max(np.abs(w))), 1e-30), (k, err)


def _assert_same_bits(got, want):
    """Two trees of tensors (or a tree of tensors against one of numpy
    arrays) with the same dtypes and bits."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if not torch.is_tensor(w):
            w = params_from_numpy({"x": np.asarray(w)}, device="cpu")["x"]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.view(torch.uint8) if g.element_size() == 1
                           else g, w), k


def _grads_like(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 0.1), params)


# ---------------------------------------------------------------------------
# Optimizers against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(name):
    """Two JAX updates make a non-trivial state; the bridge carries params,
    state and the third step's grads across; one update each."""
    j_opt = jt.adamw(lr=1e-2) if name == "adamw" else jt.adafactor(
        lr=1e-2, weight_decay=0.01)
    t_opt = adamw(lr=1e-2) if name == "adamw" else adafactor(
        lr=1e-2, weight_decay=0.01)
    params = j_init_params(J_TINY, jax.random.PRNGKey(0))
    state = j_opt.init(params)
    for step in range(2):
        params, state = j_opt.update(_grads_like(params, step), state,
                                     params, jnp.int32(step))
    grads = _grads_like(params, 7)
    tp = params_from_numpy(_np_tree(params), device="cpu")
    ts = params_from_numpy(_np_tree(state), device="cpu")
    _assert_same_bits(ts, _np_tree(state))      # the bridge carries state
    tg = params_from_numpy(_np_tree(grads), device="cpu")
    want_p, want_s = j_opt.update(grads, state, params, jnp.int32(2))
    got_p, got_s = t_opt.update(tg, ts, tp, 2)
    assert got_p is tp and got_s is ts          # in place
    _assert_close(got_p, want_p, OPT_TOL)
    _assert_close(got_s, want_s, OPT_TOL)


def test_adafactor_state_is_factored():
    params = init_params(TINY, seed=0, device="cpu")
    state = adafactor().init(params)
    w1_state = state["blocks"]["w1"]
    assert set(w1_state) == {"vr", "vc"}
    assert w1_state["vr"].shape == params["blocks"]["w1"].shape[:-1]
    assert w1_state["vc"].shape == (params["blocks"]["w1"].shape[0],
                                    params["blocks"]["w1"].shape[-1])
    assert set(state["final_norm"]) == {"v"}
    j_state = jt.adafactor().init(j_init_params(J_TINY,
                                                jax.random.PRNGKey(0)))
    assert jax.tree.map(np.shape, j_state) == jax.tree.map(
        lambda t: tuple(t.shape), state)


def test_for_arch_thresholds():
    for n in (8e9, 30e9 - 1, 30e9, 314e9):
        assert for_arch(n).name == jt.for_arch(n).name
    assert for_arch(8e9).name == "adamw"
    assert for_arch(314e9).name == "adafactor"


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _recording():
    """An optimizer whose update leaves the params and returns the grads
    as its state: the step's gradients, after accumulation."""
    return Optimizer(init=lambda p: {}, name="record",
                     update=lambda g, s, p, step: (p, g))


def _j_recording():
    return jt.Optimizer(init=lambda p: {}, name="record",
                        update=lambda g, s, p, step: (p, g))


def test_grad_accum_equivalence():
    """accum 2 against 1 on the same global batch, after one AdamW step."""
    params = init_params(TINY, seed=0, device="cpu")
    opt = adamw(lr=1e-3)
    batch = SyntheticLM(TINY, DataConfig(seq_len=32, global_batch=4, seed=7),
                        device="cpu").batch_at(0)
    outs = []
    for accum in (1, 2):
        p = {k: (v.clone() if torch.is_tensor(v)
                 else {n: t.clone() for n, t in v.items()})
             for k, v in params.items()}
        p, _, m = make_train_step(TINY, opt, grad_accum=accum)(
            p, opt.init(p), batch, 0)
        outs.append((float(m["loss"]), p))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5)
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        leaves(outs[0][1]), leaves(outs[1][1])))
    assert worst < 5e-5, worst


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_accumulated_grads_match_jax(accum_dtype):
    """grad_accum 2 on a float32 smoke config: the accumulated gradients
    in the accumulator's dtype (float32, or bf16 as the >= 100B configs
    accumulate), the loss and the grad norm, against the JAX package's.
    The model stays float32, so the microbatches' gradients agree to
    1e-6 and what the bf16 case measures is the accumulator."""
    jcfg = j_scaled(j_smoke("granite-3-8b"), dtype="float32")
    cfg = scaled_config(get_smoke_config("granite-3-8b"), dtype="float32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    dcfg = DataConfig(seq_len=24, global_batch=4, seed=3)
    jbatch = jt.SyntheticLM(jcfg, dcfg).batch_at(0)
    batch = SyntheticLM(cfg, dcfg, device="cpu").batch_at(0)
    _, want, jm = jax.jit(jt.make_train_step(
        jcfg, _j_recording(), grad_accum=2,
        accum_dtype=getattr(jnp, accum_dtype)))(jp, {}, jbatch,
                                                jnp.int32(0))
    _, got, m = make_train_step(cfg, _recording(), grad_accum=2,
                                accum_dtype=getattr(torch, accum_dtype))(
        tp, {}, batch, 0)
    for k, g in leaves(got):
        assert g.dtype == getattr(torch, accum_dtype), k
    tol = 1e-2 if accum_dtype == "bfloat16" else 1e-4
    _assert_close(got, want, tol)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=tol)
    assert m["step"] == 1


def _run_steps(opt, steps=12, grad_accum=1, cfg=TINY, seed=0):
    tr = Trainer(cfg, TrainConfig(steps=steps, grad_accum=grad_accum,
                                  seed=seed),
                 DataConfig(seq_len=32, global_batch=4, seed=7), opt=opt,
                 device="cpu")
    hist = tr.run()
    return [h["loss"] for h in hist if "loss" in h], tr


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_loss_decreases(opt_name):
    opt = adamw(lr=3e-3) if opt_name == "adamw" else adafactor(lr=3e-2)
    losses, tr = _run_steps(opt, steps=20)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert all(np.isfinite(h["grad_norm"]) for h in tr.history
               if "grad_norm" in h)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "llava-next-34b",
                                  "whisper-large-v3"])
def test_synthetic_lm_matches_jax(arch):
    """tokens, labels, embeds (a VLM) and enc_embeds (an encoder-decoder)
    bit for bit, for several (step, shard, n_shards)."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    dcfg = DataConfig(seq_len=16, global_batch=4, seed=5)
    jd = jt.SyntheticLM(jcfg, jt.DataConfig(seq_len=16, global_batch=4,
                                            seed=5))
    td = SyntheticLM(cfg, dcfg, device="cpu")
    for step, shard, n in ((0, 0, 1), (3, 0, 1), (3, 1, 2), (11, 3, 4)):
        want = jd.batch_at(step, shard, n)
        got = td.batch_at(step, shard, n)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.shape == w.shape, k
            if k in ("tokens", "labels"):
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(g, w.astype(np.int64))
            else:
                assert g.dtype == w.dtype == np.float32
                assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_data_determinism_and_sharding():
    data = SyntheticLM(TINY, DataConfig(seq_len=16, global_batch=8, seed=5),
                       device="cpu")
    assert torch.equal(data.batch_at(3)["tokens"], data.batch_at(3)["tokens"])
    s0 = data.batch_at(3, shard=0, n_shards=2)
    s1 = data.batch_at(3, shard=1, n_shards=2)
    assert s0["tokens"].shape[0] == 4
    assert not torch.equal(s0["tokens"], s1["tokens"])
    assert torch.equal(s0["tokens"], data.batch_at(3, 0, 2)["tokens"])
    with pytest.raises(ValueError):
        data.batch_at(0, 0, 3)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tiny_state(opt_name="adamw"):
    jp = j_init_params(J_TINY, jax.random.PRNGKey(0))
    j_opt = jt.adamw() if opt_name == "adamw" else jt.adafactor()
    js = j_opt.init(jp)
    jp, js = j_opt.update(_grads_like(jp, 0), js, jp, jnp.int32(0))
    return _np_tree(jp), _np_tree(js)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_float32_checkpoints_cross_load(opt_name):
    """A float32 checkpoint written by either package loads in the other
    with the same bits."""
    jp, js = _tiny_state(opt_name)
    with tempfile.TemporaryDirectory() as d:
        jt.checkpoint.save(os.path.join(d, "jax"), 5, jp, js,
                           extra={"data_seed": 17})
        p, s, meta = checkpoint.load(os.path.join(d, "jax"), device="cpu")
        assert meta["step"] == 5 and meta["data_seed"] == 17
        _assert_same_bits(p, jp)
        _assert_same_bits(s, js)
        checkpoint.save(os.path.join(d, "port"), 6, p, s)
        p2, s2, meta2 = jt.checkpoint.load(os.path.join(d, "port"))
        assert meta2["step"] == 6
        for tree, want in ((p2, jp), (s2, js)):
            got = dict(leaves(tree))
            for k, w in leaves(want):
                assert got[k].dtype == w.dtype == np.float32, k
                assert np.array_equal(got[k].view(np.int32),
                                      w.view(np.int32)), k


def test_bf16_checkpoint_round_trip():
    """bf16 parameters (with their float32 moments) save and load in the
    port with the same bits and dtypes, every leaf's dtype in meta.json."""
    cfg = ModelConfig(**dict(TINY_FIELDS, dtype="bfloat16"))
    params = init_params(cfg, seed=1, device="cpu")
    opt = adamw()
    state = opt.init(params)
    grads = {k: (torch.randn_like(v) if torch.is_tensor(v)
                 else {n: torch.randn_like(t) for n, t in v.items()})
             for k, v in params.items()}
    opt.update(grads, state, params, 0)
    with tempfile.TemporaryDirectory() as d:
        path = checkpoint.save(d, 1, params, state)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        assert meta["dtypes"]["params"]["blocks/wq"] == "bfloat16"
        assert meta["dtypes"]["opt_state"]["m/blocks/wq"] == "float32"
        p, s, _ = checkpoint.load(d, device="cpu")
    _assert_same_bits(p, params)
    _assert_same_bits(s, state)


def test_reads_jax_bf16_leaf():
    """The JAX package's np.savez writes an ml_dtypes bf16 leaf that
    reloads as two raw bytes (|V2); the port reads it as bf16."""
    rng = np.random.RandomState(0)
    leaf = jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32),
                       jnp.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        jt.checkpoint.save(d, 2, {"w": leaf}, {"m": {"w": jnp.zeros(3)}})
        with np.load(os.path.join(d, "step_000000002", "params.npz")) as z:
            assert z["w"].dtype.kind == "V"
        p, s, _ = checkpoint.load(d, device="cpu")
    assert p["w"].dtype == torch.bfloat16
    want = np.asarray(leaf).view(np.int16)
    assert np.array_equal(p["w"].view(torch.int16).numpy(), want)
    assert s["m"]["w"].dtype == torch.float32


def test_checkpoint_roundtrip_and_retention():
    with tempfile.TemporaryDirectory() as d:
        params = init_params(TINY, seed=0, device="cpu")
        state = adamw().init(params)
        for step in (10, 20, 30, 40):
            checkpoint.save(d, step, params, state, keep=2)
        assert checkpoint.all_steps(d) == [30, 40]
        p2, _, meta = checkpoint.load(d, device="cpu")
        assert meta["step"] == 40
        _assert_same_bits(p2, params)
        # idempotent: a published step is not written again
        path = checkpoint.save(d, 40, init_params(TINY, seed=9,
                                                  device="cpu"), state)
        assert path.endswith("step_000000040")
        _assert_same_bits(checkpoint.load(d, device="cpu")[0], params)


def test_checkpoint_atomicity_on_partial_write():
    """A stale .tmp directory (a crash mid-write) is not a checkpoint, and
    a re-save succeeds."""
    with tempfile.TemporaryDirectory() as d:
        params = init_params(TINY, seed=0, device="cpu")
        state = adamw().init(params)
        os.makedirs(os.path.join(d, "step_000000010.tmp"))
        assert checkpoint.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            checkpoint.load(d, device="cpu")
        checkpoint.save(d, 10, params, state)
        assert checkpoint.latest_step(d) == 10
        assert not os.path.exists(os.path.join(d, "step_000000010.tmp"))


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------

def test_resume_continues_deterministically():
    with tempfile.TemporaryDirectory() as d:
        def trainer():
            return Trainer(TINY, TrainConfig(steps=10, ckpt_every=5,
                                             ckpt_dir=d, seed=3),
                           DataConfig(seq_len=32, global_batch=4),
                           opt=adamw(lr=1e-3), device="cpu")
        t1 = trainer()
        h1 = t1.run()
        # a fresh trainer resuming from the step-5 checkpoint lands on
        # the same step-10 params, with the same bits
        shutil.rmtree(os.path.join(d, "step_000000010"))
        t2 = trainer()
        assert t2.init_or_resume() == 5
        h2 = t2.run()
        assert [h["loss"] for h in h2] == [h["loss"] for h in h1[5:]]
        _assert_same_bits(t2.params, t1.params)
        _assert_same_bits(t2.opt_state, t1.opt_state)


def test_trainer_on_jax_weights_matches_jax_trainer():
    """The same initial params and data through both trainers (three
    AdamW steps): the losses within 1e-5 relative, the params within the
    JAX package's own 5e-5 (``tests/test_training.py``: AdamW's
    m / sqrt(v) ~ sign(g) lifts float32 noise on near-zero gradients to
    the scale of lr)."""
    tcfg = dict(steps=3, seed=0)
    jtr = jt.Trainer(J_TINY, jt.TrainConfig(**tcfg),
                     jt.DataConfig(seq_len=16, global_batch=4, seed=2),
                     opt=jt.adamw(lr=1e-3))
    jtr.init_or_resume()
    tr = Trainer(TINY, TrainConfig(**tcfg),
                 DataConfig(seq_len=16, global_batch=4, seed=2),
                 opt=adamw(lr=1e-3), device="cpu")
    tr.init_or_resume()
    tr.params = params_from_numpy(_np_tree(jtr.params), device="cpu")
    tr.opt_state = tr.opt.init(tr.params)
    jh, h = jtr.run(), tr.run()
    np.testing.assert_allclose([x["loss"] for x in h],
                               [x["loss"] for x in jh], rtol=1e-5)
    worst = max(float(np.max(np.abs(g - w))) for g, w in zip(
        _flat(tr.params).values(), _flat(jtr.params).values()))
    assert worst < 5e-5, worst


def test_launcher_trains_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "granite-3-8b", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--ckpt-dir", d]
        assert launch_train.main(argv) == 0
        assert "steps 0->3" in capsys.readouterr().out
        assert checkpoint.latest_step(d) == 3
        argv[3] = "5"
        assert launch_train.main(argv) == 0
        assert "steps 3->5" in capsys.readouterr().out


def test_launcher_dry_run_writes_ok_record(monkeypatch, tmp_path, capsys):
    """``--dry-run`` dry-runs the arch's full-scale train_4k step on the
    production mesh (meta device, no card) and exits 0 on an ok record."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert launch_train.main(["--arch", "granite-3-8b", "--dry-run"]) == 0
    assert "OK" in capsys.readouterr().out
    rec = json.loads((tmp_path / "granite-3-8b__train_4k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 256 and rec["memory"]["argument_bytes"] > 0
    assert rec["costs_per_device"]["flops"] > 0


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TINY, TrainConfig(steps=1), DataConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(TINY, DataConfig())
