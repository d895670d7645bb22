"""``repro_torch.examples.train_lm`` on the CPU: the reference's model
configuration, and a run cut at a checkpoint and resumed that gives the
bits of an uninterrupted one."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.examples import train_lm
from repro_torch.models import init_params
from repro_torch.training import latest_step

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_100m_is_the_reference_config():
    spec = importlib.util.spec_from_file_location(
        "_reference_train_lm", os.path.join(REPO, "examples", "train_lm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert dataclasses.asdict(train_lm.CONFIG_100M) == \
        dataclasses.asdict(ref.CONFIG_100M)
    assert train_lm.CONFIG_100M.param_count() == \
        ref.CONFIG_100M.param_count()
    # the reference's --tiny
    tiny = dataclasses.replace(ref.CONFIG_100M, name="demo-25m", n_layers=6,
                               d_model=384, n_heads=6, n_kv_heads=2,
                               d_ff=1024)
    assert dataclasses.asdict(train_lm.CONFIG_TINY) == \
        dataclasses.asdict(tiny)


def _checkpoint_arrays(ckpt_dir, step):
    out = {}
    for part in ("params", "opt_state"):
        path = os.path.join(ckpt_dir, f"step_{step:09d}", f"{part}.npz")
        with np.load(path) as z:
            out.update({f"{part}/{k}": z[k] for k in z.files})
    return out


def test_resumed_run_gives_the_bits_of_one_run(tmp_path, capsys):
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    argv = ["--tiny", "--device", "cpu", "--ckpt-dir", cut]
    assert train_lm.main(argv + ["--steps", "2"]) == 0
    assert latest_step(cut) == 2
    assert train_lm.main(argv + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out
    assert "steps 2->3" in out
    # the whole run starts from weights the caller passes (the same draw
    # the trainer makes), the cut one from the trainer's own
    params = init_params(train_lm.CONFIG_TINY, seed=0, device="cpu")
    res = train_lm.run(train_lm.CONFIG_TINY, params, steps=3,
                       ckpt_dir=whole, batch=4, seq=128, device="cpu")
    assert (res["start"], res["step"], len(res["losses"])) == (0, 3, 3)
    assert all(np.isfinite(res["losses"]))
    a, b = _checkpoint_arrays(cut, 3), _checkpoint_arrays(whole, 3)
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
