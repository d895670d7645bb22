"""The serving launcher (``python -m repro_torch.launch.serve``) on the
CPU: ``real`` (every request finishes; first logits within 2e-3 of the
dense ``reference_logits``, the repo-wide losslessness bar), ``online``
(every agentic session finishes, the pool drains), ``--devices 2
--device cpu`` (two shards on the CPU, the same bar), the refusals of
``cuda`` without the cards, and ``sim``, whose output with the TPU v5e
constants is the JAX package's launcher's, key for key (the reference
runs in a child process; only the host-clock keys ``wall_time`` and
``control_plane_time`` differ from run to run).  One intra-op thread,
as ``test_torch_models.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import assert_drained
from repro_torch.core import H100, TPU_V5E
from repro_torch.launch.serve import main, parse_args, serve
from repro_torch.models import init_params
from repro_torch.serving import RequestState, SessionState, reference_logits

LOSSLESS_REL_TOL = 2e-3
HOST_CLOCK = ("wall_time", "control_plane_time")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1e-9, float(np.max(np.abs(b))))


def _summary(text):
    """The launcher's ``key: value`` lines as an ordered dict."""
    out = {}
    for line in text.splitlines():
        key, sep, val = line.partition(": ")
        if sep and not line.startswith("note:"):
            out[key] = val
    return out


@pytest.mark.parametrize("devices", [1, 2])
def test_real_mode_is_lossless(devices):
    argv = ["--mode", "real", "--device", "cpu", "--devices", str(devices)]
    srv, wl, res = serve(parse_args(argv))
    assert srv.engine.n_shards == devices
    assert res["n_requests"] == len(wl) > 0 and res["n_failed"] == 0
    assert all(r.state is RequestState.FINISHED for r in wl)
    assert_drained(srv)
    params = init_params(srv.cfg, seed=0, device="cpu")    # the same draw
    for r in wl:
        ref = reference_logits(srv.cfg, params, r.prompt_tokens)
        assert _rel(r.first_logits, ref) < LOSSLESS_REL_TOL, r.rid


def test_online_mode_finishes_every_session():
    srv, fe, res = serve(parse_args(["--mode", "online", "--device", "cpu"]))
    assert res["closed_loop"] and res["n_failed"] == 0
    assert all(s.state is SessionState.FINISHED for s in fe.sessions)
    assert res["n_turns"] == sum(len(s.requests) for s in fe.sessions) > 0
    assert_drained(srv)


def test_main_prints_the_summary(capsys):
    assert main(["--mode", "real", "--device", "cpu", "--devices", "2",
                 "--blocks", "63"]) == 0
    out = capsys.readouterr().out
    assert "note: --blocks 63 adjusted to 62" in out
    summary = _summary(out)
    assert summary["n_failed"] == "0" and int(summary["n_requests"]) > 0


@pytest.mark.parametrize("argv", [["--mode", "real"],
                                  ["--mode", "online"],
                                  ["--mode", "real", "--devices", "2"]])
def test_cuda_without_the_cards_is_refused(argv, capsys):
    """``--device cuda`` (the default) never falls back: with too few
    cards the launcher names what is missing and exits non-zero."""
    want = 2 if "--devices" in argv else 1
    if torch.cuda.device_count() >= want:
        pytest.skip(f"this machine has {want} or more cards")
    assert main(argv) != 0
    err = capsys.readouterr().err
    assert "CUDA" in err or "cuda" in err


def test_sim_mode_prints_what_the_reference_prints(capsys):
    """With the TPU v5e constants the port's ``sim`` is the JAX
    package's ``python -m repro.launch.serve --mode sim``: the same keys
    in the same order, the same values but for the host clock's."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                          "--mode", "sim"], capture_output=True, text=True,
                         env=env, timeout=600)
    assert ref.returncode == 0, ref.stderr
    want = _summary(ref.stdout)
    assert main(["--mode", "sim"], hardware=TPU_V5E) == 0
    got = _summary(capsys.readouterr().out)
    assert list(got) == list(want) and len(got) > 50
    for key in HOST_CLOCK:
        got.pop(key), want.pop(key)
    assert got == want
    # the card's constants give another schedule's clock
    assert main(["--mode", "sim"], hardware=H100) == 0
    h100 = _summary(capsys.readouterr().out)
    assert h100["n_requests"] == got["n_requests"]
    assert float(h100["sim_time"]) != float(got["sim_time"])
