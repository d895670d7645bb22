"""End-to-end runs of the harness at smoke size on the CPU (the plain
kernels): a cell added as new files and entries only, the reference
agreeing with the port, and ``correct`` false for each fault the timed
path can have and for the fp8 control; a windowed configuration that
brings its own reference module as new files, and that module with a
planted fault."""
import math
import time
from pathlib import Path

import pytest
import torch

from bench.harness import cell
from bench.harness.spec import Spec
from bench.tests import tiny

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny.make(tmp_path_factory.mktemp("bench")))


def _run(spec, name, traced=False, seconds=2.0, **kw):
    return cell.run(spec, name, SEED, seconds, traced, "cpu",
                    time.perf_counter(), **kw)


@pytest.mark.parametrize("name", ["t.agent", "t.chat", "t.batch"])
def test_cell_runs_and_agrees_with_the_reference(spec, name):
    out = _run(spec, name, control=True)
    chk = out["detail"]["check"]
    assert out["correct"] is True
    assert chk["positions"] > 0 and chk["disagree_share"] == 0.0
    assert chk["max_logit_gap"] <= 1e-3
    # the fp8 control, judged in the program's place under the cell's
    # own limits, is not correct
    assert out["control_correct"] is False
    assert chk["control_max_logit_gap"] > 10 * 1e-3
    assert chk["control_disagree_share"] > 0.0
    ctl = out["control_check"]["max_logit_gap"]
    assert ctl["value"] == chk["control_max_logit_gap"] > ctl["limit"]
    names = {m["name"] for m in spec.metrics(name, False)}
    assert set(out["metrics"]) == names
    # the chat cell's token-gap tail is the 95th percentile, the batch's
    # the 90th (``BENCHMARK.json``); the agent cell reports set-up alone
    tail = {"t.agent": set(), "t.chat": {"itl_p95_s"},
            "t.batch": {"itl_p90_s"}}[name]
    assert names == {"setup_s"} | tail
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_reads_the_added_metric(spec):
    out = _run(spec, "t.chat", traced=True, seconds=3.0)
    assert out["metrics"]["rows_computed"]["value"] > 0
    assert out["metrics"]["rows_computed"]["unit"] == "rows"
    # no card: no device trace, so no device metric is reported
    assert "attn_roofline.chat" not in out["metrics"]
    assert "device_idle_share.chat" not in out["metrics"]
    # the chat cell's own names of the shared readers
    assert out["metrics"]["itl_p90_s.chat"]["value"] > 0


def _altered_token(server):
    sample = server.engine._sample

    def wrong(params, x, sel):
        ids, logits = sample(params, x, sel)
        return (ids + 1) % server.cfg.vocab_size, logits
    server.engine._sample = wrong


def _half_batch(server):
    mlp = server.engine._mlp_out

    def half(x, blocks, l):
        y = mlp(x, blocks, l).clone()
        y[y.shape[0] // 2:] = 0.0
        return y
    server.engine._mlp_out = half


def _state_unchanged(monkeypatch):
    import repro_torch.serving.engine as engine
    monkeypatch.setattr(engine, "write_kv_pages", lambda *a, **k: None)


@pytest.mark.parametrize("fault", ["token", "half_batch", "state"])
def test_a_broken_timed_path_is_not_correct(spec, fault, monkeypatch):
    on_server = {"token": _altered_token, "half_batch": _half_batch,
                 "state": None}[fault]
    if fault == "state":
        _state_unchanged(monkeypatch)
    out = _run(spec, "t.agent", on_server=on_server)
    assert out["correct"] is False
    gap = out["check"]["max_logit_gap"]["value"]
    assert gap is None or gap > out["check"]["max_logit_gap"]["limit"]


def test_simulated_rehearsal_needs_no_weights(spec):
    out = _run(spec, "t.agent", simulate=True)
    assert out["correct"] is None
    assert out["attempted"] > 0


def test_a_configuration_brings_its_own_module(spec):
    # the cell's contexts pass the window of its three local layers
    out = _run(spec, "t.window", control=True)
    chk = out["detail"]["check"]
    assert out["correct"] is True
    assert chk["positions"] > 0 and chk["max_logit_gap"] <= 1e-3
    assert out["control_correct"] is False
    assert chk["control_max_logit_gap"] > 10 * 1e-3
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_module_whose_attention_ignores_the_window_is_not_correct(spec):
    out = _run(spec, "t.window_nowin")
    assert out["correct"] is False
    gap = out["check"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_the_throwaway_benchmark_edits_no_file_of_the_harness(spec):
    # every file of ``bench/`` (its tests aside) is in the copy as it is
    for f in tiny.BENCH.rglob("*"):
        rel = f.relative_to(tiny.BENCH)
        if f.is_file() and rel.parts[0] != "tests" \
                and "__pycache__" not in rel.parts:
            assert (Path(spec.dir) / rel).read_bytes() == f.read_bytes()


@pytest.mark.cuda
def test_cell_on_the_card(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = cell.run(spec, "t.chat", SEED, 2.0, True, "cuda",
                   time.perf_counter())
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert not math.isnan(out["metrics"]["device_idle_share.chat"]["value"])
