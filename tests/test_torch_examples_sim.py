"""The port's examples without a model, against the JAX package: the
paper-scale helpers copied from ``benchmarks/common.py``
(``repro_torch.examples.paper_scale``), the two discrete-event
simulations (``agentic_continuum``, ``serve_multiturn``'s policy table)
and the examples' command lines.

The simulations run the copied control plane under the copied H20 cost
model, so their results must equal the reference's to the bit; they run
at reduced sizes (the reference's defaults take minutes here).  The
reference side takes the settings of ``examples/*.py`` written out, never
the port's constants."""
import dataclasses
import importlib.util
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import (agentic_continuum, paper_scale,
                                  prefix_sharing, quickstart,
                                  serve_multiturn, serve_online, train_lm)

REPO = os.path.join(os.path.dirname(__file__), "..")
SIM_KEYS = ("job_latency_mean", "job_latency_p90", "ttft_mean", "ttft_p90",
            "tpot_mean", "block_hit_rate", "evictions", "steps",
            "n_requests", "n_rejected", "sim_time")
SERVER_FIELDS = ("policy", "num_blocks", "block_size", "clock",
                 "execute_model", "continuum_ttl", "lifespan", "reuse_prob",
                 "slope_ratio", "use_hit_count", "host_blocks")
REQUEST_FIELDS = ("rid", "session_id", "prompt_tokens", "output_script",
                  "arrival", "is_tool_call", "tool_duration")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_common():
    """The reference's ``benchmarks/common.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_reference_benchmarks_common",
        os.path.join(REPO, "benchmarks", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_number(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def _requests(wl):
    return [tuple(getattr(r, f) for f in REQUEST_FIELDS) for r in wl]


WORKLOADS = {
    "longbench_like": (lambda m: m.longbench_like(2, qps=0.2,
                                                  intra_ratio=10.0, seed=1),
                       dict(pressure=0.3, lifespan=100.0)),
    "bfcl_like": (lambda m: m.bfcl_like(3, qps=0.5, seed=11),
                  dict(pressure=0.25, continuum=True, lifespan=10.0)),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_helpers_give_the_reference_requests(ref_common, name):
    make, kw = WORKLOADS[name]
    wl, ref_wl = make(paper_scale), make(ref_common)
    assert _requests(wl) == _requests(ref_wl)
    assert paper_scale.workload_footprint(wl) == \
        ref_common.workload_footprint(ref_wl)
    srv = paper_scale.pressured_server("asymcache", wl, **kw)
    ref = ref_common.pressured_server("asymcache", ref_wl, **kw)
    for field in SERVER_FIELDS:
        assert getattr(srv.scfg, field) == getattr(ref.scfg, field), field
    assert dataclasses.asdict(srv.scfg.scheduler) == \
        dataclasses.asdict(ref.scfg.scheduler)
    assert paper_scale.BLOCK_SIZE == ref_common.BLOCK_SIZE


def _same_results(port, ref):
    assert list(port) == list(ref)
    for name in port:
        for key in SIM_KEYS:
            assert _same_number(port[name][key], ref[name][key]), \
                (name, key, port[name][key], ref[name][key])


def test_agentic_continuum_equals_reference(ref_common):
    # three jobs: four take ~25 s a package here, and three already evict
    # and order the systems differently
    port = agentic_continuum.run(n_jobs=3)
    ref = {}
    for name, policy, ttl in (("vLLM-LRU", "lru", False),
                              ("AsymCache", "asymcache", False),
                              ("Continuum", "lru", True),
                              ("Continuum+AsymCache", "asymcache", True)):
        wl = ref_common.bfcl_like(3, qps=0.5, seed=11)
        ref[name] = ref_common.pressured_server(
            policy, wl, pressure=0.25, continuum=ttl, lifespan=10.0).run(wl)
    _same_results(port, ref)
    assert port["vLLM-LRU"]["evictions"] > 0
    assert port["Continuum"]["job_latency_mean"] != \
        port["vLLM-LRU"]["job_latency_mean"]


def test_serve_multiturn_sim_equals_reference(ref_common):
    # four sessions: at two nothing fits the pool (every request is
    # refused) and at three all four policies evict alike
    port = serve_multiturn.run_sim(n_sessions=4)
    ref = {}
    for policy in ("asymcache", "lru", "maxscore", "pensieve"):
        wl = ref_common.longbench_like(4, qps=0.2, intra_ratio=10.0, seed=1)
        ref[policy] = ref_common.pressured_server(
            policy, wl, pressure=0.3, lifespan=100.0).run(wl)
    _same_results(port, ref)
    assert len({r["evictions"] for r in port.values()}) > 1


def test_serve_multiturn_cli_prints_the_table(capsys):
    assert serve_multiturn.main(["--sessions", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["policy", "TTFT(s)", "TPOT(ms)", "hit",
                                "evictions"]
    assert [ln.split()[0] for ln in lines[1:]] == \
        list(serve_multiturn.POLICIES)


NEED_A_CARD = {
    "quickstart": (lambda: quickstart.run(), quickstart.main, []),
    "prefix_sharing": (lambda: prefix_sharing.run(), prefix_sharing.main,
                       []),
    "serve_online": (lambda: serve_online.run(), serve_online.main, []),
    "serve_multiturn": (lambda: serve_multiturn.run_real(),
                        serve_multiturn.main, ["--real"]),
    "train_lm": (lambda: train_lm.run(steps=1, ckpt_dir=None),
                 train_lm.main, ["--steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(NEED_A_CARD))
def test_model_examples_need_a_card_by_default(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run, main, argv = NEED_A_CARD[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_module_entry_point_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""
