"""What runs on the card loads neither JAX nor the JAX package, and the
reference loads nothing of the program; top-level names compared whole."""
import os
import subprocess
import sys

from bench.tests.tiny import ROOT

ENV = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax_and_no_jax_package():
    names = _loaded("import bench.run as r\nfrom bench.harness import "
                    "cell, check, sources, trace, traffic, window\n"
                    "import bench.sweep")
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import bench.reference.model")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_whole():
    import bench.run as run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "reprox", "jax_fake"]) == []
    assert run.forbidden_modules(["repro.serving", "jaxlib.xla",
                                  "flax"]) == ["flax", "jaxlib", "repro"]


def test_run_without_a_card_exits_non_zero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "granite8b.batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=ENV, cwd=ROOT)
    if out.returncode == 0:
        raise AssertionError("a run ended 0")
    assert out.stdout == ""
