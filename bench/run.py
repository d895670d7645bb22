"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It makes the cell's model, weights and
traffic from the seed, serves the traffic through the port's entry
(``OnlineFrontend.run`` or ``AsymCacheServer.serve``) with a warm-up and
then ``--seconds`` of measured window, compares what the window served
with the plain reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with its limit.  The same numbers end standard error.

It exits non-zero and prints no result when no CUDA card is present,
when the cell asks for more cards than there are, or when JAX or the
JAX package was loaded.  ``--control 1`` (calibration only, never in a
benchmark run) also judges the fp8 control on the same positions under
the cell's limits, as ``control_correct`` (which has to read false).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library that would load it by itself; one thread for the host's
    numerical libraries (the serving loop is one Python thread; idle
    worker threads only contend for a host the card shares)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN``, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    from bench.harness.cell import run
    from bench.harness.spec import Spec

    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"bench: the cell needs {chips} CUDA card(s), {cards} present",
              file=sys.stderr)
        return 2
    out = run(spec, args.workload, args.seed, args.seconds,
              bool(args.trace), "cuda", T_START,
              control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    detail = out.pop("detail", {})
    chk = out.pop("check")
    for name, c in out.pop("control_check", {}).items():
        print(f"control check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    line = {"correct": out.pop("correct"), **out, "check": chk}
    print("detail: " + json.dumps(detail), file=sys.stderr)
    for name, c in chk.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
