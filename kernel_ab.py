#!/usr/bin/env python3
"""The attention kernels of two checkouts of this repository on one NVIDIA
card, for comparing a change with its parent.  Usage, from the root of a
checkout (this file's)::

    python3 kernel_ab.py run TREE OUT.pt    # once per checkout: A, B, B, A
    python3 kernel_ab.py compare A.pt B.pt

``run`` builds the three kernels of ``TREE/src/repro_torch`` and runs them
on the cases of ``chip_smoke.py``'s phase 2, which this checkout's
``chip_smoke.py`` builds from its seeds, so every tree sees the same
inputs.  It prints one ``ab`` JSON line a timed case (median of 20
CUDA-event timings on the device alone, ``ms``, and from an idle device,
``ms_with_enqueue``; the card's name and power limit first) and saves each
kernel's output on every case (the fused kernel's, the prefill and the
decode kernel's) to ``OUT.pt``.  ``compare`` says whether two runs'
kernels gave the same bits on every case.
An output file holds tens of MB.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run(tree: Path, out: Path) -> int:
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels.msa import _build
    import repro_torch
    print(cs._card_line(), flush=True)
    print(f"tree {tree} package {Path(repro_torch.__file__).parent}",
          flush=True)
    _build.build(("msa_fused", "msa_prefill", "msa_decode"))
    torch.backends.cuda.matmul.allow_tf32 = False

    fused_main, fused_decode, fused_small, fused_grok = cs.fused_cases()
    split_prefill, split_decode, _, split_grok = cs.split_cases()
    fused = {"main": fused_main, "decode": fused_decode,
             "grok_g6": fused_grok, **fused_small}
    split = {("prefill", "main"): split_prefill,
             ("decode", "main"): split_decode,
             ("decode", "fused_decode_only"):
                 cs._decode_only_as_split(fused_decode), **split_grok}
    saved = {}
    for dtype_name in ("bfloat16", "float32"):
        for name, case in fused.items():
            kernel, _ = cs._fused_fns(case, dtype_name)
            saved[f"{name}/{dtype_name}"] = kernel().cpu()
            if name in ("main", "decode", "grok_g6"):
                _timed("msa_fused", name, dtype_name, kernel)
        for (kind, name), case in split.items():
            kernel, _, _ = cs._split_fns(kind, case, dtype_name)
            saved[f"{kind}/{name}/{dtype_name}"] = kernel().cpu()
            _timed(f"msa_{kind}", name, dtype_name, kernel)
    torch.save(saved, out)
    return 0


def _timed(kernel_name, case, dtype_name, fn):
    import chip_smoke as cs
    print("ab " + json.dumps({
        "kernel": kernel_name, "case": case, "dtype": dtype_name,
        "ms": cs._median_ms(fn),
        "ms_with_enqueue": cs._median_ms(fn, device_only=False)}),
        flush=True)


def compare(a: Path, b: Path) -> int:
    import torch
    xa, xb = torch.load(a), torch.load(b)
    same = {k: bool(torch.equal(xa[k], xb[k])) for k in sorted(xa)}
    print("ab_same_bits " + json.dumps(
        {"a": str(a), "b": str(b), "all": all(same.values()), **same}),
        flush=True)
    return 0 if all(same.values()) and set(xa) == set(xb) else 1


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "run":
        return run(Path(argv[1]).resolve(), Path(argv[2]))
    if len(argv) == 3 and argv[0] == "compare":
        return compare(Path(argv[1]), Path(argv[2]))
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
