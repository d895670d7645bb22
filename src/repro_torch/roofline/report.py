"""Markdown tables of the port's dry-run records (the counterpart of
``repro.roofline.report``; no framework imported).

    PYTHONPATH=src python -m repro_torch.roofline.report [--results DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

#: the card the records' memory is held against (the dry run's
#: ``CARD_HBM_BYTES``)
CARD = "H100"
CARD_HBM_GB = 80


def load(results_dir: str, mesh: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def _fmt_bytes(b: float) -> str:
    return f"{b/1e9:.2f}"


def dryrun_table(results_dir: str) -> str:
    rows = [f"| arch | shape | 16x16 (256 {CARD}s) | 2x16x16 (512 {CARD}s) "
            f"| args GB/dev | temp GB/dev (of {CARD_HBM_GB} GB) |",
            "|---|---|---|---|---|---|"]
    single = {(r["arch"], r["shape"]): r for r in load(results_dir,
                                                       "pod16x16")}
    multi = {(r["arch"], r["shape"]): r for r in load(results_dir,
                                                      "pod2x16x16")}
    for key in sorted(single):
        s = single[key]
        m = multi.get(key, {"status": "pending"})
        def _st(r):
            if r["status"] == "ok":
                return "OK"
            if r["status"] == "skipped":
                return "SKIP"
            return "FAIL"
        mem = s.get("memory", {})
        rows.append(
            f"| {key[0]} | {key[1]} | {_st(s)} | {_st(m)} | "
            f"{_fmt_bytes(mem.get('argument_bytes', 0))} | "
            f"{_fmt_bytes(mem.get('temp_bytes', 0))} |")
    return "\n".join(rows)


def roofline_table(results_dir: str) -> str:
    rows = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) "
            "| bound | MODEL_FLOPS | useful | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in load(results_dir, "pod16x16"):
        if r["status"] != "ok":
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']*1e3:.2f} | "
            f"{rf['memory_s']*1e3:.2f} | {rf['collective_s']*1e3:.2f} | "
            f"{rf['bottleneck']} | {rf['model_flops']:.2e} | "
            f"{rf['useful_ratio']:.3f} | {rf['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def collective_breakdown(results_dir: str, arch: str, shape: str) -> str:
    path = os.path.join(results_dir, f"{arch}__{shape}__pod16x16.json")
    with open(path) as f:
        r = json.load(f)
    rows = [f"collectives for {arch} x {shape} (per device, per step):"]
    for k, v in sorted(r.get("costs_per_device", {}).items()):
        if k.startswith("wire:"):
            rows.append(f"  {k[5:]:>20s}: {v/1e9:8.2f} GB")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    default_dir = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                               "results", "dryrun_torch")
    ap.add_argument("--results", default=default_dir)
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline"])
    args = ap.parse_args()
    if args.section in ("all", "dryrun"):
        print("### Dry-run status\n")
        print(dryrun_table(args.results))
        print()
    if args.section in ("all", "roofline"):
        print(f"### Roofline (single-pod 16x16 {CARD}s, per step)\n")
        print(roofline_table(args.results))


if __name__ == "__main__":
    main()
