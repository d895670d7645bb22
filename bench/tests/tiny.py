"""A throwaway benchmark at smoke size for the CPU tests: a checkout-like
directory with its own ``BENCHMARK.json`` and every piece of ``bench/``,
plus tiny configurations, traffic mixes, limits, one extra metric and a
configuration's own reference module, added as new files and entries
only."""
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

MODEL = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64,
         "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
         "vocab_size": 256, "rope_theta": 10000.0, "norm_eps": 1e-5,
         "tie_embeddings": True, "dtype": "float32"}
DEPLOY = {"chips": 1, "num_blocks": 96, "block_size": 16, "max_prefills": 2,
          "max_chunk": 32, "min_chunk": 8, "max_decodes": 8,
          "decode_threshold": 4, "max_running": 8, "token_budget": 72}
SIZES = {"first_input": {"dist": "uniform", "lo": 10, "hi": 40},
         "next_input": {"dist": "uniform", "lo": 10, "hi": 60},
         "output": {"dist": "uniform", "lo": 4, "hi": 12},
         "warm_s": 1.0, "drain_s": 5.0}
# the extra per-layer metric a later change might add: its reader file
# and its entry are all it needs
EXTRA_METRIC = '''"""Rows computed in the window's steps (a test metric)."""


def read(run):
    steps = run.window_steps()
    return float(sum(w.rows for w in steps)) if steps else None
'''
# a configuration's own module (``"reference"`` in its file): the default
# module's layout and helpers, a layer loop of its own; WINDOWED False
# plants the fault of an attention that ignores the window
MODULE = '''"""The plain reference of a tiny windowed dense model (a test)."""
import torch
import torch.nn.functional as F

from bench.reference.model import (Linear, attention, layer_window, leaves,
                                   rms_norm, rope)

WINDOWED = {windowed}


def logits_at(params, model, seqs, keep, quant=None):
    lin = Linear(quant)
    b = params["blocks"]
    H, KH, d = model["n_heads"], model["n_kv_heads"], model["d_model"]
    D, eps, theta = model["head_dim"], model["norm_eps"], model["rope_theta"]
    out = []
    with torch.no_grad():
        for seq, kp in zip(seqs, keep):
            x = params["embed"][seq.long()].float()
            pos = torch.arange(x.shape[0])
            for l in range(model["n_layers"]):
                h = rms_norm(x, b["attn_norm"][l], eps)
                q, k, v = (lin(h, lin.weight(b[w][l].reshape(d, -1)))
                           for w in ("wq", "wk", "wv"))
                win = layer_window(model, l) if WINDOWED else 0
                o = attention(rope(q.view(-1, H, D), pos, theta),
                              rope(k.view(-1, KH, D), pos, theta),
                              v.view(-1, KH, D), 0.0, win)
                x = x + lin(o.reshape(-1, H * D),
                            lin.weight(b["wo"][l].reshape(H * D, d)))
                h = rms_norm(x, b["mlp_norm"][l], eps)
                a = F.silu(lin(h, lin.weight(b["w1"][l])))
                x = x + lin(a * lin(h, lin.weight(b["w3"][l])),
                            lin.weight(b["w2"][l]))
            h = rms_norm(x[kp.long()], params["final_norm"], eps)
            out.append(lin(h, lin.weight(params["embed"].T)))
    return out
'''
LLLG = dict(MODEL, n_layers=4, sliding_window=16, local_global_ratio=3)


def make(tmp: Path, limit: float = 1e-3) -> Path:
    """The throwaway benchmark under ``tmp``; returns its root."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = {"tiny_dense": dict(MODEL),
            "tiny_moe": dict(MODEL, family="moe", attn_logit_softcap=30.0,
                             tie_embeddings=False,
                             moe={"num_experts": 4, "top_k": 2,
                                  "ep_mode": "local", "dropless": True})}
    for name, model in cfgs.items():
        (root / "bench/configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "model": model, "deployment": DEPLOY}))
    for name, windowed in (("tiny_lllg", True), ("tiny_lllg_nowin", False)):
        (root / "bench/reference" / f"{name}.py").write_text(
            MODULE.replace("{windowed}", str(windowed)))
        (root / "bench/configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "reference": name, "model": LLLG,
             "deployment": DEPLOY}))
    agent = dict(SIZES, entry="frontend", system_prompt=40,
                 arrival={"process": "poisson", "rate_per_s": 1.0},
                 turns={"dist": "uniform", "lo": 2, "hi": 4},
                 gap_s={"dist": "uniform", "lo": 0.2, "hi": 0.6},
                 tool_calls=True)
    chat = dict(SIZES, entry="serve", system_prompt=20,
                arrival={"process": "poisson", "rate_per_s": 2.0},
                turns={"dist": "uniform", "lo": 2, "hi": 3},
                gap_s={"dist": "exponential", "mean": 0.3},
                tool_calls=False)
    batch = dict(SIZES, entry="serve", system_prompt=0,
                 arrival={"process": "at_start", "count": 400},
                 turns={"dist": "uniform", "lo": 1, "hi": 1},
                 gap_s={"dist": "uniform", "lo": 0.0, "hi": 0.0},
                 tool_calls=False)
    # contexts past the window of 16 from the first turn
    window = dict(chat, first_input={"dist": "uniform", "lo": 40, "hi": 120},
                  system_prompt=0)
    cells = {"t.agent": ("tiny_dense", "tiny_agent", agent),
             "t.chat": ("tiny_moe", "tiny_chat", chat),
             "t.batch": ("tiny_dense", "tiny_batch", batch),
             "t.window": ("tiny_lllg", "tiny_window", window),
             "t.window_nowin": ("tiny_lllg_nowin", "tiny_window", window)}
    for cell, (cfg, traffic, mix) in cells.items():
        (root / "bench/traffic" / f"{traffic}.json").write_text(
            json.dumps(mix))
        (root / "bench/limits" / f"{cell}.json").write_text(
            json.dumps({"max_logit_gap": limit}))
    b["workloads"] += [{"name": c, "config": cfg, "traffic": t, "chips": 1,
                        "why": "smoke size, CPU tests"}
                       for c, (cfg, t, _) in cells.items()]
    rename = {"grok1.chat": "t.chat", "granite8b.batch": "t.batch"}
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [rename[w] for w in m["workloads"]]
    (root / "bench/metrics/rows_computed.py").write_text(EXTRA_METRIC)
    b["per_layer"].append({"name": "rows_computed", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "model step", "moves": "itl_p90_s",
                           "workloads": list(rename.values())})
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return root
