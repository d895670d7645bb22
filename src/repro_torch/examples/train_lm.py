"""Training driver: train a ~100M-param dense LM for a few hundred steps
on the synthetic pipeline, with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        [--steps 200] [--ckpt-dir DIR] [--tiny] [--device cpu]

Resumes from the newest checkpoint in ``--ckpt-dir`` when there is one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Dict, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.examples._smoke import device_ok
from repro_torch.training import (DataConfig, TrainConfig, Trainer, adamw,
                                  latest_step)

# ~100M params: 12L x 768 with a 32k vocab
CONFIG_100M = ModelConfig(
    name="demo-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
    tie_embeddings=True, dtype="float32")
# --tiny: 25M params for quick CPU demos, at batch 4 x 128 tokens
CONFIG_TINY = dataclasses.replace(
    CONFIG_100M, name="demo-25m", n_layers=6, d_model=384, n_heads=6,
    n_kv_heads=2, d_ff=1024)
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_ckpt")


def run(cfg: ModelConfig = CONFIG_100M, params: Optional[Dict] = None,
        steps: int = 200, ckpt_dir: Optional[str] = DEFAULT_CKPT_DIR,
        batch: int = 8, seq: int = 256, device="cuda") -> Dict:
    """Train ``cfg`` up to ``steps`` (``grad_accum`` 2, AdamW at 3e-4),
    resuming from ``ckpt_dir``'s newest checkpoint when there is one,
    else from ``params`` (drawn from seed 0 when None): ``{"start": the
    step it started from, "step": the step it reached, "history": the
    trainer's records, "losses": their losses, "trainer": the
    ``Trainer``, its parameters and optimizer state as trained}``."""
    dev = resolve_device(device)
    tr = Trainer(
        cfg,
        TrainConfig(steps=steps, ckpt_every=50, ckpt_dir=ckpt_dir,
                    grad_accum=2, lr=3e-4),
        DataConfig(seq_len=seq, global_batch=batch),
        opt=adamw(lr=3e-4), device=dev)
    if params is not None and (not ckpt_dir
                               or latest_step(ckpt_dir) is None):
        tr.params, tr.opt_state = params, tr.opt.init(params)
    start = tr.init_or_resume() if tr.params is None else 0
    hist = tr.run()
    return {"start": start, "step": tr.step, "history": hist,
            "losses": [h["loss"] for h in hist if "loss" in h],
            "trainer": tr}


def main(argv=None) -> int:
    prog = "python -m repro_torch.examples.train_lm"
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true",
                    help="25M-param config for quick CPU demos")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda, cuda:<i> or cpu")
    args = ap.parse_args(argv)
    if not device_ok(args.device, prog):
        return 2

    cfg = CONFIG_100M
    if args.tiny:
        cfg = CONFIG_TINY
        args.batch, args.seq = 4, 128
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.0f}M params)")
    out = run(cfg, steps=args.steps, ckpt_dir=args.ckpt_dir,
              batch=args.batch, seq=args.seq, device=args.device)
    if out["start"]:
        print(f"resumed from checkpoint at step {out['start']}")
    losses = out["losses"]
    if losses:
        print(f"steps {out['start']}->{out['step']}: loss {losses[0]:.3f} "
              f"-> {losses[-1]:.3f}")
    print(f"checkpoints in {args.ckpt_dir}: resumable with --steps "
          f"{args.steps + 100}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
