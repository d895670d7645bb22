"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N --ckpt-dir DIR --batch B --seq S --grad-accum K --device D]``.

Trains the architecture's float32 smoke config for real, on the card
(``--device cuda``, the default) or on the CPU (``--device cpu``), resuming
from the newest checkpoint in ``--ckpt-dir`` if there is one.  The JAX
package's ``--dry-run`` (lowering the full-scale train step on the
production mesh) is not ported yet: it is refused with a non-zero exit.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_IDS, get_smoke_config, scaled_config
from repro_torch.training import DataConfig, TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    if args.dry_run:
        print("repro_torch.launch.train: --dry-run (the full-scale train "
              "step lowered on the production mesh) is not ported yet; "
              "see ROADMAP.md, Queue 1 item 1", file=sys.stderr)
        return 2

    cfg = scaled_config(get_smoke_config(args.arch), dtype="float32")
    tr = Trainer(cfg,
                 TrainConfig(steps=args.steps, ckpt_every=25,
                             ckpt_dir=args.ckpt_dir,
                             grad_accum=args.grad_accum),
                 DataConfig(seq_len=args.seq, global_batch=args.batch),
                 device=args.device)
    start = tr.init_or_resume()
    hist = tr.run()
    losses = [h["loss"] for h in hist if "loss" in h]
    if losses:
        print(f"{args.arch}: steps {start}->{tr.step} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print(f"{args.arch}: already at step {tr.step} of {args.steps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
