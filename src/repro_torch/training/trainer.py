"""Training loop (counterpart of ``repro.training.trainer``): periodic
atomic checkpoints, resume from the newest, deterministic restart, and a
step-time watchdog (straggler telemetry).  Runs eagerly on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import Optimizer, for_arch
from repro_torch.training.train_step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    grad_accum: int = 1
    lr: float = 3e-4
    seed: int = 0
    log_every: int = 10
    # watchdog: flag steps slower than `straggler_factor` x running median
    straggler_factor: float = 3.0


class Trainer:
    """``init_or_resume`` loads the newest checkpoint of ``ckpt_dir`` (or
    draws the parameters with ``init_params(cfg, seed, device)`` and a
    fresh optimizer state); ``run`` trains up to ``steps``, one
    ``history`` record a step (loss, grad_norm, step_time: the host's
    seconds, the device synchronised by reading the loss)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 opt: Optional[Optimizer] = None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.data = SyntheticLM(cfg, dcfg, self.device)
        self.opt = opt or for_arch(cfg.param_count(), lr=tcfg.lr)
        self.step_fn = make_train_step(cfg, self.opt, tcfg.grad_accum)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: List[Dict] = []
        self._step_times: List[float] = []

    def init_or_resume(self) -> int:
        t = self.tcfg
        if t.ckpt_dir and ckpt.latest_step(t.ckpt_dir) is not None:
            self.params, self.opt_state, meta = ckpt.load(
                t.ckpt_dir, device=self.device)
            self.step = int(meta["step"])
        else:
            self.params = init_params(self.cfg, seed=t.seed,
                                      device=self.device)
            self.opt_state = self.opt.init(self.params)
            self.step = 0
        return self.step

    def run(self) -> List[Dict]:
        if self.params is None:
            self.init_or_resume()
        t = self.tcfg
        while self.step < t.steps:
            batch = self.data.batch_at(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watchdog(dt)
            self.step += 1
            self.history.append({"step": self.step, "loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "step_time": dt})
            if t.ckpt_dir and self.step % t.ckpt_every == 0:
                self._save()
        if t.ckpt_dir:
            self._save()
        return self.history

    def _save(self) -> None:
        ckpt.save(self.tcfg.ckpt_dir, self.step, self.params,
                  self.opt_state, extra={"data_seed": self.data.dcfg.seed})

    def _watchdog(self, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) >= 8:
            recent = sorted(self._step_times[-32:])
            med = recent[len(recent) // 2]
            if dt > self.tcfg.straggler_factor * med:
                # at pod scale this would trigger re-scheduling; here the
                # event is recorded for the run report
                self.history.append({"straggler_step_time": dt,
                                     "median": med})
