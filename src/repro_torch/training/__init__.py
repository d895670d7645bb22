"""Training (counterpart of ``repro.training``): optimizers, the train
step (autograd over the remat'd forward, gradient accumulation), the
synthetic data pipeline, checkpoints and the trainer."""
from repro_torch.training import checkpoint
from repro_torch.training.checkpoint import all_steps, latest_step, load, save
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import (Optimizer, adafactor, adamw,
                                            for_arch)
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import TrainConfig, Trainer

__all__ = [
    "all_steps", "checkpoint", "latest_step", "load", "save",
    "DataConfig", "SyntheticLM",
    "Optimizer", "adafactor", "adamw", "for_arch",
    "make_train_step", "TrainConfig", "Trainer",
]
