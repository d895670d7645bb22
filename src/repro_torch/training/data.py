"""Synthetic deterministic data pipeline (counterpart of
``repro.training.data``): the same numpy generator, so the same
``(seed, step, shard)`` gives the JAX package's tokens, ``embeds`` and
``enc_embeds`` bit for bit, handed out as torch tensors on the trainer's
device.

Deterministic in (seed, step, shard), so that a restarted job resumes
mid-epoch from the checkpointed cursor with the same batches, and each
data-parallel shard regenerates its own slice independently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclass
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 17


class SyntheticLM:
    """Markov-ish token stream: next-token structure exists so that the
    loss can fall, yet generation is O(batch) a position.  ``tokens`` and
    ``labels`` come as int64 (torch's index type; the values are the JAX
    package's int32 ones), embeddings as float32."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        rng = np.random.RandomState(dcfg.seed)
        v = cfg.vocab_size
        self._succ = rng.randint(0, v, size=(min(v, 4096),)).astype(np.int32)

    def batch_at(self, step: int, shard: int = 0,
                 n_shards: int = 1) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` for data-parallel ``shard`` of
        ``n_shards``, on the device."""
        d = self.dcfg
        if d.global_batch % n_shards:
            raise ValueError(f"global_batch {d.global_batch} does not split "
                             f"into {n_shards} shards")
        b = d.global_batch // n_shards
        rng = np.random.RandomState(
            (d.seed * 1_000_003 + step * 131 + shard) % (2**31 - 1))
        v = self.cfg.vocab_size
        toks = np.empty((b, d.seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, min(v, 4096), size=(b,))
        noise = rng.random((b, d.seq_len))
        for t in range(d.seq_len):
            nxt = self._succ[toks[:, t] % len(self._succ)]
            rand = rng.randint(0, v, size=(b,))
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, nxt, rand)
        toks = torch.from_numpy(toks).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.inputs_are_embeddings and not self.cfg.enc_dec:
            rngf = np.random.RandomState(step + 7)
            batch["embeds"] = torch.from_numpy(rngf.standard_normal(
                (b, d.seq_len, self.cfg.d_model)).astype(np.float32))
            del batch["tokens"]
        if self.cfg.enc_dec:
            rngf = np.random.RandomState(step + 11)
            batch["enc_embeds"] = torch.from_numpy(rngf.standard_normal(
                (b, self.cfg.encoder_len, self.cfg.d_model)).astype(
                    np.float32))
        return {k: x.contiguous().to(self.device) for k, x in batch.items()}
