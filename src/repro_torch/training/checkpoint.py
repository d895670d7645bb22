"""Fault-tolerant checkpointing (counterpart of
``repro.training.checkpoint``), with the JAX package's layout and
semantics:

  * **atomicity**: written to ``step_%09d.tmp/``, then ``os.rename``d
    (atomic on POSIX) to ``step_%09d/``, so a crash mid-write never
    corrupts the newest checkpoint; a stale ``.tmp`` is not a checkpoint;
  * **idempotence**: saving a step that is already published does
    nothing;
  * **resumability**: ``latest_step`` finds the newest complete
    checkpoint; parameters, optimizer state and the data cursor restore
    exactly;
  * **retention**: the last ``keep`` checkpoints stay, older ones go.

Each directory holds ``params.npz``, ``opt_state.npz`` (leaves under
"/"-joined paths) and ``meta.json``.  A float32 checkpoint written by
either package loads in the other bit for bit.  numpy has no bfloat16
without ``ml_dtypes`` (the card's host has none), so a bf16 leaf is
saved as its int16 bit patterns and ``meta.json`` records every leaf's
dtype (``"dtypes"``); :func:`load` also reads a bf16 leaf that the JAX
package's ``np.savez`` wrote, which reloads as two raw bytes (``|V2``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.training.optimizer import leaves


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and its dtype's name; bf16 as its int16
    bit patterns."""
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _tensor(a: np.ndarray, dtype: Optional[str],
            device: torch.device) -> torch.Tensor:
    """A saved leaf back as a tensor of ``dtype`` (None: the array's
    own); a two-byte void array (the JAX package's bf16) is bf16."""
    if dtype is None and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        dtype = "bfloat16"
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None and t.dtype != torch_dtype(dtype):
            raise ValueError(f"leaf saved as {a.dtype} but recorded as "
                             f"{dtype}")
    return t.to(device)


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return tree


def _save_tree(path: str, tree: Dict) -> Dict[str, str]:
    arrays, dtypes = {}, {}
    for name, leaf in leaves(tree):
        arrays[name], dtypes[name] = _host_array(leaf)
    np.savez(path, **arrays)
    return dtypes


def save(ckpt_dir: str, step: int, params: Dict, opt_state: Dict,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Publish step ``step``'s parameters and optimizer state (tensors on
    any device) atomically; returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(final):
        return final          # idempotent: this step is already published
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step}
    meta.update(extra or {})
    meta["dtypes"] = {
        "params": _save_tree(os.path.join(tmp, "params.npz"), params),
        "opt_state": _save_tree(os.path.join(tmp, "opt_state.npz"),
                                opt_state)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load(ckpt_dir: str, step: Optional[int] = None,
         device="cuda") -> Tuple[Dict, Dict, Dict]:
    """(params, opt_state, meta) of step ``step`` (the newest if None),
    tensors on ``device``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    trees = []
    for part in ("params", "opt_state"):
        kinds = dtypes.get(part, {})
        with np.load(os.path.join(path, f"{part}.npz")) as z:
            trees.append(_unflatten({k: _tensor(z[k], kinds.get(k), dev)
                                     for k in z.files}))
    return trees[0], trees[1], meta
