"""Weight bridge: the JAX package's parameter pytree, converted to numpy
arrays by the caller (``jax.tree.map(np.asarray, params)``), into the
port's parameter dict with the same layout.  Imports no JAX."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")     # own, writable copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: move
        # the raw 16-bit patterns and reinterpret them on the torch side
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, device="cuda") -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device``, shapes and dtypes unchanged."""
    dev = resolve_device(device)
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = params_from_numpy(value, dev)
        else:
            out[name] = _tensor(np.asarray(value), dev)
    return out
