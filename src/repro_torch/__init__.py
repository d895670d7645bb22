"""PyTorch/CUDA port of the Multi-Segment Attention serving system.

Laid out like the JAX package ``repro`` so that each module's counterpart
is easy to find; it imports nothing of that package (the pure-numpy
control plane under ``core/``, ``configs/`` and ``serving/`` is carried
as its own copy).  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device with no card
    present raises here instead of failing deep inside the first
    allocation; there is no silent fallback to the CPU.  The meta device
    (shapes and dtypes only) serves the dry run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device='cuda' requested but no CUDA device is "
            "available (pass device='cpu' to run the plain versions)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or 'meta', "
                         f"shapes only), not {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype.
    numpy has no bfloat16 without ml_dtypes, so the port never routes a
    config dtype through ``np.dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
