"""Padded multi-segment prefill attention: the wrapper of the hand-written
CUDA kernel (``csrc/msa_prefill.cu``), the counterpart of the JAX
package's ``msa_prefill_pallas``.

R prefill chunks of up to QP rows each, ``q (R, QP, H, D)``, attend
through their block tables ``(R, NP)`` to the paged pools, with a logical
position per row (``q_pos``, gapped where a multi-segment history is
recomputed) and ``q_lens`` valid rows per chunk; rows at or past
``q_lens`` come out as exact zeros.  The kernel takes any QP: no round-up
to the tile.

A CUDA tensor launches the kernel or raises; nothing falls back to the
plain version (``ref.msa_prefill_ref``), which serves CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.msa import _build

_SIGNATURES = {
    "msa_prefill_launch": (ctypes.c_int, [ctypes.c_void_p] * 8
                           + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]),
    "msa_prefill_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

# rows of a chunk one block serves.  Fewer (row, head) pairs a warp let
# more blocks share the pages' work; chip_smoke.py times tiles of 4 to 32
# rows at Llama-3.1-8B shapes, where 4 and 8 are the fastest (PERF.md)
Q_TILE = 8
# shared memory a block may hold besides its dynamic (q tile x G, D) f32
# state: the kernel's own two page bounds, with room to spare
_STATIC_SMEM = 64


def msa_prefill_cuda(
    q: torch.Tensor,              # (R, QP, H, D) bf16 | f32
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (R, NP) int32
    context_lens: torch.Tensor,   # (R,) int32
    q_pos: torch.Tensor,          # (R, QP) int32
    q_lens: torch.Tensor,         # (R,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    q_tile: int = Q_TILE,
) -> torch.Tensor:
    """Launch the prefill kernel on ``torch.cuda.current_stream()``.

    Validates every argument (device, dtype, shape, contiguity, head_dim,
    alignment) and raises on anything the kernel does not take; raises if
    the launch reports an error.  ``q_tile`` rows of a chunk share a block
    (cut to fit shared memory); the result does not depend on it.
    Counts launches in ``msa_prefill_cuda.launches``."""
    name = "msa_prefill_cuda"
    _build.check_attention_operands(name, q, k_pages, v_pages, q_dims=4)
    dev = q.device
    r, qp, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if r == 0 or qp == 0 or r > 65535:
        raise ValueError(f"{name}: R={r}, QP={qp} not served")
    if block_tables.dim() != 2:
        raise ValueError(f"{name}: block_tables must be (R, NP)")
    np_ = block_tables.shape[1]
    _build.check_i32(name, "block_tables", block_tables, (r, np_), dev)
    _build.check_i32(name, "context_lens", context_lens, (r,), dev)
    _build.check_i32(name, "q_pos", q_pos, (r, qp), dev)
    _build.check_i32(name, "q_lens", q_lens, (r,), dev)
    # cut to QP, then halved until the tile's f32 state (q_tile x G rows
    # of D + 2) fits in a block's shared memory
    tile = max(1, min(q_tile, qp))
    while tile > 1 and 4 * tile * (h // kh) * (d + 2) + _STATIC_SMEM \
            > _build.MAX_SMEM:
        tile //= 2

    lib = _build.load("msa_prefill", _SIGNATURES)
    out = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k_pages, v_pages, out, block_tables,
                                   context_lens, q_pos, q_lens)]
    err = lib.msa_prefill_launch(
        *ptrs, r, qp, h, kh, d, page, np_, tile, int(window), float(softcap),
        _build.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, "msa_prefill", err)
    msa_prefill_cuda.launches += 1
    return out


msa_prefill_cuda.launches = 0
