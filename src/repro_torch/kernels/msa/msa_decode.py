"""Paged flash-decode attention: the wrapper of the hand-written CUDA
kernel (``csrc/msa_decode.cu``), the counterpart of the JAX package's
``msa_decode_pallas``.

One new token per sequence, ``q (B, H, D)`` at logical position
``ctx - 1``, attends through its block table ``(B, NP)`` to the paged
pools; a block serves one piece of a row's page range (about
``piece_pages`` pages) for one kv head and the whole GQA group, so each
page is read once per group and a long context is spread over several
blocks; the partials of a cut range are merged in the same call.

A CUDA tensor launches the kernel or raises; nothing falls back to the
plain version (``ref.msa_decode_ref``), which serves CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.msa import _build

_SIGNATURES = {
    "msa_decode_launch": (ctypes.c_int, [ctypes.c_void_p] * 9
                          + [ctypes.c_int] * 9
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "msa_decode_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def msa_decode_cuda(
    q: torch.Tensor,              # (B, H, D) bf16 | f32
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # (B, NP) int32
    context_lens: torch.Tensor,   # (B,) int32 — includes the new token
    *,
    window: int = 0,
    softcap: float = 0.0,
    piece_pages: int = _build.PIECE_PAGES,
) -> torch.Tensor:
    """Launch the decode kernel on ``torch.cuda.current_stream()``.

    Validates every argument (device, dtype, shape, contiguity, head_dim,
    alignment) and raises on anything the kernel does not take; raises if
    the launch reports an error.  ``piece_pages`` sets how finely a long
    page range is cut (the grid has ``_build.n_pieces(NP, piece_pages)``
    pieces a row); it changes the order of the sums, not the function.
    Counts calls in ``msa_decode_cuda.launches`` (one a call: the kernel
    and its merge)."""
    name = "msa_decode_cuda"
    _build.check_attention_operands(name, q, k_pages, v_pages, q_dims=3)
    _build.check_split_group(name, q.shape[-2], k_pages.shape[2])
    dev = q.device
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if b == 0:
        raise ValueError(f"{name}: B=0 not served")
    if block_tables.dim() != 2:
        raise ValueError(f"{name}: block_tables must be (B, NP)")
    np_ = block_tables.shape[1]
    _build.check_i32(name, "block_tables", block_tables, (b, np_), dev)
    _build.check_i32(name, "context_lens", context_lens, (b,), dev)

    pieces = _build.n_pieces(np_, piece_pages)

    lib = _build.load("msa_decode", _SIGNATURES)
    out = torch.empty_like(q)
    part_o, part_ml = _build.split_scratch(pieces, b, h, d, dev)
    row_pieces = torch.empty((b,), dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() for x in (q, k_pages, v_pages, out, part_o, part_ml,
                                   row_pieces, block_tables, context_lens)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.set_extents(lib, "msa_decode", stream, pages=k_pages.shape[0],
                       rows=b, seqs=b, items=np_, run_units=pieces)
    err = lib.msa_decode_launch(
        *ptrs, b, h, kh, d, page, np_, piece_pages, pieces, int(window),
        float(softcap), _build.DTYPE_CODE[q.dtype], stream)
    _build.raise_on_error(lib, "msa_decode", err)
    # repro: allow(step-hazard) — host side effect: the split and sharded
    # steps that launch it run eager (Engine._graph_eligible)
    msa_decode_cuda.launches += 1
    return out


msa_decode_cuda.launches = 0
