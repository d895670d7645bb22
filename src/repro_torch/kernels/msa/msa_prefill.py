"""Padded multi-segment prefill attention: the wrapper of the hand-written
CUDA kernel (``csrc/msa_prefill.cu``), the counterpart of the JAX
package's ``msa_prefill_pallas``.

R prefill chunks of up to QP rows each, ``q (R, QP, H, D)``, attend
through their block tables ``(R, NP)`` to the paged pools, with a logical
position per row (``q_pos``, gapped where a multi-segment history is
recomputed) and ``q_lens`` valid rows per chunk; rows at or past
``q_lens`` come out as exact zeros.  The kernel takes any QP: no round-up
to the tile.  A chunk's q tile holds ``M_ROWS // G`` rows, so that its
rows times the G heads of a GQA group fill a work item; the tile's page
range (worked out on the device) is cut into pieces of about
``piece_pages`` pages, and the partials of a cut range are merged in the
same call.

A CUDA tensor launches the kernel or raises; nothing falls back to the
plain version (``ref.msa_prefill_ref``), which serves CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.msa import _build

_SIGNATURES = {
    "msa_prefill_launch": (ctypes.c_int, [ctypes.c_void_p] * 11
                           + [ctypes.c_int] * 11
                           + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]),
    "msa_prefill_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


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
    piece_pages: int = _build.PIECE_PAGES,
) -> torch.Tensor:
    """Launch the prefill kernel on ``torch.cuda.current_stream()``.

    Validates every argument (device, dtype, shape, contiguity, head_dim,
    alignment) and raises on anything the kernel does not take; raises if
    the launch reports an error.  ``piece_pages`` sets how finely a long
    page range is cut (the grid has ``_build.n_pieces(NP, piece_pages)``
    pieces a range); it changes the order of the sums, not the function.
    Counts calls in ``msa_prefill_cuda.launches`` (one a call: the kernel
    and its merge)."""
    name = "msa_prefill_cuda"
    _build.check_attention_operands(name, q, k_pages, v_pages, q_dims=4)
    _build.check_split_group(name, q.shape[-2], k_pages.shape[2])
    dev = q.device
    r, qp, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if r == 0 or qp == 0:
        raise ValueError(f"{name}: R={r}, QP={qp} not served")
    if block_tables.dim() != 2:
        raise ValueError(f"{name}: block_tables must be (R, NP)")
    np_ = block_tables.shape[1]
    _build.check_i32(name, "block_tables", block_tables, (r, np_), dev)
    _build.check_i32(name, "context_lens", context_lens, (r,), dev)
    _build.check_i32(name, "q_pos", q_pos, (r, qp), dev)
    _build.check_i32(name, "q_lens", q_lens, (r,), dev)
    q_tile = max(1, _build.M_ROWS // (h // kh))
    tiles = -(-qp // q_tile)
    pieces = _build.n_pieces(np_, piece_pages)

    lib = _build.load("msa_prefill", _SIGNATURES)
    out = torch.empty_like(q)
    part_o, part_ml = _build.split_scratch(pieces, r * qp, h, d, dev)
    tile_pieces = torch.empty((r, tiles), dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() for x in (q, k_pages, v_pages, out, part_o, part_ml,
                                   tile_pieces, block_tables, context_lens,
                                   q_pos, q_lens)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.set_extents(lib, "msa_prefill", stream, pages=k_pages.shape[0],
                       rows=r * qp, seqs=r, items=np_, run_units=pieces)
    err = lib.msa_prefill_launch(
        *ptrs, r, qp, h, kh, d, page, np_, q_tile, piece_pages, pieces,
        int(window), float(softcap), _build.DTYPE_CODE[q.dtype], stream)
    _build.raise_on_error(lib, "msa_prefill", err)
    # repro: allow(step-hazard) — host side effect: the split and sharded
    # steps that launch it run eager (Engine._graph_eligible)
    msa_prefill_cuda.launches += 1
    return out


msa_prefill_cuda.launches = 0
