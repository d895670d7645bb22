"""Fused varlen mixed-batch Multi-Segment Attention: the host work-list and
the wrapper of the hand-written CUDA kernel (``csrc/msa_fused.cu``).

One dispatch per layer serves every prefill chunk and every decode row of
a step over a flattened ``(T, H, D)`` stream with per-sequence
``q_start``/``q_len`` runs (decode rows are runs of length 1).  The host
builds a compacted (sequence, q-tile, kv-page) work-list
(:func:`build_worklist`, a copy of the JAX package's) and the per-tile
item ranges the kernel walks (:func:`tile_ranges`).

The kernel is built with ``nvcc`` from the sources in this package into
``build/`` at the repository root on first use and bound with ``ctypes``
(``_build``).
A CUDA tensor either launches it or raises; nothing falls back to the
plain version (``ref.msa_fused_ref``), which serves CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.msa import _build

# work-list field order — assembly, packing, and the kernel agree on it
WL_FIELDS = ("wl_seq", "wl_qtile", "wl_slot", "wl_kvbase", "wl_init",
             "wl_last")


def build_worklist(
    q_start: np.ndarray,        # (N,) int32 — first stream row per sequence
    q_len: np.ndarray,          # (N,) int32 — run length (0 = inactive row)
    context_lens: np.ndarray,   # (N,) int32
    block_tables: np.ndarray,   # (N, NP) int32 — pool slot per logical page
    q_pos: np.ndarray,          # (T,) int32 — logical position per stream row
    *,
    page: int,
    q_tile: int,
    n_tiles: int,
    window: int = 0,
    pad_to: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Host-side (numpy) construction of the compacted work-list.

    Emits one item per (sequence, q-tile, needed kv page), grouped by q
    tile in ascending order (the kernel walks each tile's items as one
    contiguous range).  A page is *needed* iff it starts inside the
    sequence's context, at or below the tile's causal horizon (max valid
    q_pos), and — under a sliding window — not entirely below the
    window's lower edge.  Returns the field dict and the real
    (pre-padding) item count."""
    n = q_start.shape[0]
    np_width = block_tables.shape[1]
    seqs, qtiles, slots, kvbases, inits, lasts = [], [], [], [], [], []
    for t in range(n_tiles):
        t_lo, t_hi = t * q_tile, (t + 1) * q_tile
        first_of_tile = len(seqs)
        for s in range(n):
            ql = int(q_len[s])
            if ql <= 0:
                continue
            lo = max(int(q_start[s]), t_lo)
            hi = min(int(q_start[s]) + ql, t_hi)
            if lo >= hi:
                continue
            ctx = int(context_lens[s])
            horizon = int(q_pos[lo:hi].max())
            wlo = int(q_pos[lo:hi].min()) - window + 1 if window > 0 else 0
            n_pages = min(-(-ctx // page), np_width)
            for j in range(n_pages):
                base = j * page
                if base >= ctx or base > horizon or base + page <= wlo:
                    continue
                seqs.append(s)
                qtiles.append(t)
                slots.append(int(block_tables[s, j]))
                kvbases.append(base)
                inits.append(0)
                lasts.append(0)
        if len(seqs) > first_of_tile:
            inits[first_of_tile] = 1
            lasts[-1] = 1
        else:
            # all-padding tile (bucket slack): one masked sentinel item
            # that inits+emits, so EVERY output tile is written — exact
            # zeros on invalid rows, matching the plain version
            seqs.append(n)
            qtiles.append(t)
            slots.append(0)
            kvbases.append(0)
            inits.append(1)
            lasts.append(1)
    count = len(seqs)
    out = {"wl_seq": np.asarray(seqs, np.int32),
           "wl_qtile": np.asarray(qtiles, np.int32),
           "wl_slot": np.asarray(slots, np.int32),
           "wl_kvbase": np.asarray(kvbases, np.int32),
           "wl_init": np.asarray(inits, np.int32),
           "wl_last": np.asarray(lasts, np.int32)}
    if pad_to is not None:
        out = pad_worklist(out, pad_to, sentinel_seq=n)
    return out, count


def pad_worklist(wl: Dict[str, np.ndarray], w: int,
                 sentinel_seq: int) -> Dict[str, np.ndarray]:
    """Pad every work-list field to length ``w`` with exact no-op items:
    the sentinel sequence row (``q_len == 0``) masks every q row, and
    ``wl_qtile`` repeats the last real tile.  The single source of the
    padding rules."""
    count = wl["wl_seq"].shape[0]
    if count > w:
        raise ValueError(f"work-list {count} items > pad_to={w}")
    if count == w:
        return wl
    fills = {"wl_seq": sentinel_seq, "wl_qtile": int(wl["wl_qtile"][-1]),
             "wl_slot": 0, "wl_kvbase": 0, "wl_init": 0, "wl_last": 0}
    return {f: np.concatenate(
        [a, np.full((w - count,), fills[f], np.int32)])
        for f, a in wl.items()}


def tile_ranges(wl: Dict[str, np.ndarray], n_tiles: int) -> np.ndarray:
    """``tile_first`` (n_tiles+1,) int32: tile t's items are
    ``[tile_first[t], tile_first[t+1])``.

    Derived from the runs ``wl_init``/``wl_last`` mark.  A CUDA block per
    tile walks its range in order — the TPU grid's sequential W axis
    becomes a loop inside the block.  Padding items (``pad_worklist``)
    lie past ``tile_first[n_tiles]`` and are never visited."""
    starts = np.flatnonzero(wl["wl_init"])
    ends = np.flatnonzero(wl["wl_last"]) + 1
    if (starts.shape[0] != n_tiles or ends.shape[0] != n_tiles
            or not np.array_equal(wl["wl_qtile"][starts],
                                  np.arange(n_tiles))
            or not np.array_equal(starts[1:], ends[:-1])):
        raise ValueError("work-list is not one contiguous item run per "
                         f"q tile for {n_tiles} tiles")
    return np.append(starts, ends[-1]).astype(np.int32)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "msa_fused_launch": (ctypes.c_int, [ctypes.c_void_p] * 12
                         + [ctypes.c_int] * 9
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "msa_fused_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def load_library() -> ctypes.CDLL:
    """Build (once per source content, into ``build/``) and load the
    kernel library."""
    return _build.load("msa_fused", _SIGNATURES)


def msa_fused_cuda(
    q: torch.Tensor,              # (T, H, D) bf16 | f32
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    q_start: torch.Tensor,        # (N,) int32
    q_len: torch.Tensor,          # (N,) int32
    q_pos: torch.Tensor,          # (T,) int32
    context_lens: torch.Tensor,   # (N,) int32
    worklist: Sequence[torch.Tensor],   # WL_FIELDS order, each (W,) int32
    tile_first: torch.Tensor,     # (n_tiles+1,) int32, see tile_ranges
    *,
    window: int = 0,
    softcap: float = 0.0,
    q_tile: int = 128,
) -> torch.Tensor:
    """Launch the fused MSA kernel on ``torch.cuda.current_stream()``.

    Validates every argument (device, dtype, shape, contiguity, head_dim,
    alignment) and raises on anything the kernel does not take; raises if
    the launch reports an error.  Counts launches in
    ``msa_fused_cuda.launches``."""
    name = "msa_fused_cuda"
    _build.check_attention_operands(name, q, k_pages, v_pages, q_dims=3)
    dev = q.device
    t, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if t == 0:
        raise ValueError(f"{name}: T=0 not served")
    q_tile = min(q_tile, t)
    n_tiles = -(-t // q_tile)
    n = q_start.shape[0]
    _build.check_i32(name, "q_start", q_start, (n,), dev)
    _build.check_i32(name, "q_len", q_len, (n,), dev)
    _build.check_i32(name, "context_lens", context_lens, (n,), dev)
    _build.check_i32(name, "q_pos", q_pos, (t,), dev)
    _build.check_i32(name, "tile_first", tile_first, (n_tiles + 1,), dev)
    if len(worklist) != len(WL_FIELDS):
        raise ValueError(f"{name}: worklist needs {WL_FIELDS}")
    wl = dict(zip(WL_FIELDS, worklist))
    w = wl["wl_seq"].shape[0]
    for f in WL_FIELDS:
        _build.check_i32(name, f, wl[f], (w,), dev)

    lib = load_library()
    out = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (
        q, k_pages, v_pages, out, q_start, q_len, context_lens, q_pos,
        wl["wl_seq"], wl["wl_slot"], wl["wl_kvbase"], tile_first)]
    err = lib.msa_fused_launch(
        *ptrs, t, h, kh, d, page, n, q_tile, n_tiles, int(window),
        float(softcap), _build.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, "msa_fused", err)
    msa_fused_cuda.launches += 1
    return out


msa_fused_cuda.launches = 0
