"""Fused varlen mixed-batch Multi-Segment Attention: the host work-list and
the wrapper of the hand-written CUDA kernel (``csrc/msa_fused.cu``).

One dispatch per layer serves every prefill chunk and every decode row of
a step over a flattened ``(T, H, D)`` stream with per-sequence
``q_start``/``q_len`` runs (decode rows are runs of length 1).  The host
builds a compacted (sequence, q-tile, kv-page) work-list
(:func:`build_worklist`, a copy of the JAX package's) and cuts it into the
work units the kernel runs (:func:`build_units`): pieces of at most
``UNIT_PAGES`` pages (and at most ``RUN_UNITS`` pieces) of one
(sequence, q tile) run, so a long context is spread over several blocks;
the units of a cut run write partials that a merge in the same call
combines in a fixed order.

The same kernel has an (o, lse) mode (:func:`msa_fused_partial_cuda`),
the per-shard partial of sharded serving: a shard's work-list
(``build_worklist(..., page_valid=...)``) over its own pages, float32 o
and its log-sum-exp out.

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
# work-unit field order (build_units): per unit, then per cut run (the
# merges), then the two real counts {units, merges}
UNIT_FIELDS = ("u_item0", "u_items", "u_row0", "u_rows", "u_seq", "u_part",
               "mg_row0", "mg_rows", "mg_units", "unit_counts")
# a unit holds at most UNIT_PAGES pages of its run, and a run is cut into
# at most RUN_UNITS units (a run longer than RUN_UNITS * UNIT_PAGES pages
# shares its pages evenly among RUN_UNITS units); RUN_UNITS sizes the
# kernel's partial scratch, (RUN_UNITS, T, H, D) f32
UNIT_PAGES = 32
RUN_UNITS = 8


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
    page_valid: Optional[np.ndarray] = None,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Host-side (numpy) construction of the compacted work-list.

    Emits one item per (sequence, q-tile, needed kv page), grouped by q
    tile in ascending order (the kernel walks each tile's items as one
    contiguous range).  A page is *needed* iff it starts inside the
    sequence's context, at or below the tile's causal horizon (max valid
    q_pos), and — under a sliding window — not entirely below the
    window's lower edge.  Returns the field dict and the real
    (pre-padding) item count.

    ``page_valid`` (N, NP) bool (the port's; the reference has no such
    argument) builds one shard's work-list for the (o, lse) partial: a
    page marked False lives on another shard and gets no item, and
    ``block_tables`` is then the shard's table of local slots (the global
    slot minus the shard's first page where the page is local), so the
    items address the shard's own pool.  A tile none of whose needed
    pages is local gets the sentinel item, like an all-padding tile."""
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
                if page_valid is not None and not page_valid[s, j]:
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

    Derived from the runs ``wl_init``/``wl_last`` mark; raises unless the
    work-list is one contiguous item run per tile, which
    :func:`build_units` relies on.  Padding items (``pad_worklist``) lie
    past ``tile_first[n_tiles]``."""
    starts = np.flatnonzero(wl["wl_init"])
    ends = np.flatnonzero(wl["wl_last"]) + 1
    if (starts.shape[0] != n_tiles or ends.shape[0] != n_tiles
            or not np.array_equal(wl["wl_qtile"][starts],
                                  np.arange(n_tiles))
            or not np.array_equal(starts[1:], ends[:-1])):
        raise ValueError("work-list is not one contiguous item run per "
                         f"q tile for {n_tiles} tiles")
    return np.append(starts, ends[-1]).astype(np.int32)


def build_units(wl: Dict[str, np.ndarray], q_start: np.ndarray,
                q_len: np.ndarray, *, n_rows: int, q_tile: int,
                n_tiles: int, pad_to: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    """The kernel's work units of a (possibly padded) work-list, in
    vectorized numpy, as a dict in ``UNIT_FIELDS``.

    A *run* is the items of one (q tile, sequence): rows
    ``[u_row0, u_row0 + u_rows)`` of that tile against the run's pages.  A
    run of n items becomes ``min(RUN_UNITS, ceil(n / UNIT_PAGES))`` units
    of consecutive items, cut evenly; a unit reads items ``[u_item0,
    u_item0 + u_items)``.  A run that is one unit writes the output
    directly (``u_part == -1``); the k-th unit of a cut run writes partial
    k of its rows, and the run gets a merge (``mg_row0``, ``mg_rows``,
    ``mg_units``).  Rows of ``[0, n_rows)`` that no run covers (padding,
    all-padding tiles) get units of no item (``u_items == 0``), one per
    uncovered span of a tile, which write exact zeros.  Units of runs come
    first, in work-list order, then the zero units in row order.

    ``pad_to`` pads the unit fields to ``pad_to`` and the merge fields to
    ``pad_to // 2`` with units and merges of no row; ``unit_counts`` holds
    the real counts, which the kernel reads."""
    tile_ranges(wl, n_tiles)        # one contiguous item run per q tile
    n = q_start.shape[0]
    seq, tile = wl["wl_seq"], wl["wl_qtile"]
    idx = np.flatnonzero(seq < n)   # real items (no sentinel, no padding)
    s_i, t_i = seq[idx].astype(np.int64), tile[idx].astype(np.int64)
    new = np.ones(idx.shape[0], bool)
    new[1:] = ((s_i[1:] != s_i[:-1]) | (t_i[1:] != t_i[:-1])
               | (idx[1:] != idx[:-1] + 1))
    starts = np.flatnonzero(new)
    r_item0 = idx[starts]
    r_n = np.diff(np.append(starts, idx.shape[0]))
    r_s, r_t = s_i[starts], t_i[starts]
    qs = q_start.astype(np.int64)
    lo = np.maximum(qs[r_s], r_t * q_tile)
    hi = np.minimum(np.minimum(qs[r_s] + q_len[r_s], (r_t + 1) * q_tile),
                    n_rows)
    r_units = np.minimum(RUN_UNITS, -(-r_n // UNIT_PAGES))
    run = np.repeat(np.arange(r_n.shape[0]), r_units)
    k = np.arange(run.shape[0]) - np.repeat(np.cumsum(r_units) - r_units,
                                            r_units)
    a = r_item0[run] + k * r_n[run] // r_units[run]
    b = r_item0[run] + (k + 1) * r_n[run] // r_units[run]
    cut = r_units > 1

    # rows no run covers, cut at tile edges
    cover = (np.bincount(lo, minlength=n_rows + 1)
             - np.bincount(hi, minlength=n_rows + 1))
    free = np.cumsum(cover)[:n_rows] == 0
    rows = np.arange(n_rows)
    prev_free = np.concatenate([[False], free[:-1]])
    next_free = np.concatenate([free[1:], [False]])
    z_lo = np.flatnonzero(free & (~prev_free | (rows % q_tile == 0)))
    z_hi = np.flatnonzero(free & (~next_free | ((rows + 1) % q_tile == 0)))
    z_hi += 1

    nz = z_lo.shape[0]
    out = {
        "u_item0": np.concatenate([a, np.zeros(nz, np.int64)]),
        "u_items": np.concatenate([b - a, np.zeros(nz, np.int64)]),
        "u_row0": np.concatenate([lo[run], z_lo]),
        "u_rows": np.concatenate([(hi - lo)[run], z_hi - z_lo]),
        "u_seq": np.concatenate([r_s[run], np.full(nz, n)]),
        "u_part": np.concatenate([np.where(cut[run], k, -1),
                                  np.full(nz, -1)]),
        "mg_row0": lo[cut], "mg_rows": (hi - lo)[cut],
        "mg_units": r_units[cut],
    }
    n_units, n_merges = out["u_item0"].shape[0], out["mg_row0"].shape[0]
    out["unit_counts"] = np.asarray([n_units, n_merges])
    if pad_to is not None:
        if n_units > pad_to:
            raise ValueError(f"{n_units} work units > pad_to={pad_to}")
        fills = {"u_seq": n, "u_part": -1}
        for f in UNIT_FIELDS[:6]:
            out[f] = np.concatenate(
                [out[f], np.full(pad_to - n_units, fills.get(f, 0))])
        for f in UNIT_FIELDS[6:9]:
            out[f] = np.concatenate(
                [out[f], np.zeros(pad_to // 2 - n_merges, np.int64)])
    return {f: a.astype(np.int32) for f, a in out.items()}


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "msa_fused_launch": (ctypes.c_int, [ctypes.c_void_p] * 21
                         + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "msa_fused_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def load_library() -> ctypes.CDLL:
    """Build (once per source content, into ``build/``) and load the
    kernel library."""
    return _build.load("msa_fused", _SIGNATURES)


def _launch(name: str, q, k_pages, v_pages, q_pos, context_lens,
            worklist, units, *, window, softcap, q_tile, partial: bool):
    """Check every argument (device, dtype, shape, contiguity, head_dim,
    alignment), raising on anything the kernel does not take, then launch
    the kernel and the merge of the runs it cut on
    ``torch.cuda.current_stream()``; raise if the launch reports an error.
    ``partial`` selects the (o, lse) mode.  Returns ``out`` (and ``lse``
    in the (o, lse) mode)."""
    _build.check_attention_operands(name, q, k_pages, v_pages, q_dims=3)
    dev = q.device
    t, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    if t == 0:
        raise ValueError(f"{name}: T=0 not served")
    _build.check_i32(name, "q_pos", q_pos, (t,), dev)
    _build.check_i32(name, "context_lens", context_lens,
                     (context_lens.shape[0],), dev)
    if len(worklist) != len(WL_FIELDS) or len(units) != len(UNIT_FIELDS):
        raise ValueError(f"{name}: worklist needs {WL_FIELDS} and units "
                         f"{UNIT_FIELDS}")
    wl = dict(zip(WL_FIELDS, worklist))
    un = dict(zip(UNIT_FIELDS, units))
    w = wl["wl_seq"].shape[0]
    for f in WL_FIELDS:
        _build.check_i32(name, f, wl[f], (w,), dev)
    n_units, n_merges = un["u_item0"].shape[0], un["mg_row0"].shape[0]
    for f in UNIT_FIELDS:
        size = (2 if f == "unit_counts"
                else n_merges if f.startswith("mg_") else n_units)
        _build.check_i32(name, f, un[f], (size,), dev)

    lib = load_library()
    if partial:
        out = torch.empty((t, h, d), dtype=torch.float32, device=dev)
        lse = torch.empty((t, h), dtype=torch.float32, device=dev)
    else:
        out, lse = torch.empty_like(q), None
    part_o = torch.empty((RUN_UNITS, t, h, d), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((RUN_UNITS, t, h, 2), dtype=torch.float32,
                          device=dev)
    ptrs = [x.data_ptr() for x in (
        q, k_pages, v_pages, out, part_o, part_ml)]
    ptrs.append(None if lse is None else lse.data_ptr())
    ptrs += [x.data_ptr() for x in (
        context_lens, q_pos, wl["wl_slot"], wl["wl_kvbase"],
        *(un[f] for f in UNIT_FIELDS))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.set_extents(lib, "msa_fused", stream, pages=k_pages.shape[0],
                       rows=t, seqs=context_lens.shape[0], items=w,
                       units=n_units, run_units=RUN_UNITS, merges=n_merges)
    err = lib.msa_fused_launch(
        *ptrs, t, h, kh, d, page, min(q_tile, t), int(window),
        float(softcap), _build.DTYPE_CODE[q.dtype], stream)
    _build.raise_on_error(lib, "msa_fused", err)
    return out if lse is None else (out, lse)


def msa_fused_cuda(
    q: torch.Tensor,              # (T, H, D) bf16 | f32
    k_pages: torch.Tensor,        # (P, page, KH, D)
    v_pages: torch.Tensor,
    q_pos: torch.Tensor,          # (T,) int32
    context_lens: torch.Tensor,   # (N,) int32
    worklist: Sequence[torch.Tensor],   # WL_FIELDS order, each (W,) int32
    units: Sequence[torch.Tensor],      # UNIT_FIELDS order, see build_units
    *,
    window: int = 0,
    softcap: float = 0.0,
    q_tile: int = 128,
) -> torch.Tensor:
    """Launch the fused MSA kernel, and the merge of the runs it cut, on
    ``torch.cuda.current_stream()``: the output ``(T, H, D)`` in q's type.

    Raises on any argument the kernel does not take and if the launch
    reports an error.  ``q_tile`` is the work-list's q tile: no unit has
    more rows.  Counts calls in ``msa_fused_cuda.launches`` (one a call:
    the kernel and its merge)."""
    out = _launch("msa_fused_cuda", q, k_pages, v_pages, q_pos,
                  context_lens, worklist, units, window=window,
                  softcap=softcap, q_tile=q_tile, partial=False)
    # repro: allow(step-hazard) — host side effect: counted once at a
    # capture; Engine._replay adds the captured count at every replay
    msa_fused_cuda.launches += 1
    return out


msa_fused_cuda.launches = 0


def msa_fused_partial_cuda(
    q: torch.Tensor,              # (T, H, D) bf16 | f32
    k_pages: torch.Tensor,        # (P_loc, page, KH, D) — a shard's pool
    v_pages: torch.Tensor,
    q_pos: torch.Tensor,          # (T,) int32
    context_lens: torch.Tensor,   # (N,) int32
    worklist: Sequence[torch.Tensor],   # the shard's work-list (local slots)
    units: Sequence[torch.Tensor],      # its work units
    *,
    window: int = 0,
    softcap: float = 0.0,
    q_tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (o, lse) mode of the same kernel, the per-shard term of sharded
    serving (plain version ``ref.msa_fused_partial_ref``): attention over
    the pages the shard's work-list names (``build_worklist(...,
    page_valid=...)``), as float32 ``o`` (T, H, D), normalised by the
    local softmax mass, and ``lse`` (T, H), NEG_INF on rows with no
    visible local key.  Counts calls in
    ``msa_fused_partial_cuda.launches``."""
    out = _launch("msa_fused_partial_cuda", q, k_pages, v_pages, q_pos,
                  context_lens, worklist, units, window=window,
                  softcap=softcap, q_tile=q_tile, partial=True)
    # repro: allow(step-hazard) — host side effect: the split and sharded
    # steps that launch it run eager (Engine._graph_eligible)
    msa_fused_partial_cuda.launches += 1
    return out


msa_fused_partial_cuda.launches = 0
