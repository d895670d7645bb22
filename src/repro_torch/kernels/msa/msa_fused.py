"""Fused varlen mixed-batch Multi-Segment Attention: the host work-list and
the wrapper of the hand-written CUDA kernel (``csrc/msa_fused.cu``).

One dispatch per layer serves every prefill chunk and every decode row of
a step over a flattened ``(T, H, D)`` stream with per-sequence
``q_start``/``q_len`` runs (decode rows are runs of length 1).  The host
builds a compacted (sequence, q-tile, kv-page) work-list
(:func:`build_worklist`, a copy of the JAX package's) and the per-tile
item ranges the kernel walks (:func:`tile_ranges`).

The kernel is built with ``nvcc`` from the sources in this package into
``build/`` at the repository root on first use and bound with ``ctypes``.
A CUDA tensor either launches it or raises; nothing falls back to the
plain version (``ref.msa_fused_ref``), which serves CPU tensors only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# work-list field order — assembly, packing, and the kernel agree on it
WL_FIELDS = ("wl_seq", "wl_qtile", "wl_slot", "wl_kvbase", "wl_init",
             "wl_last")

_CSRC = Path(__file__).resolve().parent / "csrc" / "msa_fused.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
_NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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

_lib = None


def load_library() -> ctypes.CDLL:
    """Build (once per source content, into ``build/``) and load the
    kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"libmsa_fused-{tag[:16]}.so"
    if not so.exists():
        build_library(so)
    lib = ctypes.CDLL(str(so))
    lib.msa_fused_launch.restype = ctypes.c_int
    lib.msa_fused_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.msa_fused_error_string.restype = ctypes.c_char_p
    lib.msa_fused_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (shutil.which("nvcc"),
                 home and os.path.join(home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("msa_fused: nvcc not found (needs the CUDA toolkit)")


def build_library(so: Path) -> None:
    """Compile ``csrc/msa_fused.cu`` into ``so`` (atomic rename, so
    concurrent builders never load a half-written file).  The compiler's
    report (registers, spills per kernel) goes beside it, ``.log``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_CSRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"msa_fused: nvcc failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_i32(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.int32 or t.device != device or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"msa_fused_cuda: {name} must be a contiguous int32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


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
    if q.device.type != "cuda":
        raise ValueError(f"msa_fused_cuda: q is on {q.device}, not cuda")
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"msa_fused_cuda: dtype {q.dtype} not supported "
                        "(bfloat16, float32)")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("msa_fused_cuda: q must be (T, H, D) and the pools "
                         "(P, page, KH, D)")
    t, h, d = q.shape
    _, page, kh, dk = k_pages.shape
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != q.dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"msa_fused_cuda: {name} must be a contiguous "
                             f"{q.dtype} tensor on {dev}")
        if x.data_ptr() % (2 * x.element_size()):
            raise ValueError(f"msa_fused_cuda: {name} is not aligned to a "
                             "pair of elements")
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError("msa_fused_cuda: pool shapes disagree with q")
    if t == 0 or kh == 0 or h % kh:
        raise ValueError(f"msa_fused_cuda: T={t}, H={h}, KH={kh} not served")
    if d % 2 or d > 256:
        raise ValueError(f"msa_fused_cuda: head_dim {d} not served (even, "
                         "at most 256: a lane holds pairs of dims)")
    q_tile = min(q_tile, t)
    n_tiles = -(-t // q_tile)
    n = q_start.shape[0]
    _check_i32("q_start", q_start, (n,), dev)
    _check_i32("q_len", q_len, (n,), dev)
    _check_i32("context_lens", context_lens, (n,), dev)
    _check_i32("q_pos", q_pos, (t,), dev)
    _check_i32("tile_first", tile_first, (n_tiles + 1,), dev)
    if len(worklist) != len(WL_FIELDS):
        raise ValueError(f"msa_fused_cuda: worklist needs {WL_FIELDS}")
    wl = dict(zip(WL_FIELDS, worklist))
    w = wl["wl_seq"].shape[0]
    for f in WL_FIELDS:
        _check_i32(f, wl[f], (w,), dev)

    lib = load_library()
    out = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (
        q, k_pages, v_pages, out, q_start, q_len, context_lens, q_pos,
        wl["wl_seq"], wl["wl_slot"], wl["wl_kvbase"], tile_first)]
    err = lib.msa_fused_launch(
        *ptrs, t, h, kh, d, page, n, q_tile, n_tiles, int(window),
        float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("msa_fused_cuda: launch failed: "
                           + lib.msa_fused_error_string(err).decode())
    msa_fused_cuda.launches += 1
    return out


msa_fused_cuda.launches = 0
