"""Build, loading and argument checks shared by the hand-written CUDA
kernels of ``csrc/`` (``msa_fused``, ``msa_prefill``, ``msa_decode``), and
the work decomposition the two split kernels share (:func:`n_pieces`).

Each kernel is one source, ``csrc/<name>.cu``, compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and bound with
``ctypes``.  Libraries go to ``build/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the compiler flags, so a changed source is built
anew and an unchanged one is loaded as it is.  :func:`build` compiles
several kernels at once, one ``nvcc`` each.  Nothing here runs when a
module is imported: a kernel is built on its first launch.

A process started with ``MSA_CHECK_BOUNDS=1`` in its environment loads
the checked build of each kernel instead (``-DMSA_CHECK_BOUNDS``, its own
library name and hash, so it never replaces the release build): device
asserts hold every page, row, work-list, work-unit and partial index the
kernel reads or writes through to the extents its wrapper sets with
:func:`set_extents` before each launch.  An assert that fires ends the
process with a CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Set, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CHECK_ENV = "MSA_CHECK_BOUNDS"
CHECK_FLAGS = ("-DMSA_CHECK_BOUNDS",)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The split kernels (msa_prefill, msa_decode) cut a row's or a q tile's
# page range into pieces of about PIECE_PAGES pages, at most MAX_PIECES of
# them, one block each; a work item stacks up to M_ROWS (rows x GQA heads)
# rows of its products (kMRows in csrc/msa_tile.cuh)
PIECE_PAGES = 32
MAX_PIECES = 8
M_ROWS = 64

_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}
_checked_libs: Set[int] = set()


def checked() -> bool:
    """Whether this process loads the checked build (``MSA_CHECK_BOUNDS=1``
    in its environment)."""
    return os.environ.get(CHECK_ENV) == "1"


def _flags(check: bool) -> Tuple[str, ...]:
    return NVCC_FLAGS + CHECK_FLAGS if check else NVCC_FLAGS


def library_path(name: str, check: bool = False) -> Path:
    """Where the library of ``csrc/<name>.cu`` (its checked build with
    ``check``) is, or will be, built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(check)).encode())
    variant = "-checked" if check else ""
    return BUILD_DIR / f"lib{name}{variant}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (shutil.which("nvcc"),
                 home and os.path.join(home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (the kernels need the CUDA toolkit)")


def build(names: Iterable[str], check: bool = False) -> Dict[str, float]:
    """Compile every named kernel whose library (the checked build with
    ``check``) is missing, one ``nvcc`` each, all started together;
    returns each build's seconds (0.0 for a library already built).  Each
    library is renamed into place whole, so a concurrent process never
    loads a half-written file; the compiler's report (registers, spills
    per kernel) goes beside it, ``.log``."""
    secs: Dict[str, float] = {}
    procs = []
    for name in names:
        so = library_path(name, check)
        if so.exists():
            secs[name] = 0.0
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        cmd = [_nvcc(), *_flags(check), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        with open(tmp + ".log", "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        procs.append((name, so, tmp, cmd, proc, time.perf_counter()))
    while any(p[4].poll() is None for p in procs):
        for name, _, _, _, proc, t0 in procs:
            if proc.returncode is not None and name not in secs:
                secs[name] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = []
    for name, so, tmp, cmd, proc, t0 in procs:
        secs.setdefault(name, time.perf_counter() - t0)
        if proc.returncode != 0:
            os.unlink(tmp)
            report = Path(tmp + ".log").read_text()
            os.unlink(tmp + ".log")
            failed.append(f"{name}: nvcc failed ({' '.join(cmd)}):\n{report}")
            continue
        os.replace(tmp + ".log", so.with_suffix(".log"))
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if missing, with
    ``signatures`` ({function: (restype, argtypes)}) bound.  Pointers and
    the stream must be ``ctypes.c_void_p`` in the argtypes, or ctypes
    passes them as 32-bit ints.  The checked build where :func:`checked`."""
    check = checked()
    lib = _libs.get((name, check))
    if lib is None:
        build([name], check)
        lib = ctypes.CDLL(str(library_path(name, check)))
        if check:
            signatures = dict(signatures, msa_set_extents=(
                ctypes.c_int, [ctypes.c_longlong] * 7 + [ctypes.c_void_p]))
            _checked_libs.add(id(lib))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[(name, check)] = lib
    return lib


def set_extents(lib: ctypes.CDLL, name: str, stream: int, *, pages: int,
                rows: int, seqs: int, items: int, units: int = 0,
                run_units: int = 0, merges: int = 0) -> None:
    """Give a checked build the extents of the next launch's operands
    (see ``csrc/msa_common.cuh``); nothing for a release build."""
    if id(lib) not in _checked_libs:
        return
    raise_on_error(lib, name, lib.msa_set_extents(
        pages, rows, seqs, items, units, run_units, merges, stream))


def raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (it never ran then)."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}_cuda: launch failed: {msg}")


def check_attention_operands(name: str, q: torch.Tensor,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             q_dims: int) -> None:
    """The checks every kernel makes of q (``q_dims`` dims, head_dim last)
    and the (P, page, KH, D) pools: CUDA, a served dtype, one dtype and
    device, contiguous, aligned to a pair of elements, GQA-compatible head
    counts, an even head dim of at most 256."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q is on {q.device}, not cuda")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(bfloat16, float32)")
    if q.dim() != q_dims or k_pages.dim() != 4:
        raise ValueError(f"{name}: q must have {q_dims} dims and the pools "
                         "be (P, page, KH, D)")
    for what, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{q.dtype} tensor on {q.device}")
        if x.data_ptr() % (2 * x.element_size()):
            raise ValueError(f"{name}: {what} is not aligned to a pair of "
                             "elements")
    h, d = q.shape[-2], q.shape[-1]
    kh = k_pages.shape[2]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"{name}: pool shapes disagree with q")
    if kh == 0 or h % kh:
        raise ValueError(f"{name}: H={h}, KH={kh} not served")
    if d % 2 or d > 256:
        raise ValueError(f"{name}: head_dim {d} not served (even, at most "
                         "256: a lane holds pairs of dims)")


def check_i32(name: str, what: str, t: torch.Tensor, shape: Sequence[int],
              device: torch.device) -> None:
    if (t.dtype != torch.int32 or t.device != device or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: {what} must be a contiguous int32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def check_split_group(name: str, h: int, kh: int) -> None:
    """The split kernels stack a GQA group's heads into one work item's
    M_ROWS rows: a group of more heads is not served."""
    if h // kh > M_ROWS:
        raise ValueError(f"{name}: GQA group of {h // kh} heads not served "
                         f"(at most {M_ROWS})")


def n_pieces(np_: int, piece_pages: int = PIECE_PAGES) -> int:
    """The pieces a split kernel's grid gives each page range of a block
    table ``NP`` pages wide: ``min(MAX_PIECES, ceil(NP / piece_pages))``,
    at least 1.  It follows from the shape alone, so the grid and the
    partial scratch do not depend on the step's values; a range of n pages
    is cut into ``min(n_pieces, ceil(n / piece_pages))`` pieces."""
    if piece_pages < 1:
        raise ValueError(f"piece_pages={piece_pages} must be at least 1")
    return max(1, min(MAX_PIECES, -(-np_ // piece_pages)))


def split_scratch(pieces: int, rows: int, h: int, d: int,
                  device: torch.device):
    """The f32 partials of a split kernel's cut ranges: o ``(pieces, rows,
    H, D)`` and (m, l) ``(pieces, rows, H, 2)``; empty when no range can be
    cut (``pieces == 1``)."""
    n = pieces if pieces > 1 else 0
    return (torch.empty((n, rows, h, d), dtype=torch.float32, device=device),
            torch.empty((n, rows, h, 2), dtype=torch.float32, device=device))
