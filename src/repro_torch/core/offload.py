"""Asymmetric K/V host-tier offload: split-half residency + quantized
swap payloads (paper §7 hierarchical storage, extended).

Two independent ideas compose here:

**Split K/V residency** (*Efficient LLM Inference with Kcache*,
PAPERS.md): a block's K half and V half have asymmetric access
economics — K participates in every attention score while V is only
gathered post-softmax — so the host tier stores them as independent
per-half payloads.  Eviction spills only the halves the host does not
already hold (a block whose content never changed since its last spill
moves ZERO bytes — committed KV blocks are immutable, so a retained
host copy stays valid forever), the over-budget drop policy sheds V
halves first and can keep the K half of deep-position blocks (the
§4 swap-vs-recompute decision, per half: see
:meth:`~repro_torch.core.cost_model.CostModel.half_offload_gain`), and the
online prefetch path can restore K early while V streams on demand at
admission (``k_early_prefetch``).

**Quantized payloads**: host-resident halves are stored as int8 codes
with a per-page-per-head scale (or fp8 via ml_dtypes), cutting the
bytes every queued swap block carries ~4x (vs fp32; 2x vs bf16).  Two
exactness regimes:

  * ``lossy_offload=False`` (default when ``quant != "off"``): the
    engine *snaps* every KV value to the quantization grid at write
    time (``round(x/s)·s`` with the static scale ``s = clip/127``,
    inside the jitted step, before the value ever enters the pool).
    Round-trip exactness then holds **by construction**: quantizing a
    pool page recovers the exact codes, dequantizing them on swap-in
    reproduces the pool bytes bit-for-bit — offload, eviction and
    recompute all stay mutually byte-identical.  (This is
    quantization-aware serving: the grid is part of the model's
    serving numerics, like any KV-cache-quantized deployment; the
    drift vs full-precision serving is measured and reported by
    ``benchmarks/offload.py``.)
  * ``lossy_offload=True``: pool values stay full precision; payloads
    quantize at spill time with a *dynamic* per-page-per-head scale
    (max-abs over each page×head).  The first restore of a block
    incurs a bounded error once; **exact-requantization bookkeeping**
    (the scale is stored with the payload and remembered per chain
    hash) guarantees re-spills of restored content recover identical
    codes, so the error never compounds.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

INT8_QMAX = 127.0


@dataclass(frozen=True)
class OffloadConfig:
    """Host-tier offload policy knobs (wired through ``ServerConfig``).

    The default config reproduces the symmetric full-precision swap
    path byte-for-byte (no snapping, no retention, whole-entry LRU
    drops) — every flag is an independent opt-in so existing
    deterministic benchmark gates keep their baselines."""
    # payload / pool-grid format: "off" = full precision, "int8" = int8
    # codes + per-page-per-head f32 scale, "fp8" = float8_e4m3fn cast
    quant: str = "off"
    # False (+ quant on): snap-at-write, round-trip exact by
    # construction.  True: full-precision pools, dynamic-scale payloads
    # with a one-time bounded error per restored block (measured logit
    # bound gated in benchmarks/offload.py).
    lossy_offload: bool = False
    # static clip bound of the lossless int8 grid (scale = clip / 127)
    clip: float = 8.0
    # debug/baseline: keep the residency + snapping behaviour but ship
    # full-precision payloads (the "full-precision symmetric swap"
    # baseline the byte-identity gate compares against)
    payload_fp: bool = False
    # keep the host copy after a swap-in: committed block content is
    # immutable, so a retained copy makes the block's next eviction a
    # clean spill (zero bytes moved)
    retain_host: bool = False
    # over-budget drop policy: shed V halves first and keep the K half
    # of blocks whose per-half swap-vs-recompute gain is positive
    # ("evict V, keep K" for deep-position blocks)
    keep_k_half: bool = False
    # online prefetch restores only the K half early; the V half
    # streams through the in-step swap queue when the block is actually
    # acquired at admission (halves the speculative prefetch bytes of
    # cancelled/mispredicted resumes)
    k_early_prefetch: bool = False
    # device evictor weighting: rank host-complete blocks by
    # min(recompute, swap-restore) cost instead of recompute cost alone
    swap_aware_eviction: bool = False
    # remembered per-key payload scales (lossy mode requant exactness)
    scale_cache: int = 4096
    # checksum every spilled half at encode time and re-verify at
    # acquire (always on when a FaultPlan is attached; this flag forces
    # it on for fault-free runs too)
    verify_payloads: bool = False

    @property
    def snap(self) -> str:
        """Pool-grid snap mode the engine must apply at KV write time
        ("off" unless a lossless quantized payload format is active)."""
        if self.quant != "off" and not self.lossy_offload:
            return self.quant
        return "off"

    @property
    def wire_format(self) -> str:
        """Payload format on the host<->device wire: "fp" (raw dtype),
        "q8" (int8 codes + per-page-per-head scale) or "f8" (fp8 cast).
        ``payload_fp`` keeps quantization semantics (snap-at-write) but
        ships full-precision payloads — the benchmark's control arm."""
        if self.quant == "off" or self.payload_fp:
            return "fp"
        return {"int8": "q8", "fp8": "f8"}[self.quant]

    @property
    def payload_ratio(self) -> float:
        """Payload bytes relative to a 2-byte-element full-precision
        half (the model-clock billing unit of ``_step_latency``)."""
        return 1.0 if self.wire_format == "fp" else 0.5


@dataclass
class HostHalf:
    """One half (K or V) of a host-resident block.

    ``data`` is the wire payload: an fp ndarray (``fmt="fp"``), int8
    codes (``fmt="q8"``, with ``scale`` of shape (L, KH)), an fp8
    ndarray (``fmt="f8"``), or None in discrete-event simulation —
    ``nbytes`` then carries the *configured* half size so byte
    accounting stays exact without materializing payloads.

    ``checksum`` is a CRC32 over the wire payload, computed at spill
    time when payload verification is active (a fault plan is attached
    or ``OffloadConfig.verify_payloads`` is set) and re-checked at
    acquire; ``None`` means unverified."""
    data: Optional[np.ndarray]
    scale: Optional[np.ndarray]
    nbytes: int
    fmt: str = "fp"
    checksum: Optional[int] = None


def half_checksum(half: HostHalf) -> int:
    """CRC32 of a wire half's payload bytes (0 for simulated payloads,
    where ``data is None`` and only byte accounting exists)."""
    c = 0
    if half.data is not None:
        c = zlib.crc32(np.ascontiguousarray(half.data).view(np.uint8), c)
    if half.scale is not None:
        c = zlib.crc32(np.ascontiguousarray(half.scale).view(np.uint8), c)
    return c


def verify_half(half: Optional[HostHalf]) -> bool:
    """True iff the half's stored checksum (if any) matches its
    payload — a missing half or an unverified half passes."""
    if half is None or half.checksum is None:
        return True
    return half_checksum(half) == half.checksum


@dataclass
class HostEntry:
    """Per-half host-tier residency of one evicted block."""
    block_pos: int
    k: Optional[HostHalf] = None
    v: Optional[HostHalf] = None

    @property
    def complete(self) -> bool:
        return self.k is not None and self.v is not None

    @property
    def nbytes(self) -> int:
        return (self.k.nbytes if self.k else 0) + \
            (self.v.nbytes if self.v else 0)


def half_to_wire(half: Optional[HostHalf]) -> Optional[dict]:
    """Pickle-stable plain-dict form of a wire half (the prefix store's
    restart snapshot format).  Arrays are made contiguous so the
    serialized bytes are layout-independent; ``data=None`` simulated
    halves round-trip as pure byte accounting."""
    if half is None:
        return None
    return {
        "data": None if half.data is None
        else np.ascontiguousarray(half.data),
        "scale": None if half.scale is None
        else np.ascontiguousarray(half.scale),
        "nbytes": int(half.nbytes),
        "fmt": half.fmt,
        "checksum": half.checksum,
    }


def half_from_wire(d: Optional[dict]) -> Optional[HostHalf]:
    if d is None:
        return None
    return HostHalf(data=d["data"], scale=d["scale"],
                    nbytes=int(d["nbytes"]), fmt=d["fmt"],
                    checksum=d["checksum"])


def entry_to_wire(e: HostEntry) -> dict:
    """Plain-dict form of a host entry (both halves)."""
    return {"block_pos": int(e.block_pos),
            "k": half_to_wire(e.k), "v": half_to_wire(e.v)}


def entry_from_wire(d: dict) -> HostEntry:
    return HostEntry(block_pos=int(d["block_pos"]),
                     k=half_from_wire(d["k"]), v=half_from_wire(d["v"]))


def _f8_dtype():
    import ml_dtypes
    return np.dtype(ml_dtypes.float8_e4m3fn)


def snap_to_grid_np(arr: np.ndarray, mode: str, scale: float) -> np.ndarray:
    """Host-side mirror of the engine's in-step snap (same rounding as
    ``jnp.round``: half-to-even), used by tests to predict pool bytes."""
    if mode == "int8":
        q = np.clip(np.round(arr.astype(np.float32) / scale),
                    -INT8_QMAX, INT8_QMAX)
        return (q * np.float32(scale)).astype(arr.dtype)
    if mode == "fp8":
        return arr.astype(_f8_dtype()).astype(arr.dtype)
    return arr


def quantize_half(arr: np.ndarray, fmt: str, static_scale: float = 0.0,
                  scale: Optional[np.ndarray] = None) -> HostHalf:
    """Encode one (L, page, KH, D) half for the host tier.

    ``fmt="q8"``: int8 codes + per-page-per-head (L, KH) f32 scale —
    the given ``scale`` (requantization of previously restored
    content), else the static grid scale when set (lossless mode), else
    a fresh dynamic max-abs scale (lossy first spill)."""
    if fmt == "fp":
        a = np.ascontiguousarray(arr)
        return HostHalf(data=a, scale=None, nbytes=a.nbytes, fmt="fp")
    if fmt == "f8":
        codes = arr.astype(_f8_dtype())
        return HostHalf(data=codes, scale=None, nbytes=codes.nbytes,
                        fmt="f8")
    assert fmt == "q8", fmt
    f32 = arr.astype(np.float32)
    if scale is None:
        if static_scale > 0.0:
            L, _, KH, _ = arr.shape
            scale = np.full((L, KH), np.float32(static_scale), np.float32)
        else:
            amax = np.max(np.abs(f32), axis=(1, 3))          # (L, KH)
            scale = np.maximum(amax / INT8_QMAX, 1e-12).astype(np.float32)
    codes = np.clip(np.round(f32 / scale[:, None, :, None]),
                    -INT8_QMAX, INT8_QMAX).astype(np.int8)
    return HostHalf(data=codes, scale=scale,
                    nbytes=codes.nbytes + scale.nbytes, fmt="q8")


def dequantize_half(half: HostHalf, dtype) -> np.ndarray:
    """Decode a wire half back to pool dtype (host-side path: eager
    swap-in fallback and lossless-gated fp shipping).  The multiply
    order matches the device dequant in ``apply_swap_ins`` so both
    reproduce identical bytes."""
    if half.fmt == "fp":
        return half.data
    if half.fmt == "f8":
        return half.data.astype(dtype)
    out = half.data.astype(np.float32) * half.scale[:, None, :, None]
    return out.astype(dtype)


class ScaleCache:
    """Bounded per-chain-hash memory of payload quantization scales —
    the lossy mode's exact-requantization bookkeeping.  A block whose
    host copy was dropped and whose content is later re-spilled (after
    a lossless recompute of the *restored* values) requantizes with its
    remembered scale, recovering the identical codes (fixed point of
    quant∘deq) instead of compounding a second-generation error."""

    def __init__(self, cap: int):
        self.cap = cap
        self._d: "OrderedDict[Tuple[int, str], np.ndarray]" = OrderedDict()

    def put(self, key: int, which: str, scale: np.ndarray) -> None:
        if self.cap <= 0 or scale is None:
            return
        self._d[(key, which)] = scale
        self._d.move_to_end((key, which))
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def get(self, key: int, which: str) -> Optional[np.ndarray]:
        return self._d.get((key, which))
