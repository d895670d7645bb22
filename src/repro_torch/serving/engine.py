"""Inference engine: one device step executing a mixed batch of
multi-segment prefill chunks and decode tokens (port of
``repro.serving.engine``, single-device, ``attn_mode`` "fused" and
"split").

All prefill chunks and decode rows share one token stream for the
non-attention layers.  Attention runs over the paged KV pool in one of
two layouts:

* ``"fused"``: **one** dispatch per layer over the flattened varlen
  ``(T, H, D)`` stream with per-sequence ``q_start``/``q_len`` runs,
  decode rows being runs of length 1 (``msa_fused``);
* ``"split"``: two dispatches per layer over the padded layout, the R
  prefill chunks as ``(R, QP, H, D)`` (``msa_prefill``) and the B decode
  rows as ``(B, H, D)`` (``msa_decode``).

On the card each dispatch is a hand-written CUDA kernel
(``repro_torch.kernels.msa.msa_{fused,prefill,decode}_cuda``); on the
CPU it is the plain PyTorch version.

Step shapes come from the same occupancy-bucket lattice as the reference
(``derive_bucket_lattice``): a fused step is padded to a ``(t_bucket,
np_bucket)`` of the lattice and its work-list to a power-of-two
``w_bucket``; a split step always runs at ``(R * QP + B, NP)``.  So
``bucket_counts`` and the step counts match the JAX engine.
``jit_traces`` counts the distinct ``(t, np, w, k)`` buckets first seen,
as the reference counts its compiled step variants.  On the card a fused
single-device step runs eager the first time its bucket is met, is
captured into a CUDA graph at the bucket's second use and replays that
graph from then on (``_step_impl``); every other step runs eager.

Multi-token decode (fused layout): a decode-only plan with
``decode_steps == k > 1`` runs k fused decode iterations in one dispatch
(``_multi_decode_steps``), each the same ``_fused_pass`` a single step
runs.  An iteration's input token is the host-forced id, or the previous
iteration's argmax on the device; iterations past a request's
``decode_iters`` are masked (no KV write, no attention row) and the host
never consumes their ids.

Host side, ``build_inputs`` assembles every int32 input into one flat
buffer (``pack_layout_for``) moved to the device in one copy, plus the
swap payloads.  Copy-on-write page forks and host-tier swap-ins are
queued and folded into the step as padded index arrays; overflow past
the static buckets goes through the eager paths.

The synchronous baseline of the paper's §5.3 (with the server's
``pipeline_depth=0``): ``assembly="legacy"`` builds the split layout in
the reference's per-token loops and moves each field by its own copy,
and ``return_full_logits`` hands back the full (R+B, V) logits, which
``StepHandle.block`` moves to the host every step.

Quantized offload: the host-tier swap payloads may travel as int8 codes
with per-page-per-head scales ("q8") or fp8 codes ("f8") and dequantize
on the device inside the step, and the KV writes may be snapped to the
offload grid (``snap``), which makes the quantized round trip exact.
The MLP sublayer of a MoE model runs ``moe_ffn_local`` over the
reference's capacity layout.

Sharded serving (``shard_devices``, the counterpart of the reference's
``mesh``): one process drives N shards (``repro_torch.distributed``).
The page pool is cut into N contiguous runs of ``num_pages / N`` pages,
one per shard (the block manager stripes every sequence's pages over
them), and the weights are cut by the reference's serving rules
(``shard_params``): each shard computes q/k/v on its own heads, the
heads are gathered, each shard writes the KV of its own pages and runs
the attention partial over them (the fused kernel's (o, lse) mode on the
card), the partials meet in the exact log-sum-exp merge, ``wo`` and the
MLP (or MoE) run on the shard's heads and ffn columns and are summed
over the shards, and the vocab-sharded logits are gathered for the
argmax.  Page ops carry per-shard queues of local indices; a copy
between shards runs eagerly, device to device.  Fused layout, k = 1 and
full-precision payloads only, as in the reference.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import (HostHalf, dequantize_half, f8_codes,
                                      f8_values)
from repro_torch.distributed import (serving_param_shardings, shard_params,
                                     sharded_msa_fused, sharded_pool_ops)
from repro_torch.distributed.flash_decode import shard_tables
from repro_torch.kernels.msa import (
    UNIT_FIELDS,
    WL_FIELDS,
    _build,
    apply_page_copies,
    apply_swap_ins,
    build_units,
    build_worklist,
    msa_decode,
    msa_fused,
    msa_fused_cuda,
    msa_prefill,
    pad_worklist,
    write_kv_pages,
)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.layers import (apply_rope, moe_ffn_local, rms_norm,
                                       swiglu_mlp)
from repro_torch.models.model import _layer_windows
from repro_torch.serving.scheduler import StepPlan
from repro_torch.serving.tracing import NO_RANGE, PREFIX

# minimum work-list bucket; lengths round up to the next power of two
# above this, so the per-W step variants are at most log2(Wmax) many
WL_BUCKET = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def derive_bucket_lattice(ecfg: "EngineConfig"
                          ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(token_buckets, np_buckets)`` implied by an :class:`EngineConfig`:
    a decode-full bucket plus power-of-two fractions of Tmax down to
    Tmax/16, and {NPmax/4, NPmax}; the maximal bucket is always included
    so every legal plan fits (split mode: exactly ``(t_max, NP)``)."""
    R, QP, B, NP = (ecfg.max_prefills, ecfg.max_chunk,
                    ecfg.max_decodes, ecfg.max_blocks_per_seq)
    t_max = R * QP + B
    if ecfg.attn_mode != "fused":
        return (t_max,), (NP,)
    tb = ecfg.token_buckets or (
        max(8, _round_up(B, 8)),
        max(8, _round_up(t_max // 16, 8)),
        max(8, _round_up(t_max // 8, 8)),
        max(8, _round_up(t_max // 4, 8)),
        max(8, _round_up(t_max // 2, 8)),
    )
    nb = ecfg.np_buckets or (max(1, NP // 4),)
    token_buckets = tuple(sorted(
        {min(t_max, max(1, int(t))) for t in tb} | {t_max}))
    np_buckets = tuple(sorted(
        {min(NP, max(1, int(n))) for n in nb} | {NP}))
    return token_buckets, np_buckets


def pack_layout_for(ecfg: "EngineConfig", t_bucket: int, np_bucket: int,
                    w_bucket: int, n_iter: int = 1, n_shards: int = 1
                    ) -> Tuple[List[Tuple[str, int, int]], int]:
    """(name, offset, size) triples of the flat int32 pack buffer for one
    occupancy bucket of the single-device layout, plus its total length.
    Beside the reference's fused fields it carries the work units the
    fused CUDA kernel runs (``UNIT_FIELDS``, :func:`unit_bucket` units
    and half as many merges); the split layout (``w_bucket`` unused)
    is the reference's as it is.

    A multi-token decode plan (``n_iter > 1``, fused layout) carries k
    copies of the fields that change between its iterations (tokens,
    positions, valid, the write coordinates, qlen, ctx, the work-list and
    the work units); seq_ids, sel, qstart, bt and the page-op queues are
    shared.  The ``n_iter == 1`` layout is the single step's.

    A sharded engine (``n_shards > 1``, fused, k = 1) carries one
    work-list and one set of work units per shard, and per-shard page-op
    queues of local indices (the reference's rows of ``copy_src`` etc.),
    each ``n_shards`` times the single-device field."""
    e = ecfg
    ns = n_shards
    R, B = e.max_prefills, e.max_decodes
    if e.attn_mode == "fused":
        t, n, k = t_bucket, R + B, n_iter
        n_tiles = -(-t // min(e.q_tile, t))
        fields = [("tokens", k * t), ("positions", k * t),
                  ("valid", k * t), ("write_slot", k * t),
                  ("write_off", k * t), ("seq_ids", t),
                  ("sel", R + B), ("qstart", n), ("qlen", k * n),
                  ("ctx", k * n), ("bt", n * np_bucket)]
        fields += [(f, ns * k * w_bucket) for f in WL_FIELDS]
        u_b = unit_bucket(w_bucket, n_tiles)
        fields += [(f, ns * k * (2 if f == "unit_counts"
                                 else u_b // 2 if f.startswith("mg_")
                                 else u_b))
                   for f in UNIT_FIELDS]
    else:
        t, NP = R * e.max_chunk + B, e.max_blocks_per_seq
        fields = [("tokens", t), ("positions", t), ("valid", t),
                  ("write_slot", t), ("write_off", t), ("sel", R + B),
                  ("qlens", R), ("ctx_pre", R), ("ctx_dec", B),
                  ("bt_pre", R * NP), ("bt_dec", B * NP)]
    fields += [("copy_src", ns * e.max_instep_copies),
               ("copy_dst", ns * e.max_instep_copies),
               ("swap_k_dst", ns * e.max_instep_swaps),
               ("swap_v_dst", ns * e.max_instep_swaps)]
    layout: List[Tuple[str, int, int]] = []
    off = 0
    for name, size in fields:
        layout.append((name, off, size))
        off += size
    return layout, off


def unit_bucket(w_bucket: int, n_tiles: int) -> int:
    """Work units a fused iteration's pack holds: a run of n items is at
    most n units, and a zero unit covers one span of rows no run covers,
    cut at tile edges.  A single step packs every sequence's rows densely
    from row 0, so only the tail is free: at most one zero unit a tile.
    A multi-token iteration keeps each decode row at its row and masks
    the rows out of output, which leaves holes.  They fit all the same:
    every row of such a plan is live in its first iteration, with at
    least one item, and a live row's run later on (its context a few keys
    longer) is still no more units than it had items then (a unit holds
    up to 32 pages), so one iteration's run units and holes together stay
    within the first iteration's items, and so within the shared
    ``w_bucket``.
    A function of the buckets, so a step's shapes stay those of its
    ``(t, np, w, k)`` bucket."""
    return w_bucket + n_tiles


@dataclass(frozen=True)
class EngineConfig:
    num_pages: int                 # KV pool pages (= block manager blocks)
    page_size: int = 16
    max_prefills: int = 4          # R
    max_chunk: int = 128           # QP (per-request compute tokens per step)
    max_decodes: int = 64          # B
    max_blocks_per_seq: int = 64   # NP
    # rows of a work-list q tile.  The TPU kernel used 128 (its matrix
    # unit's tile); the CUDA kernel stacks a unit's rows times the G heads
    # of a GQA group into the 64 M rows of its products, so 16 rows fill
    # them at G = 4 (Llama-3.1-8B) and a prefill chunk's tiles spread over
    # many blocks
    q_tile: int = 16
    # "fused": one varlen attention dispatch per layer over the flattened
    # (T, H, D) mixed stream, with the occupancy bucket lattice.
    # "split": the padded two-dispatch layout (prefill chunks + decode
    # rows), one fixed (R*QP + B, NP) shape.
    attn_mode: str = "fused"
    # occupancy bucket lattices; empty tuples derive the defaults (see
    # derive_bucket_lattice)
    token_buckets: Tuple[int, ...] = ()
    np_buckets: Tuple[int, ...] = ()
    # static buckets for page ops folded into the step; overflow falls
    # back to the eager paths.  0 routes every op of that kind eagerly.
    max_instep_copies: int = 8     # COW forks per step
    max_instep_swaps: int = 4      # host-tier swap-ins per step
    # wire format of the host-tier swap payloads: "fp" ships pool-dtype
    # pages; "q8" int8 codes + a per-page-per-head f32 scale; "f8"
    # float8_e4m3fn codes; quantized payloads dequantize inside the step.
    # Must match the block manager's OffloadConfig.wire_format (the server
    # wires both).
    swap_payload: str = "fp"
    # KV pool grid snap applied to k_new/v_new at write time, inside the
    # step: "int8" rounds to the static snap_scale grid, "fp8" through
    # float8.  Every pool value is then on the grid from the instant it
    # exists, so quantizing a page at spill time recovers its codes and
    # the swap-in reproduces the pool bytes bit for bit.
    snap: str = "off"
    snap_scale: float = 0.0
    # "vectorized": numpy scatters over per-request cached arrays into one
    # packed buffer, moved by one copy; "legacy": the reference's
    # per-token Python loops, each field moved by its own copy — the
    # implementation the vectorized path is tested against and the
    # synchronous baseline's control plane.  Legacy implies the split
    # layout.
    assembly: str = "vectorized"
    # True restores the pre-pipeline device interface: the step returns
    # the full (R+B, V) logits and StepHandle.block() moves them all to
    # the host — the per-step sync the paper's §5.3 overlap removes.
    # False keeps sampling on the device: only the (R+B,) ids and the
    # (R, V) prefill rows leave it.
    return_full_logits: bool = False
    # The reference's attn_impl and donate_pools have no counterpart here:
    # the engine's device picks the kernels (CUDA on the card, the plain
    # versions on the CPU), and every step updates the pools in place.


def _host_array(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> a numpy copy, bit for bit (a copy on the CPU too,
    where ``.cpu()`` would hand out a view of the pool that the next step
    overwrites).  numpy has no bfloat16, so bf16 pages travel as their raw
    16-bit patterns (int16); ``offload.dequantize_half`` reverses it."""
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _host_npdtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(np.int16) if dtype == torch.bfloat16 \
        else torch.empty((), dtype=dtype).numpy().dtype


@dataclass
class StepHandle:
    """Asynchronous result of one dispatched step.

    Holds device tensors; nothing is transferred until the ``*_np``
    accessors run, so the server can assemble the next step while this
    one executes.  ``block`` waits on the CUDA event recorded after the
    step (a no-op on the CPU), and when the engine returns full logits
    (the synchronous baseline's interface) it also moves the (R+B, V)
    logits and the ids to the host, as the pre-pipeline loop did every
    step."""
    token_ids: Union[torch.Tensor, np.ndarray]      # (R+B,) or (k, R+B)
    # (R, V) rows; (R+B, V) in full-logits mode
    prefill_logits: Union[torch.Tensor, np.ndarray]
    assembly_time: float = 0.0     # host-side build_inputs seconds
    done: Optional[torch.cuda.Event] = None
    full_logits: bool = False
    _ids_np: Optional[np.ndarray] = None
    _pre_np: Optional[np.ndarray] = None

    def block(self) -> None:
        if self.full_logits:
            self.prefill_logits_np()   # the baseline's full-vocab transfer
            self.token_ids_np()
        elif self.done is not None:
            self.done.synchronize()

    def token_ids_np(self) -> np.ndarray:
        if self._ids_np is None:
            ids = self.token_ids
            self._ids_np = (ids.cpu().numpy() if torch.is_tensor(ids)
                            else np.asarray(ids))
        return self._ids_np

    def prefill_logits_np(self) -> np.ndarray:
        if self._pre_np is None:
            lg = self.prefill_logits
            self._pre_np = (lg.float().cpu().numpy() if torch.is_tensor(lg)
                            else np.asarray(lg))
        return self._pre_np


@dataclass
class _StepGraph:
    """One bucket's step captured into a CUDA graph: the static inputs it
    reads (its own pack buffer, the engine's swap payloads), the outputs
    it writes, and the ``msa_fused_cuda`` launches its capture counted
    (a fused single-device step launches no other kernel of ours)."""
    graph: "torch.cuda.CUDAGraph"
    inp: Dict[str, Optional[torch.Tensor]]
    token_ids: torch.Tensor
    logits: torch.Tensor
    launches: int


class Engine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params,
                 device="cuda", shard_devices=None):
        """``shard_devices`` (one device a shard; a device may repeat)
        serves sharded over them, the counterpart of the reference's
        ``mesh``; ``device`` is then not used.  ``params`` are the full
        parameters, on any device when sharded (``shard_params`` copies
        each shard's part to its device)."""
        if cfg.family not in ("dense", "moe", "vlm") or cfg.enc_dec:
            raise ValueError(f"the engine serves decoder-only token LMs, "
                             f"not family {cfg.family!r}")
        if ecfg.attn_mode not in ("fused", "split"):
            raise ValueError(f"attn_mode {ecfg.attn_mode!r} is neither "
                             "'fused' nor 'split'")
        if ecfg.swap_payload not in ("fp", "q8", "f8"):
            raise ValueError(f"swap_payload {ecfg.swap_payload!r} is not "
                             "'fp', 'q8' or 'f8'")
        if ecfg.snap not in ("off", "int8", "fp8"):
            raise ValueError(f"snap {ecfg.snap!r} is not 'off', 'int8' or "
                             "'fp8'")
        if ecfg.snap == "int8" and not ecfg.snap_scale > 0.0:
            raise ValueError("snap='int8' needs snap_scale > 0")
        if ecfg.assembly not in ("vectorized", "legacy"):
            raise ValueError(f"assembly {ecfg.assembly!r} is neither "
                             "'vectorized' nor 'legacy'")
        if ecfg.assembly == "legacy" and ecfg.attn_mode != "split":
            raise ValueError("legacy assembly implies attn_mode='split'")
        self.cfg = cfg
        self.ecfg = ecfg
        # the (data=1, model=N) serving mesh's model group
        group = None if shard_devices is None else make_serving_mesh(
            len(shard_devices), devices=shard_devices).group("model")
        self.group = group if group is not None and group.n > 1 else None
        self.n_shards = 1 if self.group is None else self.group.n
        if self.n_shards > 1:
            # as the reference asserts: the split layout predates the
            # work-list metadata the partial needs, and quantized payloads
            # need the single-device engine
            if ecfg.assembly == "legacy":
                raise ValueError("legacy assembly requires the "
                                 "single-device engine")
            if ecfg.attn_mode != "fused":
                raise ValueError("sharded serving requires attn_mode "
                                 "'fused'")
            if ecfg.swap_payload != "fp" or ecfg.snap != "off":
                raise ValueError("quantized offload requires the "
                                 "single-device engine")
            if ecfg.num_pages % self.n_shards:
                raise ValueError(f"num_pages={ecfg.num_pages} does not "
                                 f"divide over {self.n_shards} shards")
            self.device = self.group.devices[0]
            self.params = shard_params(params, cfg, self.group)
            self.rules = serving_param_shardings(cfg, self.n_shards)[0]
        else:
            self.device = resolve_device(
                device if group is None else group.devices[0])
            if params["embed"].device.type != self.device.type:
                raise ValueError(f"params live on "
                                 f"{params['embed'].device}, the engine "
                                 f"on {self.device}")
            self.params = params
        self.dtype = torch_dtype(cfg.dtype)
        self._payload_fmt = ecfg.swap_payload
        # host dtype of a swap payload and its dtype on the device: the
        # pool's bits (bf16 as int16), int8 codes, or fp8 codes as uint8
        self._payload_npdt = {"fp": _host_npdtype(self.dtype),
                              "q8": np.dtype(np.int8),
                              "f8": np.dtype(np.uint8)}[self._payload_fmt]
        self._payload_dtype = {"fp": self.dtype, "q8": torch.int8,
                               "f8": torch.float8_e4m3fn}[self._payload_fmt]
        # the snap grid's scale as a device tensor: a division by a CPU
        # scalar may run as a multiplication by its reciprocal on the card
        self._snap_scale = torch.tensor(ecfg.snap_scale, dtype=torch.float32,
                                        device=self.device)
        L = cfg.n_layers
        # page num_pages (one past the block manager's slots) is the drop
        # page: padding KV writes and padding swap-ins land there, and no
        # block table references it.  The pools are updated in place by
        # every step (JAX donated them into its step instead).  Sharded:
        # one (L, num_pages / N + 1, ...) pool a shard, its last page the
        # shard's drop page.
        self.p_loc = ecfg.num_pages // self.n_shards
        pool_shape = (L, self.p_loc + 1, ecfg.page_size, cfg.n_kv_heads,
                      cfg.head_dim)
        if self.n_shards > 1:
            self.k_pools = [torch.zeros(pool_shape, dtype=self.dtype,
                                        device=d)
                            for d in self.group.devices]
            self.v_pools = [torch.zeros_like(k) for k in self.k_pools]
        else:
            self.k_pools = torch.zeros(pool_shape, dtype=self.dtype,
                                       device=self.device)
            self.v_pools = torch.zeros_like(self.k_pools)
        self.windows = _layer_windows(cfg, L)
        self.steps_executed = 0
        # distinct (t, np, w, k) buckets first seen (the reference counts
        # its compiled step variants); must equal len(buckets_used)
        self.jit_traces = 0
        self.buckets_used: set = set()
        self._pending_copies: List[Tuple[int, int]] = []
        # split swap queues: the K and V halves of a block queue
        # independently.  Entries are (slot, HostHalf).
        self._pending_swap_k: List[Tuple[int, HostHalf]] = []
        self._pending_swap_v: List[Tuple[int, HostHalf]] = []
        # device-resident zero payload (in the wire dtype) and q8 scale
        # reused on swap-free steps (their destinations are all padded
        # into the drop page anyway); sharded: one a shard, on its device
        zshape = (L, ecfg.max_instep_swaps, ecfg.page_size,
                  cfg.n_kv_heads, cfg.head_dim)
        if self.n_shards > 1:
            zeros = {d: torch.zeros(zshape, dtype=self._payload_dtype,
                                    device=d) for d in self.group.devices}
            self._zero_swap = [zeros[d] for d in self.group.devices]
        else:
            self._zero_swap = torch.zeros(zshape, dtype=self._payload_dtype,
                                          device=self.device)
        self._zero_scale = (torch.zeros(
            (L, ecfg.max_instep_swaps, cfg.n_kv_heads), dtype=torch.float32,
            device=self.device) if self._payload_fmt == "q8" else None)
        self.n_seqs = ecfg.max_prefills + ecfg.max_decodes
        self.t_max = ecfg.max_prefills * ecfg.max_chunk + ecfg.max_decodes
        self.token_buckets, self.np_buckets = derive_bucket_lattice(ecfg)
        self._t_bucket_set = set(self.token_buckets)
        self._np_bucket_set = set(self.np_buckets)
        # deterministic accounting (same names as the reference)
        self.attn_dispatches = 0       # per-layer attention dispatches
        self.valid_token_rows = 0      # real compute tokens executed
        self.total_token_rows = 0      # token rows incl. bucket padding
        self.bucket_counts: Dict[Tuple[int, int], int] = {}
        self.instep_copies = 0
        self.eager_copies = 0
        self.instep_swaps = 0          # per half
        self.eager_swaps = 0
        self.swap_bytes_shipped = 0
        self.decode_only_dispatches = 0
        self.decode_tokens_emitted = 0
        self.multi_token_dispatches = 0    # dispatches with k > 1
        self.multi_token_iterations = 0    # sum of k over those
        self.multi_token_rollbacks = 0     # masked (unconsumed) iterations
        self.k_counts: Dict[int, int] = {}
        # the server's tracer (serving/tracing.py; None: off), and whether
        # each layer's parts get a profiler range (while one records)
        self.tracer = None
        self.layer_ranges = False
        self._layouts: Dict[Tuple[int, int, int, int],
                            Tuple[List[Tuple[str, int, int]], int]] = {}
        # CUDA graphs of the step (_step_impl): the captured ones, the
        # memory pool they share, the stream they are captured on and the
        # static swap payloads every graph reads (made at the first
        # capture); one count a step
        self._graphs: Dict[Tuple[int, int, int, int], _StepGraph] = {}
        self._graph_pool = None
        self._capture_stream = None
        self._graph_swap: Dict[str, Optional[torch.Tensor]] = {}
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_eager_steps = 0

    # ------------------------------------------------------------------
    def pack_layout(self, t_bucket: int, np_bucket: int, w_bucket: int,
                    n_iter: int = 1):
        """Cached :func:`pack_layout_for` of one bucket."""
        key = (t_bucket, np_bucket, w_bucket, n_iter)
        if key not in self._layouts:
            self._layouts[key] = pack_layout_for(self.ecfg, t_bucket,
                                                 np_bucket, w_bucket, n_iter,
                                                 self.n_shards)
        return self._layouts[key]

    def buckets_for(self, plan: StepPlan) -> Tuple[int, int]:
        """Resolve the step's (t_bucket, np_bucket).  The scheduler's
        selection (``plan.t_bucket``/``plan.np_bucket``) is honored when
        it names an entry of THIS engine's lattice that fits the plan;
        anything else falls back to the smallest fitting own-lattice
        entry, so no off-lattice variant appears and a legal plan always
        fits.  A split step always runs at ``(R * QP + B, NP)``."""
        bs = self.ecfg.page_size
        need_p = 1
        for c in plan.prefills:
            need_p = max(need_p, -(-(int(c.positions[-1]) + 1) // bs))
        for req in plan.decodes:
            ctx = req.prompt_len + len(req.generated) \
                + plan.decode_steps - 1
            need_p = max(need_p, -(-ctx // bs))
        if need_p > self.ecfg.max_blocks_per_seq:
            # a block table wider than NP would be cut off and the
            # attention would silently drop the context past it
            raise ValueError(
                f"a sequence needs {need_p} pages > max_blocks_per_seq="
                f"{self.ecfg.max_blocks_per_seq}")
        if self.ecfg.attn_mode != "fused":
            return self.t_max, self.ecfg.max_blocks_per_seq
        need_t = plan.n_compute_tokens
        tb = plan.t_bucket
        if tb not in self._t_bucket_set or tb < need_t:
            tb = next((b for b in self.token_buckets if b >= need_t),
                      self.token_buckets[-1])
        nb = plan.np_bucket
        if nb not in self._np_bucket_set or nb < need_p:
            nb = next((b for b in self.np_buckets if b >= need_p),
                      self.np_buckets[-1])
        assert tb >= need_t, (tb, need_t)
        return tb, nb

    # ------------------------------------------------------------------
    def _step_impl(self, params, inp, t_bucket: int, np_bucket: int,
                   w_bucket: int, n_iter: int = 1):
        """One step on the device (:meth:`_step_eager`), replayed from its
        bucket's CUDA graph where the step allows one
        (:meth:`_graph_eligible`).  Such a step runs eager the first time
        its ``(t, np, w, k)`` bucket is met, which also warms cuBLAS and
        the kernels' one-time set-up; at the bucket's next use outside a
        profiler it is captured and replayed at once; later uses replay.
        Every other step runs eager.  Each step counts once in
        ``graph_captures``, ``graph_replays`` or ``graph_eager_steps``."""
        key = (t_bucket, np_bucket, w_bucket, n_iter)
        if self._graph_eligible(params):
            g = self._graphs.get(key)
            # buckets_used: the buckets dispatched before this step
            if g is None and key in self.buckets_used \
                    and not torch.autograd._profiler_enabled():
                g = self._graphs[key] = self._capture(params, inp, key)
                self.graph_captures += 1
            elif g is not None:
                self.graph_replays += 1
            if g is not None:
                return self._replay(g, inp)
        self.graph_eager_steps += 1
        return self._step_eager(params, inp, t_bucket, np_bucket, w_bucket,
                                n_iter)

    def _graph_eligible(self, params) -> bool:
        """Whether a step may run from a CUDA graph: on the card, single
        device, the fused layout with vectorized assembly and sampled ids
        out, the release kernels (the bounds-checked build copies its
        extents from the host at every launch) and the engine's own
        weights (a graph holds their addresses).  The CPU, the split
        layout, sharded engines and the synchronous baseline's legacy
        assembly and full logits run eager."""
        e = self.ecfg
        return (self.device.type == "cuda" and self.n_shards == 1
                and e.attn_mode == "fused" and e.assembly != "legacy"
                and not e.return_full_logits and not _build.checked()
                and params is self.params)

    def _capture(self, params, inp, key) -> _StepGraph:
        """Capture bucket ``key``'s step into a CUDA graph; nothing runs on
        the card.  The graph reads a pack buffer of its own and the
        engine's static swap payloads, all allocated outside any graph's
        memory; its temporaries and outputs live in the one pool every
        graph shares.  That is safe because replays run one after another
        on one stream, each copies its inputs in just before it and clones
        its outputs out just after it (:meth:`_replay`)."""
        tr = self.tracer
        if tr is not None:
            tr.open("capture")
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_swap = {
                name: None if z is None else torch.zeros_like(z)
                for name, z in (("swap_k", self._zero_swap),
                                ("swap_v", self._zero_swap),
                                ("swap_k_scale", self._zero_scale),
                                ("swap_v_scale", self._zero_scale))}
        static = {"pack": torch.empty_like(inp["pack"]), **self._graph_swap}
        before = msa_fused_cuda.launches
        graph = torch.cuda.CUDAGraph()
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        # no automatic collection inside the capture: one could free an
        # unreachable engine's graphs or events, a call the capture
        # refuses, and the capture would fail
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._graph_pool,
                                    capture_error_mode="thread_local")
                try:
                    token_ids, logits = self._step_eager(params, static,
                                                         *key)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        launches = msa_fused_cuda.launches - before
        msa_fused_cuda.launches = before      # each replay counts them
        if tr is not None:
            tr.close()
        return _StepGraph(graph, static, token_ids, logits, launches)

    def _replay(self, g: _StepGraph, inp):
        """Run a step from its bucket's graph: its pack and any swap
        payload copied into the graph's static inputs on the stream, the
        replay, the launches its capture counted, and its ids and logit
        rows cloned out of the graph's memory (the next replay of any
        graph overwrites it, and the loop dispatches step N+1 before it
        retires step N)."""
        tr = self.tracer
        if tr is not None:
            tr.open("replay")
        s = g.inp
        s["pack"].copy_(inp["pack"])
        for half in ("swap_k", "swap_v"):
            if inp[half] is not self._zero_swap:
                # this half swaps pages in.  A swap-free half sends every
                # destination to the drop page, which no block table
                # references, so the stale bytes of the static payload
                # land where nothing reads them
                s[half].copy_(inp[half])
                if s[half + "_scale"] is not None:
                    s[half + "_scale"].copy_(inp[half + "_scale"])
        g.graph.replay()
        msa_fused_cuda.launches += g.launches
        out = g.token_ids.clone(), g.logits.clone()
        if tr is not None:
            tr.close()
        return out

    def _step_eager(self, params, inp, t_bucket: int, np_bucket: int,
                    w_bucket: int, n_iter: int = 1):
        """One step on the device, launched op by op (and so what a
        bucket's CUDA graph captures): in-step page ops, then per layer
        norm -> q/k/v -> rope -> KV write -> attention (ONE ``msa_fused``
        dispatch, or ``msa_prefill`` + ``msa_decode`` in split mode) ->
        wo -> MLP, then the final norm, the logits at ``sel`` and the
        greedy argmax on the device.  ``n_iter > 1`` runs the k fused
        decode iterations of a multi-token plan instead.  A sharded engine
        runs :meth:`_sharded_pass` over its shards."""
        e = self.ecfg
        if self.n_shards > 1:
            inps = [self._unpack(inp, t_bucket, np_bucket, w_bucket, 1,
                                 shard=i) for i in range(self.n_shards)]
            sharded_pool_ops(self.group, self.k_pools, self.v_pools, *(
                [d[f] for d in inps] for f in (
                    "swap_k_dst", "swap_v_dst", "swap_k", "swap_v",
                    "copy_src", "copy_dst")))
            x = self._sharded_pass(params, inps, t_bucket)
            token_ids, logits = self._sharded_sample(params, x, inps)
            return token_ids, self._out_logits(logits)
        if e.assembly != "legacy":
            # the legacy path moved each field to the device by itself
            inp = self._unpack(inp, t_bucket, np_bucket, w_bucket, n_iter)
        # swap-ins land first (they commit pages a COW fork in the same
        # round may use as its donor), then copies; both precede the KV
        # writes and attention that read those pages
        apply_swap_ins(self.k_pools, self.v_pools, inp["swap_k_dst"],
                       inp["swap_v_dst"], inp["swap_k"], inp["swap_v"],
                       inp["swap_k_scale"], inp["swap_v_scale"])
        apply_page_copies(self.k_pools, self.v_pools, inp["copy_src"],
                          inp["copy_dst"])
        if n_iter > 1:
            return self._multi_decode_steps(params, inp, t_bucket, n_iter)

        if e.attn_mode == "fused":
            x = self._fused_pass(
                params, inp["tokens"], inp["positions"], inp["valid"],
                inp["write_slot"], inp["write_off"], inp["ctx"], inp["bt"],
                inp["seq_ids"], tuple(inp[f] for f in WL_FIELDS),
                tuple(inp[f] for f in UNIT_FIELDS), t_bucket)
        else:
            cfg = self.cfg
            R, QP = e.max_prefills, e.max_chunk
            RQP = R * QP
            H, hd = cfg.n_heads, cfg.head_dim
            qpos_pre = inp["positions"][:RQP].view(R, QP)

            def attend(l, q, kp, vp):
                op = msa_prefill(
                    q[:RQP].view(R, QP, H, hd), kp, vp, inp["bt_pre"],
                    inp["ctx_pre"], qpos_pre, inp["qlens"],
                    window=self.windows[l], softcap=cfg.attn_logit_softcap)
                od = msa_decode(
                    q[RQP:], kp, vp, inp["bt_dec"], inp["ctx_dec"],
                    window=self.windows[l], softcap=cfg.attn_logit_softcap)
                return torch.cat([op.view(RQP, H, hd), od])

            x = self._layers(params, inp["tokens"], inp["positions"],
                             inp["write_slot"], inp["write_off"],
                             inp["valid"], attend)
        token_ids, logits = self._sample(params, x, inp["sel"])
        return token_ids, self._out_logits(logits)

    def _out_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits a step hands back: the R prefill rows, or all
        (R+B, V) under ``return_full_logits``."""
        if self.ecfg.return_full_logits:
            return logits
        return logits[:self.ecfg.max_prefills]

    def _layers(self, params, tokens, pos, write_slot, write_off, valid,
                attend):
        """Embed ``tokens`` and run every layer over the stream: norm ->
        q/k/v -> rope -> snap -> KV write -> ``attend(l, q, k_pool,
        v_pool)`` -> wo -> MLP (or MoE).  Returns the residual before the
        final norm."""
        cfg = self.cfg
        blocks = params["blocks"]
        x = params["embed"][tokens.long()]               # (T, d)
        T, d = x.shape
        H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for l in range(cfg.n_layers):
            h = rms_norm(x, blocks["attn_norm"][l], cfg.norm_eps)
            q = (h @ blocks["wq"][l].reshape(d, H * hd)).view(T, H, hd)
            k_new = (h @ blocks["wk"][l].reshape(d, KH * hd)).view(T, KH, hd)
            v_new = (h @ blocks["wv"][l].reshape(d, KH * hd)).view(T, KH, hd)
            if cfg.rope_theta > 0:
                q = apply_rope(q, pos, cfg.rope_theta)
                k_new = apply_rope(k_new, pos, cfg.rope_theta)
            kp, vp = self.k_pools[l], self.v_pools[l]
            write_kv_pages(kp, vp, self._snap(k_new), self._snap(v_new),
                           write_slot, write_off, valid)
            with self._range("attn"):
                attn = attend(l, q, kp, vp)
            x = x + attn.reshape(T, H * hd) @ blocks["wo"][l].reshape(
                H * hd, d)
            x = self._mlp_sublayer(x, blocks, l)
        return x

    def _snap(self, x: torch.Tensor) -> torch.Tensor:
        """Snap freshly computed K/V to the offload quantization grid at
        write time: "int8" rounds to the static ``snap_scale`` grid
        (half-to-even, clipped to ±127 steps), "fp8" rounds through
        ``float8_e4m3fn``.  Pool values are then on the grid from the
        instant they exist, so spill-time quantization recovers the exact
        codes and the swap-in reproduces the pool bytes bit for bit; a
        recompute runs this same write path and reproduces them too.  The
        int8 codes have no -0, so the int8 grid writes +0 where the JAX
        engine writes -0 (the same value), or a restored page would differ
        from its spilled self in the sign of its zeros."""
        mode = self.ecfg.snap
        if mode == "off":
            return x
        if mode == "int8":
            q = torch.clamp(torch.round(x.float() / self._snap_scale),
                            -127.0, 127.0)
            q = q.masked_fill(q == 0, 0.0)
            return (q * self._snap_scale).to(x.dtype)
        return f8_values(f8_codes(x), x.dtype)

    def _mlp_sublayer(self, x, blocks, l: int) -> torch.Tensor:
        """Layer ``l``'s norm and MLP (SwiGLU, or the MoE over the
        reference's capacity layout), added to the residual ``x``."""
        return x + self._mlp_out(x, blocks, l)

    def _mlp_out(self, x, blocks, l: int) -> torch.Tensor:
        """Layer ``l``'s norm and MLP of the residual ``x`` (on a shard:
        its part of the sum over the ffn columns)."""
        cfg = self.cfg
        h2 = rms_norm(x, blocks["mlp_norm"][l], cfg.norm_eps)
        if cfg.moe is not None:
            m = cfg.moe
            with self._range("moe"):
                y = moe_ffn_local(h2, blocks["router"][l], blocks["we1"][l],
                                  blocks["we3"][l], blocks["we2"][l],
                                  m.top_k, m.capacity_factor,
                                  dropless=m.dropless,
                                  expert_split=m.expert_split)
        else:
            with self._range("mlp"):
                y = swiglu_mlp(h2, blocks["w1"][l], blocks["w3"][l],
                               blocks["w2"][l])
        return y

    def _range(self, name: str):
        """A profiler range ``repro.<name>`` around one part of a layer
        while the tracer sees a profiler recording; a shared no-op
        context otherwise."""
        if self.layer_ranges:
            return torch.profiler.record_function(PREFIX + name)
        return NO_RANGE

    def _fused_pass(self, params, tokens, pos, valid, write_slot, write_off,
                    ctx, bt, seq_ids, worklist, units, t_bucket: int):
        """One fused forward over a varlen token stream: per layer the KV
        page write and ONE ``msa_fused`` dispatch over the whole mixed
        stream.  A single step and each iteration of a multi-token plan
        run this same function, op for op (the k-vs-1 identity depends on
        it).  Returns the residual before the final norm."""
        cfg = self.cfg
        tq = min(self.ecfg.q_tile, t_bucket)

        def attend(l, q, kp, vp):
            return msa_fused(q, kp, vp, bt, ctx, pos, seq_ids, valid,
                             worklist=worklist, units=units,
                             window=self.windows[l],
                             softcap=cfg.attn_logit_softcap, q_tile=tq)

        return self._layers(params, tokens, pos, write_slot, write_off,
                            valid, attend)

    def _sharded_pass(self, params, inps, t_bucket: int):
        """The fused forward of a sharded step: per shard ``i``, its
        weights ``params[i]`` and its view ``inps[i]`` of the step's
        inputs; a value every shard holds is a list, one tensor a shard.
        Per layer: norm, q/k/v on the shard's heads (rope on them), the
        heads gathered, the KV write and the attention partial of each
        shard's pages merged exactly (``sharded_msa_fused``), ``wo`` on
        the shard's heads and the MLP on its ffn columns, each summed over
        the shards.  Returns the residual before the final norm, per
        shard."""
        cfg, g = self.cfg, self.group
        n, L = g.n, cfg.n_layers
        hd = cfg.head_dim
        col = {a: self.rules[a] == "model" for a in
               ("heads", "kv_heads", "ffn", "expert_ffn")}
        field = lambda name: [d[name] for d in inps]           # noqa: E731
        pos = field("positions")
        x = self._sharded_embed(params, field("tokens"))
        tables = [shard_tables(i, self.p_loc, d["write_slot"], d["valid"],
                               d["bt"]) for i, d in enumerate(inps)]
        worklists = [tuple(d[f] for f in WL_FIELDS) for d in inps]
        units = [tuple(d[f] for f in UNIT_FIELDS) for d in inps]
        tq = min(self.ecfg.q_tile, t_bucket)

        def project(hs, name, l, split):
            out = []
            for i in range(n):
                w = params[i]["blocks"][name][l]
                y = (hs[i] @ w.reshape(w.shape[0], -1)).view(
                    hs[i].shape[0], -1, hd)
                if name != "wv" and cfg.rope_theta > 0:
                    y = apply_rope(y, pos[i], cfg.rope_theta)
                out.append(y)
            return g.all_gather(out, dim=1) if split else out

        def reduce(ys, split):
            return g.all_reduce_sum(ys) if split else ys

        for l in range(L):
            hs = [rms_norm(x[i], params[i]["blocks"]["attn_norm"][l],
                           cfg.norm_eps) for i in range(n)]
            q = project(hs, "wq", l, col["heads"])
            k_new = project(hs, "wk", l, col["kv_heads"])
            v_new = project(hs, "wv", l, col["kv_heads"])
            attn = sharded_msa_fused(
                g, q, [kp[l] for kp in self.k_pools],
                [vp[l] for vp in self.v_pools], k_new, v_new,
                field("write_slot"), field("write_off"), field("valid"),
                field("bt"), field("ctx"), pos, field("seq_ids"),
                window=self.windows[l], softcap=cfg.attn_logit_softcap,
                worklists=worklists, units=units, q_tile=tq, tables=tables)
            ys = []
            for i in range(n):
                wo = params[i]["blocks"]["wo"][l]        # (H or H/N, hd, d)
                h0 = i * wo.shape[0] if col["heads"] else 0
                a = attn[i][:, h0:h0 + wo.shape[0]].reshape(
                    attn[i].shape[0], -1)
                ys.append(a @ wo.reshape(-1, wo.shape[-1]))
            ys = reduce(ys, col["heads"])
            x = [x[i] + ys[i] for i in range(n)]
            ys = [self._mlp_out(x[i], params[i]["blocks"], l)
                  for i in range(n)]
            ys = reduce(ys, col["expert_ffn"] if cfg.moe is not None
                        else col["ffn"])
            x = [x[i] + ys[i] for i in range(n)]
        return x

    def _sharded_embed(self, params, tokens):
        """Embedding rows of ``tokens`` from a vocab-sharded table: each
        shard looks up the ids in its range (zeros elsewhere) and the
        shards' rows are summed (one non-zero term, so exact)."""
        g = self.group
        if self.rules["vocab"] != "model":
            return [p["embed"][t.long()] for p, t in zip(params, tokens)]
        rows = []
        for i in range(g.n):
            emb = params[i]["embed"]
            local = tokens[i].long() - i * emb.shape[0]
            ok = (local >= 0) & (local < emb.shape[0])
            rows.append(torch.where(ok[:, None],
                                    emb[local.clamp(0, emb.shape[0] - 1)],
                                    0.0).to(emb.dtype))
        return g.all_reduce_sum(rows)

    def _sharded_sample(self, params, x, inps):
        """Final norm and the logits at the ``sel`` rows on each shard's
        vocab columns, gathered on the first shard's device for the greedy
        argmax."""
        cfg, g = self.cfg, self.group
        logits = []
        for i in range(g.n):
            h = rms_norm(x[i], params[i]["final_norm"], cfg.norm_eps)
            head = params[i]["embed"].T if cfg.tie_embeddings \
                else params[i]["lm_head"]
            logits.append(h[inps[i]["sel"].long()] @ head)
        full = g.gather(logits, dim=-1) if self.rules["vocab"] == "model" \
            else logits[0]
        return torch.argmax(full, dim=-1).to(torch.int32), full

    def _sample(self, params, x, sel):
        """Final norm, the logits at the ``sel`` rows and the greedy
        argmax on the device: only (R+B,) ids and the R prefill rows
        (losslessness checks) leave the device."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x[sel.long()] @ head                    # (R+B, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits

    def _multi_decode_steps(self, params, inp, t_bucket: int, n_iter: int):
        """k sequential fused decode iterations in one dispatch.

        Each iteration's input token is the host-forced id where it is
        >= 0, else the previous iteration's greedy sample for that row,
        gathered on the device through ``seq_ids``.  The scripted serving
        loop always forces, so runs stay teacher-forced and comparable
        with k = 1.  Iterations at or past a request's ``decode_iters``
        are masked (valid 0: the KV write lands in the drop page; qlen 0:
        no attention row); the host never consumes their ids.  Returns
        the ids, (k, R+B), and the last iteration's prefill logit rows
        (all its rows under ``return_full_logits``)."""
        seq_ids = inp["seq_ids"]
        ids_steps = []
        prev = logits = None
        for i in range(n_iter):
            tok = inp["tokens"][i]
            if prev is not None:
                tok = torch.where(tok >= 0, tok, prev[seq_ids.long()])
            x = self._fused_pass(
                params, tok.clamp(min=0), inp["positions"][i],
                inp["valid"][i], inp["write_slot"][i], inp["write_off"][i],
                inp["ctx"][i], inp["bt"], seq_ids,
                tuple(inp[f][i] for f in WL_FIELDS),
                tuple(inp[f][i] for f in UNIT_FIELDS), t_bucket)
            prev, logits = self._sample(params, x, inp["sel"])
            ids_steps.append(prev)
        return torch.stack(ids_steps), self._out_logits(logits)

    # ------------------------------------------------------------------
    def build_inputs(self, plan: StepPlan):
        """Host-side assembly of one step's device inputs.

        Returns ``(inp, (t_bucket, np_bucket, w_bucket))``: every int32
        field assembled into named views of ONE flat host buffer moved to
        the device in one copy, plus the two swap-payload buffers.  A
        multi-token plan gets one work-list and one set of work units an
        iteration, all padded to one shared W, so the bucket key stays
        ``(t, np, w, k)``.  A sharded engine builds one work-list and one
        set of units a shard, over the shard's local pages, all padded to
        one shared W, and moves the buffer to each shard's device.

        Legacy assembly (the synchronous baseline) builds the split
        layout's eleven fields in per-token loops, folds the page ops into
        index arrays of their own, and moves each field to the device by
        its own copy, as the reference's ``{k: jnp.asarray(v)}`` does."""
        t_b, np_b = self.buckets_for(plan)
        n_it = plan.decode_steps
        if n_it > 1 and (self.ecfg.attn_mode != "fused"
                         or self.n_shards > 1
                         or self.ecfg.assembly == "legacy"):
            raise ValueError("multi-token decode dispatch requires the "
                             "fused single-device vectorized layout")
        if self.ecfg.assembly == "legacy":
            out = self._assemble_legacy(plan)
            out.update(self._fold_page_ops())
            # one host-to-device copy a field: the baseline's cost
            return ({k: torch.from_numpy(v).to(self.device)
                     if isinstance(v, np.ndarray) else v
                     for k, v in out.items()}, (t_b, np_b, 0))
        if self.ecfg.attn_mode != "fused":
            layout, size = self.pack_layout(t_b, np_b, 0)
            buf = np.zeros((size,), np.int32)
            views = {name: buf[off:off + size_]
                     for name, off, size_ in layout}
            self._assemble_vectorized(plan, views)
            return self._pack_inputs(buf, views), (t_b, np_b, 0)
        # one derivation of the varlen metadata feeds both the packed
        # buffer and the work-list builder
        if n_it > 1:
            fields = self._assemble_fused_multi(plan, t_b, np_b, n_it)
        else:
            fields = self._assemble_fused(plan, t_b, np_b)
        tq = min(self.ecfg.q_tile, t_b)
        n_tiles = -(-t_b // tq)
        # (k, ·) views of the per-iteration fields, k = 1 included
        qlen, ctx, pos = (fields[f].reshape(n_it, -1)
                          for f in ("qlen", "ctx", "positions"))
        bt = fields["bt"]
        # one work-list an (shard, iteration), in that order
        wls = []
        for sh in range(self.n_shards):
            page_valid, table = None, bt
            if self.n_shards > 1:
                lo = sh * self.p_loc
                page_valid = (bt >= lo) & (bt < lo + self.p_loc)
                table = np.where(page_valid, bt - lo, 0)
            wls += [build_worklist(
                fields["qstart"], qlen[i], ctx[i], table, pos[i],
                page=self.ecfg.page_size, q_tile=tq, n_tiles=n_tiles,
                window=0, page_valid=page_valid)[0] for i in range(n_it)]
        w_b = max(WL_BUCKET, 1 << (max(
            wl["wl_seq"].shape[0] for wl in wls) - 1).bit_length())
        layout, size = self.pack_layout(t_b, np_b, w_b, n_it)
        buf = np.zeros((size,), np.int32)
        views = {name: buf[off:off + size_] for name, off, size_ in layout}
        for name, arr in fields.items():
            views[name][:] = arr.reshape(-1)
        for j, wl in enumerate(wls):
            i = j % n_it
            wl = pad_worklist(wl, w_b, sentinel_seq=self.n_seqs)
            units = build_units(
                wl, fields["qstart"], qlen[i], n_rows=t_b, q_tile=tq,
                n_tiles=n_tiles, pad_to=unit_bucket(w_b, n_tiles))
            for name, arr in (*wl.items(), *units.items()):
                views[name].reshape(len(wls), -1)[j] = arr
        return self._pack_inputs(buf, views), (t_b, np_b, w_b)

    def _pack_inputs(self, buf: np.ndarray, views: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """Fold the queued page ops into the packed buffer and move it to
        the device in one copy, beside the two swap payloads and, in the
        q8 wire format, their scales (None otherwise).  Sharded: one copy
        of the buffer a distinct shard device, and per-shard payloads."""
        if self.n_shards > 1:
            ops = self._fold_page_ops_sharded(views)
            pack = torch.from_numpy(buf)
            on = {d: pack.to(d) for d in self.group.devices}
            return {"pack": [on[d] for d in self.group.devices], **ops}
        ops = self._fold_page_ops(views)
        return {"pack": torch.from_numpy(buf).to(self.device), **ops}

    def _unpack(self, inp: Dict[str, torch.Tensor], t_bucket: int,
                np_bucket: int, w_bucket: int, n_iter: int = 1,
                shard: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Slices of the packed device buffer back into named step inputs
        (views of the one transferred buffer); a multi-token plan's
        per-iteration fields fold out to (k, ·).  ``shard``: that shard's
        view, from its device's buffer, with its own row of the (N, ·)
        work-list, work-unit and page-op fields and its payloads."""
        layout, _ = self.pack_layout(t_bucket, np_bucket, w_bucket, n_iter)
        buf = inp["pack"] if shard is None else inp["pack"][shard]
        out = {name: buf[off:off + size] for name, off, size in layout}
        if shard is not None:
            for f in WL_FIELDS + UNIT_FIELDS + (
                    "copy_src", "copy_dst", "swap_k_dst", "swap_v_dst"):
                out[f] = out[f].view(self.n_shards, -1)[shard]
            for name in ("swap_k", "swap_v"):
                out[name] = inp[name][shard]
            inp = {"swap_k_scale": None, "swap_v_scale": None,
                   "swap_k": out["swap_k"], "swap_v": out["swap_v"]}
        out["valid"] = out["valid"].bool()
        e = self.ecfg
        if e.attn_mode == "fused":
            out["bt"] = out["bt"].view(self.n_seqs, np_bucket)
            if n_iter > 1:
                for f in ("tokens", "positions", "valid", "write_slot",
                          "write_off", "qlen", "ctx") + WL_FIELDS \
                        + UNIT_FIELDS:
                    out[f] = out[f].view(n_iter, -1)
        else:
            NP = e.max_blocks_per_seq
            out["bt_pre"] = out["bt_pre"].view(e.max_prefills, NP)
            out["bt_dec"] = out["bt_dec"].view(e.max_decodes, NP)
        for name in ("swap_k", "swap_v", "swap_k_scale", "swap_v_scale"):
            out[name] = inp[name]
        return out

    # ------------------------------------------------------------------
    def _assemble_fused(self, plan: StepPlan, t_bucket: int,
                        np_bucket: int) -> Dict[str, np.ndarray]:
        """Varlen assembly: prefill chunks pack densely at the head of
        the flattened stream, decode rows follow as runs of length 1.
        Sequence rows 0..R-1 are prefills, R..R+B-1 decodes; only bucket
        slack at the tail is padding.  Returns the named field arrays —
        the single source for the packed buffer and the work-list."""
        e = self.ecfg
        bs = e.page_size
        R, B = e.max_prefills, e.max_decodes
        t = t_bucket
        tokens = np.zeros((t,), np.int32)
        positions = np.zeros((t,), np.int32)
        valid = np.zeros((t,), np.int32)
        write_slot = np.zeros((t,), np.int32)
        write_off = np.zeros((t,), np.int32)
        seq_ids = np.zeros((t,), np.int32)
        sel = np.zeros((R + B,), np.int32)
        qstart = np.zeros((self.n_seqs,), np.int32)
        qlen = np.zeros((self.n_seqs,), np.int32)
        ctx = np.zeros((self.n_seqs,), np.int32)
        bt = np.zeros((self.n_seqs, np_bucket), np.int32)

        assert len(plan.prefills) <= R and len(plan.decodes) <= B
        off = 0
        for r, chunk in enumerate(plan.prefills):
            req = chunk.req
            pos = np.asarray(chunk.positions, np.int32)
            n = pos.shape[0]
            slots = req.slot_array()
            tokens[off:off + n] = req.token_array()[pos]
            positions[off:off + n] = pos
            valid[off:off + n] = True
            write_slot[off:off + n] = slots[pos // bs]
            write_off[off:off + n] = pos % bs
            seq_ids[off:off + n] = r
            qstart[r] = off
            qlen[r] = n
            ctx[r] = pos[-1] + 1
            k = min(np_bucket, slots.shape[0])
            bt[r, :k] = slots[:k]
            sel[r] = off + n - 1
            off += n

        nd = len(plan.decodes)
        if nd:
            p = np.fromiter(
                (req.prompt_len + len(req.generated) - 1
                 for req in plan.decodes), np.int32, nd)
            tokens[off:off + nd] = np.fromiter(
                (req.generated[-1] for req in plan.decodes), np.int32, nd)
            positions[off:off + nd] = p
            valid[off:off + nd] = True
            write_slot[off:off + nd] = np.fromiter(
                (req.slot_array()[pi // bs]
                 for req, pi in zip(plan.decodes, p)), np.int32, nd)
            write_off[off:off + nd] = p % bs
            rows = off + np.arange(nd, dtype=np.int32)
            seq_ids[off:off + nd] = R + np.arange(nd, dtype=np.int32)
            qstart[R:R + nd] = rows
            qlen[R:R + nd] = 1
            ctx[R:R + nd] = p + 1
            for i, req in enumerate(plan.decodes):
                slots = req.slot_array()
                k = min(np_bucket, slots.shape[0])
                bt[R + i, :k] = slots[:k]
            sel[R:R + nd] = rows
            off += nd
        assert off <= t_bucket, (off, t_bucket)
        return dict(tokens=tokens, positions=positions, valid=valid,
                    write_slot=write_slot, write_off=write_off,
                    seq_ids=seq_ids, sel=sel, qstart=qstart, qlen=qlen,
                    ctx=ctx, bt=bt)

    def _assemble_fused_multi(self, plan: StepPlan, t_bucket: int,
                              np_bucket: int,
                              k: int) -> Dict[str, np.ndarray]:
        """Per-iteration varlen assembly of a decode-only multi-token plan
        (``decode_steps == k > 1``).

        Iteration ``i`` of decode row ``j`` feeds the teacher-forced token
        at logical position ``p0_j + i`` (``output_script[gen - 1 + i]``,
        the id iteration ``i - 1`` emits under forcing) and writes that
        position's KV page.  Iterations at or past ``decode_iters[j]`` are
        masked: valid 0 (the write lands in the drop page), qlen 0 and
        ctx 0 (no attention row); row j keeps its place, so the stream
        has holes (:func:`unit_bucket`).  The device still computes the
        row's logits, which the host never consumes."""
        e = self.ecfg
        bs = e.page_size
        R, B = e.max_prefills, e.max_decodes
        t, n = t_bucket, self.n_seqs
        nd = len(plan.decodes)
        assert not plan.prefills and 0 < nd <= B
        iters = np.asarray(plan.decode_iters, np.int32)
        # every row is live in the first iteration (unit_bucket relies on
        # it)
        assert iters.shape == (nd,) and int(iters.max()) == k \
            and int(iters.min()) >= 1

        tokens = np.zeros((k, t), np.int32)
        positions = np.zeros((k, t), np.int32)
        valid = np.zeros((k, t), np.int32)
        write_slot = np.zeros((k, t), np.int32)
        write_off = np.zeros((k, t), np.int32)
        seq_ids = np.zeros((t,), np.int32)
        sel = np.zeros((R + B,), np.int32)
        qstart = np.zeros((n,), np.int32)
        qlen = np.zeros((k, n), np.int32)
        ctx = np.zeros((k, n), np.int32)
        bt = np.zeros((n, np_bucket), np.int32)

        rows = np.arange(nd, dtype=np.int32)
        p0 = np.fromiter((req.prompt_len + len(req.generated) - 1
                          for req in plan.decodes), np.int32, nd)
        gen = np.fromiter((len(req.generated) for req in plan.decodes),
                          np.int32, nd)
        seq_ids[:nd] = R + rows
        qstart[R:R + nd] = rows
        sel[R:R + nd] = rows
        for j, req in enumerate(plan.decodes):
            slots = req.slot_array()
            m = min(np_bucket, slots.shape[0])
            bt[R + j, :m] = slots[:m]
        for i in range(k):
            act = i < iters                 # (nd,) live this iteration
            p = p0 + i
            positions[i, :nd] = np.where(act, p, 0)
            valid[i, :nd] = act
            qlen[i, R:R + nd] = act
            ctx[i, R:R + nd] = np.where(act, p + 1, 0)
            write_off[i, :nd] = np.where(act, p % bs, 0)
            for j, req in enumerate(plan.decodes):
                if act[j]:
                    tokens[i, j] = req.output_script[gen[j] - 1 + i]
                    write_slot[i, j] = req.slot_array()[p[j] // bs]
        return dict(tokens=tokens, positions=positions, valid=valid,
                    write_slot=write_slot, write_off=write_off,
                    seq_ids=seq_ids, sel=sel, qstart=qstart, qlen=qlen,
                    ctx=ctx, bt=bt)

    def _assemble_vectorized(self, plan: StepPlan,
                             v: Dict[str, np.ndarray]) -> None:
        """Vectorized assembly of the split (two-dispatch) layout: numpy
        scatter/gather over per-request arrays cached on ``Request``
        (``token_array`` / ``slot_array``) into the packed-buffer views
        ``v``; Python loops run only over requests (≤ R prefills + B
        decodes), never over tokens.  Chunk r occupies stream rows
        ``r*QP .. r*QP + n``, decode row i row ``R*QP + i``.  Padding
        decode rows carry ``ctx_dec = 1`` and an all-zero block table:
        the decode kernel reads one page for them and they are never
        selected."""
        e = self.ecfg
        bs = e.page_size
        R, QP, B, NP = e.max_prefills, e.max_chunk, e.max_decodes, \
            e.max_blocks_per_seq
        tokens = v["tokens"]
        positions = v["positions"]
        valid = v["valid"]
        write_slot = v["write_slot"]
        write_off = v["write_off"]
        bt_pre = v["bt_pre"].reshape(R, NP)
        ctx_pre = v["ctx_pre"]
        qlens = v["qlens"]
        bt_dec = v["bt_dec"].reshape(B, NP)
        ctx_dec = v["ctx_dec"]
        ctx_dec[:] = 1
        sel = v["sel"]

        assert len(plan.prefills) <= R and len(plan.decodes) <= B
        for r, chunk in enumerate(plan.prefills):
            req = chunk.req
            pos = np.asarray(chunk.positions, np.int32)
            n = pos.shape[0]
            assert n <= QP, (n, QP)
            base = r * QP
            slots = req.slot_array()
            tokens[base:base + n] = req.token_array()[pos]
            positions[base:base + n] = pos
            valid[base:base + n] = True
            write_slot[base:base + n] = slots[pos // bs]
            write_off[base:base + n] = pos % bs
            qlens[r] = n
            ctx_pre[r] = pos[-1] + 1
            k = min(NP, slots.shape[0])
            bt_pre[r, :k] = slots[:k]
            sel[r] = base + n - 1

        nd = len(plan.decodes)
        if nd:
            p = np.fromiter(
                (req.prompt_len + len(req.generated) - 1
                 for req in plan.decodes), np.int32, nd)
            tokens[R * QP:R * QP + nd] = np.fromiter(
                (req.generated[-1] for req in plan.decodes), np.int32, nd)
            positions[R * QP:R * QP + nd] = p
            valid[R * QP:R * QP + nd] = True
            write_slot[R * QP:R * QP + nd] = np.fromiter(
                (req.slot_array()[pi // bs]
                 for req, pi in zip(plan.decodes, p)), np.int32, nd)
            write_off[R * QP:R * QP + nd] = p % bs
            ctx_dec[:nd] = p + 1
            for i, req in enumerate(plan.decodes):
                slots = req.slot_array()
                k = min(NP, slots.shape[0])
                bt_dec[i, :k] = slots[:k]
            sel[R:R + nd] = R * QP + np.arange(nd, dtype=np.int32)

    def _assemble_legacy(self, plan: StepPlan) -> Dict[str, np.ndarray]:
        """The reference's per-token Python-loop assembly of the split
        layout (the vectorized path's reference and the synchronous
        baseline's control plane): the same eleven fields as
        :meth:`_assemble_vectorized`, ``valid`` as bool, the block tables
        as (R, NP) and (B, NP)."""
        e = self.ecfg
        bs = e.page_size
        R, QP, B, NP = e.max_prefills, e.max_chunk, e.max_decodes, \
            e.max_blocks_per_seq
        T = R * QP + B
        tokens = np.zeros((T,), np.int32)
        positions = np.zeros((T,), np.int32)
        valid = np.zeros((T,), bool)
        write_slot = np.zeros((T,), np.int32)
        write_off = np.zeros((T,), np.int32)
        bt_pre = np.zeros((R, NP), np.int32)
        ctx_pre = np.zeros((R,), np.int32)
        qlens = np.zeros((R,), np.int32)
        bt_dec = np.zeros((B, NP), np.int32)
        ctx_dec = np.ones((B,), np.int32)
        sel = np.zeros((R + B,), np.int32)

        assert len(plan.prefills) <= R and len(plan.decodes) <= B
        for r, chunk in enumerate(plan.prefills):
            req = chunk.req
            toks = req.all_tokens
            n = len(chunk.positions)
            assert n <= QP, (n, QP)
            base = r * QP
            for i, p in enumerate(chunk.positions):
                tokens[base + i] = toks[p]
                positions[base + i] = p
                valid[base + i] = True
                write_slot[base + i] = req.block_slots[p // bs]
                write_off[base + i] = p % bs
            qlens[r] = n
            ctx_pre[r] = chunk.positions[-1] + 1
            for b, s in enumerate(req.block_slots[:NP]):
                bt_pre[r, b] = 0 if s is None else s
            sel[r] = base + n - 1

        for i, req in enumerate(plan.decodes):
            p = req.prompt_len + len(req.generated) - 1
            row = R * QP + i
            tokens[row] = req.generated[-1]
            positions[row] = p
            valid[row] = True
            write_slot[row] = req.block_slots[p // bs]
            write_off[row] = p % bs
            ctx_dec[i] = p + 1
            for b, s in enumerate(req.block_slots[:NP]):
                bt_dec[i, b] = 0 if s is None else s
            sel[R + i] = row

        return dict(
            tokens=tokens, positions=positions, valid=valid,
            write_slot=write_slot, write_off=write_off,
            bt_pre=bt_pre, ctx_pre=ctx_pre, qlens=qlens,
            bt_dec=bt_dec, ctx_dec=ctx_dec, sel=sel)

    def _fold_page_ops(self, views: Optional[Dict[str, np.ndarray]] = None
                       ) -> Dict[str, object]:
        """Drain queued COW copies / host-tier swap-ins into padded index
        fields (swap padding: dst == num_pages, the drop page); overflow
        past the static buckets goes eager.  With ``views`` the index
        fields are written into the packed buffer; without (legacy
        assembly) they come back as arrays of their own beside the
        payloads."""
        e = self.ecfg
        C = e.max_instep_copies
        copies, self._pending_copies = self._pending_copies, []
        if len(copies) > C:
            # eager copies run against the pools BEFORE this step, so any
            # queued swap-ins (which would otherwise land inside the step,
            # after the copy reads its donor) are flushed eagerly first —
            # a same-round swap-in may be the donor of one of these forks
            self._flush_swaps_eager()
            self.copy_pages(copies[C:])
            self.eager_copies += len(copies) - C
            copies = copies[:C]
        self.instep_copies += len(copies)
        # padding repeats the last real copy (idempotent: sources never
        # alias destinations) or is the identity 0 -> 0 on copy-free steps
        pad_src, pad_dst = copies[-1] if copies else (0, 0)
        own = views is None
        if own:
            S = e.max_instep_swaps
            views = {name: np.zeros((n,), np.int32) for name, n in (
                ("copy_src", C), ("copy_dst", C), ("swap_k_dst", S),
                ("swap_v_dst", S))}
        copy_src, copy_dst = views["copy_src"], views["copy_dst"]
        copy_src[:] = pad_src
        copy_dst[:] = pad_dst
        for j, (src, dst) in enumerate(copies):
            copy_src[j] = src
            copy_dst[j] = dst

        kq, self._pending_swap_k = self._pending_swap_k, []
        vq, self._pending_swap_v = self._pending_swap_v, []
        out: Dict[str, object] = dict(views) if own else {}
        out["swap_k"], out["swap_k_scale"] = self._fold_swap_half(
            "k", kq, views)
        out["swap_v"], out["swap_v_scale"] = self._fold_swap_half(
            "v", vq, views)
        return out

    def _flush_swaps_eager(self) -> None:
        """Apply every queued swap-in half eagerly (pre-step), draining
        both split queues."""
        kq, self._pending_swap_k = self._pending_swap_k, []
        vq, self._pending_swap_v = self._pending_swap_v, []
        self.eager_swaps += len(kq) + len(vq)
        for slot, half in kq:
            self.swap_in(slot, (half, None))
        for slot, half in vq:
            self.swap_in(slot, (None, half))

    def _fold_swap_half(self, name: str, queue, views
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Fold one half's queued swap-ins (K or V) into its padded
        destination bucket and return its payload buffer on the device,
        with its (L, S, KH) f32 scales in the q8 wire format (else None).
        ``swap_bytes_shipped`` counts the host->device payload bytes,
        scales included."""
        e = self.ecfg
        S, P = e.max_instep_swaps, e.num_pages
        if len(queue) > S:
            for slot, half in queue[S:]:          # eager overflow fallback
                self.swap_in(slot, (half, None) if name == "k"
                             else (None, half))
            self.eager_swaps += len(queue) - S
            queue = queue[:S]
        self.instep_swaps += len(queue)
        dst = views[f"swap_{name}_dst"]
        dst[:] = P
        if not queue:
            # swap-free half (the common case): every destination is the
            # drop page, so reuse the device-resident zero payload
            return self._zero_swap, self._zero_scale
        cfg = self.cfg
        buf = np.zeros((cfg.n_layers, S, e.page_size, cfg.n_kv_heads,
                        cfg.head_dim), self._payload_npdt)
        scale = (np.zeros((cfg.n_layers, S, cfg.n_kv_heads), np.float32)
                 if self._payload_fmt == "q8" else None)
        for j, (slot, half) in enumerate(queue):
            assert half.fmt == self._payload_fmt, (half.fmt,
                                                   self._payload_fmt)
            dst[j] = slot
            buf[:, j] = half.data
            if scale is not None:
                scale[:, j] = half.scale
        self.swap_bytes_shipped += buf.nbytes
        payload = torch.from_numpy(buf).view(self._payload_dtype)
        if scale is None:
            return payload.to(self.device), None
        self.swap_bytes_shipped += scale.nbytes
        return (payload.to(self.device),
                torch.from_numpy(scale).to(self.device))

    def _fold_page_ops_sharded(self, views: Dict[str, np.ndarray]
                               ) -> Dict[str, object]:
        """Per-shard routing of queued COW copies and swap-ins (the
        reference's ``_fold_page_ops_sharded``).  Shard i's row of the
        (N, C) copy and (N, S) swap fields holds shard-local page indices.
        A copy whose source and destination live on different shards (a
        device-to-device transfer) and per-shard overflow run eagerly.
        Swap payloads: one (N, L, S, page, KH, D) host buffer when any
        shard swaps in (``swap_bytes_shipped`` counts all of it, as the
        reference ships it), row i moved to shard i's device; otherwise
        the shards' zero payloads."""
        e = self.ecfg
        ns, ploc = self.n_shards, self.p_loc
        C, S = e.max_instep_copies, e.max_instep_swaps
        copies, self._pending_copies = self._pending_copies, []
        per_c: List[List[Tuple[int, int]]] = [[] for _ in range(ns)]
        eager_c: List[Tuple[int, int]] = []
        for src, dst in copies:
            s1, s2 = src // ploc, dst // ploc
            if C > 0 and s1 == s2 and len(per_c[s1]) < C:
                per_c[s1].append((src - s1 * ploc, dst - s1 * ploc))
            else:
                eager_c.append((src, dst))
        self.instep_copies += len(copies) - len(eager_c)
        self.eager_copies += len(eager_c)
        if eager_c:
            # eager copies run before this step while queued swap-ins land
            # inside it: flush the swaps first (a same-round swap-in may be
            # the donor of one of these forks)
            self._flush_swaps_eager()
            self.copy_pages(eager_c)
        copy_src = views["copy_src"].reshape(ns, C)
        copy_dst = views["copy_dst"].reshape(ns, C)
        for i in range(ns):
            # padding repeats the shard's last real local copy
            # (idempotent) or is the local identity 0 -> 0
            copy_src[i], copy_dst[i] = per_c[i][-1] if per_c[i] else (0, 0)
            for j, (a, b) in enumerate(per_c[i]):
                copy_src[i, j], copy_dst[i, j] = a, b
        out: Dict[str, object] = {"swap_k_scale": None, "swap_v_scale": None}
        kq, self._pending_swap_k = self._pending_swap_k, []
        vq, self._pending_swap_v = self._pending_swap_v, []
        cfg = self.cfg
        for name, queue in (("k", kq), ("v", vq)):
            dst = views[f"swap_{name}_dst"].reshape(ns, S)
            dst[:] = ploc                       # each shard's drop page
            per: List[List[Tuple[int, HostHalf]]] = [[] for _ in range(ns)]
            for slot, half in queue:
                sh = slot // ploc
                if S > 0 and len(per[sh]) < S:
                    per[sh].append((slot - sh * ploc, half))
                    self.instep_swaps += 1
                else:                           # per-shard overflow
                    self.swap_in(slot, (half, None) if name == "k"
                                 else (None, half))
                    self.eager_swaps += 1
            if not any(per):
                out[f"swap_{name}"] = self._zero_swap
                continue
            buf = np.zeros((ns, cfg.n_layers, S, e.page_size,
                            cfg.n_kv_heads, cfg.head_dim),
                           self._payload_npdt)
            for i in range(ns):
                for j, (ls, half) in enumerate(per[i]):
                    dst[i, j] = ls
                    buf[i, :, j] = half.data
            self.swap_bytes_shipped += buf.nbytes
            payload = torch.from_numpy(buf).view(self._payload_dtype)
            out[f"swap_{name}"] = [payload[i].to(d) for i, d in
                                   enumerate(self.group.devices)]
        return out

    def _locate(self, slot: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(K pools, V pools, page index) that hold global ``slot``: the
        single-device pools, or the owning shard's."""
        if self.n_shards == 1:
            return self.k_pools, self.v_pools, slot
        sh, local = divmod(slot, self.p_loc)
        return self.k_pools[sh], self.v_pools[sh], local

    # -- copy-on-write page forks (cross-request prefix sharing) --------
    def queue_copies(self, pairs: List[Tuple[int, int]]) -> None:
        """Queue COW page copies ``src -> dst`` to be folded into the next
        dispatched step (before its attention reads the forked pages)."""
        self._pending_copies.extend(pairs)

    def copy_pages(self, pairs: List[Tuple[int, int]]) -> None:
        """Eager device-side K/V page copies ``src -> dst`` (all layers),
        the overflow fallback when a round queues more forks than
        ``max_instep_copies``."""
        if not pairs:
            return
        if self.n_shards > 1:
            # each pair where its pages live; a copy between shards is a
            # device-to-device copy.  All sources are read before any
            # write, as in the single-device gather.
            halves = [(ks[:, i].clone(), vs[:, i].clone())
                      for ks, vs, i in (self._locate(a) for a, _ in pairs)]
            for (_, b), (kh, vh) in zip(pairs, halves):
                kd, vd, j = self._locate(b)
                kd[:, j] = kh.to(kd.device)
                vd[:, j] = vh.to(vd.device)
            return
        src = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                           device=self.device)
        self.k_pools[:, dst] = self.k_pools[:, src]
        self.v_pools[:, dst] = self.v_pools[:, src]

    # -- host-tier swaps (paper §7 hierarchical storage) ----------------
    @staticmethod
    def _pop_queued(queue, slot: int):
        """Remove and return the half queued for ``slot``, if any."""
        for i, (s, half) in enumerate(queue):
            if s == slot:
                del queue[i]
                return half
        return None

    def swap_out(self, slot: int, need_k: bool = True,
                 need_v: bool = True):
        """Copy one block's K/V (all layers) device -> host, per half.

        Returns ``(k, v)``: each the half's payload (a queued
        :class:`HostHalf` or a raw pool ndarray) or ``None`` when not
        requested.  A raw page carries the pool's bits (bf16 as int16) for
        the fp wire format, and its float32 values (exact from bf16) for a
        quantizing one, which the block manager quantizes.  The device
        read waits for the step in flight, so no stale page is handed
        out.  A swap-in still QUEUED for this slot
        is returned directly and removed from both queues: the queued
        payload IS the block's content, and letting it land later would
        clobber whatever the reallocated page holds by then."""
        kh = self._pop_queued(self._pending_swap_k, slot)
        vh = self._pop_queued(self._pending_swap_v, slot)
        k_pools, v_pools, page_at = self._locate(slot)

        def read(pools):
            page = pools[:, page_at]
            if self._payload_fmt != "fp":
                page = page.float()
            return _host_array(page)

        out_k = out_v = None
        if need_k:
            out_k = kh if kh is not None else read(k_pools)
        if need_v:
            out_v = vh if vh is not None else read(v_pools)
        return out_k, out_v

    @staticmethod
    def _as_half(payload) -> HostHalf:
        """Normalize a raw ndarray payload into the :class:`HostHalf`
        wire form the split queues carry."""
        if isinstance(payload, HostHalf):
            return payload
        arr = np.asarray(payload)
        return HostHalf(data=arr, scale=None, nbytes=arr.nbytes, fmt="fp")

    def queue_swap_in(self, slot: int, payload) -> None:
        """Queue a host-tier payload ``(k_half, v_half)`` — either may be
        ``None`` — to be scattered into ``slot`` inside the next
        dispatched step.  Eager when the in-step bucket is disabled."""
        if self.ecfg.max_instep_swaps <= 0:
            self.swap_in(slot, payload)
            return
        kh, vh = payload
        if kh is not None:
            self._pending_swap_k.append((slot, self._as_half(kh)))
        if vh is not None:
            self._pending_swap_v.append((slot, self._as_half(vh)))

    def swap_in(self, slot: int, payload) -> None:
        """Eager host -> device restore (overflow / bucket-disabled
        path).  Quantized halves dequantize on the host with the same
        operand order as the in-step ``_dequant_payload``, so both paths
        land the same pool bytes."""
        kh, vh = payload
        k_pools, v_pools, page_at = self._locate(slot)
        for half, pools in ((kh, k_pools), (vh, v_pools)):
            if half is not None:
                pools[:, page_at] = dequantize_half(
                    self._as_half(half), self.dtype).to(pools.device)

    # ------------------------------------------------------------------
    def perf_counters(self) -> Dict[str, object]:
        """Deterministic hot-path accounting: the reference engine's
        schema, and the port's count of steps captured into a CUDA graph,
        replayed from one and run eager (they sum to
        ``engine_dispatches``)."""
        steps = max(self.steps_executed, 1)
        total = max(self.total_token_rows, 1)
        return {
            "attn_dispatches": self.attn_dispatches,
            "attn_dispatches_per_step": self.attn_dispatches / steps,
            "padded_token_fraction":
                1.0 - self.valid_token_rows / total,
            "bucket_counts": {f"T{t}xNP{n}": c for (t, n), c
                              in sorted(self.bucket_counts.items())},
            "instep_copies": self.instep_copies,
            "eager_copies": self.eager_copies,
            "instep_swaps": self.instep_swaps,
            "eager_swaps": self.eager_swaps,
            "swap_bytes_shipped": self.swap_bytes_shipped,
            "engine_dispatches": self.steps_executed,
            "decode_only_dispatches": self.decode_only_dispatches,
            "decode_tokens_emitted": self.decode_tokens_emitted,
            "multi_token_dispatches": self.multi_token_dispatches,
            "multi_token_iterations": self.multi_token_iterations,
            "multi_token_rollbacks": self.multi_token_rollbacks,
            "k_counts": {f"k{k}": c for k, c
                         in sorted(self.k_counts.items())},
            "graph_captures": self.graph_captures,
            "graph_replays": self.graph_replays,
            "graph_eager_steps": self.graph_eager_steps,
        }

    def reset_perf_counters(self) -> None:
        """Zero the deterministic accounting so that one phase of a run
        can be measured alone.  ``jit_traces`` and ``buckets_used`` are
        kept: the once-per-bucket invariant spans the engine's life, as
        do the captured graphs."""
        self.steps_executed = 0
        self.attn_dispatches = 0
        self.valid_token_rows = 0
        self.total_token_rows = 0
        self.bucket_counts = {}
        self.instep_copies = self.eager_copies = 0
        self.instep_swaps = self.eager_swaps = 0
        self.swap_bytes_shipped = 0
        self.decode_only_dispatches = 0
        self.decode_tokens_emitted = 0
        self.multi_token_dispatches = 0
        self.multi_token_iterations = 0
        self.multi_token_rollbacks = 0
        self.k_counts = {}
        self.graph_captures = self.graph_replays = 0
        self.graph_eager_steps = 0

    # ------------------------------------------------------------------
    def dispatch(self, plan: StepPlan) -> StepHandle:
        """Assemble and launch one step without waiting for the device.

        The kernels are queued on the current CUDA stream; the returned
        :class:`StepHandle` carries an event recorded after them, so the
        host can schedule and assemble the next step meanwhile (the
        in-place pool updates of consecutive steps are ordered by the
        stream)."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is None else tr.open("assemble")
        k = plan.decode_steps
        inp, (t_b, np_b, w_b) = self.build_inputs(plan)
        t1 = time.perf_counter() if tr is None else tr.close()
        t_asm = t1 - t0
        if tr is not None:
            tr.open("enqueue")
            self.layer_ranges = tr.profiling
        with torch.no_grad():
            token_ids, pre_logits = self._step_impl(
                self.params, inp, t_b, np_b, w_b, k)
        if tr is not None:
            tr.close()
        done = None
        if self.device.type == "cuda":
            # sharded: the ids are gathered on the first shard's device,
            # after every shard's work that feeds them
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self.steps_executed += 1
        key = (t_b, np_b, w_b, k)
        if key not in self.buckets_used:
            self.buckets_used.add(key)
            self.jit_traces += 1
        fused = self.ecfg.attn_mode == "fused"
        self.attn_dispatches += self.cfg.n_layers * (k if fused else 2)
        emitted = plan.emitted_tokens
        self.valid_token_rows += emitted
        self.total_token_rows += t_b * k
        self.bucket_counts[(t_b, np_b)] = \
            self.bucket_counts.get((t_b, np_b), 0) + 1
        if plan.decodes and not plan.prefills:
            self.decode_only_dispatches += 1
            self.decode_tokens_emitted += emitted
        if k > 1:
            self.multi_token_dispatches += 1
            self.multi_token_iterations += k
            self.multi_token_rollbacks += \
                k * len(plan.decodes) - sum(plan.decode_iters)
            self.k_counts[k] = self.k_counts.get(k, 0) + 1
        return StepHandle(token_ids=token_ids, prefill_logits=pre_logits,
                          assembly_time=t_asm, done=done,
                          full_logits=self.ecfg.return_full_logits)

    def execute(self, plan: StepPlan) -> StepHandle:
        """Synchronous convenience wrapper: dispatch + wait."""
        handle = self.dispatch(plan)
        handle.block()
        return handle
