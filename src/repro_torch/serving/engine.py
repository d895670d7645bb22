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
``bucket_counts`` and the step counts match the JAX engine.  PyTorch
runs eagerly; ``jit_traces`` counts the distinct ``(t, np, w, k)``
buckets first seen, as the reference counts its compiled step variants.

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

Later slices of the port bring quantized swap payloads and pool
snapping, MoE, and sharded serving; each raises ``NotImplementedError``
here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import HostHalf
from repro_torch.kernels.msa import (
    UNIT_FIELDS,
    WL_FIELDS,
    apply_page_copies,
    apply_swap_ins,
    build_units,
    build_worklist,
    msa_decode,
    msa_fused,
    msa_prefill,
    pad_worklist,
    write_kv_pages,
)
from repro_torch.models.layers import apply_rope, rms_norm, swiglu_mlp
from repro_torch.models.model import _layer_windows
from repro_torch.serving.scheduler import StepPlan

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
                    w_bucket: int, n_iter: int = 1
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
    shared.  The ``n_iter == 1`` layout is the single step's."""
    e = ecfg
    R, B = e.max_prefills, e.max_decodes
    if e.attn_mode == "fused":
        t, n, k = t_bucket, R + B, n_iter
        n_tiles = -(-t // min(e.q_tile, t))
        fields = [("tokens", k * t), ("positions", k * t),
                  ("valid", k * t), ("write_slot", k * t),
                  ("write_off", k * t), ("seq_ids", t),
                  ("sel", R + B), ("qstart", n), ("qlen", k * n),
                  ("ctx", k * n), ("bt", n * np_bucket)]
        fields += [(f, k * w_bucket) for f in WL_FIELDS]
        u_b = unit_bucket(w_bucket, n_tiles)
        fields += [(f, k * (2 if f == "unit_counts"
                            else u_b // 2 if f.startswith("mg_") else u_b))
                   for f in UNIT_FIELDS]
    else:
        t, NP = R * e.max_chunk + B, e.max_blocks_per_seq
        fields = [("tokens", t), ("positions", t), ("valid", t),
                  ("write_slot", t), ("write_off", t), ("sel", R + B),
                  ("qlens", R), ("ctx_pre", R), ("ctx_dec", B),
                  ("bt_pre", R * NP), ("bt_dec", B * NP)]
    fields += [("copy_src", e.max_instep_copies),
               ("copy_dst", e.max_instep_copies),
               ("swap_k_dst", e.max_instep_swaps),
               ("swap_v_dst", e.max_instep_swaps)]
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
    # host-tier swap wire format and write-time pool snap; only the
    # lossless defaults ("fp", "off") are served by this slice
    swap_payload: str = "fp"
    snap: str = "off"
    snap_scale: float = 0.0


def _host_array(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, bit for bit.  numpy has no bfloat16, so
    bf16 pages travel as their raw 16-bit patterns (int16);
    :func:`_device_tensor` reverses it."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _device_tensor(a: np.ndarray, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    if t.dtype != dtype:
        raise TypeError(f"host payload dtype {t.dtype} != pool dtype {dtype}")
    return t.to(device)


def _host_npdtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(np.int16) if dtype == torch.bfloat16 \
        else torch.empty((), dtype=dtype).numpy().dtype


@dataclass
class StepHandle:
    """Asynchronous result of one dispatched step.

    Holds device tensors; nothing is transferred until the ``*_np``
    accessors run, so the server can assemble the next step while this
    one executes.  ``block`` waits on the CUDA event recorded after the
    step (a no-op on the CPU)."""
    token_ids: Union[torch.Tensor, np.ndarray]      # (R+B,) or (k, R+B)
    prefill_logits: Union[torch.Tensor, np.ndarray]  # (R, V) rows
    assembly_time: float = 0.0     # host-side build_inputs seconds
    done: Optional[torch.cuda.Event] = None
    _ids_np: Optional[np.ndarray] = None
    _pre_np: Optional[np.ndarray] = None

    def block(self) -> None:
        if self.done is not None:
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


class Engine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params,
                 device="cuda"):
        if cfg.family == "moe" or cfg.moe is not None:
            raise NotImplementedError(
                "MoE serving comes with the MoE slice of the port")
        if cfg.family not in ("dense", "vlm") or cfg.enc_dec:
            raise ValueError(f"the engine serves decoder-only token LMs, "
                             f"not family {cfg.family!r}")
        if ecfg.attn_mode not in ("fused", "split"):
            raise ValueError(f"attn_mode {ecfg.attn_mode!r} is neither "
                             "'fused' nor 'split'")
        if ecfg.swap_payload != "fp" or ecfg.snap != "off":
            raise NotImplementedError(
                "quantized swap payloads and pool snapping come with the "
                "quantized-offload slice of the port")
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.dtype = torch_dtype(cfg.dtype)
        self._host_npdt = _host_npdtype(self.dtype)
        L = cfg.n_layers
        # page num_pages (one past the block manager's slots) is the drop
        # page: padding KV writes and padding swap-ins land there, and no
        # block table references it.  The pools are updated in place by
        # every step (JAX donated them into its step instead).
        self.k_pools = torch.zeros(
            (L, ecfg.num_pages + 1, ecfg.page_size, cfg.n_kv_heads,
             cfg.head_dim), dtype=self.dtype, device=self.device)
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
        # device-resident zero payload reused on swap-free steps (their
        # destinations are all padded into the drop page anyway)
        self._zero_swap = torch.zeros(
            (L, ecfg.max_instep_swaps, ecfg.page_size, cfg.n_kv_heads,
             cfg.head_dim), dtype=self.dtype, device=self.device)
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
        self._layouts: Dict[Tuple[int, int, int, int],
                            Tuple[List[Tuple[str, int, int]], int]] = {}

    # ------------------------------------------------------------------
    def pack_layout(self, t_bucket: int, np_bucket: int, w_bucket: int,
                    n_iter: int = 1):
        """Cached :func:`pack_layout_for` of one bucket."""
        key = (t_bucket, np_bucket, w_bucket, n_iter)
        if key not in self._layouts:
            self._layouts[key] = pack_layout_for(self.ecfg, t_bucket,
                                                 np_bucket, w_bucket, n_iter)
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
        """One step on the device: in-step page ops, then per layer
        norm -> q/k/v -> rope -> KV write -> attention (ONE ``msa_fused``
        dispatch, or ``msa_prefill`` + ``msa_decode`` in split mode) ->
        wo -> MLP, then the final norm, the logits at ``sel`` and the
        greedy argmax on the device.  ``n_iter > 1`` runs the k fused
        decode iterations of a multi-token plan instead."""
        e = self.ecfg
        inp = self._unpack(inp, t_bucket, np_bucket, w_bucket, n_iter)
        # swap-ins land first (they commit pages a COW fork in the same
        # round may use as its donor), then copies; both precede the KV
        # writes and attention that read those pages
        apply_swap_ins(self.k_pools, self.v_pools, inp["swap_k_dst"],
                       inp["swap_v_dst"], inp["swap_k"], inp["swap_v"])
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
        return token_ids, logits[:e.max_prefills]

    def _layers(self, params, tokens, pos, write_slot, write_off, valid,
                attend):
        """Embed ``tokens`` and run every layer over the stream: norm ->
        q/k/v -> rope -> KV write -> ``attend(l, q, k_pool, v_pool)`` ->
        wo -> MLP.  Returns the residual before the final norm."""
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
            write_kv_pages(kp, vp, k_new, v_new, write_slot, write_off,
                           valid)
            attn = attend(l, q, kp, vp)
            x = x + attn.reshape(T, H * hd) @ blocks["wo"][l].reshape(
                H * hd, d)
            h2 = rms_norm(x, blocks["mlp_norm"][l], cfg.norm_eps)
            x = x + swiglu_mlp(h2, blocks["w1"][l], blocks["w3"][l],
                               blocks["w2"][l])
        return x

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
        the ids, (k, R+B), and the last iteration's prefill logit rows."""
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
        return torch.stack(ids_steps), logits[:self.ecfg.max_prefills]

    # ------------------------------------------------------------------
    def build_inputs(self, plan: StepPlan):
        """Host-side assembly of one step's device inputs.

        Returns ``(inp, (t_bucket, np_bucket, w_bucket))``: every int32
        field assembled into named views of ONE flat host buffer moved to
        the device in one copy, plus the two swap-payload buffers.  A
        multi-token plan gets one work-list and one set of work units an
        iteration, all padded to one shared W, so the bucket key stays
        ``(t, np, w, k)``."""
        t_b, np_b = self.buckets_for(plan)
        n_it = plan.decode_steps
        if self.ecfg.attn_mode != "fused":
            if n_it > 1:
                raise ValueError("multi-token decode dispatch requires the "
                                 "fused single-device layout")
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
        wls = [build_worklist(
            fields["qstart"], qlen[i], ctx[i], fields["bt"], pos[i],
            page=self.ecfg.page_size, q_tile=tq, n_tiles=n_tiles,
            window=0)[0] for i in range(n_it)]
        w_b = max(WL_BUCKET, 1 << (max(
            wl["wl_seq"].shape[0] for wl in wls) - 1).bit_length())
        layout, size = self.pack_layout(t_b, np_b, w_b, n_it)
        buf = np.zeros((size,), np.int32)
        views = {name: buf[off:off + size_] for name, off, size_ in layout}
        for name, arr in fields.items():
            views[name][:] = arr.reshape(-1)
        for i, wl in enumerate(wls):
            wl = pad_worklist(wl, w_b, sentinel_seq=self.n_seqs)
            units = build_units(
                wl, fields["qstart"], qlen[i], n_rows=t_b, q_tile=tq,
                n_tiles=n_tiles, pad_to=unit_bucket(w_b, n_tiles))
            for name, arr in (*wl.items(), *units.items()):
                views[name].reshape(n_it, -1)[i] = arr
        return self._pack_inputs(buf, views), (t_b, np_b, w_b)

    def _pack_inputs(self, buf: np.ndarray, views: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        """Fold the queued page ops into the packed buffer and move it to
        the device in one copy, beside the two swap payloads."""
        ops = self._fold_page_ops(views)
        return {"pack": torch.from_numpy(buf).to(self.device),
                "swap_k": ops["swap_k"], "swap_v": ops["swap_v"]}

    def _unpack(self, inp: Dict[str, torch.Tensor], t_bucket: int,
                np_bucket: int, w_bucket: int,
                n_iter: int = 1) -> Dict[str, torch.Tensor]:
        """Slices of the packed device buffer back into named step inputs
        (views of the one transferred buffer); a multi-token plan's
        per-iteration fields fold out to (k, ·)."""
        layout, _ = self.pack_layout(t_bucket, np_bucket, w_bucket, n_iter)
        buf = inp["pack"]
        out = {name: buf[off:off + size] for name, off, size in layout}
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
        out["swap_k"] = inp["swap_k"]
        out["swap_v"] = inp["swap_v"]
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

    def _fold_page_ops(self, views: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
        """Drain queued COW copies / host-tier swap-ins into the padded
        index fields of the packed buffer (swap padding: dst == num_pages,
        the drop page); overflow past the static buckets goes eager."""
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
        copy_src, copy_dst = views["copy_src"], views["copy_dst"]
        copy_src[:] = pad_src
        copy_dst[:] = pad_dst
        for j, (src, dst) in enumerate(copies):
            copy_src[j] = src
            copy_dst[j] = dst

        out: Dict[str, torch.Tensor] = {}
        kq, self._pending_swap_k = self._pending_swap_k, []
        vq, self._pending_swap_v = self._pending_swap_v, []
        out["swap_k"] = self._fold_swap_half("k", kq, views)
        out["swap_v"] = self._fold_swap_half("v", vq, views)
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

    def _fold_swap_half(self, name: str, queue, views) -> torch.Tensor:
        """Fold one half's queued swap-ins (K or V) into its padded
        destination bucket and return its payload buffer on the device.
        ``swap_bytes_shipped`` counts the host->device payload bytes."""
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
            return self._zero_swap
        cfg = self.cfg
        buf = np.zeros((cfg.n_layers, S, e.page_size, cfg.n_kv_heads,
                        cfg.head_dim), self._host_npdt)
        for j, (slot, half) in enumerate(queue):
            assert half.fmt == "fp", half.fmt
            dst[j] = slot
            buf[:, j] = half.data
        self.swap_bytes_shipped += buf.nbytes
        return _device_tensor(buf, self.dtype, self.device)

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
        requested.  The device read waits for the step in flight, so no
        stale page is handed out.  A swap-in still QUEUED for this slot
        is returned directly and removed from both queues: the queued
        payload IS the block's content, and letting it land later would
        clobber whatever the reallocated page holds by then."""
        kh = self._pop_queued(self._pending_swap_k, slot)
        vh = self._pop_queued(self._pending_swap_v, slot)
        out_k = out_v = None
        if need_k:
            out_k = kh if kh is not None \
                else _host_array(self.k_pools[:, slot])
        if need_v:
            out_v = vh if vh is not None \
                else _host_array(self.v_pools[:, slot])
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
        path) of full-precision halves."""
        kh, vh = payload
        for half, pools in ((kh, self.k_pools), (vh, self.v_pools)):
            if half is None:
                continue
            half = self._as_half(half)
            assert half.fmt == "fp", half.fmt
            pools[:, slot] = _device_tensor(half.data, self.dtype,
                                            self.device)

    # ------------------------------------------------------------------
    def perf_counters(self) -> Dict[str, object]:
        """Deterministic hot-path accounting, same schema as the
        reference engine's."""
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
        }

    def reset_perf_counters(self) -> None:
        """Zero the deterministic accounting so that one phase of a run
        can be measured alone.  ``jit_traces`` and ``buckets_used`` are
        kept: the once-per-bucket invariant spans the engine's life."""
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

    # ------------------------------------------------------------------
    def dispatch(self, plan: StepPlan) -> StepHandle:
        """Assemble and launch one step without waiting for the device.

        The kernels are queued on the current CUDA stream; the returned
        :class:`StepHandle` carries an event recorded after them, so the
        host can schedule and assemble the next step meanwhile (the
        in-place pool updates of consecutive steps are ordered by the
        stream)."""
        t0 = time.perf_counter()
        k = plan.decode_steps
        inp, (t_b, np_b, w_b) = self.build_inputs(plan)
        t_asm = time.perf_counter() - t0
        with torch.no_grad():
            token_ids, pre_logits = self._step_impl(
                self.params, inp, t_b, np_b, w_b, k)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
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
                          assembly_time=t_asm, done=done)

    def execute(self, plan: StepPlan) -> StepHandle:
        """Synchronous convenience wrapper: dispatch + wait."""
        handle = self.dispatch(plan)
        handle.block()
        return handle
