"""AsymCache serving loop: discrete-event orchestration of scheduler +
engine + block manager + evictor (+ optional Continuum TTL layer).

Two clocks:
  * ``clock="wall"``  — real execution time of the engine steps
  * ``clock="model"`` — the fitted/analytic Eq.-6 cost model advances the
                        simulated clock (paper-scale latencies on Llama
                        3.1-8B/70B constants) while the engine still runs
                        for real so losslessness is preserved end to end.

Overlapped execution pipeline (``pipeline_depth`` ≥ 1, the default): the
host schedules and assembles step N+1 while the device executes step N.
This is sound because outputs are teacher-forced — the host-side state
update after a step (:meth:`AsymCacheServer._postprocess`) depends only on
the plan, never on logits, so only the small logits/ids fetch
(:meth:`_retire`) has to wait for the device, and it is deferred until
step N+1 has already been dispatched.  ``pipeline_depth=0`` preserves the
fully synchronous order (dispatch → wait → postprocess) for A/B runs and
losslessness bisection; both modes execute the identical device program,
so their logits and sampled ids match byte-for-byte.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    BlockManager,
    CostModel,
    FaultPlan,
    FreqParams,
    H100,
    H100_HOST_LINK_BW,
    InjectedFault,
    LifespanTracker,
    OffloadConfig,
    PrefixStore,
    PrefixStoreConfig,
    analytic_cost_model,
    chain_hash,
    hash_seed,
    make_policy,
    model_fingerprint,
)
from repro_torch.distributed import make_serving_devices
from repro_torch.serving.engine import Engine, EngineConfig, StepHandle
from repro_torch.serving.request import Request, RequestState, SessionStats
from repro_torch.serving.scheduler import ChunkingScheduler, SchedulerConfig, StepPlan
from repro_torch.serving.tracing import Tracer

# graceful-degradation bounds (docs/SERVING.md "Failure semantics"):
# all-idle admission retries before the head-of-line request is rejected,
# consecutive dispatch failures before the loop gives up, and consecutive
# request-source exceptions before the source's error is re-raised
STALL_RETRY_LIMIT = 64
DISPATCH_RETRY_LIMIT = 8
SOURCE_ERROR_LIMIT = 100


class _SimEngine:
    """Engine stand-in for discrete-event simulation (execute_model=False):
    block/scheduler behaviour is real; logits are zeros."""

    def __init__(self, sched_cfg: SchedulerConfig):
        class _E:  # minimal ecfg view used by run()/_postprocess
            pass
        self.ecfg = _E()
        self.ecfg.max_prefills = sched_cfg.max_prefills
        self.steps_executed = 0
        r, b = sched_cfg.max_prefills, sched_cfg.max_decodes
        self._ids = np.zeros((r + b,), np.int32)
        self._logits = np.zeros((r, 1), np.float32)
        # same dispatch accounting the real engine keeps, so the stress
        # benchmark's simulated runs can gate the multi-token dispatch
        # drop on identical counter names
        self.decode_only_dispatches = 0
        self.decode_tokens_emitted = 0
        self.multi_token_dispatches = 0
        self.multi_token_iterations = 0
        self.multi_token_rollbacks = 0
        self.k_counts: Dict[int, int] = {}

    def queue_copies(self, pairs) -> None:
        pass

    def perf_counters(self) -> Dict:
        return {
            "engine_dispatches": self.steps_executed,
            "decode_only_dispatches": self.decode_only_dispatches,
            "decode_tokens_emitted": self.decode_tokens_emitted,
            "multi_token_dispatches": self.multi_token_dispatches,
            "multi_token_iterations": self.multi_token_iterations,
            "multi_token_rollbacks": self.multi_token_rollbacks,
            "k_counts": {f"k{k}": c for k, c
                         in sorted(self.k_counts.items())},
        }

    def dispatch(self, plan: StepPlan) -> StepHandle:
        self.steps_executed += 1
        k = plan.decode_steps
        if plan.decodes and not plan.prefills:
            self.decode_only_dispatches += 1
            self.decode_tokens_emitted += plan.emitted_tokens
        ids = self._ids
        if k > 1:
            ids = np.zeros((k, self._ids.shape[0]), np.int32)
            self.multi_token_dispatches += 1
            self.multi_token_iterations += k
            self.multi_token_rollbacks += \
                k * len(plan.decodes) - sum(plan.decode_iters)
            self.k_counts[k] = self.k_counts.get(k, 0) + 1
        return StepHandle(token_ids=ids, prefill_logits=self._logits)


class ScriptedSource:
    """RequestSource over a pre-scripted workload: every arrival time is
    known up front (the offline replay mode).  The source protocol —
    ``pop_due`` / ``next_time`` / ``done`` — is what the closed-loop
    online frontend (`repro.serving.frontend.OnlineFrontend`) implements
    instead, generating each session's next turn only when the previous
    turn's last token has actually been emitted."""

    def __init__(self, requests: List[Request]):
        self._req = sorted(requests, key=lambda r: r.arrival)
        self._i = 0

    def pop_due(self, now: float) -> List[Request]:
        out = []
        while self._i < len(self._req) and self._req[self._i].arrival <= now:
            out.append(self._req[self._i])
            self._i += 1
        return out

    def next_time(self) -> Optional[float]:
        """Earliest future event (None = nothing more will ever arrive)."""
        return self._req[self._i].arrival if self._i < len(self._req) else None

    def done(self) -> bool:
        return self._i >= len(self._req)


@dataclass
class ServerConfig:
    policy: str = "asymcache"
    lifespan: float = 30.0
    reuse_prob: float = 0.5
    slope_ratio: float = 40.0
    num_blocks: int = 512
    block_size: int = 16
    clock: str = "wall"                 # "wall" | "model"
    # execute_model=False: discrete-event simulation — the block manager,
    # evictor and scheduler run for real but the engine is replaced by the
    # Eq.-6 cost model (paper-scale contexts on CPU).  Losslessness is
    # validated separately with execute_model=True.
    execute_model: bool = True
    online_lifespan: bool = True
    continuum_ttl: bool = False         # agentic TTL pinning layer
    tool_boost: float = 8.0             # §5.2 correction factor
    # cross-request prefix sharing: radix-trie matching of previously
    # served prompts + copy-on-write forks of partially shared blocks.
    # False salts every request's chain hashes so nothing is shared
    # across requests (the vLLM-without-APC baseline).
    prefix_sharing: bool = True
    # hierarchical KV storage (paper §7): evicted blocks spill to a host
    # tier of this many blocks (0 = off); swap-in replaces recomputation
    host_blocks: int = 0
    # bytes/s host<->device for swaps: the card's pinned host -> device
    # rate (core.cost_model.H100_HOST_LINK_BW, measured)
    pcie_bw: float = H100_HOST_LINK_BW
    # asymmetric K/V offload policy: split-half residency, quantized swap
    # payloads, keep-K drop policy, k-early prefetch (core/offload.py).
    # The default config reproduces the symmetric fp swap path exactly.
    offload: OffloadConfig = field(default_factory=OffloadConfig)
    # overlapped execution: how many dispatched steps may be awaiting
    # retirement.  0 = fully synchronous (current order preserved for A/B
    # and losslessness tests); 1 = schedule/assemble step N+1 while step N
    # executes (one-step-deep, the paper's §5.3 overlap assumption).
    pipeline_depth: int = 1
    # attention layout of the default-constructed engine: "fused" = one
    # varlen dispatch per layer with occupancy-bucketed compile shapes,
    # "split" = the original padded prefill + decode two-dispatch layout
    # (the baseline benchmarks/kernel_fusion.py compares against).
    attn_mode: str = "fused"
    # sharded serving: KV page pools sequence-shard over n shards (one
    # process drives them, repro_torch.distributed), weights shard by the
    # decode sharding rules, and per-shard attention partials merge
    # through the exact LSE combine.  Requires n CUDA devices, or
    # shard_devices (a device may repeat: ["cpu"] * n, ["cuda:0"] * n),
    # and num_blocks % n_shards == 0.  1 = single-device.
    n_shards: int = 1
    shard_devices: Optional[Sequence] = None
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    use_hit_count: bool = True
    # ---- fault injection + graceful degradation (core/faults.py) ----
    # seeded chaos schedule consulted at the named fault sites; None =
    # fault-free serving (zero overhead: no checksums, no audits)
    faults: Optional[FaultPlan] = None
    # strict=True preserves the historical fail-fast behaviour: a request
    # that can never fit the pool raises out of serve() instead of being
    # rejected with a structured reason (tests opt in)
    strict: bool = False
    # run BlockManager.check_invariants() every N dispatched steps
    # (0 = only after injected faults / at drain when a plan is attached)
    audit_every: int = 0
    # content-addressed global prefix store (core/prefix_store.py):
    # cross-restart, multi-tenant dedup of prompt blocks.  None (or the
    # default capacity_bytes=0) disables it; the server still constructs
    # a store object so its counters merge as zeros into every result.
    prefix_store: Optional[PrefixStoreConfig] = None


class AsymCacheServer:
    def __init__(self, cfg: ModelConfig, params, scfg: ServerConfig,
                 ecfg: Optional[EngineConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 sim_cost_model: Optional[CostModel] = None,
                 device="cuda"):
        self.cfg = cfg
        self.scfg = scfg
        scfg.scheduler.block_size = scfg.block_size
        self.freq = FreqParams.from_turning_point(
            scfg.lifespan, scfg.reuse_prob, scfg.slope_ratio)
        self.cost_model = cost_model or analytic_cost_model(cfg, H100)
        # clock="model" uses (possibly different, paper-scale) constants
        self.sim_cost_model = sim_cost_model or self.cost_model
        policy = make_policy(scfg.policy, self.freq,
                             **({"use_hit_count": scfg.use_hit_count}
                                if scfg.policy.startswith("asymcache") else {}))
        # per-half byte sizes: one (L, page, KH, D) half in pool precision
        # (the host-tier BYTE budget unit) and in the configured wire
        # format (what a spill actually moves)
        fp_half = (cfg.n_layers * scfg.block_size
                   * max(cfg.n_kv_heads, 1) * cfg.head_dim
                   * torch_dtype(cfg.dtype).itemsize)
        wire_half = int(fp_half * scfg.offload.payload_ratio)
        # content-addressed global prefix store: always constructed (the
        # default config is disabled, counters merge as zeros); the
        # fingerprint binds stored KV to this exact architecture+weights
        pscfg = scfg.prefix_store or PrefixStoreConfig()
        self.store = PrefixStore(
            pscfg, model_fingerprint(cfg, pscfg.weights_version))
        if pscfg.snapshot_path:
            self.store.load(pscfg.snapshot_path, now=0.0)
        self.bm = BlockManager(scfg.num_blocks, scfg.block_size, policy,
                               self.cost_model, self.freq,
                               host_blocks=scfg.host_blocks,
                               prefix_sharing=scfg.prefix_sharing,
                               n_shards=scfg.n_shards,
                               offload=scfg.offload,
                               block_bytes=(fp_half, fp_half),
                               payload_half_bytes=(wire_half, wire_half),
                               pcie_bw=scfg.pcie_bw,
                               faults=scfg.faults,
                               store=self.store)
        self.sched = ChunkingScheduler(scfg.scheduler, self.bm)
        if scfg.execute_model:
            ecfg = ecfg or EngineConfig(
                num_pages=scfg.num_blocks, page_size=scfg.block_size,
                max_chunk=scfg.scheduler.max_chunk,
                max_prefills=scfg.scheduler.max_prefills,
                max_decodes=scfg.scheduler.max_decodes,
                attn_mode=scfg.attn_mode)
            if scfg.offload.quant != "off":
                # quantized payload serving: the engine snaps KV writes to
                # the grid (lossless mode) and dequantizes wire payloads
                # inside the step
                if scfg.n_shards > 1:
                    raise ValueError("quantized swap payloads require "
                                     "single-device serving")
                ecfg = replace(
                    ecfg, swap_payload=scfg.offload.wire_format,
                    snap=scfg.offload.snap,
                    snap_scale=scfg.offload.clip / 127.0)
            shard_devices = None
            if scfg.n_shards > 1:
                shard_devices = make_serving_devices(scfg.n_shards,
                                                     scfg.shard_devices)
            self.engine = Engine(cfg, ecfg, params, device=device,
                                 shard_devices=shard_devices)
            # the scheduler picks each step's occupancy bucket from its
            # §5.1 chunk decision — both sides must share one lattice
            self.sched.cfg.token_buckets = self.engine.token_buckets
            self.sched.cfg.page_buckets = self.engine.np_buckets
            # multi-token decode dispatch is a fused single-device
            # vectorized-assembly path; other layouts force k = 1
            if (scfg.n_shards > 1 or ecfg.attn_mode != "fused"
                    or ecfg.assembly == "legacy"):
                scfg.scheduler.max_decode_steps = 1
            # a queued COW copy / host-tier swap-in targets ONE step
            # boundary's pool state — k-step plans wait for empty queues
            self.sched.pending_ops_fn = lambda: bool(
                self.engine._pending_copies or self.engine._pending_swap_k
                or self.engine._pending_swap_v)
            if scfg.host_blocks > 0 or self.store.enabled:
                self.bm.swap_out_fn = \
                    lambda slot, need_k=True, need_v=True: \
                    self.engine.swap_out(slot, need_k, need_v)
                self.bm.swap_in_fn = lambda slot, pl: \
                    self.engine.queue_swap_in(slot, pl)
        else:
            assert scfg.clock == "model", "simulation requires clock='model'"
            self.engine = _SimEngine(scfg.scheduler)
        self.lifespan_tracker = LifespanTracker(self.freq) \
            if scfg.online_lifespan else None
        self._block_last_release: Dict[int, float] = {}
        self.stats = SessionStats()
        self.now = 0.0
        self.control_plane_time = 0.0
        # online session serving hooks: listeners fire at the end of
        # _finish (after stats/release) with (request, now); uses_pins
        # gates the per-step pin-expiry sweep (the frontend's prefetch
        # pins need it even when continuum_ttl is off)
        self.finish_listeners: List = []
        self.uses_pins = scfg.continuum_ttl
        # per-request fault domains: listeners fire with (request, now)
        # when a request lands in a terminal FAILED/REJECTED state (the
        # online frontend uses this to retire the owning session)
        self.failure_listeners: List = []
        self.n_failed = 0
        self.n_rejected = 0
        self.n_deadline_aborts = 0
        self.n_on_token_errors = 0
        self.n_source_errors = 0
        self.n_dispatch_retries = 0
        self._has_deadlines = False
        self._stall_retries = 0
        self._dispatch_failures = 0      # consecutive
        self._consec_source_errors = 0
        # spans and counters of the loop (serving/tracing.py): the tracer
        # attached (None = off) and the last one that was
        self.tracer: Optional[Tracer] = None
        self._recorded: Optional[Tracer] = None

    def enable_tracing(self, capacity: int = 1 << 18) -> Tracer:
        """Record the loop's spans from now on: one tracer, shared with
        the scheduler and the engine (off by default)."""
        self._attach(Tracer(capacity))
        return self.tracer

    def trace_export(self) -> Optional[Dict]:
        """What the last tracer attached recorded (``Tracer.export``), or
        None when none was."""
        return None if self._recorded is None else self._recorded.export()

    def _attach(self, tr: Optional[Tracer]) -> None:
        self.tracer = self.sched.tracer = self.engine.tracer = tr
        self.engine.layer_ranges = False
        if tr is not None:
            tr.resume(self.sched.admit_tries, self.sched.admitted)
            self._recorded = tr

    def _follow_profiler(self, tr: Optional[Tracer]) -> Optional[Tracer]:
        """The tracer of the loop iteration about to begin: ``tr`` where
        ``enable_tracing`` made it; otherwise one attached while a
        ``torch.profiler`` records and detached (its open tree
        discarded) once none does."""
        on = torch.autograd._profiler_enabled()
        if on == (tr is not None):
            return tr
        if on:
            follower = self._recorded
            if follower is None or not follower.follows:
                follower = Tracer(follows=True)
            self._attach(follower)
        else:
            tr.discard()
            self._attach(None)
        return self.tracer

    # ------------------------------------------------------------------
    def _hashes_for(self, req: Request, n_blocks: int):
        """Incrementally extended per-request chain-hash cache (O(1)/block)."""
        hs = getattr(req, "_hash_chain", None)
        if hs is None:
            hs = []
            req._hash_chain = hs
        if len(hs) < n_blocks:
            bs = self.scfg.block_size
            toks = req.all_tokens
            h = hs[-1] if hs else hash_seed(
                self.bm.request_salt(req.rid, req.hash_salt))
            for b in range(len(hs), n_blocks):
                h = chain_hash(h, tuple(toks[b * bs:(b + 1) * bs]))
                hs.append(h)
        return hs[:n_blocks]

    def _commit_ready_blocks(self, req: Request, processed_through: int):
        """Commit every block fully covered by positions < processed_through."""
        bs = self.scfg.block_size
        n_full = processed_through // bs
        hashes = self._hashes_for(req, n_full)
        for b in range(n_full):
            slot = req.block_slots[b]
            if slot is None:
                continue
            blk = self.bm.blocks[slot]
            if blk.key is None:
                self.bm.commit(slot, hashes[b], b)

    def _step_latency(self, plan: StepPlan) -> float:
        """Exact per-token step cost: a compute token at logical position p
        pays k2 (GEMMs) + k5·min(p, window) (attention over its context).
        This is Eq. 4's exact form — the evictor still *decides* with the
        Eq. 6/7 approximation, as in the paper."""
        cm = self.sim_cost_model
        k2, k5, k6 = cm.k[1], cm.k[4], cm.k[5]
        w = cm.eff_window
        lat = cm.beta
        for c in plan.prefills:
            pos_sum = int(np.minimum(c.positions, w).sum())
            lat += k2 * len(c.positions) + k5 * pos_sum
        iters = plan.decode_iters if plan.decode_steps > 1 else None
        for j, r in enumerate(plan.decodes):
            ctx = r.prompt_len + len(r.generated)
            # a k-step plan emits each request's decode_iters tokens in
            # this ONE dispatch: every token still pays its per-token
            # compute, but β (the fixed per-dispatch overhead) is paid
            # once — the model-clock form of the control-plane
            # amortization multi-token dispatch buys
            for i in range(iters[j] if iters else 1):
                lat += k2 + k6 * min(ctx + i, w)
        if self.sched.swaps_this_round:
            blk_bytes = (2 * self.cfg.n_layers * self.scfg.block_size
                         * max(self.cfg.n_kv_heads, 1) * self.cfg.head_dim * 2)
            # quantized wire payloads move proportionally fewer bytes per
            # swapped block (payload_ratio = 1.0 keeps the fp billing
            # bit-identical to the pre-offload model clock)
            lat += self.sched.swaps_this_round * cm.swap_latency(
                blk_bytes * self.scfg.offload.payload_ratio,
                self.scfg.pcie_bw)
        return lat

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 200_000) -> Dict:
        """Discrete-event main loop over a scripted workload (see
        :meth:`serve` — this is the ScriptedSource special case)."""
        return self.serve(ScriptedSource(requests), max_steps=max_steps)

    def serve(self, source, max_steps: int = 200_000) -> Dict:
        """Discrete-event main loop over a request source.

        ``source`` follows the :class:`ScriptedSource` protocol: it hands
        over requests due by the current clock (``pop_due``), names the
        next future event for idle jumps (``next_time``), and says when no
        further arrivals can come (``done``).  Closed-loop sources (the
        online frontend) generate arrivals from _finish listeners while
        the loop runs, and fire their own timed actions — predictive
        prefetches — from inside ``pop_due``.

        With ``pipeline_depth`` ≥ 1 each iteration dispatches step N+1
        before retiring step N: the scripted state update runs immediately
        after dispatch (it never looks at logits), and the handle joins
        ``inflight`` until the pipeline is full, at which point the oldest
        step's ids/prefill-logit rows are fetched — by then the device has
        been executing it for a whole scheduling round."""
        depth = max(0, int(self.scfg.pipeline_depth))
        inflight: Deque[Tuple[StepPlan, StepHandle]] = deque()
        steps = 0
        faults = self.scfg.faults
        t_run0 = time.perf_counter()
        t_last_dispatch = t_run0
        tr = self.tracer
        if tr is not None:
            tr.discard()         # a tree an earlier serve left open

        while (not source.done() or self.sched.waiting
               or self.sched.running) and steps < max_steps:
            if tr is None or tr.follows:
                tr = self._follow_profiler(tr)
            if tr is not None:
                # an iteration that dispatches nothing (idle jump, retry)
                # leaves its tree open for the next one
                tr.open_step()
                tr.open("poll")
            # admit arrivals due by now (closed-loop sources also fire
            # their due prefetches inside pop_due).  A throwing source
            # (real or injected) degrades to a skipped poll, retried next
            # iteration, instead of killing the loop mid-pipeline; a
            # persistently-broken source re-raises after the bound.
            try:
                if faults is not None and faults.should_fire("source_error"):
                    raise InjectedFault("source_error")
                due = source.pop_due(self.now)
            except Exception:
                self.n_source_errors += 1
                self._consec_source_errors += 1
                if self._consec_source_errors > SOURCE_ERROR_LIMIT:
                    raise
                self.bm.audit_after_fault()
                due = []
            else:
                self._consec_source_errors = 0
            for req in due:
                self._on_arrival(req)
            self._preflight(due)
            self._sweep_deadlines()

            if self.uses_pins:
                self.bm.unpin_expired(self.now)
            if tr is None:
                t0 = time.perf_counter()
            else:
                tr.close()                 # poll
                t0 = tr.open("schedule")   # its reads are the control plane's
            plan = self.sched.schedule(self.now)
            t = time.perf_counter() if tr is None else tr.close()
            self.control_plane_time += t - t0

            if plan.empty():
                # idle: jump to the source's next event
                nt = source.next_time()
                if nt is not None:
                    self.now = max(self.now, nt)
                    continue
                if self.sched.waiting and not self.sched.running:
                    expiry = self.bm.earliest_pin_expiry(self.now)
                    if expiry is not None:    # pinned blocks block admission
                        self.now = expiry
                        self.bm.unpin_expired(self.now)
                        continue
                    if self.scfg.strict:
                        raise RuntimeError(
                            "KV pool too small for a single waiting request "
                            f"({self.scfg.num_blocks} blocks)")
                    # nothing runs, nothing will arrive, no pin will
                    # expire: a transient (injected) admission fault
                    # clears on retry; a genuinely stuck head-of-line
                    # request is rejected with a structured reason and
                    # the loop keeps serving everyone else
                    self._stall_retries += 1
                    if self._stall_retries <= STALL_RETRY_LIMIT:
                        continue
                    self._stall_retries = 0
                    head = self.sched.waiting[0]
                    self._reject(head, "pool_exhausted",
                                 required=self.sched.required_blocks(head),
                                 available=self.bm.num_free())
                    continue
                break
            self._stall_retries = 0

            # device step-dispatch fault site: injected BEFORE the COW
            # drain, so nothing has entered the device and rollback is
            # exact — un-consume the prefill chunks and retry the very
            # same step with backoff (bounded by DISPATCH_RETRY_LIMIT)
            if faults is not None and faults.should_fire("dispatch_fail"):
                self.n_dispatch_retries += 1
                self._dispatch_failures += 1
                if self._dispatch_failures > DISPATCH_RETRY_LIMIT:
                    raise RuntimeError(
                        "persistent device dispatch failure "
                        f"({self._dispatch_failures} consecutive)")
                for chunk in plan.prefills:
                    if chunk.req.state is RequestState.PREFILL:
                        chunk.req.compute_ptr -= len(chunk.positions)
                if self.scfg.clock == "model":
                    # linear backoff in model time before the retry
                    self.now += self.sim_cost_model.beta \
                        * self._dispatch_failures
                self.bm.audit_after_fault()
                continue
            self._dispatch_failures = 0

            # copy-on-write forks queued during admission are folded into
            # the step about to be dispatched — they land before its
            # attention reads the forked pages, and the donor slots can be
            # released as soon as the step is in flight (any later write to
            # a re-allocated donor page is ordered after it by the data
            # dependency between consecutive steps' donated pools)
            copies = self.bm.drain_pending_copies()
            if copies:
                self.engine.queue_copies(copies)
                self.bm.release([s for s, _ in copies], self.now)

            if tr is not None:
                tr.dispatched(self.now, plan, self.sched.admit_tries,
                              self.sched.admitted)
            t1 = time.perf_counter()
            handle = self.engine.dispatch(plan)
            self.control_plane_time += handle.assembly_time

            if depth == 0:
                if tr is not None:
                    tr.open("wait")
                handle.block()     # synchronous order: wait for the device
                if tr is not None:
                    tr.close()
            if self.scfg.clock == "model":
                self.now += self._step_latency(plan)
            elif depth == 0:
                self.now += time.perf_counter() - t1
            else:
                # pipelined wall clock: the step's cost is the dispatch-to-
                # dispatch interval (host and device work overlap inside it)
                t_now = time.perf_counter()
                self.now += t_now - t_last_dispatch
            t_last_dispatch = time.perf_counter()
            steps += 1
            if self.scfg.audit_every \
                    and steps % self.scfg.audit_every == 0:
                self.bm.check_invariants()

            if tr is not None:
                tr.open("postprocess")
            self._postprocess(plan)
            if tr is not None:
                tr.close()
            inflight.append((plan, handle))
            while len(inflight) > depth:
                self._retire(*inflight.popleft())
            if tr is not None:
                tr.close_step()

        if tr is not None:
            tr.discard()               # the last iteration dispatched nothing
        while inflight:                # drain the pipeline
            self._retire(*inflight.popleft())
        wall = time.perf_counter() - t_run0

        # serve-drain audit: after a natural drain (every request reached
        # a terminal state) nothing may still hold a block reference or a
        # queued page copy, and the cross-structure accounting must be
        # clean — leaks fail HERE, not silently degrade forever
        drained = (source.done() and not self.sched.waiting
                   and not self.sched.running)
        if drained and (faults is not None or self.scfg.audit_every):
            self.bm.check_invariants()
            leaked = [b.slot for b in self.bm.blocks if b.ref_count > 0]
            assert not leaked, f"blocks leaked at drain: {leaked}"
            assert not self.bm.pending_copies, \
                "queued COW copies leaked at drain"

        out = self.stats.summary()
        out.update({
            "steps": steps,
            "wall_time": wall,
            "control_plane_time": self.control_plane_time,
            "evictions": self.bm.n_evictions,
            "swap_ins": self.bm.n_swap_ins,
            "swap_outs": self.bm.n_swap_outs,
            "block_hit_rate_manager": self.bm.hit_rate(),
            "cow_forks_manager": self.bm.n_cow_forks,
            "prefix_matches": self.bm.n_prefix_matches,
            "sim_time": self.now,
        })
        # host-tier offload accounting (per-half byte movement + residency
        # + drop counters) — always present, zeros when host_blocks == 0,
        # so result-schema consumers never need key-existence checks
        out.update(self.bm.counters())
        out.update(self.bm.prefetch_counters())
        # content-addressed prefix-store accounting (store_*/tenant_*) —
        # always present, zeros when the store is disabled
        out.update(self.store.counters())
        # per-structure control-plane op counts (treap rotations, trie
        # walks, evictor re-ranks) — the stress benchmark divides these
        # by `steps` and gates them sublinear in resident sessions
        out.update(self.bm.control_plane_counts())
        if self.bm.n_shards > 1:
            # deterministic shard accounting (benchmarks/sharded_serving)
            out["n_shards"] = self.bm.n_shards
            out["per_shard_used"] = self.bm.per_shard_used()
        # deterministic hot-path accounting (fused-dispatch + occupancy
        # buckets; empty for the simulated engine)
        out.update(self.engine.perf_counters())
        # failure-semantics accounting: terminal fault-domain counts +
        # degradation counters, and the fault plan's armed/fired tallies
        # when one is attached (all zeros on a fault-free run)
        out.update({
            "n_failed": self.n_failed,
            "n_rejected": self.n_rejected,
            "n_deadline_aborts": self.n_deadline_aborts,
            "n_on_token_errors": self.n_on_token_errors,
            "n_source_errors": self.n_source_errors,
            "n_dispatch_retries": self.n_dispatch_retries,
            "drained": drained,
        })
        out.update(self.bm.fault_counters())
        if self.scfg.faults is not None:
            out.update(self.scfg.faults.counts())
            out["fault_sites_fired"] = self.scfg.faults.sites_fired()
        return out

    # ------------------------------------------------------------------
    def _on_arrival(self, req: Request) -> None:
        if req.deadline < math.inf:
            self._has_deadlines = True
        if not self.scfg.strict:
            # a request that can NEVER fit the pool is refused up front
            # with a structured reason instead of wedging the queue
            required = self.sched.required_blocks(req)
            if required > self.scfg.num_blocks:
                self._reject(req, "request_exceeds_pool",
                             required=required,
                             available=self.scfg.num_blocks)
                return
        self.sched.submit(req)

    # ------------------------------------------------------------------
    # content-addressed global prefix store (core/prefix_store.py)
    # ------------------------------------------------------------------
    def _content_keys_for(self, req: Request) -> Optional[List[bytes]]:
        """Restart-stable content keys of the request's full prompt
        blocks, cached on the request; None when the store is off or the
        request runs in a private (non-shared) hash namespace."""
        if not self.store.enabled \
                or self.bm.request_salt(req.rid, req.hash_salt) != 0:
            return None
        cks = getattr(req, "_content_keys", None)
        if cks is None:
            cks = self.bm.content_keys(req.prompt_tokens)
            req._content_keys = cks
        return cks

    def _preflight(self, due: List[Request]) -> None:
        """Admission-time dedup pre-flight: analyze the arriving batch's
        content keys and mark duplicate-prefix followers so the
        scheduler holds them until their leader's shared blocks commit
        (one prefill + N-1 table hits instead of N identical prefills)."""
        if not self.store.enabled:
            return
        batch, reqs = [], []
        for r in due:
            if r.terminal:
                continue
            cks = self._content_keys_for(r)
            if cks:
                batch.append((r.tenant, cks))
                reqs.append(r)
        if len(batch) < 2:
            return
        report = self.store.analyze_batch(batch)
        for follower, leader in report.followers:
            reqs[follower]._dedup_hold = reqs[leader]

    def snapshot_store(self, path: str) -> int:
        """Persist the prefix store for a restart: deposit every
        committed resident block with a known content key (device pool
        read + host-tier entries), then write the snapshot.  Call after
        :meth:`serve` drains.  Returns the number of deposits made."""
        n = self.bm.export_resident(self.now)
        self.store.save(path, self.now)
        return n

    # ------------------------------------------------------------------
    # per-request fault domains (docs/SERVING.md "Failure semantics")
    # ------------------------------------------------------------------
    def _sweep_deadlines(self) -> None:
        """Abort every waiting/running request whose deadline has passed
        — through the shared cancel machinery, so blocks/pins release
        exactly as a client cancellation would release them."""
        if not self._has_deadlines:
            return
        expired = [r for r in self.sched.waiting if self.now > r.deadline]
        expired += [r for r in self.sched.running if self.now > r.deadline]
        for req in expired:
            self.n_deadline_aborts += 1
            self._fail_request(req, "deadline",
                               {"deadline": req.deadline,
                                "aborted_at": self.now})

    def _fail_request(self, req: Request, reason: str,
                      detail: Optional[Dict] = None,
                      state: RequestState = RequestState.FAILED) -> bool:
        """Land ``req`` in a terminal FAILED/REJECTED state: release
        every block/pin/copy it owns (via the scheduler's shared
        terminal-removal path), purge any swap-in halves still queued
        for its pages, record the structured failure, and notify the
        failure listeners.  The loop keeps serving everyone else."""
        if req.terminal:
            return False
        if req in self.sched.running and self.bm.swap_out_fn is not None:
            # an injected dispatch failure may have skipped the step that
            # would have consumed this request's queued swap-in halves;
            # purge them BEFORE the pages become reallocatable so a later
            # step can't scatter stale payload into someone else's block
            for s in req.block_slots:
                if s is not None:
                    self.bm.swap_out_fn(s, False, False)
        if not self.sched.remove(req, self.now, state):
            # never submitted (arrival-time rejection): no scheduler or
            # pool state to unwind, just mark it terminal
            req.state = state
            req.finished_at = self.now
        req.failure = {"status": req.status, "reason": reason,
                       **(detail or {})}
        if state is RequestState.REJECTED:
            self.n_rejected += 1
        else:
            self.n_failed += 1
        for fn in self.failure_listeners:
            fn(req, self.now)
        return True

    def _reject(self, req: Request, reason: str, required: int,
                available: int) -> bool:
        """Structured admission rejection: terminal ``rejected`` status
        with the blocks the request needed vs. what the pool offers."""
        return self._fail_request(
            req, reason,
            {"required_blocks": required, "available_blocks": available},
            state=RequestState.REJECTED)

    def _emit_token(self, req: Request) -> None:
        """Fire the streaming callback inside the owning request's fault
        domain: an exception (thrown by user code, or injected at the
        ``on_token_error`` site) fails THIS request — cancel + release —
        and never escapes into the serve loop.  (It used to propagate
        out of the pipeline with inflight handles and leaked refcounts.)
        The callback may still legitimately call :meth:`cancel`."""
        if req.on_token is None:
            return
        faults = self.scfg.faults
        try:
            if faults is not None and faults.should_fire("on_token_error"):
                raise InjectedFault("on_token_error")
            req.on_token(req, req.generated[-1])
        except Exception as e:  # noqa: BLE001 — user-code boundary
            self.n_on_token_errors += 1
            self._fail_request(req, "on_token_error", {"error": repr(e)})
            self.bm.audit_after_fault()

    def _postprocess(self, plan: StepPlan) -> None:
        """Host-side state update for a *dispatched* step.

        Outputs are teacher-forced, so nothing here reads logits — which
        is exactly what makes the one-step-deep overlap legal: the next
        step can be scheduled against fully updated host state while the
        device is still executing this one.  The logits/ids fetch lives in
        :meth:`_retire`.

        Requests cancelled mid-step (a streaming ``on_token`` callback or
        the frontend may abort any request while this loop runs) are
        skipped: their blocks are already released and they must not emit
        tokens or finish."""
        for r, chunk in enumerate(plan.prefills):
            req = chunk.req
            if req.terminal:
                continue               # cancelled/failed mid-pipeline
            self._commit_ready_blocks(req, int(chunk.positions[-1]) + 1)
            if chunk.completes_prefill:
                req.state = RequestState.DECODE
                req.first_token_at = self.now
                if req.hash_salt == 0:
                    # prompt is now resident: index it for prefix sharing
                    self.bm.register_prefix(req.prompt_tokens)
                req.generated.append(int(req.output_script[0]))
                self._emit_token(req)
                if req.state is RequestState.DECODE \
                        and len(req.output_script) <= 1:
                    self._finish(req)
        iters = plan.decode_iters if plan.decode_steps > 1 else None
        for j, req in enumerate(plan.decodes):
            # k-step plans consume decode_iters[j] tokens per request —
            # iterations past that were masked on device and roll back
            # here by simply not being consumed
            for _ in range(iters[j] if iters else 1):
                if req.state is not RequestState.DECODE:
                    break    # cancelled/failed (or already finished)
                p = req.prompt_len + len(req.generated) - 1
                if (p + 1) % self.scfg.block_size == 0:
                    self._commit_ready_blocks(req, p + 1)
                req.generated.append(
                    int(req.output_script[len(req.generated)]))
                self._emit_token(req)
                if req.state is RequestState.DECODE and req.decode_done:
                    self._finish(req)
                    break

    def _retire(self, plan: StepPlan, handle: StepHandle) -> None:
        """Fetch a completed step's device results: greedy sample ids for
        every selection row and the prefill logit rows for requests whose
        prefill completed (losslessness validation)."""
        R = self.engine.ecfg.max_prefills
        tr = self.tracer
        if tr is not None:
            tr.open("retire")
            tr.open("wait")
        ids = handle.token_ids_np()
        pre = handle.prefill_logits_np() if any(
            c.completes_prefill for c in plan.prefills) else None
        if tr is not None:
            tr.close()
        # pipelined wall clock: at _postprocess time the clock had not yet
        # absorbed this step's device execution (it is billed to the next
        # dispatch-to-dispatch interval); by retirement it has, so re-stamp
        # first_token_at here to keep TTFT comparable with depth-0 runs
        restamp = (self.scfg.clock == "wall"
                   and self.scfg.pipeline_depth > 0)
        for r, chunk in enumerate(plan.prefills):
            if chunk.completes_prefill:
                req = chunk.req
                req.first_logits = pre[r].copy()
                req.sampled_ids.append(int(ids[r]))
                if restamp:
                    req.first_token_at = self.now
        if plan.decode_steps > 1:
            # ids is (k, R+B); consume only each request's decode_iters
            # rows (host-side rollback of the masked iterations)
            for j, req in enumerate(plan.decodes):
                for i in range(plan.decode_iters[j]):
                    req.sampled_ids.append(int(ids[i, R + j]))
        else:
            for i, req in enumerate(plan.decodes):
                req.sampled_ids.append(int(ids[R + i]))
        if tr is not None:
            tr.close()

    def _finish(self, req: Request) -> None:
        # §5.1 online lifespan: feed actual per-block reuse intervals
        # observed by the block manager into the λ tracker
        if self.lifespan_tracker is not None and self.bm.reuse_intervals:
            for iv in self.bm.reuse_intervals:
                ll = self.lifespan_tracker.observe_reuse(iv)
                if ll is not None:
                    self.bm.policy.set_log_lambda(ll)
            self.bm.reuse_intervals.clear()
        if req.hash_salt == 0:
            # index prompt+output so follow-up turns can share the full chain
            self.bm.register_prefix(req.all_tokens)
        if self.scfg.continuum_ttl and req.is_tool_call:
            slots = [s for s in req.block_slots if s is not None]
            self.bm.pin(slots, until=self.now + req.tool_duration)
            self.bm.set_boost(slots, self.scfg.tool_boost)
        self.sched.finish(req, self.now)
        self.stats.record(req)
        # online session serving: the closed-loop frontend schedules the
        # session's next turn / suspension from here — AFTER release, so a
        # listener that boosts or pins the request's blocks sees their
        # post-release refcounts (and no allocation can have intervened)
        for fn in self.finish_listeners:
            fn(req, self.now)

    # ------------------------------------------------------------------
    def cancel(self, req: Request) -> bool:
        """Abort a request (streaming/cancellation API of the online
        frontend — safe to call from an ``on_token`` callback).  Releases
        every block reference immediately; refcounts return to their
        pre-admission baseline.  Finish listeners do NOT fire."""
        return self.sched.cancel(req, self.now)


# ---------------------------------------------------------------------------
# Reference-output helper for losslessness checks
# ---------------------------------------------------------------------------

def reference_logits(cfg: ModelConfig, params, tokens: List[int]) -> np.ndarray:
    """Logits for the last position of ``tokens`` via the dense (non-paged,
    non-evicting) model path — the ground truth for lossless serving.
    Runs on the device the parameters live on."""
    from repro_torch.models import forward
    t = torch.as_tensor(tokens, dtype=torch.long,
                        device=params["embed"].device)[None]
    with torch.no_grad():
        lg = forward(params, cfg, {"tokens": t})
    return lg[0, -1].float().cpu().numpy()
