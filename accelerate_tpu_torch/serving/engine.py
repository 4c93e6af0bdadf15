"""Continuous-batching serving engine over the paged or the flat KV arena.

Counterpart of ``accelerate_tpu/serving/engine.py``. Many requests decode
per device step against
one arena. On the paged arena (``page_size``, what users run with
``accelerate-tpu serve replica``) admissions ride the packed ragged
prefill:

- **paged arena** (``pages.py``): ``[num_pages, KVH, page_size, D]``
  pages per layer, per-slot page tables, page 0 the parking page, and
  the copy-on-write prefix cache (on by default) so a prompt whose
  prefix is cached prefills only its tail. ``kv_cache_dtype`` "int8" or
  "int4" stores int8 payload pages beside fp32 scale pages, which ride
  every fork and prefix share with their payload; decode writes quantize
  with ``quantize_kv``, the packed prefill quantizes on write inside its
  kernel, and both kernels read the pages dequantized;
- **batched decode step**: every slot decodes each step at a fixed batch
  of ``num_slots``; inactive slots are parked at the last cache position,
  where an active request always writes before it reads. On CUDA the
  step runs as the replay of a CUDA graph (``utils/cuda_graphs.py``),
  captured once per engine over fixed device buffers of tokens, write
  positions and active flags (the reference's jitted step); the CPU runs
  the same step body eagerly;
- **decode bursts** (``steps_per_call=K``): K steps back to back with the
  next token and the write positions moving on the device and one read
  of the [K, N] tokens, when no admission is in flight or can start and
  every live slot has K tokens of budget left (the reference's
  ``_burst_len``); otherwise one step;
- **speculative verify** (``spec_draft_len=K``, paged arena only): the
  host-side drafter (:class:`~.pages.NGramDrafter` by default) proposes K
  tokens per slot and one batched step feeds ``[last, d1..dK]`` at K + 1
  positions through the paged decode kernel (Sq = K + 1), emitting the
  longest accepted draft prefix plus one model token; greedy and sampled
  tokens are those of K + 1 sequential steps. The verify step is a CUDA
  graph too; spec replaces the burst, as in the reference;
- **packed ragged prefill**: each scheduler iteration packs the primary
  admission's next tail segment, plus the whole tails of further queued
  requests while capacity remains, into one token pack of the smallest
  capacity that fits (``prefill_chunks`` rounded up to the token block);
  a tail longer than the largest capacity continues mid-tail over its
  own arena prefix on the next iteration;
- **host-side scheduler**: the FIFO queue (or, with ``scheduler=``, the
  multi-tenant policy tier of ``scheduler.py``), slot allocator,
  per-request token callbacks, cancels and ``timeout_s`` expiries (reaped
  at the top of every step, queued, admitting and live alike), the drain
  (``request_drain`` / ``drain``) and the serving gauges a replica server
  and a router read (``metrics()``: ITL, free slots and pages,
  ``load_score``);
- **multi-tenant scheduling** (``scheduler=SchedulerConfig(...)``):
  weighted-fair, priority-classed, quota-metered queues whose overflow
  sheds at submit; watermark shedding under page pressure; preemption,
  which pages a lower-priority live slot out through the prefix cache,
  requeues it at the front of its class and later re-admits it by
  replaying prompt + generated tokens (mostly prefix hits) with nothing
  sampled, so its tokens are those of an uninterrupted run; and, with
  ``itl_slo_ms``, the AIMD controller that sets how many prefill
  dispatches may run between decode steps. Preemption parks the slot in
  the captured step's fixed buffers, as a cancel does, and a resume
  reloads them: no scheduling action captures a new graph;
- **hierarchical KV tiers** (``kv_tiers=TierConfig(...)``, ``tiers.py``;
  paged arena): a prefix-cache eviction demotes the victim's pages (one
  gather, one copy to the host) into host RAM, then disk blobs; an
  admission whose prompt a tier (or a peer replica's directory) holds
  deeper than the cache restores the pages into the arena in place,
  ``restore_batch_pages`` a scheduler iteration, before it is planned as
  a plain prefix hit: a restored hit gives the bits of a hit never
  evicted;
- **KV handoff** (``export_prefix_kv`` / ``import_prefix_kv`` /
  ``kv_directory``, paged arena): a cached prefix's pages in the
  reference's wire format (its leaf names, scan-stacked shapes and dtype
  names; bf16 as raw 2-byte words), so the reference's replicas and the
  port's accept each other's handoffs and disk blobs. Imports and
  restores copy into the existing pages, whose addresses the captured
  decode graphs hold;
- **fault injection** (``faults=FaultInjector(...)``, ``faults.py``):
  page squeezes, storms and delays at the step boundaries and before
  each decode and prefill dispatch;
- **telemetry** (``telemetry=TelemetrySession(...)``, or the process's
  ``current_session()``; ``telemetry/``): the reference's hooks at the
  reference's call sites feed the request tracer (one record per request,
  the TTFT / ITL / queue-wait histograms), the per-tenant usage meters,
  the session's step window and goodput ledger, and the flight ring. Each
  hook runs on the host between steps, on values the step already read
  back; none runs inside a captured graph or adds a device sync. With no
  session every hook is one attribute check.

On the flat arena (``page_size=None``, the reference's default;
``arena.py``) each slot is one batch row of a dense
[num_slots, KVH, max_cache_len, D] cache, quantized when
``kv_cache_dtype`` is "int8" or "int4". Admission is per-slot chunked
prefill in the ``prefill_chunks`` buckets against a slot view (the
masked-dense read, as the reference forces for chunks); the batched
decode step writes each slot's token at its own position and reads
through the dense decode kernel.

Greedy decoding is ``argmax``, inside the graph; temperature/top-k
sampling draws from a ``torch.Generator`` per request, seeded by
``submit(seed=...)``, outside the graph and on the device: each live
slot's generator draws once per step, in step order, so a burst gives
the tokens of K single steps.

HTTP handler threads of a replica server (``replica_server.py``) call
:meth:`ServingEngine.submit`, :meth:`Request.cancel` and
:meth:`ServingEngine.metrics` while one loop thread runs
:meth:`ServingEngine.step`: those touch host state only (the queue, flags,
counters, ``req.tokens``). The KV handoff calls (``kv_directory``,
``export_prefix_kv``, ``import_prefix_kv``) read or write pages: the
replica runs them and every ``step()`` under one lock.

A dispatched model (``big_modeling.DispatchedModel``: weights on the
card, in pinned host memory, on disk, or quantized on load) is served
through :meth:`ServingEngine.from_dispatched`, the reference's
counterpart: the engine runs the dispatched model's own tier binding, so
host-tier weights stream into the model's per-kind device buffers inside
every step (inside its CUDA graph too, as ``generate_dispatched``'s
decode step captures them), and holds the binding's disk-tier weights
pinned until :meth:`ServingEngine.close`. The reference's in-graph
``param_placer`` option has no counterpart here and raises, naming
``from_dispatched``; so does buffer donation (the port updates in place).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..generation import _sample
from ..models.decoder import resolve_device
from ..ops import kernels
from ..ops.attention import PREFILL_KV_TILE, PREFILL_TOKEN_BLOCK
from ..telemetry.capacity import CapacityModel
from ..telemetry.fleet import load_score
from ..utils import cuda_graphs
from ..utils.quantization import kv_cache_bits
from .arena import arena_nbytes, init_arena, slot_view, write_slot
from .pages import (
    NGramDrafter,
    PageAllocator,
    PagedTables,
    PrefixCache,
    fork_page,
    gather_pages,
    init_paged_arena,
    install_pages,
    set_table_entry,
    set_table_row,
    wire_leaf_specs,
)
from .scheduler import (
    SHED_DRAINING,
    SHED_PAGE_EXHAUSTED,
    SHED_PAGE_PRESSURE,
    MultiTenantScheduler,
    PrefillBudgetController,
    SchedulerConfig,
)
from .tiers import TierConfig, TieredStore, TierEntry, entry_nbytes, wire_dtype


class PagePressure(RuntimeError):
    """Raised by the page allocator when nothing is left to evict; the
    engine turns it into a scheduling decision (preempt a victim, shed a
    request) so the serving loop never wedges on it."""


@dataclass(eq=False)
class Request:
    """One generation request and its life-cycle state. ``tokens`` is the
    generated continuation; ``result()`` returns prompt + continuation.
    ``eq=False``: requests are identities, not values (the queue's
    ``remove`` must not compare prompt arrays).

    Every submitted request reaches exactly one terminal ``outcome``:
    ``"finished"`` (eos or token budget), ``"shed"`` (admission control,
    load shedding, page exhaustion or drain: ``shed_reason`` says which)
    or ``"cancelled"`` (``cancel()``,
    ``timeout_s`` expiry, or a raising ``on_token`` callback).
    ``finish_reason`` carries the finer cause."""

    prompt: np.ndarray
    max_new_tokens: int
    generator: Optional[torch.Generator] = None
    on_token: Optional[Callable] = None
    id: object = -1
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None   # scheduling hint (EDF within class)
    timeout_s: Optional[float] = None    # hard wall from submit to cancel
    replica: Optional[str] = None        # which engine served this hop

    # runtime state (engine-owned)
    tokens: list = field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    outcome: Optional[str] = None        # finished | shed | cancelled
    finish_reason: Optional[str] = None  # eos | budget | timeout | ...
    shed_reason: Optional[str] = None
    preemptions: int = 0
    _last_token_t: float = 0.0
    _cancel: bool = False
    # preempted and requeued: its re-admission replays prompt + tokens[:-1]
    # and samples nothing (the generator stays where the last step left it)
    _resume: bool = False
    # a re-queued continuation's draws made on an earlier hop, taken
    # before its first token is sampled
    _owed_draws: int = 0
    prefix_hit: int = 0         # prompt tokens served from the prefix cache
    prefill_dispatches: int = 0  # prefill dispatches (packs or chunks) its prompt rode
    pages_allocated: int = 0    # fresh pages this request consumed (forks incl.)
    prefill_kernel: Optional[str] = None  # "ragged" (paged arena) or "dense" (flat)
    spec_proposed: int = 0      # draft tokens verified for it
    spec_accepted: int = 0      # of which accepted
    # KV tiers: the tier a restore fed its prefix hit from (None: an HBM
    # hit or cold), the restore's wall and the pages it installed
    kv_restore_tier: Optional[str] = None
    kv_restore_ms: float = 0.0
    kv_restore_pages: int = 0

    def result(self) -> np.ndarray:
        """[prompt + generated] token ids."""
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])

    def cancel(self) -> bool:
        """Request cancellation: the engine frees the slot and pages at its
        next scheduler iteration and the request ends ``cancelled``. False
        if already terminal."""
        if self.done:
            return False
        self._cancel = True
        return True


class ServingEngine:
    """Slot-based continuous-batching scheduler over one ``DecoderLM``.

    ``model`` is a ``DecoderLM`` on ``device``; ``params``, when given, is
    a weight dict (``models/convert.py``) loaded into it first.
    ``device=None`` means CUDA and raises without it; ``device="cpu"``
    runs the kernels' plain versions. ``page_size`` (default None, the
    flat arena, as the reference) selects the paged arena with ``num_pages`` physical pages (default: capacity-equivalent
    to ``num_slots * max_cache_len`` plus the parking page);
    ``page_size=None`` the flat arena. ``kv_cache_dtype`` ("bf16", "int8"
    or "int4"; default: the model config's) is the KV storage precision,
    on either arena. ``spec_draft_len=K`` (paged arena only) turns on
    speculative verify with ``drafter`` (default
    :class:`~.pages.NGramDrafter`); it reserves K positions of per-slot
    headroom. ``temperature``/``top_k`` are engine-wide. ``replica`` is the
    engine's fleet identity, stamped on every request.
    ``steps_per_call=K`` runs decode bursts of K steps where the
    reference's rules allow one (ignored under spec, which replaces the
    burst). ``scheduler`` (a :class:`~.scheduler.SchedulerConfig` or a
    :class:`~.scheduler.MultiTenantScheduler`) replaces the FIFO queue
    with the multi-tenant policy tier; ``faults`` (a
    :class:`~.faults.FaultInjector`) is consulted at each step and before
    each dispatch. ``kv_tiers`` (paged arena; a
    :class:`~.tiers.TierConfig`, or a built :class:`~.tiers.TieredStore`)
    puts the host / disk / peer tiers under the prefix cache.
    ``invariant_prefill=True`` (paged arena; a port option) lays every
    prefill out so that each prompt row's attention walks the same
    64-position kv tiles whatever its prefix hit and its pack neighbours:
    prefix hits round down to a multiple of
    :data:`~..ops.attention.PREFILL_KV_TILE` and each co-admitted tail starts
    on a tile of the pack. A prompt's tokens are then the same bits on
    every admission and every replica over the same weights, which the
    canary's token-exact goldens need on CUDA, where the kernel's online
    softmax rounds by tile; it costs up to 63 re-prefilled positions a
    prefix hit and up to 63 pad rows a co-admitted tail. ``telemetry`` is a
    :class:`~accelerate_tpu_torch.telemetry.TelemetrySession` (default: the
    process's ``current_session()``, if any), attached by weak reference.
    """

    _LATER = {
        "param_placer": "an in-graph weight placer; serve a DispatchedModel with "
                        "ServingEngine.from_dispatched",
        "donate": "buffer donation (the port updates in place)",
    }

    def __init__(
        self,
        model,
        params: Optional[dict] = None,
        *,
        num_slots: int = 8,
        max_cache_len: Optional[int] = None,
        prefill_chunks=(64, 256),
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        prefix_max_entries: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,
        spec_draft_len: int = 0,
        drafter=None,
        device=None,
        replica: Optional[str] = None,
        steps_per_call: int = 1,
        scheduler=None,
        faults=None,
        telemetry=None,
        kv_tiers=None,
        invariant_prefill: bool = False,
        **later,
    ):
        if later:
            names = ", ".join(f"{k} ({self._LATER.get(k, 'unknown option')})"
                              for k in sorted(later))
            raise NotImplementedError(
                f"ServingEngine options {names} are not the port's"
            )
        self.device = resolve_device(device)
        from ..generation import depipeline

        # a pipelined model serves with its stages folded back into one
        # stack (a decode step is serial across stages)
        model = depipeline(model)
        if model.device != self.device:
            raise ValueError(
                f"the model lives on {model.device}, the engine on {self.device}"
            )
        if params is not None:
            model.load_params(params)
        self.model = model
        cfg = model.config
        self.kv_cache_dtype = kv_cache_dtype or cfg.kv_cache_dtype
        kv_cache_bits(self.kv_cache_dtype)  # raises on an unknown value
        self.spec_k = max(0, int(spec_draft_len))
        if self.spec_k and not page_size:
            raise ValueError(
                "speculative decoding (spec_draft_len > 0) requires the paged "
                "arena; pass page_size=..."
            )
        self._drafter = (drafter or NGramDrafter()) if self.spec_k else None
        cap = max_cache_len or cfg.max_cache_len or cfg.max_seq_len
        self.num_slots = int(num_slots)
        self.max_cache_len = int(cap)
        self.prefill_chunks = tuple(sorted(set(int(c) for c in prefill_chunks)))
        if not self.prefill_chunks or self.prefill_chunks[0] < 1:
            raise ValueError(f"bad prefill_chunks {prefill_chunks!r}")
        self.temperature = float(temperature)
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.steps_per_call = max(1, int(steps_per_call))

        self._prefix = None
        self._tiers = None
        self.replica = str(replica) if replica else None
        # the prefix hits' and the packed tails' alignment (1: none)
        self._prefill_align = PREFILL_KV_TILE if invariant_prefill else 1
        if not page_size:
            if kv_tiers is not None:
                raise ValueError("KV tiers need the paged arena; pass page_size=...")
            if invariant_prefill:
                raise ValueError("invariant_prefill needs the paged arena; pass page_size=...")
            self.page_size = None
            self._arena = init_arena(model, self.num_slots, self.max_cache_len,
                                     self.kv_cache_dtype)
        else:
            self._init_paged(cfg, int(page_size), num_pages, prefix_cache,
                             prefix_max_entries, kv_tiers)
        self.arena_bytes = arena_nbytes(self._arena)

        # per-slot decode state. The host arrays are the scheduler's; before
        # each decode step or burst one transfer copies them into fixed
        # device buffers (last tokens, write positions, active flags) that
        # the step body, and its CUDA graph, read and move forward
        n = self.num_slots
        self._tokens = np.zeros((n,), np.int64)
        self._lengths = np.zeros((n,), np.int64)
        self._active = np.zeros((n,), bool)
        self._state_dev = torch.zeros((3, n), dtype=torch.long, device=self.device)
        self._tok_dev, self._pos_dev, self._act_dev = self._state_dev.unbind(0)
        self._burst_dev = torch.zeros((self.steps_per_call, n), dtype=torch.long,
                                      device=self.device)  # one burst's tokens
        if self.spec_k:
            # the verify step's [last, d1..dK] and their write positions
            self._verify_dev = torch.zeros((2, n, self.spec_k + 1), dtype=torch.long,
                                           device=self.device)
            self._cand_dev = torch.zeros((n, self.spec_k + 1), dtype=torch.long,
                                         device=self.device)
        self._graphs: dict = {}  # step name -> CapturedStep (CUDA only)

        # scheduler=None keeps the FIFO deque; a SchedulerConfig or a
        # MultiTenantScheduler switches submit() and step() to the policy
        # tier (scheduler.py), with the ITL controller when it sets an SLO
        if isinstance(scheduler, SchedulerConfig):
            scheduler = MultiTenantScheduler(scheduler)
        self._sched: Optional[MultiTenantScheduler] = scheduler
        self._controller = None
        if scheduler is not None and scheduler.config.itl_slo_ms is not None:
            self._controller = PrefillBudgetController(
                scheduler.config.itl_slo_ms,
                budget=scheduler.config.prefill_budget,
                min_budget=scheduler.config.prefill_budget_min,
                max_budget=scheduler.config.prefill_budget_max,
            )
        self._faults = faults
        self._prefill_credit = 0.0

        self._queue: deque = deque()
        self._free = list(range(self.num_slots))[::-1]  # pop() -> slot 0 first
        self._slot_req: dict = {}
        self._admitting = None
        # request ids: HTTP handler threads submit while the loop thread
        # steps, so the counter moves under a lock
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._draining = False

        # metrics
        self.step_count = 0
        self.prefill_dispatches = 0
        self.prefill_packed_tokens = 0
        self.page_forks = 0
        self.requests_completed = 0
        self.requests_shed = 0
        self.requests_cancelled = 0
        self._capacity_model = CapacityModel()
        self._capacity_lock = threading.Lock()  # metrics() runs on scrape threads too
        self.preemptions = 0
        self.resumptions = 0
        self.generated_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefill_chunks_skipped = 0
        self.kv_pages_exported = 0
        self.kv_pages_imported = 0
        # committed admission hits per tier (hbm: a prefix hit with no
        # restore behind it) and the restore counters
        self.kv_tier_hits = {"hbm": 0, "host": 0, "disk": 0, "peer": 0}
        self.kv_restore_batches = 0
        self.kv_restore_batches_overlapped = 0
        self.kv_restores = 0
        self.kv_restores_aborted = 0
        self._restore = None        # the restore in flight (_plan_restore)
        self._restored_tier = None  # the tier feeding the plan being made
        self._step_samples: deque = deque(maxlen=512)  # (wall_s, tokens, steps)
        self._ttft: deque = deque(maxlen=2048)  # submit -> first token, s
        self._itl: deque = deque(maxlen=2048)  # inter-token gaps, s
        self._itl_emitted = 0   # lifetime gap count; the controller only
        self._itl_observed = 0  # observes when these differ (fresh gaps)

        if telemetry is None:
            from ..telemetry import current_session

            telemetry = current_session()
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach_serving(self)
        self._binding = None  # a dispatched model's tier binding (from_dispatched)

    @classmethod
    def from_dispatched(cls, dispatched, **kwargs) -> "ServingEngine":
        """An engine over a ``DispatchedModel`` (``big_modeling``): the
        serving counterpart of ``generation.generate_dispatched``. The
        model's weights stay where the device map put them (device rows,
        pinned host tensors streamed per layer, quantized layer views);
        disk-tier weights are loaded into pinned host memory once, here,
        and stay pinned for the engine's life. The decode and verify
        graphs capture the streamed weights' host-to-device copies, as
        generate()'s decode graph does. Call :meth:`close` when done to
        release that binding. ``kwargs`` are the constructor's
        (``device`` defaults to the dispatched model's)."""
        kwargs.setdefault("device", dispatched.device)
        binding = dispatched._concrete()
        binding.__enter__()
        try:
            engine = cls(dispatched.model, **kwargs)
        except BaseException as exc:
            binding.__exit__(type(exc), exc, exc.__traceback__)
            raise
        engine._binding = binding
        return engine

    def close(self):
        """Release a dispatched model's binding (:meth:`from_dispatched`):
        its disk-tier weights leave pinned memory, and the engine drops
        its model, arena and captured graphs, so it serves no more. A
        no-op on an engine built from a model."""
        if self._binding is None:
            return
        if self._slot_req or self._queued_depth() or self._admitting is not None:
            raise RuntimeError("close() needs an idle engine: drain or run it first")
        binding, self._binding = self._binding, None
        self._graphs.clear()
        self.model = self._arena = None
        binding.__exit__(None, None, None)

    def _init_paged(self, cfg, page_size: int, num_pages, prefix_cache: bool,
                    prefix_max_entries, kv_tiers):
        """The paged arena, its allocator, host tables, KV tiers, prefix
        cache and the packed ragged prefill's capacities."""
        self.page_size = page_size
        if self.page_size & (self.page_size - 1):
            raise ValueError(f"page_size must be a power of two, got {self.page_size}")
        if self.max_cache_len % self.page_size:
            raise ValueError(
                f"page_size ({self.page_size}) must divide max_cache_len "
                f"({self.max_cache_len})"
            )
        self.pages_per_slot = self.max_cache_len // self.page_size
        self.num_pages = (
            int(num_pages) if num_pages else 1 + self.num_slots * self.pages_per_slot
        )
        if self.num_pages < 2:
            raise ValueError(f"num_pages ({self.num_pages}) must be >= 2")
        self._allocator = PageAllocator(self.num_pages, reserved=1)
        self._tables_host = PagedTables(self.num_slots, self.pages_per_slot, parking=0)
        # a TierConfig builds the store, wired to the usage meters' tier
        # byte-seconds and this replica's identity; a built TieredStore is
        # taken as it is
        if isinstance(kv_tiers, TierConfig):
            kv_tiers = TieredStore(kv_tiers, page_size=self.page_size,
                                   kv_cache_dtype=self.kv_cache_dtype,
                                   replica=self.replica, on_bytes=self._note_tier_bytes)
        elif kv_tiers is not None and kv_tiers.on_bytes is None:
            kv_tiers.on_bytes = self._note_tier_bytes
        self._tiers = kv_tiers
        entries = int(prefix_max_entries or 512)
        tier_entries = kv_tiers.config.entry_capacity() if kv_tiers is not None else 0
        self._prefix = (
            PrefixCache(self._allocator, self.page_size, max_entries=entries,
                        # the ghost shadows measure headroom beyond the
                        # total (HBM + host + disk) capacity
                        ghost_base_entries=entries + tier_entries if tier_entries else None,
                        on_evict=self._demote_entry if kv_tiers is not None else None)
            if prefix_cache else None
        )
        self._arena = init_paged_arena(cfg, self.num_pages, self.page_size, self.device,
                                       self.kv_cache_dtype)
        self._page_tables = torch.zeros(
            (self.num_slots, self.pages_per_slot), dtype=torch.int32, device=self.device
        )
        # packed ragged prefill: fixed pack capacities, each chunk bucket
        # rounded up to the token block; the packer takes the smallest
        # capacity that fits the round's packed tails
        self._ragged_bt = int(cfg.prefill_kernel_block or PREFILL_TOKEN_BLOCK)
        rb = self._ragged_bt
        self._ragged_caps = tuple(sorted({-(-c // rb) * rb for c in self.prefill_chunks}))

    # -- request API -------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32, seed: int = 0,
               on_token: Optional[Callable] = None, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None, request_id=None,
               resumed_tokens: int = 0) -> Request:
        """Queue one request; returns its live :class:`Request` handle.
        ``on_token(token_id, request)`` fires as each token is emitted;
        ``seed`` seeds the request's sampling generator (unused when
        greedy). ``timeout_s`` cancels the request (freeing its slot and
        pages) if it has not finished that many seconds after submit.
        ``request_id`` (int or str) overrides the engine-assigned id; an
        external int id bumps the auto counter past itself.
        ``resumed_tokens``: the prompt's last that many tokens are this
        request's own output from an earlier hop (a router's re-queued
        continuation), so the generator draws past them before it samples
        the first token, which is then the uninterrupted run's. A
        continuation whose last resumed token is the engine's
        ``eos_token_id`` returns finished ("eos") at once: its stream
        already ended there.

        Without a scheduler the queue is FIFO and ``tenant``, ``priority``
        and ``deadline_s`` are only recorded. With one,
        they drive the weighted-fair, priority-classed queue (``deadline_s``
        orders a class earliest-deadline first), and admission control
        applies: a submit past the queue bounds returns the request
        already terminal, ``outcome`` "shed" with ``shed_reason``
        "queue_full" or "tenant_queue_full". A submit to a draining engine
        returns it shed with ``shed_reason`` "draining". Backpressure is a
        value, not an exception."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if not 0 <= resumed_tokens < prompt.size:
            raise ValueError(f"resumed_tokens must be in [0, {prompt.size}), "
                             f"got {resumed_tokens}")
        cover = self._plan_cover(prompt.size)
        if self._sched is not None and self._sched.config.preemption:
            # a preemptible request must be re-admittable at any point of
            # its progress: the worst-case replay (prompt + every generated
            # token but the last) must itself chunk-plan within the slot
            cover = max(cover, self._plan_cover(prompt.size + max_new_tokens - 1))
        # speculative verify writes up to spec_k positions past the last
        # sequential write, so spec reserves that much per-slot headroom
        need = prompt.size + max_new_tokens + self.spec_k
        if need > self.max_cache_len or cover > self.max_cache_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens})"
                + (f" + spec headroom ({self.spec_k})" if self.spec_k else "")
                + f" exceeds the slot KV capacity ({self.max_cache_len}); raise "
                "max_cache_len"
            )
        with self._id_lock:
            if request_id is None:
                rid = self._next_id
                self._next_id += 1
            else:
                rid = request_id
                if isinstance(rid, int) and rid >= self._next_id:
                    self._next_id = rid + 1
        gen = None
        if self.temperature != 0.0:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      generator=gen, on_token=on_token, id=rid,
                      tenant=str(tenant or "default"), priority=int(priority),
                      deadline_s=None if deadline_s is None else float(deadline_s),
                      timeout_s=None if timeout_s is None else float(timeout_s),
                      replica=self.replica)
        if gen is not None:
            req._owed_draws = int(resumed_tokens)
        req.submit_t = time.perf_counter()
        tr = self._tracer()
        if tr is not None:
            # before the queue append: the loop thread admits from the
            # queue, and admission must find the record already live
            tr.on_submit(req)
        usage = self._usage()
        if usage is not None:
            usage.note_submit(req.tenant)
        if (resumed_tokens and self.eos_token_id is not None
                and int(prompt[-1]) == self.eos_token_id):
            # a continuation whose earlier hop already emitted the eos (its
            # stream broke before the done event): the request is over, so
            # it finishes here, drawing nothing and taking no slot
            self._finish(req, req.submit_t, "eos")
            return req
        if self._draining:
            self._shed(req, SHED_DRAINING)
            return req
        if self._sched is not None:
            ok, reason = self._sched.admit(req)
            if not ok:
                self._shed(req, reason)
            return req
        self._queue.append(req)
        return req

    def generate_batched(self, prompts, *, max_new_tokens: int = 32, seeds=None):
        """Submit ``prompts`` (list of 1-D id arrays), run to completion and
        return the list of [prompt + generated] arrays."""
        if seeds is None:
            seeds = range(len(prompts))
        else:
            seeds = list(seeds)
            if len(seeds) != len(prompts):
                raise ValueError(
                    f"seeds ({len(seeds)}) must match prompts ({len(prompts)})"
                )
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, seed=s)
                for p, s in zip(prompts, seeds)]
        self.run()
        bad = [r for r in reqs if r.outcome != "finished"]
        if bad:
            raise RuntimeError(
                f"generate_batched: {len(bad)}/{len(reqs)} requests did not "
                f"finish (first: id={bad[0].id} outcome={bad[0].outcome} "
                f"shed_reason={bad[0].shed_reason}); the arena is "
                "overcommitted for this batch: raise num_pages"
            )
        return [r.result() for r in reqs]

    # -- scheduler ---------------------------------------------------------

    def _queued_depth(self) -> int:
        return self._sched.total_queued if self._sched is not None else len(self._queue)

    def _pending(self) -> bool:
        return bool(self._queued_depth() or self._admitting is not None or self._slot_req)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: fire due faults, shed the queue when
        draining, reap cancels and timeouts, apply the scheduler's pressure
        decisions (shed, preempt), advance prefill admission (one packed
        dispatch, or as many as the ITL budget's credit allows under a
        scheduler), then run one batched decode step over every active
        slot. Returns whether any work happened."""
        if self._faults is not None:
            self._faults.on_step(self)
        if self._draining and self._queued_depth():
            # request_drain() only sets the flag (it may fire from a signal
            # handler); the queue shed always runs here, on the loop thread
            self._shed_queue_for_drain()
        progressed = self._reap()
        if self._sched is not None:
            progressed = self._shed_on_pressure() or progressed
            progressed = self._maybe_preempt() or progressed
            budget = (self._controller.budget if self._controller is not None
                      else self._sched.config.prefill_budget)
            if not self._slot_req:
                # throttling prefill protects live decodes' ITL; with none
                # live there is nothing to protect: admit freely
                budget = max(budget, 1.0)
            self._prefill_credit = min(self._prefill_credit + budget, max(1.0, budget))
            while self._prefill_credit >= 1.0:
                if not self._advance_admission():
                    break
                self._prefill_credit -= 1.0
                progressed = True
        else:
            progressed = self._advance_admission() or progressed
        progressed = self._decode_once() or progressed
        if self._controller is not None and self._itl_emitted != self._itl_observed:
            # fresh gaps only: idle iterations (serve() polling an empty
            # engine) must not replay the last window's p99 into the
            # controller at the loop's rate
            self._itl_observed = self._itl_emitted
            p99, n = self._recent_itl_p99_ms()
            self._controller.observe(p99, samples=n)
        return progressed

    def _recent_itl_p99_ms(self, window: int = 128):
        """p99 over the most recent ITL gaps, in ms, and how many gaps: what
        the prefill-budget controller acts on."""
        if not self._itl:
            return None, 0
        recent = list(self._itl)[-window:]
        return 1e3 * float(np.percentile(np.asarray(recent), 99)), len(recent)

    def run(self):
        """Drive :meth:`step` until queue, admissions and slots are idle."""
        try:
            while self._pending():
                self.step()
        except Exception:
            self._flight_dump("serving_exception")
            raise

    def serve(self, should_stop: Optional[Callable[[], bool]] = None,
              idle_sleep_s: float = 0.001):
        """Long-running loop: keep scheduling as requests arrive (from
        another thread's ``submit``) until ``should_stop()`` returns True;
        idle iterations sleep ``idle_sleep_s``. A drain
        (:meth:`request_drain`) finishes the in-flight requests and
        returns even when ``should_stop`` never fires; with no
        ``should_stop`` it returns once idle."""
        try:
            while should_stop is None or not should_stop():
                busy = self.step()
                if self._draining and not self._pending():
                    return
                if not busy:
                    if should_stop is None and not self._pending():
                        return
                    time.sleep(idle_sleep_s)
        except Exception:
            self._flight_dump("serving_exception")
            raise

    # -- warmup ----------------------------------------------------------------

    def _kernel_names(self) -> tuple:
        """The kernels this engine's arena, ``kv_cache_dtype`` and model
        dtype (bf16 or fp16 entries) launch on a CUDA device
        (``ops/kernels.py`` names)."""
        quant = "_quant" if kv_cache_bits(self.kv_cache_dtype) < 16 else ""
        sfx = kernels.KERNEL_DTYPES.get(self.model.config.dtype, "")
        if self.page_size:
            return (f"paged_decode{quant}{sfx}", f"ragged_prefill{quant}{sfx}")
        return (f"dense_decode{quant}{sfx}",)

    def warmup(self):
        """The port's counterpart of the reference's warmup, which compiles
        every program the engine can dispatch. On CUDA this builds
        :meth:`_kernel_names` (the nvcc build the first request would
        otherwise wait for) and captures the CUDA graph of every step the
        engine replays: the decode step (a burst replays it K times) or,
        under spec, the verify step. The capture runs the step over parked
        slots, whose writes land where no request reads. On the CPU (the
        plain versions, no graphs) there is nothing to do. Needs an idle
        engine."""
        if self._slot_req or self._queued_depth() or self._admitting is not None:
            raise RuntimeError("warmup() needs an idle engine")
        if self.device.type == "cuda":
            kernels.build(self._kernel_names())
            if self.spec_k:
                self._load_verify_state(np.zeros((self.num_slots, self.spec_k), np.int64))
                self._step_fn("verify")
            else:
                self._load_decode_state()
                self._step_fn("decode")

    def mark_steady(self):
        """No-op. The reference snapshots its compile counters here so that
        ``serving/admission_recompiles`` counts every later compile; the
        port compiles no programs, keeps no compile counter and exports no
        such gauge."""

    # -- drain / flight ----------------------------------------------------------

    def request_drain(self):
        """Flag-only drain: later submits shed with ``shed_reason``
        "draining", and everything still queued is shed at the top of the
        next :meth:`step`; in-flight requests finish under whatever loop
        drives :meth:`step`. Setting one flag is the whole effect, so this
        is safe from a signal handler or another thread mid-step."""
        self._draining = True

    def _queued(self) -> list:
        """Snapshot of every queued request."""
        return self._sched.queued() if self._sched is not None else list(self._queue)

    def _unqueue(self, req: Request) -> bool:
        """Drop ``req`` from the queue; False if it is not queued."""
        if self._sched is not None:
            return self._sched.remove(req)
        try:
            self._queue.remove(req)
        except ValueError:
            return False
        return True

    def _shed_queue_for_drain(self):
        now = time.perf_counter()
        for req in self._queued():
            if not self._unqueue(req):
                continue
            req.shed_reason = SHED_DRAINING
            self._terminate(req, now, "shed", "shed")

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown on the owner thread: stop admitting, shed the
        queue, step until every in-flight request finishes (or
        ``timeout_s`` passes: the stragglers are then cancelled with
        reason "drain_timeout"). Every request submitted before the drain
        ends with a definite outcome. Returns ``{completed, shed,
        cancelled}``."""
        self.request_drain()
        self._shed_queue_for_drain()
        deadline = time.perf_counter() + timeout_s if timeout_s is not None else None
        while self._pending():
            if deadline is not None and time.perf_counter() > deadline:
                now = time.perf_counter()
                if self._admitting is not None:
                    self._abort_admission(now, "cancelled", "drain_timeout")
                for req in list(self._slot_req.values()):
                    self._terminate(req, now, "cancelled", "drain_timeout")
                break
            self.step()
        if self.telemetry is not None:
            try:
                self.telemetry.flush()
            except Exception:
                pass
        return {
            "completed": self.requests_completed,
            "shed": self.requests_shed,
            "cancelled": self.requests_cancelled,
        }

    def _tracer(self):
        """The session's request tracer, or None: the whole per-request
        tracing layer costs one attribute check when telemetry is off."""
        if self.telemetry is None:
            return None
        return getattr(self.telemetry, "requests", None)

    def _usage(self):
        """The session's per-tenant usage accountant, or None (the same
        one-attribute-check contract as the tracer)."""
        if self.telemetry is None:
            return None
        return getattr(self.telemetry, "usage", None)

    def _flight_note(self, kind: str, **fields):
        flight = getattr(self.telemetry, "flight", None)
        if flight is not None:
            flight.note(kind, **fields)

    def _flight_dump(self, reason: str):
        flight = getattr(self.telemetry, "flight", None)
        if flight is not None:
            try:
                flight.dump(reason)
            except Exception:
                pass

    def flight_dump(self, reason: str) -> bool:
        """Capture a flight-recorder bundle now (``POST /v1/flight`` on a
        replica server lands here). Returns whether a flight recorder
        exists to dump to."""
        has_flight = getattr(self.telemetry, "flight", None) is not None
        self._flight_dump(str(reason))
        return has_flight

    # -- terminal transitions ----------------------------------------------

    def _release_slot(self, req: Request):
        if req.slot is None:
            return
        slot = req.slot
        self._slot_req.pop(slot, None)
        self._active[slot] = False
        if self.page_size:
            self._release_slot_pages(slot, tenant=req.tenant)
        self._free.append(slot)
        req.slot = None

    def _terminate(self, req: Request, now: float, outcome: str, reason: str):
        """The single exit for every request: one terminal outcome, slot
        and pages freed, counters fed."""
        if req.done:
            return
        req.outcome = outcome
        req.finish_reason = reason
        req.finish_t = now
        self._release_slot(req)
        if outcome == "finished":
            self.requests_completed += 1
        elif outcome == "shed":
            self.requests_shed += 1
        else:
            self.requests_cancelled += 1
        usage = self._usage()
        if usage is not None:
            usage.note_outcome(req.tenant, outcome)
        tr = self._tracer()
        if tr is not None:
            tr.on_finish(req, reason)
        # last: a handler thread that sees ``done`` sees the slot freed,
        # the counters fed and the record written
        req.done = True

    def _shed(self, req: Request, reason: str):
        req.shed_reason = reason
        self._terminate(req, time.perf_counter(), "shed", "shed")

    def _reap(self) -> bool:
        """Process cancellations and ``timeout_s`` expiries: queued,
        admitting and live alike. A cancelled or timed-out request frees
        its slot and pages now."""
        now = time.perf_counter()
        progressed = False

        def reason(req):
            if req._cancel:
                return "cancelled"
            if req.timeout_s is not None and now - req.submit_t > req.timeout_s:
                return "timeout"
            return None

        for req in list(self._slot_req.values()):
            why = reason(req)
            if why:
                self._terminate(req, now, "cancelled", why)
                progressed = True
        if self._admitting is not None:
            why = reason(self._admitting[0])
            if why:
                self._abort_admission(now, "cancelled", why)
                progressed = True
        for req in self._queued():
            why = reason(req)
            if why:
                if not self._unqueue(req):
                    continue
                self._terminate(req, now, "cancelled", why)
                progressed = True
        return progressed

    def _abort_admission(self, now: float, outcome: str, reason: str):
        """Tear down the mid-prefill admission (cancel, timeout or page
        exhaustion): the slot returns to the free list, its partly
        prefilled pages are released on the paged arena (the prefix cache
        never saw them: a prompt is published only once admitted), and
        the request terminates with ``outcome`` (a shed records
        ``reason`` as its ``shed_reason``)."""
        req, slot = self._admitting[0], self._admitting[1]
        self._admitting = None
        if self._restore is not None:
            # mid-restore: its pages were allocated but never published
            for p in self._restore["pages"]:
                self._allocator.release(p)
            self._restore = None
            self.kv_restores_aborted += 1
        if self.page_size:
            self._release_slot_pages(slot, tenant=req.tenant)
        self._free.append(slot)
        req.slot = None
        if outcome == "shed":
            req.shed_reason = req.shed_reason or reason
            self._terminate(req, now, "shed", "shed")
        else:
            self._terminate(req, now, outcome, reason)

    # -- pressure: shedding and preemption ------------------------------------

    def _page_free_frac(self) -> float:
        if not self.page_size:
            return 1.0
        usable = self.num_pages - self._allocator.reserved
        return self._allocator.free_count / max(1, usable)

    def _shed_on_pressure(self) -> bool:
        """Watermark load shedding: when the paged arena's free fraction
        drops below the watermark, drop the newest lowest-priority queued
        request (queued work that could not be admitted anyway)."""
        if not self.page_size or self._sched.total_queued == 0:
            return False
        # pages the prefix cache holds are reclaimable, not pressure: evict
        # LRU entries first, and shed only if the arena is still below the
        # watermark (its pages pinned by live slots or a fault injector)
        low = self._sched.config.page_low_watermark
        while self._page_free_frac() < low and self._prefix is not None \
                and self._prefix.evict_lru():
            pass
        if self._page_free_frac() >= low:
            return False
        # a queued request that outranks a live slot is preemption's job
        # (_maybe_preempt runs next): shed only classes no live slot loses
        # to, or the lone high-priority request would be dropped while
        # low-priority slots pin the arena
        live = [int(r.priority) for r in self._slot_req.values()]
        victim = self._sched.pick_shed(max_priority=(min(live) + 1) if live else None)
        if victim is None:
            return False
        self._sched.shed(victim)
        self._shed(victim, SHED_PAGE_PRESSURE)
        self._flight_note("request_shed", request_id=victim.id, reason=SHED_PAGE_PRESSURE,
                          free_frac=round(self._page_free_frac(), 4))
        return True

    def _maybe_preempt(self) -> bool:
        """Page out the lowest-priority live slot when a strictly
        higher-priority request waits and no slot is free (at most one
        preemption per scheduler iteration)."""
        if (self._free or self._admitting is not None or not self._slot_req
                or self._sched.total_queued == 0):
            return False
        best = self._sched.peek_priority()
        if best is None:
            return False
        victim = self._sched.pick_victim(self._slot_req.items(), best)
        if victim is None:
            return False
        self._preempt(*victim)
        return True

    def _preempt(self, slot: int, req: Request):
        """Suspend a live request: publish its KV pages to the prefix cache
        (paged arena), release the slot, and requeue it at the front of its
        class. The slot is parked in the decode step's buffers as a freed
        one is; the request's generator stays where its last draw left it.
        Re-admission replays prompt + generated through the prefix cache
        (mostly hits) and samples nothing: its tokens are those of an
        uninterrupted run."""
        self._slot_req.pop(slot, None)
        self._active[slot] = False
        if self.page_size:
            if self._prefix is not None and req.tokens:
                # page out through the prefix cache: its entries hold the
                # page references, so the resume maps them back as hits
                # (and LRU eviction can still reclaim them under pressure)
                self._prefix.insert(self._replay_seq(req), self._tables_host.rows[slot],
                                    tenant=req.tenant)
            self._release_slot_pages(slot, tenant=req.tenant)
        self._free.append(slot)
        req.slot = None
        req.preemptions += 1
        req._resume = True
        self.preemptions += 1
        usage = self._usage()
        if usage is not None:
            usage.note_preempt(req.tenant)
        self._sched.requeue(req)
        tr = self._tracer()
        if tr is not None:
            tr.on_preempt(req)
        self._flight_note("request_preempt", request_id=req.id, slot=slot,
                          tokens=len(req.tokens))

    def _relieve_pressure(self, req: Request, exclude_slot: int) -> bool:
        """A slot could not get pages: preempt a strictly lower-priority
        victim (its pages come free for this one) if the scheduler allows.
        False when no victim qualifies: the caller sheds ``req``."""
        if self._sched is None:
            return False
        victim = self._sched.pick_victim(
            ((s, r) for s, r in self._slot_req.items() if s != exclude_slot),
            int(req.priority))
        if victim is None:
            return False
        self._preempt(*victim)
        return True

    # -- planning ------------------------------------------------------------

    def _plan_chunks(self, prompt_len: int):
        """(start, bucket) list covering [0, prompt_len) from the fixed
        bucket set: largest bucket that fits, smallest (padded) for the
        tail. The admission planner weighs prefix hits by it."""
        plan, start = [], 0
        while start < prompt_len:
            rem = prompt_len - start
            fit = [c for c in self.prefill_chunks if c <= rem]
            bucket = fit[-1] if fit else self.prefill_chunks[0]
            plan.append((start, bucket))
            start += bucket
        return plan

    def _plan_cover(self, prompt_len: int) -> int:
        start, bucket = self._plan_chunks(prompt_len)[-1]
        return start + bucket

    # -- paged-arena bookkeeping -------------------------------------------

    def _alloc_page(self) -> int:
        """One fresh page, evicting LRU prefix-cache entries under
        pressure; raises :class:`PagePressure` when nothing is left."""
        page = self._allocator.alloc()
        while page is None and self._prefix is not None and self._prefix.evict_lru():
            page = self._allocator.alloc()
        if page is None:
            raise PagePressure(
                f"paged KV arena exhausted ({self.num_pages} pages, "
                f"{len(self._slot_req)} live slots): raise num_pages"
            )
        return page

    def _ensure_writable(self, req: Request, slot: int, lo_pos: int, hi_pos: int):
        """Before a dispatch that writes positions [lo_pos, hi_pos] for
        ``slot``: grow its page table to cover hi_pos, and copy-on-write
        fork any page in the write range that is shared (prefix cache or
        another slot still references it)."""
        th = self._tables_host
        ps = self.page_size
        usage = self._usage()
        p_hi = hi_pos // ps
        while th.alloc_count[slot] <= p_hi:
            idx = th.alloc_count[slot]
            page = self._alloc_page()
            th.rows[slot][idx] = page
            th.alloc_count[slot] = idx + 1
            set_table_entry(self._page_tables, slot, idx, page)
            req.pages_allocated += 1
            if usage is not None:
                # growth: one more page held; a fork below is held-count
                # neutral (the fresh page replaces the shared claim)
                usage.note_pages(req.tenant, 1)
        for idx in range(lo_pos // ps, p_hi + 1):
            page = int(th.rows[slot][idx])
            if not self._allocator.shared(page):
                continue
            fresh = self._alloc_page()
            fork_page(self._arena, page, fresh)
            self._allocator.release(page)
            th.rows[slot][idx] = fresh
            set_table_entry(self._page_tables, slot, idx, fresh)
            req.pages_allocated += 1
            self.page_forks += 1

    def _paged_admit_plan(self, req: Request, slot: int, seq: np.ndarray) -> list:
        """Map the longest cached prefix of ``seq`` into the slot's fresh
        page table (refcount++ per shared page) and return the chunk plan
        for the uncached tail only, as [(global_start, bucket), ...]. At
        least the final token always prefills: its logits seed the first
        sampled token."""
        th = self._tables_host
        th.reset_slot(slot)
        cold_chunks = len(self._plan_chunks(seq.size))
        hit_len, entry = 0, None
        if self._prefix is not None:
            hit_len, entry = self._prefix.lookup(seq, limit=seq.size - 1)
            align = self._prefill_align
            hit_len -= hit_len % align
            # the tail plan must still fit the slot
            while hit_len and (
                hit_len + self._plan_cover(seq.size - hit_len) > self.max_cache_len
            ):
                hit_len = max(0, hit_len - max(self.page_size, align))
            # a hit whose tail needs more prefill dispatches than the cold
            # plan is a TTFT loss, not a win: decline it
            if hit_len and len(self._plan_chunks(seq.size - hit_len)) > cold_chunks:
                hit_len = 0
            if hit_len == 0:
                entry = None
            self._prefix.record_hit(hit_len, entry)
        usage = self._usage()
        if entry is not None:
            n_map = -(-hit_len // self.page_size)
            for i in range(n_map):
                page = int(entry.pages[i])
                self._allocator.retain(page)
                th.rows[slot][i] = page
            th.alloc_count[slot] = n_map
            if usage is not None:
                usage.note_pages(req.tenant, n_map)
        if usage is not None and hit_len:
            usage.note_prefix_hit(req.tenant, hit_len)
        if hit_len:
            # a hit right after a restore belongs to the tier that supplied
            # its pages; every other committed hit was HBM-resident
            self.kv_tier_hits[self._restored_tier or "hbm"] += 1
            # the prefill chunks the cached prefix made unnecessary
            self.prefill_chunks_skipped += cold_chunks - len(
                self._plan_chunks(seq.size - hit_len))
        req.prefix_hit = hit_len
        set_table_row(self._page_tables, slot, th.rows[slot])
        tail_plan = self._plan_chunks(seq.size - hit_len)
        return [(hit_len + start, bucket) for start, bucket in tail_plan]

    def _insert_prefix(self, req: Request, slot: int):
        """Admission finished: publish this prompt's pages to the prefix
        cache. The request's own boundary page becomes shared here; its
        first decode write into that page forks it."""
        if self._prefix is None:
            return
        n_pages = -(-req.prompt.size // self.page_size)
        if n_pages > self._tables_host.alloc_count[slot]:
            return
        self._prefix.insert(req.prompt, self._tables_host.rows[slot], tenant=req.tenant)

    def _release_slot_pages(self, slot: int, tenant: Optional[str] = None):
        """Drop the slot's page references (pages still retained by the
        prefix cache or another slot survive) and point its device table
        row back at the parking page, so a parked decode write can never
        land in a page that was reallocated. ``tenant`` is billed the
        released pages in the usage meters."""
        th = self._tables_host
        pages = th.slot_pages(slot)
        for page in pages:
            self._allocator.release(page)
        if tenant is not None and pages:
            usage = self._usage()
            if usage is not None:
                usage.note_pages(tenant, -len(pages))
        th.reset_slot(slot)
        set_table_row(self._page_tables, slot, th.rows[slot])

    # -- hierarchical KV tiers (HBM -> host -> disk -> peers) ---------------

    def _note_tier_bytes(self, tenant: str, tier: str, delta: int):
        """The tier store's byte hook into the usage meters' tier
        byte-seconds: every + has its -, so held bytes drain to 0. The disk
        scan runs while the engine is built, before its session is
        attached: nothing is metered then."""
        usage = self._usage() if hasattr(self, "telemetry") else None
        if usage is not None:
            usage.note_tier_bytes(tenant, tier, delta)

    def _demote_entry(self, entry):
        """The prefix cache's ``on_evict`` hook: copy the victim's pages to
        the host (one gather, one transfer) and offer them to the host
        tier. An entry some tier already covers is skipped (a longer
        demoted entry serves every shorter aligned prefix)."""
        tiers = self._tiers
        if tiers is None or entry.tokens is None or tiers.covers(entry.key):
            return
        specs = wire_leaf_specs(self._arena)
        arrays = gather_pages(self._arena, entry.pages)
        tokens = np.asarray(entry.tokens, np.int32)
        tiers.put(TierEntry(
            key=entry.key, token_len=entry.token_len, tokens=tokens,
            n_pages=len(entry.pages), arrays=arrays, paths=[sp[0] for sp in specs],
            nbytes=entry_nbytes(arrays, tokens), tenant=entry.tenant,
            dtypes=[sp[3] for sp in specs],
        ))

    def _plan_restore(self, req: Request, seq: np.ndarray) -> Optional[dict]:
        """Probe the tiers for a prefix of ``seq`` deeper than the prefix
        cache's own and, on a hit the admit plan would commit to, allocate
        its pages. Returns the restore :meth:`_advance_restore` drives, or
        None (plan now). Page pressure aborts the restore: a restore never
        sheds or preempts live work."""
        tiers = self._tiers
        if tiers is None or self._prefix is None or seq.size < 2:
            return None
        limit = seq.size - 1
        hbm_len, _ = self._prefix.peek(seq, limit)
        hit = tiers.probe(seq, limit, min_len=hbm_len)
        if hit is None:
            return None
        if hit["tier"] == "peer":
            try:
                tokens, token_len, _, arrays = self._handoff_arrays(hit["handoff"])
            except ValueError:
                self.kv_restores_aborted += 1
                return None
        else:
            tokens, token_len, arrays = hit["tokens"], hit["token_len"], hit["arrays"]
        # _paged_admit_plan's commit rules, applied before paying for the
        # restore: a hit the plan would shrink or decline installs nothing
        cold_chunks = len(self._plan_chunks(seq.size))
        hit_len = int(token_len)
        while hit_len and hit_len + self._plan_cover(seq.size - hit_len) > self.max_cache_len:
            hit_len = max(0, hit_len - self.page_size)
        if hit_len and len(self._plan_chunks(seq.size - hit_len)) > cold_chunks:
            hit_len = 0
        if hit_len <= hbm_len:
            return None
        pages = []
        try:
            for _ in range(-(-hit_len // self.page_size)):
                pages.append(self._alloc_page())
        except PagePressure:
            for p in pages:
                self._allocator.release(p)
            self.kv_restores_aborted += 1
            return None
        return {"tier": hit["tier"], "tokens": np.asarray(tokens[:hit_len], np.int32),
                "arrays": arrays, "pages": pages, "next": 0, "t0": time.perf_counter()}

    def _advance_restore(self):
        """One restore batch: copy up to ``restore_batch_pages`` pages into
        the arena in place (the decode step of the same iteration follows
        on the same stream). After the last, the prefix joins the cache and
        the admission is planned as a plain prefix hit, attributed to the
        tier: a restored hit is a never-evicted hit, bit for bit."""
        req, slot, _, _, seq = self._admitting
        r = self._restore
        end = min(r["next"] + max(1, int(self._tiers.config.restore_batch_pages)),
                  len(r["pages"]))
        install_pages(self._arena, [a[:, r["next"]:end] for a in r["arrays"]],
                      r["pages"][r["next"]:end])
        r["next"] = end
        self.kv_restore_batches += 1
        if self._slot_req:
            self.kv_restore_batches_overlapped += 1
        if end < len(r["pages"]):
            return
        # the cache entries take the page references
        self._prefix.insert(r["tokens"], r["pages"], tenant=req.tenant)
        for p in r["pages"]:
            self._allocator.release(p)
        if r["tier"] == "peer":
            self.kv_pages_imported += len(r["pages"])
        self.kv_restores += 1
        req.kv_restore_tier = r["tier"]
        req.kv_restore_pages = len(r["pages"])
        req.kv_restore_ms = round((time.perf_counter() - r["t0"]) * 1e3, 3)
        self._restore = None
        self._restored_tier = r["tier"]
        try:
            self._admitting[2] = self._paged_admit_plan(req, slot, seq)
        finally:
            self._restored_tier = None

    def kv_directory(self) -> dict:
        """Digest directory of the prefixes this replica can export (what
        ``GET /v1/kv/directory`` serves and peers' tier stores poll): each
        prefix cache entry's content key (blake2b-16 of the int32 tokens),
        hex, and its token length."""
        prefixes = []
        if self._prefix is not None:
            prefixes = [{"digest": e.key.hex(), "token_len": int(e.token_len)}
                        for e in list(self._prefix.entries.values())]
        return {"version": 1, "replica": self.replica, "page_size": self.page_size or 0,
                "kv_cache_dtype": self.kv_cache_dtype, "prefixes": prefixes}

    # -- KV handoff (prefill -> decode replicas, session migration) ---------

    def _require_handoff(self):
        if not self.page_size or self._prefix is None:
            raise ValueError("KV handoff needs the paged arena with the prefix cache "
                             "(page_size=..., prefix_cache=True)")

    def export_prefix_kv(self, tokens) -> Optional[dict]:
        """The longest cached prefix of ``tokens`` as a KV handoff: its
        pages' bytes as they sit in the arena (quantized payloads and
        scales verbatim), in the reference's wire format, so the importer
        admits the prefix as a local warm hit, bit for bit. None when
        nothing is cached. The probe is ``peek``: an export skews no hit
        gauge."""
        import base64

        self._require_handoff()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            return None
        hit_len, entry = self._prefix.peek(tokens)
        if not hit_len:
            return None
        n_pages = -(-hit_len // self.page_size)
        arrays = gather_pages(self._arena, entry.pages[:n_pages])
        leaves = [{"path": path, "dtype": dname, "shape": list(arr.shape),
                   "data": base64.b64encode(arr.tobytes()).decode("ascii")}
                  for (path, _, _, dname), arr in zip(wire_leaf_specs(self._arena), arrays)]
        self.kv_pages_exported += n_pages
        return {"version": 1, "page_size": self.page_size,
                "kv_cache_dtype": self.kv_cache_dtype, "token_len": int(hit_len),
                "tokens": [int(t) for t in tokens[:hit_len]], "n_pages": n_pages,
                "replica": self.replica, "leaves": leaves}

    def _handoff_arrays(self, handoff: dict):
        """Validate a KV handoff against this arena's wire identity
        (version, page size, KV dtype, leaf paths, shapes and dtypes) and
        decode its leaves. Returns ``(tokens, token_len, n_pages,
        arrays)``; raises ValueError on any mismatch. The import endpoint
        and the peer tier's restore share it: a pull can never install
        what an import would reject."""
        try:
            return self._decode_handoff(handoff)
        except (KeyError, TypeError) as exc:
            # a body from the wire that lacks a field or has the wrong type
            raise ValueError(f"malformed KV handoff: {exc!r}") from exc

    def _decode_handoff(self, handoff: dict):
        import base64

        if handoff.get("version") != 1:
            raise ValueError(f"unknown KV handoff version {handoff.get('version')!r}")
        if int(handoff["page_size"]) != self.page_size:
            raise ValueError(f"KV handoff page_size {handoff['page_size']} != engine "
                             f"page_size {self.page_size}")
        if (handoff.get("kv_cache_dtype") or "bf16") != self.kv_cache_dtype:
            raise ValueError(f"KV handoff kv_cache_dtype {handoff.get('kv_cache_dtype')!r} "
                             f"!= engine {self.kv_cache_dtype!r}")
        tokens = np.asarray(handoff["tokens"], np.int32).reshape(-1)
        token_len = int(handoff["token_len"])
        n_pages = int(handoff["n_pages"])
        if tokens.size != token_len or n_pages != -(-token_len // self.page_size):
            raise ValueError("KV handoff token/page accounting is inconsistent")
        specs = wire_leaf_specs(self._arena)
        wire = handoff["leaves"]
        if len(wire) != len(specs):
            raise ValueError(f"KV handoff carries {len(wire)} K/V leaves, engine arena "
                             f"has {len(specs)}: a different model or cache layout")
        arrays = []
        for (path, _, page_shape, dname), spec in zip(specs, wire):
            expect = [page_shape[0], n_pages, *page_shape[1:]]
            if spec["path"] != path or list(spec["shape"]) != expect or spec["dtype"] != dname:
                raise ValueError(
                    f"KV handoff leaf {spec['path']} ({spec['dtype']}{spec['shape']}) does "
                    f"not match engine leaf {path} ({dname}, page-gathered {expect})")
            arrays.append(np.frombuffer(base64.b64decode(spec["data"]),
                                        wire_dtype(dname)).reshape(expect))
        return tokens, token_len, n_pages, arrays

    def import_prefix_kv(self, handoff: dict) -> int:
        """Install a peer's KV handoff: allocate pages, copy the leaves into
        them in place, register the prefix, so the next admission of those
        tokens is a prefix hit as if this replica had prefilled them.
        Returns the token length now cached (0 when page pressure blocked
        the install: a handoff never sheds live work). Raises ValueError
        on an incompatible handoff."""
        self._require_handoff()
        tokens, token_len, n_pages, arrays = self._handoff_arrays(handoff)
        have, _ = self._prefix.peek(tokens)
        if have >= token_len:
            return have  # already cached at least this deep
        pages = []
        try:
            for _ in range(n_pages):
                pages.append(self._alloc_page())
        except PagePressure:
            for p in pages:
                self._allocator.release(p)
            return 0
        install_pages(self._arena, arrays, pages)
        self._prefix.insert(tokens, pages)
        # the cache entries hold the references now: LRU may reclaim them
        for p in pages:
            self._allocator.release(p)
        self.kv_pages_imported += n_pages
        return token_len

    # -- admission -----------------------------------------------------------

    def _pop_next(self) -> Optional[Request]:
        """Next request to admit: the scheduler's WFQ / priority pick, or
        the FIFO head. Skips requests that went terminal while queued."""
        while True:
            if self._sched is not None:
                req = self._sched.next_request()
            else:
                req = self._queue.popleft() if self._queue else None
            if req is None or not req.done:
                return req

    def _draw_first(self, req: Request, row: torch.Tensor) -> int:
        """The first token's draw from ``row`` [1, V]. A continuation first
        spends the draws an earlier hop made: a draw takes as much of the
        generator as its row's shape asks, whatever the values, so drawing
        from zeros leaves the generator where those draws did."""
        for _ in range(req._owed_draws):
            _sample(torch.zeros_like(row), req.generator, self.temperature, self.top_k)
        req._owed_draws = 0
        return int(_sample(row, req.generator, self.temperature, self.top_k)[0])

    def _replay_seq(self, req: Request) -> np.ndarray:
        """The sequence a preemption resume re-prefills: the prompt plus
        every generated token but the last (whose K/V the next decode step
        writes), exactly the state the slot held when it was paged out."""
        if not req.tokens:
            return req.prompt
        return np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])

    def _advance_admission(self) -> bool:
        if self._admitting is None:
            if not self._free:
                return False
            req = self._pop_next()
            if req is None:
                return False
            slot = self._free.pop()
            seq = self._replay_seq(req) if req._resume else req.prompt
            if self.page_size:
                # the tier probe comes first: a host / disk / peer hit
                # deeper than the cache's stages a restore, and the plan
                # waits (None) until its pages are installed
                self._restore = self._plan_restore(req, seq)
                plan = None if self._restore is not None else \
                    self._paged_admit_plan(req, slot, seq)
            else:
                plan = self._plan_chunks(seq.size)
            self._admitting = [req, slot, plan, 0, seq]
            tr = self._tracer()
            if tr is not None:
                if req._resume:
                    tr.on_resume(req, slot)
                else:
                    tr.on_admission(req, slot, time.perf_counter() - req.submit_t)
        if self._admitting[2] is None:
            # a restore in flight: one page batch a scheduler iteration,
            # with the decode step after it in the same iteration
            self._advance_restore()
            return True
        return self._ragged_advance() if self.page_size else self._flat_advance()

    def _flat_advance(self) -> bool:
        """One bucketed prefill chunk of the admitting request against its
        slot view (flat arena): queries at positions start .. start + C - 1
        attend the slot's whole prefix, so chunks continue exactly. The
        last chunk's last valid row samples the first token (the padding
        rows of a bucketed final chunk give logits nobody reads); a resume
        samples nothing."""
        req, slot, plan, idx, seq = self._admitting
        start, bucket = plan[idx]
        seg = seq[start:start + bucket]
        chunk = np.zeros((1, bucket), np.int64)
        chunk[0, :seg.size] = seg
        dev = self.device
        if self._faults is not None:
            self._faults.before_prefill(self)
        t0 = time.perf_counter()
        view = slot_view(self._arena, slot, start)
        logits = self.model(torch.as_tensor(chunk, device=dev),
                            start + torch.arange(bucket, device=dev), cache=view,
                            decode=True)[0]  # [bucket, V]
        write_slot(self._arena, view, slot)
        self.prefill_dispatches += 1
        req.prefill_dispatches += 1
        self._note_prefill(req, slot, start, bucket, int(seg.size), t0,
                           time.perf_counter() - t0, 1.0)
        if idx + 1 < len(plan):
            self._admitting[3] = idx + 1
            return True
        self._admitting = None
        req.prefill_kernel = "dense"
        if req._resume:
            self._resume_live(req, slot, seq)
            return True
        first = self._draw_first(req, logits[seg.size - 1][None])
        self._go_live(req, slot, first, time.perf_counter())
        return True

    def _ragged_advance(self) -> bool:
        """One packed ragged-prefill dispatch: the primary admission's next
        tail segment plus, while capacity remains, the whole tails of
        further queued requests (FIFO only: a scheduler's pick stays one
        at a time, and a resume admits alone), packed token-block-aligned
        into the smallest pack capacity that fits."""
        req, slot, plan, idx, seq = self._admitting
        bt = self._ragged_bt
        cap_max = self._ragged_caps[-1]
        # ``idx`` is the next global position to prefill (0 = nothing
        # dispatched yet: start past the prefix hit of the admit plan; a
        # first dispatch always advances past position 0)
        cur = plan[0][0] if idx == 0 else idx
        n = min(seq.size - cur, cap_max)
        if self._faults is not None:
            self._faults.before_prefill(self)
        try:
            self._ensure_writable(req, slot, cur, cur + n - 1)
        except PagePressure:
            # the ladder of live-slot growth: page out a strictly
            # lower-priority victim before shedding the admission
            resolved = self._relieve_pressure(req, slot)
            if resolved:
                try:
                    self._ensure_writable(req, slot, cur, cur + n - 1)
                except PagePressure:
                    resolved = False
            if not resolved:
                self._abort_admission(time.perf_counter(), "shed", SHED_PAGE_EXHAUSTED)
                self._flight_note("request_shed", request_id=req.id,
                                  reason=SHED_PAGE_EXHAUSTED)
                return True
        # packs: [request, slot, s0, s1, primary, seq]. The primary may be
        # mid-tail (longer than the largest pack); co-admitted tails are
        # always whole, so every co-admit completes in this dispatch
        packs = [[req, slot, cur, cur + n, True, seq]]
        used = -(-n // bt) * bt
        align = self._prefill_align

        def aligned(rows: int) -> int:
            # where the next packed tail starts (a kv tile under invariant_prefill)
            return -(-rows // align) * align

        # co-admission is FIFO only (a scheduler's pick stays one at a
        # time) and off under KV tiers (a tier probe may stage a restore,
        # which needs the admission to itself)
        while (self._sched is None and self._tiers is None and self._free
               and self._queue and aligned(used) + bt <= cap_max):
            nxt = self._queue[0]
            if aligned(used) + -(-int(nxt.prompt.size) // bt) * bt > cap_max:
                break
            self._queue.popleft()
            slot2 = self._free.pop()
            hit2 = self._paged_admit_plan(nxt, slot2, nxt.prompt)[0][0]
            n2 = int(nxt.prompt.size) - hit2
            try:
                self._ensure_writable(nxt, slot2, hit2, hit2 + n2 - 1)
            except PagePressure:
                # back out and requeue at the head: it re-admits alone
                self._release_slot_pages(slot2, nxt.tenant)
                self._free.append(slot2)
                if nxt.prefix_hit:
                    self.kv_tier_hits["hbm"] -= 1
                nxt.prefix_hit = 0
                self._queue.appendleft(nxt)
                break
            tr = self._tracer()
            if tr is not None:
                tr.on_admission(nxt, slot2, time.perf_counter() - nxt.submit_t)
            packs.append([nxt, slot2, hit2, hit2 + n2, False, nxt.prompt])
            used = aligned(used) + -(-n2 // bt) * bt
        rcap = next(c for c in self._ragged_caps if c >= used)
        ids = np.zeros((1, rcap), np.int64)
        row_slot = np.full((rcap,), -1, np.int32)
        row_pos = np.full((rcap,), -1, np.int32)
        hist = np.zeros((self.num_slots,), np.int32)
        last_rows = {}
        r = 0
        for _, psl, s0, s1, _, pseq in packs:
            r = aligned(r)
            nseg = s1 - s0
            nb = -(-nseg // bt)
            ids[0, r:r + nseg] = pseq[s0:s1]
            # pad rows of a pack's last block keep the slot id (the kernel
            # reads the block's first row to name its slot); pads are dead
            # through pos = -1
            row_slot[r:r + nb * bt] = psl
            row_pos[r:r + nseg] = np.arange(s0, s1)
            hist[psl] = s0
            last_rows[psl] = r + nseg - 1
            r += nb * bt
        dev = self.device
        t0 = time.perf_counter()
        row_pos_t = torch.as_tensor(row_pos, device=dev)
        logits = self.model(
            torch.as_tensor(ids, device=dev),
            row_pos_t.clamp(min=0)[None],
            cache=self._arena,
            cache_positions=row_pos_t[None],
            page_table=self._page_tables,
            ragged_slots=torch.as_tensor(row_slot, device=dev),
            slot_hist=torch.as_tensor(hist, device=dev),
        )[0]  # [rcap, V]
        self.prefill_dispatches += 1
        fresh = sum(s1 - s0 for _, _, s0, s1, _, _ in packs)
        self.prefill_packed_tokens += fresh
        # the packs that complete here and sample a first token: not a
        # primary still mid-tail, and not a resume (which samples nothing,
        # so its generator stays where the uninterrupted run's would)
        done = [p for p in packs
                if not (p[4] and p[3] < p[5].size) and not p[0]._resume]
        firsts = {}
        if done:
            rows = logits[[last_rows[p[1]] for p in done]]
            if self.temperature == 0.0:
                toks = _sample(rows, None, 0.0, None).tolist()
            else:
                toks = [self._draw_first(p[0], rows[i:i + 1]) for i, p in enumerate(done)]
            firsts = {p[1]: int(t) for p, t in zip(done, toks)}
        now = time.perf_counter()
        wall = now - t0
        for preq, psl, s0, s1, primary, pseq in packs:
            preq.prefill_dispatches += 1
            # the shared dispatch wall is billed to each tenant in
            # proportion to its live tokens in the pack
            self._note_prefill(preq, psl, s0, s1 - s0, s1 - s0, t0, wall,
                               (s1 - s0) / max(fresh, 1))
            if primary and s1 < pseq.size:
                # mid-tail: the primary stays the admission and resumes at
                # position s1 next iteration (it filled the whole pack, so
                # it never coexists with co-admits)
                self._admitting[3] = s1
                continue
            if primary:
                self._admitting = None
            preq.prefill_kernel = "ragged"
            if preq._resume:
                # its pages were published when it was paged out
                self._resume_live(preq, psl, pseq)
                continue
            self._insert_prefix(preq, psl)
            self._go_live(preq, psl, firsts[psl], now)
        return True

    def _go_live(self, req: Request, slot: int, first_tok: int, now: float):
        """Admission done: the slot decodes from the next step on, and the
        first token is emitted."""
        self._tokens[slot] = first_tok
        self._lengths[slot] = req.prompt.size
        req.slot = slot
        self._slot_req[slot] = req
        self._active[slot] = True
        req.first_token_t = now
        self._ttft.append(now - req.submit_t)
        tr = self._tracer()
        if tr is not None:
            tr.on_first_token(req, now - req.submit_t)
        self._emit(req, first_tok, now)

    def _note_prefill(self, req: Request, slot: int, start: int, bucket: int,
                      tokens: int, t0: float, wall: float, share: float):
        """Telemetry of one prefill dispatch for ``req``: the tracer's chunk
        record, and the usage meters' prefilled tokens (padding excluded)
        and ``share`` of the dispatch wall."""
        tr = self._tracer()
        if tr is not None:
            tr.on_prefill_chunk(req, slot, start, bucket, t0, wall)
        usage = self._usage()
        if usage is not None:
            usage.note_prefill(req.tenant, tokens)
            usage.note_compute(req.tenant, wall * 1e3 * share)

    def _resume_live(self, req: Request, slot: int, seq: np.ndarray):
        """A preemption resume's replay is done: the slot continues where
        it was paged out, feeding the last emitted token back at position
        ``seq.size``; nothing is emitted. The wait since the page-out is
        scheduling latency, not an inter-token gap: the ITL clock restarts,
        so one preemption cannot fake an SLO breach."""
        self._tokens[slot] = req.tokens[-1]
        self._lengths[slot] = seq.size
        req.slot = slot
        self._slot_req[slot] = req
        self._active[slot] = True
        req._resume = False
        req._last_token_t = 0.0
        self.resumptions += 1

    # -- decode --------------------------------------------------------------

    def _next_write_pos(self, req: Request) -> int:
        """The slot's next cache write position: the latest emitted token's
        K/V has not been written yet."""
        return req.prompt.size + len(req.tokens) - 1

    def _grow_or_resolve(self, req: Request, slot: int, lo: int, hi: int) -> bool:
        """Grow a live slot's pages for the next write range. Under page
        pressure with nothing left to evict, preempt a strictly
        lower-priority victim (its pages come free here) or, when none
        qualifies, shed ``req`` itself. True when the slot is still live
        and writable."""
        while True:
            try:
                self._ensure_writable(req, slot, lo, hi)
                return True
            except PagePressure:
                if self._relieve_pressure(req, slot):
                    continue
                self._shed(req, SHED_PAGE_EXHAUSTED)
                self._flight_note("request_shed", request_id=req.id,
                                  reason=SHED_PAGE_EXHAUSTED)
                return False

    def _burst_len(self) -> int:
        """``steps_per_call`` when a burst can neither delay an admission
        (none in flight, and the queue cannot be admitted) nor overshoot a
        request's token budget, else 1 (the reference's ``_burst_len``)."""
        k = self.steps_per_call
        if k <= 1 or self._admitting is not None or (self._queued_depth() and self._free):
            return 1
        remaining = min(req.max_new_tokens - len(req.tokens)
                        for req in self._slot_req.values())
        return k if remaining >= k else 1

    def _load_decode_state(self):
        """Copy the host's per-slot state into the decode step's device
        buffers in one transfer. Inactive slots still flow through the
        fixed-batch step but must not write at ``lengths`` (a slot
        mid-admission has its prefix there): they are parked on the LAST
        cache position, which any request reaching it writes before
        attending, and do not move. A freed slot's table row points at the
        parking page, so a parked write never lands in another request's
        page."""
        write_pos = np.where(self._active, self._lengths, self.max_cache_len - 1)
        state = np.stack([self._tokens, write_pos, self._active]).astype(np.int64)
        self._state_dev.copy_(torch.from_numpy(state))

    def _decode_body(self) -> torch.Tensor:
        """One decode step on the device buffers, what the step's CUDA graph
        captures: every slot's token through the model at its write
        position, the greedy argmax into the token buffer, the active
        slots' positions one further. Returns the logits [N, V]."""
        pos = self._pos_dev
        paged = {"page_table": self._page_tables} if self.page_size else {}
        logits = self.model(self._tok_dev[:, None], pos[:, None], cache=self._arena,
                            cache_positions=pos, **paged)[:, -1]
        if self.temperature == 0.0:
            self._tok_dev.copy_(torch.argmax(logits, dim=-1))
        pos.add_(self._act_dev)
        return logits

    def _step_fn(self, name: str):
        """Step ``name`` ("decode" or "verify") as this engine runs it: on
        CUDA the replay of its graph, captured here at first use (warmup()
        captures ahead of traffic) from the device buffers as the caller
        loaded them; on the CPU the body itself."""
        step = self._graphs.get(name)
        if step is None:
            body = self._decode_body if name == "decode" else self._verify_body
            if not cuda_graphs.captures(self.device):
                return body
            restore = (self._tok_dev, self._pos_dev) if name == "decode" else ()
            step = self._graphs[name] = cuda_graphs.capture(body, self.device,
                                                            restore=restore)
        return step.replay

    def _decode_once(self) -> bool:
        if not self._slot_req:
            return False
        if self.spec_k:
            return self._spec_verify_once()
        k = self._burst_len()
        if self.page_size:
            for slot, req in list(self._slot_req.items()):
                if slot not in self._slot_req:
                    continue  # shed or preempted while relieving another slot
                pos = self._next_write_pos(req)
                self._grow_or_resolve(req, slot, pos, pos + k - 1)
            if not self._slot_req:
                return True  # every live slot was shed under page pressure
        if self._faults is not None:
            self._faults.before_decode(self)
        live = list(self._slot_req.items())
        self._load_decode_state()
        step = self._step_fn("decode")
        t0 = time.perf_counter()
        for i in range(k):
            logits = step()
            if self.temperature != 0.0:
                # each live slot's generator draws once a step, in step
                # order, on the device: no host read until the burst ends
                for slot, req in live:
                    self._tok_dev[slot:slot + 1].copy_(
                        _sample(logits[slot:slot + 1], req.generator, self.temperature,
                                self.top_k))
            self._burst_dev[i].copy_(self._tok_dev)
        host = self._burst_dev[:k].cpu().numpy()  # [K, N]; waits for the burst
        now = time.perf_counter()
        wall = now - t0
        self.step_count += k
        self._usage_note_step(wall)
        for slot, _ in live:
            self._tokens[slot] = host[k - 1, slot]
            self._lengths[slot] += k
        emitted = 0
        for i in range(k):
            # a burst delivers K tokens in one host read: its wall is
            # amortized over them, so ITL reads the per-token pace instead
            # of K - 1 zeros and one K-sized gap
            ts = t0 + wall * (i + 1) / k
            for slot, req in list(self._slot_req.items()):
                self._emit(req, int(host[i, slot]), ts)
                emitted += 1
        # delivered tokens only: an eos mid-burst drops the rest of its
        # slot's burst tokens, and tokens/s must not claim them
        self._step_samples.append((wall, emitted, k))
        if self.telemetry is not None:
            self.telemetry.on_step(self, wall, tokens=emitted, steps=k)
        return True

    def _draft_context(self, req: Request) -> np.ndarray:
        """The tail of the request's prompt + generation the drafter reads
        (all of it when the drafter sets no ``lookback``)."""
        lb = int(getattr(self._drafter, "lookback", 0) or 0)
        gen = np.asarray(req.tokens[-lb:] if lb else req.tokens, np.int32)
        if lb and gen.size >= lb:
            return gen
        head = req.prompt[-(lb - gen.size):] if lb else req.prompt
        return np.concatenate([np.asarray(head, np.int32), gen])

    def _load_verify_state(self, drafts: np.ndarray):
        """Copy ``[last, d1..dK]`` and their write positions ``lengths ..
        lengths + K`` (inactive slots parked at the last position) into the
        verify step's device buffers, in one transfer."""
        k = self.spec_k
        seq = np.concatenate([self._tokens[:, None], drafts], axis=1)  # [N, K+1]
        pos = self._lengths[:, None] + np.arange(k + 1)[None, :]
        write_pos = np.where(self._active[:, None], pos, self.max_cache_len - 1)
        self._verify_dev.copy_(torch.from_numpy(np.stack([seq, write_pos]).astype(np.int64)))

    def _verify_body(self) -> torch.Tensor:
        """The verify step on its device buffers, what its CUDA graph
        captures: the model over ``[last, d1..dK]`` at K + 1 positions a
        slot (Sq = K + 1 through the paged decode kernel), the greedy
        argmax into the candidate buffer. Returns the logits [N, K+1, V]."""
        seq, pos = self._verify_dev.unbind(0)
        logits = self.model(seq, pos, cache=self._arena, cache_positions=pos,
                            page_table=self._page_tables)
        if self.temperature == 0.0:
            self._cand_dev.copy_(torch.argmax(logits, dim=-1))
        return logits

    def _verify_candidates(self, logits, live):
        """The model's token at every verify position, ``(cand [N, K+1],
        states)``. Sampled, each live slot draws its K + 1 candidates in
        order from its generator, as K + 1 sequential steps would, and
        ``states[slot][i]`` is the generator's state after draw i, so
        acceptance can put the generator where the sequential loop would
        stand. Greedy: the step's argmax, and no states."""
        if self.temperature == 0.0:
            return self._cand_dev.cpu().numpy(), None
        cand = np.zeros(logits.shape[:2], np.int64)
        states = {}
        for slot, req in live:
            states[slot] = []
            for i in range(logits.shape[1]):
                cand[slot, i] = int(_sample(logits[slot, i:i + 1], req.generator,
                                            self.temperature, self.top_k)[0])
                states[slot].append(req.generator.get_state())
        return cand, states

    def _spec_verify_once(self) -> bool:
        """One speculative round: the drafter proposes K tokens per live
        slot, one batched step feeds ``[last, d1..dK]`` at positions
        ``lengths .. lengths + K`` (inactive slots parked at the last
        position) through the paged decode kernel at Sq = K + 1, and each
        slot emits its longest accepted draft prefix plus the model's
        token after it. Rejected drafts' K/V sit past the new frontier,
        where the decode mask hides them until they are overwritten."""
        k = self.spec_k
        drafts = np.zeros((self.num_slots, k), np.int64)
        for slot, req in list(self._slot_req.items()):
            if slot not in self._slot_req:
                continue  # shed or preempted while relieving another slot
            drafts[slot] = self._drafter.propose(self._draft_context(req), k)
            pos = self._next_write_pos(req)
            self._grow_or_resolve(req, slot, pos, pos + k)
        if not self._slot_req:
            return True  # every live slot was shed under page pressure
        self._load_verify_state(drafts)
        step = self._step_fn("verify")
        t0 = time.perf_counter()
        logits = step()  # [N, K+1, V]
        live = list(self._slot_req.items())
        cand, states = self._verify_candidates(logits, live)
        now = time.perf_counter()
        wall = now - t0
        self.step_count += 1
        self._usage_note_step(wall)
        emitted = 0
        for slot, req in live:
            matched = cand[slot, :k] == drafts[slot]
            accepted = int(np.cumprod(matched).sum())
            if states is not None:
                # the generator as accepted + 1 sequential draws leave it
                req.generator.set_state(states[slot][accepted])
            self._tokens[slot] = cand[slot, accepted]
            self._lengths[slot] += accepted + 1
            req.spec_proposed += k
            req.spec_accepted += accepted
            self.spec_proposed += k
            self.spec_accepted += accepted
            n_emit = accepted + 1
            for i in range(n_emit):
                # the verify wall amortized over the slot's emitted run
                self._emit(req, int(cand[slot, i]), t0 + wall * (i + 1) / n_emit)
                emitted += 1
                if req.done:
                    break  # budget or eos inside the run: drop the rest
        self._step_samples.append((wall, emitted, 1))
        if self.telemetry is not None:
            self.telemetry.on_step(self, wall, tokens=emitted, steps=1)
        return True

    def _usage_note_step(self, wall_s: float):
        """Bill one batched decode / verify dispatch's wall evenly across
        the live slots' tenants; called before emission (a request that
        finishes in ``_emit`` leaves ``_slot_req`` but rode this step)."""
        usage = self._usage()
        if usage is None or not self._slot_req:
            return
        share = wall_s * 1e3 / len(self._slot_req)
        for req in self._slot_req.values():
            usage.note_compute(req.tenant, share)

    def _emit(self, req: Request, token: int, now: float):
        req.tokens.append(token)
        self.generated_tokens += 1
        if self._sched is not None:
            # a quota meters generation, not submission
            self._sched.note_tokens(req.tenant, 1)
        usage = self._usage()
        if usage is not None:
            # per-tenant decode tokens sum exactly to generated_tokens:
            # both count here and only here
            usage.note_decode(req.tenant)
        if req._last_token_t:
            gap = now - req._last_token_t
            self._itl.append(gap)
            self._itl_emitted += 1
            tr = self._tracer()
            if tr is not None:
                tr.on_token(req, gap, len(req.tokens) - 1)
        req._last_token_t = now
        if req.on_token is not None:
            try:
                req.on_token(token, req)
            except Exception:
                # a raising consumer costs exactly its own request, never
                # the serving loop
                self._terminate(req, now, "cancelled", "callback_error")
                return
        if self.eos_token_id is not None and token == self.eos_token_id:
            self._finish(req, now, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, now, "budget")

    def _finish(self, req: Request, now: float, reason: str = "budget"):
        self._terminate(req, now, "finished", reason)

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict:
        """Serving gauges, ``serving/``-namespaced like the reference's.
        Safe from another thread while the loop steps: it reads host state
        only, and snapshots each sample deque before reading it."""
        out = {
            "serving/queue_depth": self._queued_depth(),
            "serving/slot_occupancy": len(self._slot_req) / self.num_slots,
            "serving/requests_completed": self.requests_completed,
            "serving/requests_shed": self.requests_shed,
            "serving/generated_tokens": self.generated_tokens,
            "serving/decode_steps": self.step_count,
            "serving/prefill_dispatches": self.prefill_dispatches,
            "serving/prefill_packed_tokens": self.prefill_packed_tokens,
            "serving/arena_bytes": self.arena_bytes,
            # storage bits per K/V value (16: the compute dtype), beside
            # arena_bytes to tell a quantized arena from a shrunk one
            "serving/kv_cache_bits": kv_cache_bits(self.kv_cache_dtype),
        }
        # preemption needs a scheduler, so its count rides the scheduler's test
        if self._sched is not None or self.requests_shed or self.requests_cancelled:
            out["serving/shed"] = self.requests_shed
            out["serving/cancelled"] = self.requests_cancelled
            out["serving/preemptions"] = self.preemptions
            out["serving/resumptions"] = self.resumptions
        if self._sched is not None:
            out.update(self._sched.metrics())
        if self._controller is not None:
            out["serving/itl_budget"] = round(self._controller.budget, 4)
            out["serving/itl_slo_breaches"] = self._controller.breaches
            out["serving/itl_budget_adjustments"] = self._controller.adjustments
        if self._draining:
            out["serving/draining"] = True
        if self.spec_k:
            out["serving/spec_proposed"] = self.spec_proposed
            out["serving/spec_accepted"] = self.spec_accepted
            out["serving/spec_accept_rate"] = (
                self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0
            )
        if self.page_size:
            out["serving/pages_in_use"] = self._allocator.in_use
            out["serving/pages_total"] = self.num_pages
            out["serving/page_size"] = self.page_size
            out["serving/page_forks"] = self.page_forks
        samples = list(self._step_samples)
        if samples:
            wall = sum(w for w, _, _ in samples)
            toks = sum(n for _, n, _ in samples)
            if wall > 0:
                out["serving/tokens_per_s"] = toks / wall
            # per step: a burst's wall over its K steps
            out["serving/decode_step_ms_p50"] = 1e3 * float(
                np.median([w / k for w, _, k in samples]))
        # the denominator of the shed-rate burn alert and the arrival trend
        # the autoscaler reads: every request that reached an outcome
        out["serving/requests_terminal"] = (
            self.requests_completed + self.requests_shed + self.requests_cancelled)
        ttft = list(self._ttft)
        if ttft:
            out["serving/ttft_ms_p50"] = 1e3 * float(np.median(ttft))
        itl = np.asarray(list(self._itl))
        if itl.size:
            out["serving/itl_p50_ms"] = 1e3 * float(np.percentile(itl, 50))
            out["serving/itl_p95_ms"] = 1e3 * float(np.percentile(itl, 95))
            # p99 of the most recent 128 gaps: the live gauge, which decays
            # once a regression clears (the reference's window)
            out["serving/itl_recent_p99_ms"] = round(
                1e3 * float(np.percentile(itl[-128:], 99)), 3)
        if self.kv_pages_exported or self.kv_pages_imported:
            out["serving/kv_pages_exported"] = self.kv_pages_exported
            out["serving/kv_pages_imported"] = self.kv_pages_imported
        if self._prefix is not None:
            out["serving/prefix_hit_ratio"] = self._prefix.hit_ratio
            out["serving/prefix_hit_tokens"] = self._prefix.hit_tokens
            out["serving/prefix_entries"] = len(self._prefix.entries)
            out["serving/prefill_chunks_skipped"] = self.prefill_chunks_skipped
            if self._prefix.ghost is not None:
                # the hit ratio the cache would have at 2x / 4x / 10x its
                # capacity, and reuse-after-evict distances
                out.update(self._prefix.ghost.gauges())
        if self._tiers is not None:
            out.update(self._tiers.gauges())
            lookups = self._prefix.lookups if self._prefix is not None else 0
            for tier, hits in self.kv_tier_hits.items():
                out[f"serving/kv_tier_hits_{tier}"] = hits
                out[f"serving/kv_tier_hit_ratio_{tier}"] = hits / lookups if lookups else 0.0
            out["serving/kv_restores"] = self.kv_restores
            out["serving/kv_restores_aborted"] = self.kv_restores_aborted
            out["serving/kv_restore_batches"] = self.kv_restore_batches
            out["serving/kv_restore_overlap_frac"] = (
                self.kv_restore_batches_overlapped / self.kv_restore_batches
                if self.kv_restore_batches else 0.0)
        # the placement signal a router ranks replicas by, with the raw
        # components it folds (telemetry/fleet.py)
        out["serving/num_slots"] = self.num_slots
        out["serving/free_slots"] = self.num_slots - len(self._slot_req)
        if self.page_size:
            out["serving/free_pages"] = self._allocator.free_count
        out["serving/load_score"] = load_score(
            queue_depth=out["serving/queue_depth"],
            num_slots=self.num_slots,
            slot_occupancy=out["serving/slot_occupancy"],
            free_pages=out.get("serving/free_pages"),
            pages_total=self.num_pages if self.page_size else None,
            itl_recent_p99_ms=out.get("serving/itl_recent_p99_ms"),
            itl_slo_ms=self._sched.config.itl_slo_ms if self._sched is not None else None,
            draining=self._draining,
        )
        # sustainable rate and headroom (telemetry/capacity.py), the
        # autoscaler's inputs. The roofline registry that would feed the
        # model's exe/decode_step_* fallback is ROADMAP queue 1 item 11, so
        # the measured step wall is the model's only roofline input.
        with self._capacity_lock:
            out.update(self._capacity_model.observe(out))
        return out


def generate_batched(model, params, prompts, *, max_new_tokens: int = 32,
                     num_slots: Optional[int] = None, seeds=None, **engine_kwargs):
    """One-shot batched generation (the reference's module-level
    ``generate_batched``): build a :class:`ServingEngine` of
    ``min(max(len(prompts), 1), 8)`` slots unless ``num_slots`` says
    otherwise (``engine_kwargs`` pass through, ``steps_per_call`` and
    ``device`` among them), submit every prompt, run to completion.
    Returns the list of [prompt + generated] id arrays. Request i draws
    from ``seeds[i]`` (default i): the tokens of ``generate()`` with
    ``torch.Generator().manual_seed(seeds[i])``. ``params`` (a weight dict,
    or None for the model's own) is loaded into ``model`` first. For a
    long-lived server keep an engine instead: this builds one (and, on
    CUDA, captures its graphs) per call."""
    engine = ServingEngine(
        model, params,
        num_slots=num_slots or min(max(len(prompts), 1), 8),
        **engine_kwargs,
    )
    return engine.generate_batched(prompts, max_new_tokens=max_new_tokens, seeds=seeds)
