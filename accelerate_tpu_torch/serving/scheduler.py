"""SLO-aware multi-tenant scheduling policy for the serving engine.

This package's own copy of the reference's
``accelerate_tpu/serving/scheduler.py`` (the port imports nothing from
the JAX package, not even its jax-free modules). A FIFO queue with a
fixed prefill/decode interleave lets one tenant's long-prompt storm
freeze every other tenant's inter-token latency, and a burst past the
slot/page capacity can only be shed. This module is the **policy
layer** the engine consults between dispatches, pure host-side
bookkeeping:

- :class:`MultiTenantScheduler`: per-tenant **weighted-fair queues**
  (virtual-time WFQ: a tenant's virtual clock advances by
  ``cost / weight`` per scheduled request, and the scheduler picks the
  furthest-behind tenant), strict **priority classes** above the fair
  share (a higher class always schedules first; within a class,
  earliest ``deadline_s`` first), **token quotas** (a refilling token
  bucket per tenant; over-quota tenants schedule only when no in-quota
  tenant has work, so quotas bound *contended* share, not idle
  throughput), and **admission control**: bounded per-tenant and global
  queues whose overflow is a ``shed`` decision, not an exception, plus
  lowest-priority-first load shedding when page pressure crosses a
  watermark.
- :class:`PrefillBudgetController`: the observe-act loop for the ITL
  SLO. Prefill steals decode-step time from every live request, so the
  controller adapts **how many prefill dispatches the engine may
  interleave per decode step** (multiplicative decrease when the
  observed ITL p99 breaches the SLO, additive increase while it holds).
- victim selection for **preemption** (:meth:`MultiTenantScheduler.pick_victim`):
  when a higher-priority request waits and no slot is free, the engine
  pages out the lowest-priority, least-progressed victim (releasing its
  KV pages) and re-admits it later through the prefix cache.

Everything here is plain python and imports neither torch nor jax: a
router tier can run the same admission and shed math on a machine with
no accelerator stack.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

# terminal shed reasons (the `shed_reason` field on a shed Request and
# its JSONL record — bounded vocabulary so dashboards can group on it)
SHED_QUEUE_FULL = "queue_full"          # global queue watermark at submit
SHED_TENANT_QUEUE_FULL = "tenant_queue_full"
SHED_PAGE_PRESSURE = "page_pressure"    # watermark shed while queued
SHED_PAGE_EXHAUSTED = "page_exhausted"  # allocation failed mid-flight
SHED_DRAINING = "draining"              # engine refused/flushed on drain


@dataclass
class TenantConfig:
    """Static per-tenant policy. ``weight`` is the WFQ share; ``quota``
    is a token budget per ``quota_window_s`` (None = unmetered);
    ``max_queued`` bounds this tenant's queue (None = global bound
    only)."""

    weight: float = 1.0
    quota: Optional[float] = None
    max_queued: Optional[int] = None


@dataclass
class SchedulerConfig:
    """Knobs for :class:`MultiTenantScheduler`."""

    tenants: dict = field(default_factory=dict)  # name -> TenantConfig
    default_weight: float = 1.0
    max_queue_depth: int = 256           # global bound; submit past it sheds
    max_tenant_queue_depth: Optional[int] = 64  # default per-tenant bound
    quota_window_s: float = 1.0          # token buckets refill over this window
    # load shedding: when the paged arena's free fraction drops below the
    # watermark, the scheduler sheds the newest lowest-priority queued
    # request each step (queued work that cannot be admitted anyway)
    page_low_watermark: float = 0.05
    preemption: bool = True              # allow paging out lower-priority slots
    # bound on distinct tenant states (and the per-tenant gauge family):
    # rotating tenant ids reap the longest-idle unconfigured tenant
    # instead of growing the map forever (None = unbounded)
    max_tenants: Optional[int] = 4096
    # the ITL feedback loop (None = fixed 1-chunk-per-step interleave)
    itl_slo_ms: Optional[float] = None
    prefill_budget: float = 1.0          # starting chunks-per-decode-step
    prefill_budget_min: float = 0.25     # never starve admissions entirely
    prefill_budget_max: float = 4.0


class PrefillBudgetController:
    """Adapt the chunked-prefill budget to hold the ITL-p99 SLO.

    The budget is **prefill chunks per decode step** (fractional: 0.25
    means one chunk every 4th step). AIMD keeps it stable: a p99 breach
    multiplies the budget down (fast back-off protects the SLO), a
    comfortable margin adds a small step back up (slow recovery protects
    TTFT). ``observe()`` is fed the live recent-window p99 by the engine
    once per scheduler iteration; adjustments apply at most every
    ``observe_every`` observations so one noisy window cannot whipsaw
    the interleave.
    """

    def __init__(self, slo_ms: float, *, budget: float = 1.0,
                 min_budget: float = 0.25, max_budget: float = 4.0,
                 decrease: float = 0.7, increase: float = 0.1,
                 headroom: float = 0.8, observe_every: int = 8,
                 min_samples: int = 8):
        if slo_ms <= 0:
            raise ValueError(f"itl SLO must be positive, got {slo_ms}")
        if not (0 < min_budget <= budget <= max_budget):
            raise ValueError(
                f"need 0 < min <= budget <= max, got "
                f"{min_budget}/{budget}/{max_budget}"
            )
        if not (0 < decrease < 1):
            raise ValueError(f"decrease must be in (0, 1), got {decrease}")
        self.slo_ms = float(slo_ms)
        self.budget = float(budget)
        self.min_budget = float(min_budget)
        self.max_budget = float(max_budget)
        self.decrease = float(decrease)
        self.increase = float(increase)
        self.headroom = float(headroom)
        self.observe_every = max(1, int(observe_every))
        self.min_samples = max(1, int(min_samples))
        self.breaches = 0      # observations over the SLO (acted or not)
        self.adjustments = 0   # times the budget actually moved
        self._since_adjust = 0

    def observe(self, itl_p99_ms: Optional[float], samples: int = 0) -> float:
        """One control-loop tick: fold the live window's p99 in, return
        the (possibly adjusted) budget."""
        if itl_p99_ms is None or samples < self.min_samples:
            return self.budget
        over = itl_p99_ms > self.slo_ms
        if over:
            self.breaches += 1
        self._since_adjust += 1
        if self._since_adjust < self.observe_every:
            return self.budget
        self._since_adjust = 0
        if over:
            new = max(self.min_budget, self.budget * self.decrease)
        elif itl_p99_ms < self.headroom * self.slo_ms:
            new = min(self.max_budget, self.budget + self.increase)
        else:
            return self.budget  # inside the hysteresis band: hold
        if new != self.budget:
            self.budget = new
            self.adjustments += 1
        return self.budget


@dataclass
class _TenantState:
    name: str
    weight: float
    quota: Optional[float]
    max_queued: Optional[int]
    queue: list = field(default_factory=list)  # sorted on demand (small)
    vtime: float = 0.0        # WFQ virtual clock (advances by cost/weight)
    bucket: float = 0.0       # available quota tokens (can go into debt)
    last_refill: float = 0.0
    last_active: float = 0.0  # last admit/charge (idle-tenant reaping)
    tokens_used: float = 0.0  # lifetime emitted tokens (the quota gauge)

    def sort_key(self, seq_of):
        """Head-of-queue order: priority class desc, deadline asc (None
        last), then arrival order — requeued (preempted) requests carry a
        negative seq so they resume before fresh arrivals of their
        class. EDF compares ABSOLUTE deadlines (submit time + the
        relative ``deadline_s`` hint): a request submitted earlier with a
        longer hint can still expire before a late arrival with a short
        one."""
        def key(req):
            dl = getattr(req, "deadline_s", None)
            if dl is not None:
                dl += getattr(req, "submit_t", 0.0) or 0.0
            return (-int(getattr(req, "priority", 0) or 0),
                    dl if dl is not None else float("inf"),
                    seq_of(req))
        return key


class MultiTenantScheduler:
    """Weighted-fair, quota-metered, priority-classed request queue with
    admission control — the host policy tier ``ServingEngine`` consults.

    The engine owns the device work; this class only ever answers four
    questions: *may this request enter the queue* (:meth:`admit`),
    *which request goes to the freed slot next* (:meth:`next_request`),
    *which queued request should be shed under pressure*
    (:meth:`pick_shed`), and *which live slot should be paged out for a
    higher class* (:meth:`pick_victim`). All state is plain python, so
    the same object is importable on a router tier with no accelerator stack.

    Thread-safe: ``ServingEngine.serve()`` admits from other threads'
    ``submit()`` calls, so every method that touches the per-tenant
    queues holds an internal lock — an ``admit`` appending mid
    ``next_request`` sort would otherwise crash the serving loop.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None, *,
                 now_fn: Callable[[], float] = time.monotonic):
        self.config = config or SchedulerConfig()
        self._now = now_fn
        self.tenants: dict = {}
        self._lock = threading.RLock()
        self._seq = itertools.count()
        self._req_seq: dict = {}      # id(req) is unstable; key by req.id
        self._requeue_seq = 0         # decreasing: resumed before fresh
        self._billed: set = set()     # requeued req ids: WFQ cost already paid
        self._vclock = 0.0            # system virtual time (last pop's vtime)
        self.admitted = 0
        self.rejected = 0
        self.shed_queued = 0

    # -- tenants -----------------------------------------------------------

    def tenant(self, name: str) -> _TenantState:
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                cfg = self.config.tenants.get(name)
                if cfg is None:
                    # unconfigured tenants get the global per-tenant bound;
                    # an EXPLICIT TenantConfig keeps its max_queued as
                    # written — None there means "global bound only" (the
                    # one way to exempt a tenant from the default)
                    cfg = TenantConfig(
                        weight=self.config.default_weight,
                        max_queued=self.config.max_tenant_queue_depth,
                    )
                self._reap_idle_tenants()
                now = self._now()
                t = self.tenants[name] = _TenantState(
                    name=name, weight=max(1e-6, float(cfg.weight)),
                    quota=cfg.quota, max_queued=cfg.max_queued,
                    last_refill=now, last_active=now,
                )
                if t.quota:
                    t.bucket = float(t.quota)  # start with a full window
            return t

    def _reap_idle_tenants(self):
        """Bound the tenant-state map: rotating tenant ids (one per user,
        say) must not grow the dict — and the per-tenant gauge family —
        without bound. Oldest-refilled idle tenants (empty queue,
        unconfigured) are dropped when a new name would exceed
        ``max_tenants``; their WFQ clock and bucket are simply rebuilt on
        the next admit, which the idle-start vtime fix makes safe."""
        limit = self.config.max_tenants
        if limit is None or len(self.tenants) < limit:
            return
        idle = sorted(
            (t for t in self.tenants.values()
             if not t.queue and t.name not in self.config.tenants),
            key=lambda t: t.last_active,
        )
        for t in idle[: max(1, len(self.tenants) - limit + 1)]:
            del self.tenants[t.name]

    def _refill(self, t: _TenantState):
        if not t.quota:
            return
        now = self._now()
        dt = max(0.0, now - t.last_refill)
        t.last_refill = now
        rate = t.quota / max(1e-9, self.config.quota_window_s)
        t.bucket = min(float(t.quota), t.bucket + rate * dt)

    # -- admission control -------------------------------------------------

    @property
    def total_queued(self) -> int:
        with self._lock:
            return sum(len(t.queue) for t in self.tenants.values())

    def admit(self, req) -> tuple:
        """Queue-depth backpressure at submit: ``(True, None)`` and the
        request is queued, or ``(False, shed_reason)`` — the caller
        records a shed, never an exception."""
        with self._lock:
            if self.total_queued >= self.config.max_queue_depth:
                self.rejected += 1
                return False, SHED_QUEUE_FULL
            t = self.tenant(getattr(req, "tenant", "default") or "default")
            if t.max_queued is not None and len(t.queue) >= t.max_queued:
                self.rejected += 1
                return False, SHED_TENANT_QUEUE_FULL
            # WFQ start-time fix: a tenant waking from idle must not replay
            # the virtual time it sat out, or it would monopolize the slots.
            # With no backlogged tenant to floor against (queues drain
            # instantly in steady state), the system virtual clock — the
            # vtime of the last scheduled tenant — is the reference
            if not t.queue:
                active = [s.vtime for s in self.tenants.values() if s.queue]
                t.vtime = max(t.vtime, min(active) if active else self._vclock)
            self._req_seq[req.id] = next(self._seq)
            t.queue.append(req)
            t.last_active = self._now()
            self.admitted += 1
            return True, None

    def requeue(self, req):
        """A preempted request re-enters at the *front* of its class
        (negative seq): it already paid its queue wait once."""
        with self._lock:
            t = self.tenant(getattr(req, "tenant", "default") or "default")
            self._requeue_seq -= 1
            self._req_seq[req.id] = self._requeue_seq
            self._billed.add(req.id)  # its WFQ cost was paid on the first pop
            t.queue.append(req)

    def remove(self, req) -> bool:
        """Drop one queued request (cancel/timeout/shed); False if it is
        not queued here."""
        with self._lock:
            t = self.tenants.get(getattr(req, "tenant", "default") or "default")
            if t is None:
                return False
            try:
                t.queue.remove(req)
            except ValueError:
                return False
            self._req_seq.pop(req.id, None)
            self._billed.discard(req.id)
            return True

    def queued(self) -> list:
        """Snapshot of every queued request (reap/timeout scans)."""
        with self._lock:
            return [r for t in self.tenants.values() for r in t.queue]

    # -- the scheduling decision ---------------------------------------------

    def _seq_of(self, req) -> int:
        return self._req_seq.get(req.id, 0)

    def _head(self, t: _TenantState):
        t.queue.sort(key=t.sort_key(self._seq_of))
        return t.queue[0]

    def _pool(self) -> list:
        """The tenants the next pop may schedule from: everyone with
        work, quota-filtered unless every queued tenant is over quota
        (work-conserving fallback). Refills buckets as a side effect."""
        candidates = [t for t in self.tenants.values() if t.queue]
        if not candidates:
            return []
        for t in candidates:
            self._refill(t)
        pool = [t for t in candidates if not t.quota or t.bucket > 0]
        return pool or candidates  # work-conserving: idle capacity is never wasted

    def peek_priority(self) -> Optional[int]:
        """Highest priority class the next pop could actually schedule
        (None when idle) — what the engine compares against live slots
        to decide preemption. Uses the same quota-filtered pool as
        :meth:`next_request`: an over-quota tenant's waiting class must
        not trigger a preemption that the pop then refuses to fill
        (equal-priority preempt/re-admit churn)."""
        with self._lock:
            pool = self._pool()
            if not pool:
                return None
            return max(
                int(getattr(self._head(t), "priority", 0) or 0) for t in pool
            )

    def next_request(self):
        """Pop the request the freed slot should run: strict priority
        class first; within the class, the in-quota tenant with the
        smallest virtual time (WFQ); over-quota tenants only when no
        in-quota tenant has work (work-conserving). Returns None when
        idle."""
        with self._lock:
            pool = self._pool()
            if not pool:
                return None
            best_prio = max(
                int(getattr(self._head(t), "priority", 0) or 0) for t in pool
            )
            pool = [
                t for t in pool
                if int(getattr(self._head(t), "priority", 0) or 0) == best_prio
            ]
            t = min(pool, key=lambda s: (s.vtime, s.name))
            # the popped tenant has the minimum vtime among backlogged
            # tenants = the system virtual time (floors idle wake-ups)
            self._vclock = max(self._vclock, t.vtime)
            req = t.queue.pop(0)
            self._req_seq.pop(req.id, None)
            # bill the WFQ cost exactly once per request: a preempted request
            # re-popped after requeue() (or a cancelled one popped and
            # discarded) must not advance its tenant's clock again — the
            # tenant a high-priority class preempts would otherwise also lose
            # its fair share, double-punished for interference it didn't cause
            if req.id in self._billed:
                self._billed.discard(req.id)
            elif not getattr(req, "done", False):
                cost = float(req.prompt.size + req.max_new_tokens)
                t.vtime += cost / t.weight
            return req

    # -- quotas --------------------------------------------------------------

    def note_tokens(self, tenant: str, n: int):
        """Charge ``n`` emitted tokens to the tenant's bucket (the engine
        calls this per token — generation, not submission, is what a
        quota meters)."""
        with self._lock:
            t = self.tenant(tenant or "default")
            t.tokens_used += n
            t.last_active = self._now()
            if t.quota:
                self._refill(t)
                # debt is floored at one window's quota: tokens generated
                # via the work-conserving fallback while everyone else was
                # idle must not starve the tenant for unbounded time once
                # contention returns — quotas bound *contended* share
                t.bucket = max(-float(t.quota), t.bucket - n)

    # -- pressure decisions --------------------------------------------------

    def pick_shed(self, max_priority: Optional[int] = None):
        """The queued request load shedding drops next: lowest priority
        class first, newest arrival within it (it has waited least, so
        dropping it wastes the least). ``max_priority`` restricts to
        classes strictly below it. Returns None when nothing qualifies.
        The caller still owns the terminal bookkeeping (this only picks)."""
        with self._lock:
            best = None
            best_key = None
            for t in self.tenants.values():
                for req in t.queue:
                    p = int(getattr(req, "priority", 0) or 0)
                    if max_priority is not None and p >= max_priority:
                        continue
                    key = (p, -self._seq_of(req))
                    if best_key is None or key < best_key:
                        best, best_key = req, key
            return best

    def shed(self, req) -> bool:
        """Remove a picked request and count the shed."""
        with self._lock:
            if self.remove(req):
                self.shed_queued += 1
                return True
            return False

    def pick_victim(self, live: Iterable, min_priority: int):
        """The live (slot, request) pair preemption should page out for
        an incoming request of ``min_priority``: the lowest class
        *strictly below* it (equal classes never preempt each other —
        that would thrash), least generated tokens within the class (the
        cheapest replay). Returns ``(slot, req)`` or None."""
        if not self.config.preemption:
            return None
        best = None
        best_key = None
        for slot, req in live:
            p = int(getattr(req, "priority", 0) or 0)
            if p >= min_priority:
                continue
            key = (p, len(req.tokens), -slot)
            if best_key is None or key < best_key:
                best, best_key = (slot, req), key
        return best

    # -- gauges --------------------------------------------------------------

    def metrics(self) -> dict:
        """Flat ``serving/``-namespaced gauges: global queue state plus
        one ``quota_<tenant>_*`` family per tenant (the tenant set — and
        therefore the gauge cardinality — is bounded by ``max_tenants``
        idle-reaping)."""
        with self._lock:
            out = {
                "serving/sched_queued": self.total_queued,
                "serving/sched_admitted": self.admitted,
                "serving/sched_rejected": self.rejected,
            }
            for t in self.tenants.values():
                out[f"serving/quota_{t.name}_tokens_used"] = t.tokens_used
                out[f"serving/tenant_{t.name}_queued"] = len(t.queue)
                if t.quota:
                    self._refill(t)
                    out[f"serving/quota_{t.name}_remaining_frac"] = round(
                        max(0.0, t.bucket) / t.quota, 4
                    )
            return out
