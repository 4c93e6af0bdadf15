"""Per-tenant usage accounting for the serving plane.

An own copy of the reference's ``accelerate_tpu/telemetry/usage.py``:
the same fields, windows, rates and snapshot format.

The multi-tenant scheduler decides *who runs next*; this module
answers the billing-side question — *who consumed what*. Fed by
``ServingEngine`` hooks (one ``is None`` check per event when telemetry
is off, the established hot-path contract), it meters per tenant:

- **prefill_tokens / decode_tokens** — tokens actually prefilled
  (padding excluded; preemption replays count, they are real work) and
  tokens emitted (``decode_tokens`` sums exactly to the engine's
  ``generated_tokens`` counter — the conservation law the tests assert);
- **prefix_hit_tokens** — prompt tokens served from the prefix cache
  (work the tenant *didn't* pay for — the cache's dividend, attributed);
- **page_seconds** — device-memory page occupancy integrated over time: every
  page-table change (admission mapping, growth, CoW fork, release on
  finish/evict/preempt) adjusts the tenant's held count, and elapsed
  time × held pages accrues continuously — the "who is consuming the
  device-memory budget" number;
- **compute_ms** — measured dispatch wall attributed per tenant: a
  prefill chunk bills its admitting tenant, a batched decode/verify step
  splits its wall evenly across the live slots' tenants (the same
  dispatches the CostRegistry's roofline rows record);
- **outcome counts** — submitted / finished / shed / cancelled /
  preempted.

Both **cumulative** and **windowed**: the sampler's periodic ``mark()``
keeps a bounded ring of snapshots so ``window(seconds)`` returns
per-tenant deltas (tokens/s, page-seconds burn) without unbounded state.
Tenant cardinality is bounded: past ``max_tenants`` distinct names, new
tenants fold into ``"_other"`` (totals stay conserved, the gauge family
stays finite — the same stance the scheduler takes).

Exports ride the session rollup as ``usage/<tenant>/...`` gauges (and
through it the Prometheus exposition and the timeline), persist to
``usage-host<i>.json`` for the reference's ``report`` tenant table.
Plain stdlib.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

OVERFLOW_TENANT = "_other"

# the per-tenant fields exported to rollups/snapshots, in table order
FIELDS = (
    "submitted", "finished", "shed", "cancelled", "preempted",
    "prefill_tokens", "decode_tokens", "prefix_hit_tokens",
    "page_seconds", "host_byte_seconds", "disk_byte_seconds",
    "compute_ms",
)


@dataclass
class TenantUsage:
    name: str
    submitted: int = 0
    finished: int = 0
    shed: int = 0
    cancelled: int = 0
    preempted: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefix_hit_tokens: int = 0
    page_seconds: float = 0.0
    # KV-tier occupancy integrated over time: bytes a demoted prefix
    # holds in host RAM / on disk, the billing-side twin of page_seconds.
    # The port has no KV tiers yet, so these stay 0; the fields keep the
    # reference's snapshot format
    host_byte_seconds: float = 0.0
    disk_byte_seconds: float = 0.0
    compute_ms: float = 0.0
    # live occupancy integration state
    pages_held: int = 0
    host_bytes_held: int = 0
    disk_bytes_held: int = 0
    _last_t: float = field(default=0.0, repr=False)

    def as_dict(self) -> dict:
        out = {f: getattr(self, f) for f in FIELDS}
        out["page_seconds"] = round(out["page_seconds"], 4)
        out["host_byte_seconds"] = round(out["host_byte_seconds"], 4)
        out["disk_byte_seconds"] = round(out["disk_byte_seconds"], 4)
        out["compute_ms"] = round(out["compute_ms"], 3)
        out["pages_held"] = self.pages_held
        out["host_bytes_held"] = self.host_bytes_held
        out["disk_bytes_held"] = self.disk_bytes_held
        return out


class UsageAccountant:
    """Cumulative + windowed per-tenant meters, fed by engine hooks."""

    def __init__(self, clock=time.monotonic, max_tenants: int = 256,
                 window_marks: int = 1024):
        self._clock = clock
        self._lock = threading.Lock()
        self.tenants: dict = {}
        self.max_tenants = int(max_tenants)
        self.overflowed = False
        # (t, {tenant: (prefill, decode, page_s, compute_ms)}) ring the
        # sampler feeds; window() diffs against it
        self._marks: deque = deque(maxlen=max(2, int(window_marks)))

    # -- producers (engine hooks) ------------------------------------------

    def _tenant(self, name: str) -> TenantUsage:
        name = str(name or "default")
        t = self.tenants.get(name)
        if t is None:
            if len(self.tenants) >= self.max_tenants:
                # fold the long tail into one bucket: totals stay exact,
                # the gauge family stays bounded
                self.overflowed = True
                name = OVERFLOW_TENANT
                t = self.tenants.get(name)
                if t is not None:
                    return t
            t = self.tenants[name] = TenantUsage(
                name=name, _last_t=self._clock()
            )
        return t

    def _integrate(self, t: TenantUsage, now: float):
        if now > t._last_t:
            dt = now - t._last_t
            if t.pages_held > 0:
                t.page_seconds += t.pages_held * dt
            if t.host_bytes_held > 0:
                t.host_byte_seconds += t.host_bytes_held * dt
            if t.disk_bytes_held > 0:
                t.disk_byte_seconds += t.disk_bytes_held * dt
        t._last_t = now

    def note_submit(self, tenant: str):
        with self._lock:
            self._tenant(tenant).submitted += 1

    def note_outcome(self, tenant: str, outcome: str):
        with self._lock:
            t = self._tenant(tenant)
            if outcome == "finished":
                t.finished += 1
            elif outcome == "shed":
                t.shed += 1
            elif outcome == "cancelled":
                t.cancelled += 1

    def note_preempt(self, tenant: str):
        with self._lock:
            self._tenant(tenant).preempted += 1

    def note_prefill(self, tenant: str, tokens: int):
        with self._lock:
            self._tenant(tenant).prefill_tokens += int(tokens)

    def note_decode(self, tenant: str, tokens: int = 1):
        with self._lock:
            self._tenant(tenant).decode_tokens += int(tokens)

    def note_prefix_hit(self, tenant: str, tokens: int):
        with self._lock:
            self._tenant(tenant).prefix_hit_tokens += int(tokens)

    def note_compute(self, tenant: str, ms: float):
        with self._lock:
            self._tenant(tenant).compute_ms += float(ms)

    def note_pages(self, tenant: str, delta: int, now: Optional[float] = None):
        """A tenant's held-page count changed by ``delta`` (admission
        map / growth / release). Integrates the occupancy held so far
        first, so ``page_seconds`` is exact at every transition."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            t = self._tenant(tenant)
            self._integrate(t, now)
            t.pages_held += int(delta)
            if t.pages_held < 0:
                # release without a matched retain (flat arena, double
                # release): clamp — page_seconds must stay non-negative
                t.pages_held = 0

    def note_tier_bytes(self, tenant: str, tier: str, delta: int,
                        now: Optional[float] = None):
        """A tenant's demoted-KV footprint in ``tier`` ("host" or
        "disk") changed by ``delta`` bytes. Same symmetric contract as
        :meth:`note_pages`: occupancy accrued so far is integrated
        first, held counts clamp at 0 on unmatched release."""
        if tier not in ("host", "disk"):
            return
        now = self._clock() if now is None else float(now)
        attr = f"{tier}_bytes_held"
        with self._lock:
            t = self._tenant(tenant)
            self._integrate(t, now)
            held = getattr(t, attr) + int(delta)
            setattr(t, attr, held if held > 0 else 0)

    def advance(self, now: Optional[float] = None):
        """Bring every tenant's page-seconds current (rollup/sample time)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            for t in self.tenants.values():
                self._integrate(t, now)

    # -- consumers ---------------------------------------------------------

    def totals(self) -> dict:
        """Cross-tenant sums (the conservation side: ``decode_tokens``
        here equals the engine's ``generated_tokens``)."""
        self.advance()
        with self._lock:
            out = {f: 0 for f in FIELDS}
            for t in self.tenants.values():
                for f in FIELDS:
                    out[f] += getattr(t, f)
            return out

    def mark(self, now: Optional[float] = None):
        """Record one windowing snapshot (the timeline sampler calls
        this each tick); ``window()`` diffs against the ring."""
        now = self._clock() if now is None else float(now)
        self.advance(now)
        with self._lock:
            snap = {
                name: (t.prefill_tokens, t.decode_tokens,
                       t.page_seconds, t.compute_ms)
                for name, t in self.tenants.items()
            }
            self._marks.append((now, snap))

    def window(self, seconds: float, now: Optional[float] = None) -> dict:
        """Per-tenant deltas over the trailing window: ``{tenant:
        {prefill_tokens, decode_tokens, page_seconds, compute_ms,
        span_s}}`` — zeros when no mark is old enough yet."""
        now = self._clock() if now is None else float(now)
        self.advance(now)
        with self._lock:
            base_t, base = None, {}
            for t, snap in self._marks:
                if t <= now - seconds:
                    base_t, base = t, snap
                else:
                    break
            if base_t is None and self._marks:
                base_t, base = self._marks[0]
            if base_t is None:
                # never marked (timeline off): deltas are zero, not the
                # lifetime totals masquerading as a window
                base_t = now
                base = {
                    name: (t.prefill_tokens, t.decode_tokens,
                           t.page_seconds, t.compute_ms)
                    for name, t in self.tenants.items()
                }
            out = {}
            for name, t in self.tenants.items():
                b = base.get(name, (0, 0, 0.0, 0.0))
                out[name] = {
                    "prefill_tokens": t.prefill_tokens - b[0],
                    "decode_tokens": t.decode_tokens - b[1],
                    "page_seconds": round(t.page_seconds - b[2], 4),
                    "compute_ms": round(t.compute_ms - b[3], 3),
                    "span_s": round(now - base_t, 3),
                }
            return out

    def rates(self, seconds: float, now: Optional[float] = None,
              eps_span_s: float = 1e-6) -> dict:
        """Per-tenant windowed rates derived from :meth:`window`:
        ``{tenant: {prefill_tokens_per_s, decode_tokens_per_s,
        pages_mean, span_s}}``. The first window after start (or a
        same-instant query) has ``span_s`` 0 — rates report **0** there
        instead of raising or returning inf (the zero-span guard the
        SLO scorecard shares)."""
        out = {}
        for name, w in self.window(seconds, now).items():
            span = w["span_s"]
            guard = span > eps_span_s
            out[name] = {
                "prefill_tokens_per_s": (
                    w["prefill_tokens"] / span if guard else 0.0
                ),
                "decode_tokens_per_s": (
                    w["decode_tokens"] / span if guard else 0.0
                ),
                # page_seconds/span = mean pages held over the window
                "pages_mean": w["page_seconds"] / span if guard else 0.0,
                "span_s": span,
            }
        return out

    def rollup_keys(self) -> dict:
        """Flat ``usage/<tenant>/<field>`` gauges for the session rollup
        (cardinality bounded by ``max_tenants`` folding)."""
        self.advance()
        with self._lock:
            out = {}
            for name, t in self.tenants.items():
                for f in FIELDS:
                    v = getattr(t, f)
                    out[f"usage/{name}/{f}"] = (
                        round(v, 3) if isinstance(v, float) else v
                    )
                out[f"usage/{name}/pages_held"] = t.pages_held
                if t.host_bytes_held or t.host_byte_seconds:
                    out[f"usage/{name}/host_bytes_held"] = t.host_bytes_held
                if t.disk_bytes_held or t.disk_byte_seconds:
                    out[f"usage/{name}/disk_bytes_held"] = t.disk_bytes_held
            if out:
                out["usage/tenants"] = len(self.tenants)
            return out

    def snapshot(self) -> dict:
        self.advance()
        with self._lock:
            return {
                "tenants": {name: t.as_dict() for name, t in self.tenants.items()},
                "totals": {
                    f: sum(getattr(t, f) for t in self.tenants.values())
                    for f in FIELDS
                },
                "overflowed": self.overflowed,
            }

    def write_snapshot(self, path: str):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh, indent=1)
        os.replace(tmp, path)


def load_usage(target: str) -> dict:
    """Merge ``usage-host*.json`` snapshots under a telemetry dir into
    one tenant table (fields summed across hosts) — what ``report`` and
    ``watch`` render offline."""
    import glob

    if os.path.isdir(target):
        paths = sorted(glob.glob(os.path.join(target, "usage-host*.json")))
    elif os.path.exists(target):
        paths = [target]
    else:
        paths = []
    tenants: dict = {}
    hosts = 0
    for path in paths:
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        hosts += 1
        for name, row in (data.get("tenants") or {}).items():
            cur = tenants.setdefault(name, {f: 0 for f in FIELDS})
            for f in FIELDS:
                cur[f] += row.get(f) or 0
    totals = {f: sum(row[f] for row in tenants.values()) for f in FIELDS}
    return {"tenants": tenants, "totals": totals, "hosts": hosts}
