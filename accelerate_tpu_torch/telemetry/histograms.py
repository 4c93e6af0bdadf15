"""Log-bucketed streaming histograms for SLO latency tracking.

An own copy of the reference's ``accelerate_tpu/telemetry/histograms.py``
(same bucket layout, quantile walk, exemplar reservoir and rollup keys),
so a port histogram merges with a reference one and renders the same
exposition.

A serving stack's latency SLOs live in the tail — p99 TTFT and p99
inter-token latency — and a tail is exactly what a rolling deque of raw
samples loses the moment it evicts. These histograms keep **geometric
buckets** instead: bucket ``i`` covers ``(lo * growth**(i-1), lo *
growth**i]``, so any latency from microseconds to minutes lands in one of
a few dozen integer counters with bounded (~``growth - 1``) relative
error. Memory is O(buckets touched), adding a sample is one dict
increment, and the quantile walk is O(buckets) — cheap enough to stay on
for every request the engine ever serves, with no window to size and no
eviction to bias the percentiles.

The bucket layout doubles as the Prometheus histogram exposition
(``exporter.py`` renders ``_bucket{le=...}`` lines straight from
``cumulative_buckets()``), so the scrape endpoint and the in-process
``snapshot()`` can never disagree about what was observed.
"""

from __future__ import annotations

import math
import time
from typing import Optional

# per-bucket exemplar reservoir: the latest observation plus the largest
# one — two slots is enough to answer both "what just landed here" and
# "what was the worst", and bounds memory at 2 * buckets-touched
EXEMPLARS_PER_BUCKET = 2


def _reservoir_put(cur: Optional[list], entry: dict) -> list:
    """Fold one exemplar into a bucket reservoir: keep the max-valued
    entry and the newest entry (``entry`` is by definition the newest —
    newest-wins, the same policy the fleet merge applies)."""
    if not cur:
        return [entry]
    best = max(cur, key=lambda e: e.get("value") or 0.0)
    if (entry.get("value") or 0.0) >= (best.get("value") or 0.0):
        return [entry]
    return [best, entry]


def _entry_value(e) -> float:
    return e[0] if type(e) is tuple else (e.get("value") or 0.0)


def _entry_time(e) -> float:
    return e[1] if type(e) is tuple else (e.get("unix_s") or 0.0)


def _entry_dict(e) -> dict:
    """Normalize one reservoir entry to the exposition dict shape.
    ``observe`` stores compact ``(value, unix_s, descriptor)`` tuples —
    it is the per-token hot path and must not build a dict per
    observation — and every reader normalizes through here."""
    if type(e) is not tuple:
        return e
    v, t, ex = e
    out = {"request_id": str(ex.get("request_id")), "value": v,
           "unix_s": round(t, 3)}
    replica = ex.get("replica")
    if replica:
        out["replica"] = str(replica)
    return out


def _reservoir_union(a: Optional[list], b: Optional[list]) -> list:
    """Bounded union of two bucket reservoirs: the max-valued entry plus
    the newest entry across both sides (newest-wins on ties). Accepts
    mixed tuple/dict entries; always returns normalized dicts."""
    merged = [_entry_dict(e) for e in list(a or []) + list(b or [])]
    if not merged:
        return []
    best = max(merged, key=lambda e: (e.get("value") or 0.0,
                                      e.get("unix_s") or 0.0))
    newest = max(merged, key=lambda e: e.get("unix_s") or 0.0)
    if newest is best:
        return [best]
    return [best, newest]


class StreamingHistogram:
    """Streaming log-bucketed histogram over positive values (seconds).

    ``growth=1.25`` bounds quantile error at ~12% relative — far below
    run-to-run latency noise — while covering 1 µs..1000 s in ~77 buckets.
    """

    def __init__(self, lo: float = 1e-6, growth: float = 1.25):
        if not (lo > 0 and growth > 1):
            raise ValueError(f"need lo > 0 and growth > 1, got {lo}, {growth}")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        self.counts: dict = {}  # bucket index -> count
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # bucket index -> bounded exemplar reservoir ([{request_id,
        # value, unix_s, replica?}, ...], at most EXEMPLARS_PER_BUCKET)
        self.exemplars: dict = {}
        self.exemplars_enabled = True

    def _bucket_index(self, v: float) -> int:
        return 0 if v <= self.lo else 1 + int(
            math.log(v / self.lo) / self._log_growth
        )

    def add(self, value: float):
        v = float(value)
        if v != v or v < 0:  # NaN / negative clock skew: drop, don't poison
            return
        idx = self._bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def observe(self, value: float, exemplar: Optional[dict] = None):
        """``add`` plus an optional exemplar — the trace-linkage hook the
        serving observation sites call with the live request id:
        ``hist.observe(ttft_s, exemplar={"request_id": req.id,
        "replica": "r0"})``. The exemplar joins the bounded per-bucket
        reservoir (latest + max); a missing/disabled exemplar makes this
        exactly ``add``."""
        v = float(value)
        if v != v or v < 0:
            return
        idx = self._bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if not exemplar or not self.exemplars_enabled:
            return
        if exemplar.get("request_id") is None:
            return
        # compact-tuple write path (normalized to dicts only at read, by
        # ``_entry_dict``), with ``_reservoir_put`` inlined against the
        # invariant every reservoir writer maintains: res[0] is the
        # max-valued entry, res[-1] the newest. This is the per-token hot
        # path — a dict build + key-lambda max() per observation is what
        # the bench's zero-overhead witness caught. The descriptor is
        # stored BY REFERENCE: callers pass one stable dict per request
        # (the tracer caches it on the record), never a mutated shared one.
        entry = (v, exemplar.get("unix_s") or time.time(), exemplar)
        res = self.exemplars.get(idx)
        if res is None:
            self.exemplars[idx] = [entry]
        elif v >= _entry_value(res[0]):
            res[:] = [entry]
        elif len(res) == 1:
            res.append(entry)
        else:
            res[-1] = entry

    def upper_edge(self, idx: int) -> float:
        """Inclusive upper bound of bucket ``idx``."""
        return self.lo * self.growth ** idx

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (geometric bucket midpoint, clamped to the
        observed min/max so tiny sample counts don't overshoot).
        Snapshots the bucket dict first: the exporter's scrape thread reads
        while the serving thread adds."""
        counts = dict(self.counts)
        if not counts:
            return None
        total = sum(counts.values())
        target = q * total
        seen = 0
        lo_clamp, hi_clamp = self.min, self.max
        for idx in sorted(counts):
            seen += counts[idx]
            if seen >= target:
                hi = self.upper_edge(idx)
                est = hi / math.sqrt(self.growth) if idx > 0 else hi
                if lo_clamp is not None:
                    est = max(est, lo_clamp)
                if hi_clamp is not None:
                    est = min(est, hi_clamp)
                return est
        return hi_clamp

    def cumulative_buckets(self) -> list:
        """[(le_seconds, cumulative_count), ...] ascending — the Prometheus
        histogram series (the caller appends the +Inf bucket = count).
        Snapshot-safe against a concurrent ``add``."""
        counts = dict(self.counts)
        out, seen = [], 0
        for idx in sorted(counts):
            seen += counts[idx]
            out.append((self.upper_edge(idx), seen))
        return out

    def merge(self, other: "StreamingHistogram"):
        """Fold another histogram in — the primitive behind multi-host
        ``trace``/``report`` summaries and the fleet collector's exact
        cross-replica quantiles. Bucket layouts must align exactly
        (``lo``/``growth`` identical, which they are by construction for
        every default-layout session); a mismatch **raises** rather than
        silently misbinning — a wrong fleet p99 is worse than no fleet
        p99."""
        if (other.lo, other.growth) != (self.lo, self.growth):
            raise ValueError(
                f"histogram layouts differ (lo/growth {self.lo}/{self.growth} "
                f"vs {other.lo}/{other.growth}); cannot merge"
            )
        for idx, n in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max, other.max)
        # exemplars union bounded per bucket, newest-wins: a fleet merge
        # of N replicas still holds at most EXEMPLARS_PER_BUCKET each
        for idx, res in other.exemplars.items():
            self.exemplars[idx] = _reservoir_union(self.exemplars.get(idx), res)

    @classmethod
    def from_cumulative(cls, buckets, *, sum_value: float = 0.0,
                        lo: float = 1e-6, growth: float = 1.25,
                        tolerance: float = 0.01,
                        exemplars=None) -> "StreamingHistogram":
        """Rebuild a histogram from exposition-format cumulative buckets
        (``[(le_seconds, cumulative_count), ...]`` — the inverse of
        :meth:`cumulative_buckets`, which is how the fleet collector
        turns a replica's scrape back into a mergeable histogram.

        Every ``le`` edge must land on the ``lo * growth**i`` grid
        (within ``tolerance`` of an integer exponent, covering the
        ``%.9g`` rendering); an off-grid edge raises ``ValueError`` —
        a replica running a custom layout must be skipped, not misbinned.
        ``min``/``max`` are unknowable from the exposition and stay
        ``None`` (quantiles lose only the endpoint clamp, which moves an
        estimate within its own bucket — inside the usual ~12% bound)."""
        h = cls(lo=lo, growth=growth)
        prev = 0
        for le, cum in sorted(buckets):
            n = int(cum) - prev
            prev = int(cum)
            if n < 0:
                raise ValueError("cumulative bucket counts must be ascending")
            if n == 0:
                continue
            if le <= lo * (1 + tolerance):
                idx = 0
            else:
                exponent = math.log(le / lo) / math.log(growth)
                idx = int(round(exponent))
                if abs(exponent - idx) > tolerance or idx < 0:
                    raise ValueError(
                        f"bucket edge {le!r} is not on the lo={lo} "
                        f"growth={growth} grid"
                    )
            h.counts[idx] = h.counts.get(idx, 0) + n
        h.count = prev
        h.sum = float(sum_value)
        # exposition-carried exemplars ride back in, keyed by their
        # bucket edge (``[(le_seconds, entry), ...]`` — what
        # ``parse_exposition`` collects); an off-grid or malformed entry
        # is dropped, never raised — exemplars are debug hints, not data
        for le, entry in (exemplars or []):
            if not isinstance(entry, dict) or entry.get("request_id") is None:
                continue
            try:
                v = float(entry.get("value") or le)
                idx = h._bucket_index(v)
            except (TypeError, ValueError):
                continue
            e = {"request_id": str(entry["request_id"]), "value": v,
                 "unix_s": round(float(entry.get("unix_s") or 0.0), 3)}
            if entry.get("replica"):
                e["replica"] = str(entry["replica"])
            h.exemplars[idx] = _reservoir_put(h.exemplars.get(idx), e)
        return h

    def exposition_exemplars(self) -> dict:
        """``{le_seconds: entry}`` — the one exemplar per bucket the
        Prometheus exposition renders (OpenMetrics allows a single
        exemplar per ``_bucket`` line; the newest wins, matching the
        fleet-merge policy)."""
        out = {}
        for idx, res in sorted(dict(self.exemplars).items()):
            if not res:
                continue
            out[self.upper_edge(idx)] = _entry_dict(max(res, key=_entry_time))
        return out

    def exemplar_near_quantile(self, q: float) -> Optional[dict]:
        """The exemplar closest to the q-quantile bucket — preferring the
        quantile bucket itself, then the nearest bucket below (a tail
        quantile's culprit), then the nearest above. This is what names a
        concrete request id next to a p99."""
        counts = dict(self.counts)
        exemplars = dict(self.exemplars)
        if not counts or not exemplars:
            return None
        total = sum(counts.values())
        target, seen = q * total, 0
        q_idx = max(counts)
        for idx in sorted(counts):
            seen += counts[idx]
            if seen >= target:
                q_idx = idx
                break
        have = sorted(exemplars)
        below = [i for i in have if i <= q_idx]
        pick = below[-1] if below else have[0]
        res = exemplars.get(pick) or []
        if not res:
            return None
        return _entry_dict(max(res, key=lambda e: (_entry_value(e),
                                                   _entry_time(e))))

    def snapshot(self) -> dict:
        """{count, sum_s, min_s, max_s, mean_s, p50_s, p95_s, p99_s} or {}."""
        if not self.count:
            return {}
        return {
            "count": self.count,
            "sum_s": self.sum,
            "mean_s": self.sum / self.count,
            "min_s": self.min,
            "max_s": self.max,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }


def percentile_keys(name: str, hist: StreamingHistogram) -> dict:
    """Flat rollup keys for one histogram: ``{name}_p50_ms`` etc. — what
    ``TelemetrySession.rollup()`` folds into every tracker flush."""
    snap = hist.snapshot()
    if not snap:
        return {}
    out = {f"{name}_count": snap["count"]}
    for field, key in (("p50_s", "p50_ms"), ("p95_s", "p95_ms"),
                       ("p99_s", "p99_ms"), ("mean_s", "mean_ms"),
                       ("max_s", "max_ms")):
        v = snap.get(field)
        # a histogram rebuilt from exposition buckets (from_cumulative)
        # has no observed min/max — skip those keys, don't crash rollups
        if v is not None:
            out[f"{name}_{key}"] = round(v * 1e3, 3)
    e = hist.exemplar_near_quantile(0.99)
    if e is not None:
        # a string value: the exporter's gauge loop skips it (an id is
        # not a series), but watch/report/alerts read it off the rollup
        out[f"{name}_p99_exemplar"] = str(e["request_id"])
    return out
