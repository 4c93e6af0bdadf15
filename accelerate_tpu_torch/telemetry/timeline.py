"""Continuous telemetry timeline: every gauge, continuously, bounded.

An own copy of the reference's ``accelerate_tpu/telemetry/timeline.py``.

``rollup()`` is an instantaneous snapshot and the JSONL artifacts are
post-mortem files; neither can answer the live-ops questions — "is ITL
p99 degrading over the last minute vs the last hour?", "did queue depth
start climbing before or after the page arena filled?". The timeline is
the third generation: a background sampler (see ``TelemetrySession``)
feeds every rollup gauge plus the SLO-histogram percentiles into a
bounded in-memory ring at a fixed cadence, with **multi-resolution
downsampling** so history stays cheap:

- tier 0 keeps raw samples at the sampling interval (default 1 s for the
  last ~10 minutes),
- tier 1+ keep (min, max, mean, first, last) aggregates per coarser
  bucket (default 10 s for ~2 h, 60 s for ~24 h),

so an hour of ~100-gauge history fits in a few MB and a day in less.
``window(key, seconds)`` answers windowed queries by merging the finest
tiers that cover the span; ``points()`` exposes the same merge for
sparklines and the alert rules (``telemetry/alerts.py``).

Samples persist to ``timeline-host<i>.jsonl`` on session flush/close
(:func:`load_timeline` reads them back offline). Plain stdlib, no torch
and no numpy (a CPU test imports it with both blocked): the same module
runs on a router or a laptop that only holds the log files.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

# (bucket_interval_s, capacity_points) per tier; tier 0 is the raw ring
# sampled at the session cadence, coarser tiers aggregate it. Defaults:
# ~10 min raw @1 Hz, ~2 h @10 s, ~24 h @60 s — a few MB for ~100 gauges.
DEFAULT_TIERS = ((1.0, 600), (10.0, 720), (60.0, 1440))

# aggregate point layout per key: [min, max, sum, count, first, last]
_MIN, _MAX, _SUM, _N, _FIRST, _LAST = range(6)


def _numeric(v):
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        f = float(v)
        return f if f == f else None  # drop NaN
    return None


class _AggTier:
    """One downsampling tier: a ring of completed buckets plus the
    bucket currently accumulating."""

    def __init__(self, interval_s: float, capacity: int):
        self.interval_s = float(interval_s)
        self.points: deque = deque(maxlen=max(2, int(capacity)))
        self._bucket_end: Optional[float] = None
        self._acc: dict = {}

    def fold(self, t: float, values: dict):
        if self._bucket_end is None:
            self._bucket_end = (t // self.interval_s + 1) * self.interval_s
        elif t >= self._bucket_end:
            self.flush()
            self._bucket_end = (t // self.interval_s + 1) * self.interval_s
        acc = self._acc
        for k, v in values.items():
            a = acc.get(k)
            if a is None:
                acc[k] = [v, v, v, 1, v, v]
            else:
                if v < a[_MIN]:
                    a[_MIN] = v
                if v > a[_MAX]:
                    a[_MAX] = v
                a[_SUM] += v
                a[_N] += 1
                a[_LAST] = v

    def flush(self):
        """Close the accumulating bucket into the ring (no-op if empty)."""
        if self._acc:
            self.points.append((self._bucket_end, self._acc))
            self._acc = {}


class Timeline:
    """Bounded multi-resolution ring over flat gauge samples."""

    def __init__(self, tiers=None):
        tiers = tuple(tiers) if tiers else DEFAULT_TIERS
        if len(tiers) < 1:
            raise ValueError("need at least the raw tier")
        self.raw_interval_s = float(tiers[0][0])
        self.raw: deque = deque(maxlen=max(2, int(tiers[0][1])))
        self.tiers = [_AggTier(i, c) for i, c in tiers[1:]]
        self.sample_count = 0
        self.last_t: Optional[float] = None
        self._keys: set = set()
        self._pending: deque = deque(maxlen=4096)  # unwritten JSONL samples
        self._writers: dict = {}  # flush path -> ArtifactWriter
        self._lock = threading.Lock()

    # -- producers ---------------------------------------------------------

    def add_sample(self, values: dict, now: Optional[float] = None) -> float:
        """Fold one flat gauge dict in (non-numeric values are dropped,
        bools become 0/1). Returns the sample's timestamp."""
        t = time.time() if now is None else float(now)
        clean = {}
        for k, v in values.items():
            f = _numeric(v)
            if f is not None:
                clean[k] = f
        with self._lock:
            self.raw.append((t, clean))
            for tier in self.tiers:
                tier.fold(t, clean)
            self.sample_count += 1
            self.last_t = t
            self._keys.update(clean)
            self._pending.append((t, clean))
        return t

    # -- queries -----------------------------------------------------------

    def keys(self) -> list:
        with self._lock:
            return sorted(self._keys)

    def last(self, key: str):
        """Most recent raw value of ``key`` (None if never sampled)."""
        with self._lock:
            for t, values in reversed(self.raw):
                if key in values:
                    return values[key]
        return None

    def points(self, key: str, seconds: float, now: Optional[float] = None) -> list:
        """Merged per-point aggregates ``[(t, [min,max,sum,n,first,last]),
        ...]`` ascending over the trailing window, finest tier first:
        raw samples where the raw ring covers, coarser buckets for the
        older remainder — so a one-hour window still answers from a
        10-minute raw ring."""
        with self._lock:
            if now is None:
                now = self.last_t
            if now is None:
                return []
            start = now - float(seconds)
            out = []
            boundary = now + self.raw_interval_s  # inclusive of `now` itself
            if self.raw:
                for t, values in self.raw:
                    if start <= t <= now and key in values:
                        v = values[key]
                        out.append((t, [v, v, v, 1, v, v]))
                boundary = min(boundary, max(start, self.raw[0][0]))
            for tier in self.tiers:
                pts = list(tier.points)
                if tier._acc and tier._bucket_end is not None:
                    pts.append((tier._bucket_end, tier._acc))
                tier_oldest = None
                for t, agg in pts:
                    if tier_oldest is None:
                        tier_oldest = t - tier.interval_s
                    # a bucket stamped t covers (t - interval, t]: include
                    # it only where the finer coverage has not
                    if t <= boundary and t > start and key in agg:
                        out.append((t, list(agg[key])))
                if tier_oldest is not None:
                    boundary = min(boundary, max(start, tier_oldest))
        out.sort(key=lambda p: p[0])
        return out

    def window(self, key: str, seconds: float, now: Optional[float] = None) -> Optional[dict]:
        """Windowed stats over the trailing ``seconds``: ``{n, min, max,
        mean, first, last, rate, delta, span_s}`` — or None when the key
        has no samples in the window. ``rate``/``delta`` read the series
        as a counter (last minus first, per second / absolute)."""
        pts = self.points(key, seconds, now)
        if not pts:
            return None
        mn = min(p[1][_MIN] for p in pts)
        mx = max(p[1][_MAX] for p in pts)
        sm = sum(p[1][_SUM] for p in pts)
        n = sum(p[1][_N] for p in pts)
        t_first, first = pts[0][0], pts[0][1][_FIRST]
        t_last, last = pts[-1][0], pts[-1][1][_LAST]
        span = max(t_last - t_first, 0.0)
        delta = last - first
        return {
            "n": n,
            "min": mn,
            "max": mx,
            "mean": sm / n if n else None,
            "first": first,
            "last": last,
            "delta": delta,
            "rate": (delta / span) if span > 0 else None,
            "span_s": span,
            "t_first": t_first,
            "t_last": t_last,
        }

    def series(self, key: str, seconds: float, now: Optional[float] = None,
               max_points: int = 64) -> list:
        """``[(t, mean), ...]`` downsampled to at most ``max_points`` —
        what a sparkline plots."""
        pts = self.points(key, seconds, now)
        if not pts:
            return []
        if len(pts) <= max_points:
            return [(t, a[_SUM] / a[_N]) for t, a in pts]
        out = []
        stride = len(pts) / max_points
        for i in range(max_points):
            chunk = pts[int(i * stride): max(int((i + 1) * stride), int(i * stride) + 1)]
            sm = sum(a[_SUM] for _, a in chunk)
            n = sum(a[_N] for _, a in chunk)
            out.append((chunk[-1][0], sm / n if n else 0.0))
        return out

    # -- persistence ---------------------------------------------------------

    def flush_jsonl(self, path: str) -> int:
        """Append samples accumulated since the last flush to ``path``
        (one ``{"t": ..., "v": {...}}`` line each); returns how many were
        written. Crash-tolerant by construction: each line is a complete
        record, a torn tail line is skipped by the loader."""
        with self._lock:
            pending, self._pending = list(self._pending), deque(maxlen=4096)
            if not pending:
                return 0
            writer = self._writers.get(path)
            if writer is None:
                from .artifacts import ArtifactWriter

                writer = self._writers[path] = ArtifactWriter(path)
        for t, values in pending:
            writer.write_line(json.dumps(
                {"t": round(t, 3),
                 "v": {k: round(v, 6) for k, v in values.items()}}
            ))
        return len(pending)


def load_timeline(target: str, tiers=None) -> Timeline:
    """Rebuild a :class:`Timeline` from ``timeline-host*.jsonl`` files
    under ``target`` (a directory) or from one file path — the offline
    path. Multi-host samples are
    merged in timestamp order; malformed lines are skipped."""
    from .artifacts import artifact_files, iter_jsonl

    if os.path.isdir(target):
        paths = artifact_files(target, "timeline-host*.jsonl")
    elif os.path.exists(target):
        paths = artifact_files(target)
    else:
        paths = []
    records = []
    for rec in iter_jsonl(paths):
        if "t" in rec and isinstance(rec.get("v"), dict):
            try:
                records.append((float(rec["t"]), rec["v"]))
            except (TypeError, ValueError):
                continue
    records.sort(key=lambda r: r[0])
    tl = Timeline(tiers=tiers)
    for t, values in records:
        tl.add_sample(values, now=t)
    return tl


class TimelineSampler:
    """Background cadence for the timeline: calls ``sample_fn()`` every
    ``interval_s`` on a daemon thread (watchdog-style), so engine hot
    paths never pay for sampling — the established telemetry contract.
    ``stop()`` is prompt (event-driven, no sleep to ride out)."""

    def __init__(self, sample_fn, interval_s: float = 1.0):
        self._fn = sample_fn
        self.interval_s = max(0.01, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    def start(self) -> "TimelineSampler":
        self._thread = threading.Thread(
            target=self._run, name="att-timeline-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._fn()
                self.ticks += 1
            except Exception:
                # a sick gauge source must not kill the sampling cadence;
                # the next tick retries (mirrors the scrape thread's stance)
                pass

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
