"""Nestable span tracing emitted as a Chrome-trace-compatible JSONL per host.

An own copy of the reference's ``accelerate_tpu/telemetry/spans.py``: the
same event lines, ring and module-level recorder.

Generalizes the flat TTFT phase timing of ``utils/phases.py`` into spans
that nest (per-thread), carry attributes, and stream to disk as they
close. Each line of the output file is one complete Chrome trace event
(``"ph": "X"``), so the file doubles as

- a JSONL stream (tail it, grep it, load line-by-line), and
- the body of a Chrome ``traceEvents`` array: ``load_chrome_trace()``
  wraps the lines into ``{"traceEvents": [...]}``, which Perfetto /
  ``chrome://tracing`` ingest directly (the JSON Array Format tolerates
  the missing brackets too).

Spans on the same thread nest by time containment — exactly how the trace
viewers render them — so no name mangling is needed. ``span(...,
annotate=True)`` (or arming the recorder with ``annotate_device=True``)
additionally brackets the region with ``torch.profiler.record_function``
(where the reference uses ``jax.profiler.TraceAnnotation``), so a host span
shows in a ``torch.profiler`` trace beside the kernels it launched.

The recorder also keeps an in-memory ring of the most recently *closed*
spans (``last_spans()``) — the watchdog dumps it when a stall fires, so
the post-mortem shows what the host was doing right before the hang.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

_RECORDER: Optional["SpanRecorder"] = None
_tls = threading.local()


class SpanRecorder:
    """Streams closed spans to ``path`` (one Chrome trace event per line)."""

    def __init__(self, path: str, process_index: int = 0, ring: int = 64,
                 annotate_device: bool = False):
        self.path = path
        self.process_index = process_index
        self.annotate_device = annotate_device
        self.ring: deque = deque(maxlen=ring)
        # one clock for every ts in this file: perf_counter, rebased so the
        # trace starts near 0 (viewers dislike 10^9-microsecond offsets)
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        from .artifacts import ArtifactWriter

        self._fh = ArtifactWriter(path)
        self._write({
            "name": "process_name", "ph": "M", "pid": process_index, "tid": 0,
            "args": {"name": f"host{process_index}", "epoch_unix_s": time.time()},
        })

    def emit(self, name: str, t0: float, dur_s: float, cat: str = "span",
             args: Optional[dict] = None):
        """Record one closed span (``t0`` on the perf_counter clock)."""
        evt = {
            "name": name,
            "ph": "X",
            "cat": cat,
            "ts": round(max(t0 - self._epoch, 0.0) * 1e6, 3),
            "dur": round(dur_s * 1e6, 3),
            "pid": self.process_index,
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            evt["args"] = args
        self.ring.append({"name": name, "end_unix_s": time.time(), "dur_s": dur_s})
        self._write(evt)

    def _write(self, obj: dict):
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write_line(json.dumps(obj))

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


def arm(path: str, process_index: int = 0, ring: int = 64,
        annotate_device: bool = False) -> SpanRecorder:
    """Install the process-global recorder (replacing any previous one)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
    _RECORDER = SpanRecorder(path, process_index, ring=ring,
                             annotate_device=annotate_device)
    return _RECORDER


def disarm():
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.close()
        _RECORDER = None


def recorder() -> Optional[SpanRecorder]:
    return _RECORDER


def last_spans(n: int = 16) -> list:
    """The most recently closed spans (newest last); [] when nothing armed."""
    rec = _RECORDER
    if rec is None:
        return []
    return list(rec.ring)[-n:]


@contextmanager
def span(name: str, annotate: bool = False, cat: str = "span", **args):
    """Time a nestable region. No-op (one global read) when nothing is armed."""
    rec = _RECORDER
    if rec is None:
        yield
        return
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    ann = None
    if annotate or rec.annotate_device:
        try:
            from torch.profiler import record_function

            ann = record_function(name)
            ann.__enter__()
        except Exception:
            ann = None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        _tls.depth = depth
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        rec.emit(name, t0, dur, cat=cat, args={**args, "depth": depth} if args or depth else None)


def load_chrome_trace(path: str) -> dict:
    """Parse a span JSONL back into the Chrome ``{"traceEvents": [...]}``
    object (what Perfetto's JSON importer and ``chrome://tracing`` accept)."""
    events = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return {"traceEvents": events}
