"""Goodput ledger: partition session wall-clock into what it actually
bought. An own copy of the reference's ``accelerate_tpu/telemetry/goodput.py``.

Large-fleet training accounting (MLPerf-style goodput) asks one question
of every wall-clock second: did it advance the model? The ledger answers
it continuously, splitting elapsed time into six exhaustive buckets:

- ``compute``   — step wall net of everything below (the goodput),
- ``compile``   — compile seconds billed to a step (the port reports none:
  its counterpart of a compile is a CUDA graph capture, which it counts),
- ``checkpoint``— save/restore walls (the ``checkpoint/*`` phases),
- ``data_wait`` — host time blocked on the input pipeline (``note_data_wait``),
- ``stall``     — watchdog-diagnosed dead time (heartbeat past deadline),
- ``idle``      — the remainder (between-step host time, warmup, teardown).

The fractions always sum to 1.0: ``idle`` is defined as the remainder
and, if instrumented buckets ever overlap (a stall interval later covered
by a completed step's wall), the known buckets renormalize over elapsed
time rather than double-billing. Every ``TelemetrySession.rollup()``
carries the fractions, and ``goodput-host<i>.json`` snapshots them for
the reference's offline ``report``.

Pure host arithmetic; producers pay one float add.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

BUCKETS = ("compute", "compile", "checkpoint", "data_wait", "stall", "idle")

_ACTIVE: Optional["GoodputLedger"] = None


class GoodputLedger:
    """Accumulates attributed seconds per bucket against a session clock."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._start = clock()
        self._lock = threading.Lock()
        self._acc = {b: 0.0 for b in BUCKETS if b != "idle"}

    def add(self, bucket: str, seconds: float):
        if bucket not in self._acc:
            raise ValueError(f"unknown goodput bucket {bucket!r}; one of {BUCKETS}")
        if seconds > 0:
            with self._lock:
                self._acc[bucket] += float(seconds)

    def on_step(self, wall_s: float, compile_s: float = 0.0,
                data_wait_s: float = 0.0):
        """Attribute one completed step: its wall is compute except for the
        compile seconds the counters billed to it and the data wait the
        loader reported; either can exceed the step wall on multi-threaded
        hosts, so compute clamps at zero instead of going negative."""
        wall = max(float(wall_s), 0.0)
        compile_s = max(float(compile_s), 0.0)
        data_wait_s = max(float(data_wait_s), 0.0)
        with self._lock:
            self._acc["compile"] += compile_s
            self._acc["data_wait"] += data_wait_s
            self._acc["compute"] += max(wall - compile_s - data_wait_s, 0.0)

    def note_phase(self, name: str, seconds: float):
        """Phase-timing hook (``utils/phases.py`` forwards every closed
        phase): checkpoint phases land in the checkpoint bucket, the rest
        are already covered by step wall or idle."""
        if name.startswith("checkpoint/"):
            self.add("checkpoint", seconds)

    def note_stall(self, age_s: float):
        """Watchdog trip: the heartbeat has been dead ``age_s`` — reclassify
        that interval from idle to stall."""
        self.add("stall", age_s)

    # -- consumers ---------------------------------------------------------

    def elapsed_s(self) -> float:
        return max(self._clock() - self._start, 1e-9)

    def totals(self) -> dict:
        """Per-bucket seconds; idle is the non-negative remainder of
        elapsed wall, so the six entries sum to max(elapsed, attributed)."""
        with self._lock:
            acc = dict(self._acc)
        elapsed = self.elapsed_s()
        known = sum(acc.values())
        acc["idle"] = max(elapsed - known, 0.0)
        acc["elapsed_s"] = elapsed
        return acc

    def fractions(self) -> dict:
        """{bucket: fraction} summing to 1.0 (known buckets renormalize if
        instrumentation overlap pushed their sum past elapsed wall)."""
        t = self.totals()
        total = sum(t[b] for b in BUCKETS)
        if total <= 0:
            return {b: 0.0 for b in BUCKETS}
        return {b: t[b] / total for b in BUCKETS}

    def rollup_keys(self) -> dict:
        """Flat ``goodput/*`` scalars for the session rollup: per-bucket
        fractions plus the headline ``goodput/goodput_frac`` (the compute
        share — the number fleet accounting wants)."""
        fr = self.fractions()
        out = {f"goodput/{b}_frac": round(v, 4) for b, v in fr.items()}
        out["goodput/goodput_frac"] = round(fr["compute"], 4)
        out["goodput/elapsed_s"] = round(self.elapsed_s(), 3)
        return out

    def snapshot(self) -> dict:
        t = self.totals()
        return {
            "elapsed_s": round(t.pop("elapsed_s"), 3),
            "seconds": {b: round(t[b], 4) for b in BUCKETS},
            "fractions": {b: round(v, 4) for b, v in self.fractions().items()},
        }

    def write_snapshot(self, path: str):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh, indent=1)
        os.replace(tmp, path)


# -- module-level producer API (decoupled producers, like note_data_wait) ----

def arm(ledger: "GoodputLedger") -> "GoodputLedger":
    global _ACTIVE
    _ACTIVE = ledger
    return ledger


def disarm():
    global _ACTIVE
    _ACTIVE = None


def ledger() -> Optional["GoodputLedger"]:
    return _ACTIVE


def note_phase(name: str, seconds: float):
    """Fast-path hook for ``utils/phases.py``: one global read when no
    ledger is armed."""
    led = _ACTIVE
    if led is not None:
        led.note_phase(name, seconds)
