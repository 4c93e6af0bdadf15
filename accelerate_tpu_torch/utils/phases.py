"""Lightweight phase timing, a thin veneer over the telemetry span layer.

An own copy of the reference's ``accelerate_tpu/utils/phases.py``. Two
consumers, two shapes:

- ``collect_phases()`` arms a process-global collector that accumulates
  wall time per named phase (where a dispatch or a checkpoint spends its
  time, instead of a single opaque total).
- when a telemetry span recorder is armed (``telemetry.spans.arm`` or a
  ``TelemetrySession`` with spans on), every ``phase(...)`` additionally
  lands in the per-host Chrome-trace JSONL as a nested span, and an armed
  goodput ledger bills ``checkpoint/*`` phases to its checkpoint bucket
  (``checkpointing.py`` wraps ``save_accelerator_state`` and
  ``load_accelerator_state`` in ``checkpoint/save`` and
  ``checkpoint/restore``).

Both are off by default: with neither armed, ``phase`` is a no-op
context manager (two global reads).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

_ACTIVE: Optional[dict] = None


def collect_phases() -> dict:
    """Arm collection; returns the (live) dict of phase -> seconds."""
    global _ACTIVE
    _ACTIVE = {}
    return _ACTIVE


def phases_snapshot() -> dict:
    return dict(_ACTIVE or {})


@contextmanager
def phase(name: str):
    from ..telemetry import goodput as _goodput
    from ..telemetry import spans as _spans

    rec = _spans.recorder()
    led = _goodput.ledger()
    if _ACTIVE is None and rec is None and led is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        if rec is not None:
            with _spans.span(name, cat="phase"):
                yield
        else:
            yield
    finally:
        dt = time.perf_counter() - t0
        if _ACTIVE is not None:
            _ACTIVE[name] = _ACTIVE.get(name, 0.0) + dt
        if led is not None:
            # checkpoint/* phases feed the goodput ledger's checkpoint
            # bucket; every other phase is covered by step wall or idle
            led.note_phase(name, dt)


def add_phase(name: str, seconds: float) -> None:
    """Record an externally-measured duration (e.g. a thread's wall time)."""
    if _ACTIVE is not None:
        _ACTIVE[name] = _ACTIVE.get(name, 0.0) + seconds
    from ..telemetry import goodput as _goodput

    led = _goodput.ledger()
    if led is not None:
        led.note_phase(name, seconds)
