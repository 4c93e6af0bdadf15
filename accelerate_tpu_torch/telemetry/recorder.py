"""Flight recorder: a bounded ring of recent events and the debug bundle
it dumps on a trigger.

An own copy of the reference's ``accelerate_tpu/telemetry/recorder.py``
``FlightRecorder``. When a serving host wedges mid-burst, the evidence is
gone by the time a human attaches: the interesting state was the last few
seconds of events. The recorder keeps a **bounded ring** of recent events
and metric snapshots (one deque append each) and, on a trigger, dumps one
self-contained **debug bundle** JSON:

- the ring contents (request submits/finishes, steps, sheds, preemptions,
  snapshots),
- in-flight request ids with their state/slot/age and last lifecycle
  event (from the request tracer),
- the last closed telemetry spans (what the host was doing),
- the CUDA graph capture counters under the reference's
  ``compile_counters`` key (the port's counterpart of a recompile is a
  capture), device memory (``torch.cuda.memory_stats``) with peak
  watermark deltas, and every python thread's stack.

Triggers: an **unhandled exception** (``sys.excepthook`` chain),
**SIGTERM** (dump, request a serving drain when the session asks for one,
then chain to the previous handler so termination semantics are
unchanged), or an explicit ``dump()`` call. The reference's watchdog
trigger is a later item of the port (ROADMAP queue 1 item 10 part 2); a session
configured for it raises.

:class:`CaptureWindow` is the reference's trigger-gated profiler window
over ``torch.profiler`` in place of ``jax.profiler``: steps N..M of
``TelemetryConfig.profile_steps``, or a window armed by an ITL p99 over
``profile_trigger_itl_p99_ms``, each written as a Chrome trace.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional


def _thread_stacks() -> str:
    """Every python thread's stack (the reference's ``watchdog._thread_stacks``)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in frames.items():
        chunks.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---\n"
                      + "".join(traceback.format_stack(frame)))
    return "\n".join(chunks)


class FlightRecorder:
    """Bounded event ring + debug-bundle dumper for one telemetry session."""

    def __init__(self, session, dump_dir: Optional[str] = None,
                 capacity: int = 256, process_index: int = 0,
                 drain_serving: bool = True):
        self.session = session
        self.dump_dir = dump_dir
        self.process_index = process_index
        self.drain_serving = drain_serving
        self.ring: deque = deque(maxlen=max(8, int(capacity)))
        self.dump_count = 0
        self.last_bundle_path: Optional[str] = None
        # reentrant: SIGTERM can land while the same thread is mid-dump
        # (explicit dump / excepthook), and the handler dumps again
        self._lock = threading.RLock()
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._hooks_installed = False

    # -- producers ---------------------------------------------------------

    def note(self, kind: str, **fields):
        """Append one event to the ring (the per-event cost of leaving the
        recorder on)."""
        evt = {"t_unix_s": round(time.time(), 3), "kind": kind}
        evt.update(fields)
        self.ring.append(evt)

    def note_snapshot(self, values: dict):
        """Stash a (flat) metric rollup in the ring — called at flush
        cadence so the bundle shows the gauges' recent trajectory."""
        keep = {k: v for k, v in values.items()
                if isinstance(v, (int, float, bool))}
        self.note("metrics_snapshot", values=keep)

    # -- trigger hooks -----------------------------------------------------

    def install_hooks(self):
        """Chain into ``sys.excepthook`` and SIGTERM (main thread only for
        the signal). Both previous handlers keep running after the dump, so
        tracebacks still print and preemption still terminates."""
        if self._hooks_installed:
            return
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        try:
            if threading.current_thread() is threading.main_thread():
                self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):  # non-main thread / exotic runtime
            self._prev_sigterm = None
        self._hooks_installed = True

    def uninstall_hooks(self):
        if not self._hooks_installed:
            return
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._prev_sigterm is not None:
            try:
                if signal.getsignal(signal.SIGTERM) is self._on_sigterm:
                    signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
        self._hooks_installed = False

    def _excepthook(self, exc_type, exc, tb):
        try:
            self.dump("unhandled_exception", extra={
                "exception": "".join(
                    traceback.format_exception_only(exc_type, exc)
                ).strip(),
            })
        except Exception:
            pass
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_sigterm(self, signum, frame):
        try:
            self.dump("sigterm")
        except Exception:
            pass
        if self.drain_serving and self.session is not None:
            # request (not run) a serving drain: attached engines stop
            # admitting and shed their queues right here — host-side
            # bookkeeping only — and whatever loop is driving them
            # finishes the in-flight requests before exiting, so shutdown
            # mid-burst leaves every request with a definite outcome
            try:
                self.session.request_drain_serving()
            except Exception:
                pass
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore + re-raise so the default disposition terminates us
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    # -- the bundle --------------------------------------------------------

    def build_bundle(self, reason: str, extra: Optional[dict] = None) -> dict:
        """Everything a post-mortem needs, each section individually
        fail-soft (a dead backend must not lose the host-side evidence)."""
        bundle = {
            "reason": reason,
            "time_unix_s": round(time.time(), 3),
            "wall_clock": time.strftime("%Y-%m-%d %H:%M:%S"),
            "process_index": self.process_index,
            "events": list(self.ring),
        }
        if extra:
            bundle.update(extra)
        try:
            from ..utils.cuda_graphs import capture_counters

            bundle["compile_counters"] = capture_counters()
        except Exception:
            pass
        try:
            from .metrics import device_memory_stats

            bundle["device_memory"] = device_memory_stats(per_device=True)
        except Exception:
            pass
        session = self.session
        if session is not None:
            tracer = getattr(session, "requests", None)
            if tracer is not None:
                bundle["inflight_requests"] = tracer.inflight()
            try:
                from . import spans

                bundle["last_spans"] = spans.last_spans(32)
            except Exception:
                pass
            try:
                # host_rollup, not rollup: a full rollup device_gets pending
                # loss/grad scalars, which blocks forever on the wedged
                # backend this dump may be diagnosing
                bundle["rollup"] = {
                    k: v for k, v in session.host_rollup().items()
                    if isinstance(v, (int, float, bool))
                }
            except Exception:
                pass
        bundle["thread_stacks"] = _thread_stacks()
        return bundle

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Write one debug bundle; returns its path (None without a dump
        dir — the bundle still lands on stderr as a one-line summary)."""
        with self._lock:
            bundle = self.build_bundle(reason, extra)
            n = self.dump_count + 1
            inflight = bundle.get("inflight_requests") or []
            print(
                f"[accelerate_tpu_torch flight-recorder] {reason}: "
                f"{len(bundle['events'])} ring events, "
                f"{len(inflight)} in-flight requests "
                f"[{', '.join(str(r['request_id']) for r in inflight[:16])}]",
                file=sys.stderr,
            )
            if not self.dump_dir:
                self.dump_count = n
                return None
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir,
                    f"flightrec-host{self.process_index}-{n}.json",
                )
                with open(path, "w") as fh:
                    json.dump(bundle, fh, indent=1, default=str)
                self.last_bundle_path = path
                return path
            except OSError:
                return None
            finally:
                # advance the counter only once last_bundle_path is set (or
                # the write definitively failed): pollers on another thread
                # key on dump_count to decide the bundle is readable
                self.dump_count = n



class CaptureWindow:
    """Trigger-gated ``torch.profiler`` window keyed on session step counts.

    ``start_step``/``stop_step`` come from config; :meth:`arm` (an ITL SLO
    breach) opens a window at the next step for ``window_steps`` steps.
    One window at a time; ``max_auto_arms`` bounds trigger storms. Each
    window is one ``torch.profiler.profile`` (CPU, and CUDA where it is
    available) exported to ``out_dir/capture-<n>.json``. The start and
    stop callables are injectable, so tests can drive the trigger logic
    without a profiler."""

    def __init__(self, out_dir: str, start_step: Optional[int] = None,
                 stop_step: Optional[int] = None, window_steps: int = 16,
                 max_auto_arms: int = 1, start_fn=None, stop_fn=None):
        self.out_dir = out_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self.window_steps = max(1, int(window_steps))
        self.max_auto_arms = max_auto_arms
        self.active = False
        self.captures = 0
        self.reason: Optional[str] = None
        self.paths: list = []
        self._armed_reason: Optional[str] = None
        self._armed_until: Optional[int] = None
        self._auto_arms = 0
        self._disabled = False
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._prof = None

    def arm(self, reason: str = "trigger") -> bool:
        """Open a capture window at the next step (no-op while one is
        active or the auto-arm budget is spent)."""
        if self._disabled or self.active or self._armed_reason is not None:
            return False
        if self._auto_arms >= self.max_auto_arms:
            return False
        self._auto_arms += 1
        self._armed_reason = reason
        return True

    def _start(self, reason: str):
        try:
            if self._start_fn is not None:
                self._start_fn(self.out_dir)
            else:
                import torch

                os.makedirs(self.out_dir, exist_ok=True)
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
        except Exception as e:
            # one failed start disables the window for the session: a
            # config-steps window would otherwise retry on every step
            import logging

            logging.getLogger(__name__).warning(
                "profiler capture window disabled: the profiler did not start (%r)", e)
            self._prof = None
            self._armed_reason = None
            self._armed_until = None
            self._disabled = True
            return
        self.active = True
        self.reason = reason

    def _stop(self):
        try:
            if self._stop_fn is not None:
                self._stop_fn()
            elif self._prof is not None:
                prof, self._prof = self._prof, None
                prof.__exit__(None, None, None)
                path = os.path.join(self.out_dir, f"capture-{self.captures}.json")
                prof.export_chrome_trace(path)
                self.paths.append(path)
        except Exception:
            pass
        self.active = False
        self.captures += 1

    def on_step(self, step: int):
        """Advance the window state machine; called once per recorded step."""
        if self._disabled:
            return
        if self.active:
            if (self._armed_until is not None and step >= self._armed_until) or (
                self._armed_until is None
                and self.stop_step is not None and step >= self.stop_step
            ):
                self._armed_until = None
                self._stop()
            return
        if self._armed_reason is not None:
            reason, self._armed_reason = self._armed_reason, None
            self._armed_until = step + self.window_steps
            self._start(reason)
            return
        if (self.start_step is not None and self.stop_step is not None
                and self.start_step <= step < self.stop_step):
            self._start("config_steps")

    def close(self):
        if self.active:
            self._stop()
