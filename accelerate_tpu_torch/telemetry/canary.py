"""Synthetic canary probing: active correctness checks for the fleet.

An own copy of the reference's ``accelerate_tpu/telemetry/canary.py``.

Every telemetry plane so far is *passive* — it reports what real traffic
experienced. A silent correctness regression (a drifting int8 replica, a
bad KV import installing garbage pages, a corrupting transport) produces
perfectly healthy latency gauges while returning wrong tokens. The
canary closes that hole with an **active prober**: seeded golden prompts
submitted through the router (or straight at one engine) at a low
configurable rate, each reply checked for **token-exactness** against
the recorded golden output — the same determinism contract the failover
drills already rely on (same weights + same seed + same prompt ⇒ the
same tokens, on every replica).

Published gauges (``rollup_keys()``; the router's ``/metrics`` merges
them in when a prober is attached, and ``telemetry/fleet.py`` carries
their merge policy):

- ``canary/probes_sent`` / ``canary/probes_passed`` /
  ``canary/probes_failed`` — monotone counters (fleet-summed);
- ``canary/pass_ratio`` — pass fraction over the recent ``window``
  probes (recent, so the ``canary_failing`` alert *resolves* once the
  fault clears instead of dragging a lifetime average forever);
- ``canary/e2e_ttft_ms`` — the last probe's client-observed TTFT (the
  canary doubles as a latency heartbeat when real traffic is idle);
- ``canary/last_pass_unix_s`` — freshness watermark (fleet-max: "when
  did ANY probe last verify the service end to end").

The ``canary_failing`` rule in :func:`~.alerts.default_ruleset` pages on
``canary/pass_ratio < 1`` and — through ``on_fail``/``flight_fn`` — the
prober triggers a flight dump **on the replica that served the failing
probe** (``POST /v1/flight``, ``serving/replica_server.py``), so the
debug bundle is captured on the degraded box while the fault is live.

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the prober runs wherever the router runs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional


def via_router(router) -> Callable:
    """``submit_fn`` over a live :class:`~..serving.router.Router`: the
    probe travels the exact path real traffic does (placement, failover,
    streaming), so the canary verifies the *service*, not one engine."""

    def submit(golden: dict, request_id) -> dict:
        req = router.submit(
            list(golden["prompt"]),
            max_new_tokens=int(golden.get("max_new_tokens") or 16),
            seed=int(golden.get("seed") or 0),
            tenant=str(golden.get("tenant") or "_canary"),
            request_id=request_id,
        )
        ttft = (
            round((req.first_token_t - req.submit_t) * 1e3, 3)
            if req.first_token_t is not None else None
        )
        e2e = (
            round((req.finish_t - req.submit_t) * 1e3, 3)
            if req.finish_t is not None else None
        )
        return {"tokens": [int(t) for t in req.tokens],
                "replica": req.replica, "outcome": req.outcome,
                "shed_reason": req.shed_reason,
                "ttft_ms": ttft, "e2e_ms": e2e}

    return submit


def via_engine(engine, *, drive: bool = False,
               timeout_s: float = 30.0) -> Callable:
    """``submit_fn`` straight at one :class:`ServingEngine` (no router):
    isolates a single replica's correctness — the triage step after the
    router-path canary fails. With ``drive=True`` the prober runs the
    engine loop itself (``engine.run()`` — standalone use); the default
    waits on the request while the embedder's own loop (e.g. a
    :class:`ReplicaServer`) serves it."""

    def submit(golden: dict, request_id) -> dict:
        t0 = time.perf_counter()
        first = []

        def on_token(token, req):
            if not first:
                first.append(time.perf_counter())

        req = engine.submit(
            list(golden["prompt"]),
            max_new_tokens=int(golden.get("max_new_tokens") or 16),
            seed=int(golden.get("seed") or 0),
            tenant=str(golden.get("tenant") or "_canary"),
            on_token=on_token,
            request_id=request_id,
        )
        if drive:
            engine.run()
        else:
            deadline = t0 + timeout_s
            while not req.done and time.perf_counter() < deadline:
                time.sleep(0.002)
        t1 = time.perf_counter()
        return {
            "tokens": [int(t) for t in req.tokens],
            "replica": getattr(engine, "replica", None),
            "outcome": getattr(req, "outcome", None)
            or ("finished" if req.done else "timeout"),
            "shed_reason": getattr(req, "shed_reason", None),
            "ttft_ms": round((first[0] - t0) * 1e3, 3) if first else None,
            "e2e_ms": round((t1 - t0) * 1e3, 3),
        }

    return submit


def flight_via_router(router) -> Callable:
    """``flight_fn`` that POSTs ``/v1/flight`` on the replica that
    served the failing probe, through the router's own transport —
    best-effort (a dead replica can't dump; the canary failure already
    names it)."""

    def dump(replica: Optional[str], info: dict):
        if not replica:
            return
        url = router._replica_url(replica)
        if url is None:
            return
        router.transport.post_json(url, "/v1/flight", {
            "reason": "canary_failed",
            "request_id": info.get("request_id"),
        })

    return dump


class CanaryProber:
    """Background prober over ``submit_fn(golden, request_id) -> {tokens,
    replica, outcome, ttft_ms, e2e_ms}``.

    ``goldens`` is a list of ``{prompt, seed, max_new_tokens,
    tokens?}`` dicts, probed round-robin. A golden with no recorded
    ``tokens`` is **recorded** by its first finished probe (record-then-
    verify bring-up: the first pass defines the truth every later probe
    and every replica must reproduce). ``probe_once()`` is the manual /
    deterministic cadence; ``start()`` runs it every ``interval_s`` on a
    daemon thread. Results append to ``canary-results.jsonl`` under
    ``log_dir`` and to the bounded in-memory ``results`` ring.
    """

    def __init__(self, submit_fn: Callable, goldens: list, *,
                 interval_s: float = 10.0, window: int = 32,
                 history: int = 256, log_dir: Optional[str] = None,
                 flight_fn: Optional[Callable] = None,
                 on_fail: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        if not goldens:
            raise ValueError("canary needs at least one golden prompt")
        self.submit_fn = submit_fn
        self.goldens = [dict(g) for g in goldens]
        self.interval_s = float(interval_s)
        self.window = max(1, int(window))
        self.history = max(1, int(history))
        self.flight_fn = flight_fn
        self.on_fail = on_fail
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next = 0
        self.probes_sent = 0
        self.probes_passed = 0
        self.probes_failed = 0
        self.last_pass_unix_s: Optional[float] = None
        self.last_ttft_ms: Optional[float] = None
        self.results: list = []       # bounded ring of result dicts
        self._recent: list = []       # bounded pass/fail ring (pass_ratio)
        self._fh = None
        if log_dir:
            from .artifacts import ArtifactWriter

            self._fh = ArtifactWriter(
                os.path.join(log_dir, "canary-results.jsonl")
            )

    # -- probing -------------------------------------------------------------

    def probe_once(self) -> dict:
        """Submit the next golden, verify token-exactness, publish. Never
        raises: a prober crash must not take the router process with it —
        a submit_fn exception IS a failed probe (the service did not
        answer correctly)."""
        with self._lock:
            i = self._next % len(self.goldens)
            self._next += 1
            n = self.probes_sent
            self.probes_sent += 1
        golden = self.goldens[i]
        request_id = f"canary-{n}"
        t = self._clock()
        result = {"t_unix_s": round(t, 3), "request_id": request_id,
                  "golden": i, "replica": None}
        try:
            out = self.submit_fn(golden, request_id) or {}
        except Exception as e:
            out = {"outcome": "error", "error": f"{type(e).__name__}: {e}"}
        result["replica"] = out.get("replica")
        result["outcome"] = out.get("outcome")
        result["ttft_ms"] = out.get("ttft_ms")
        result["e2e_ms"] = out.get("e2e_ms")
        if out.get("error"):
            result["error"] = out["error"]
        got = [int(tok) for tok in (out.get("tokens") or [])]
        expected = golden.get("tokens")
        if out.get("outcome") != "finished":
            passed = False
            result["reason"] = out.get("error") or out.get("shed_reason") \
                or f"outcome={out.get('outcome')}"
        elif expected is None:
            # record mode: the first finished probe defines the golden
            with self._lock:
                golden["tokens"] = got
            passed = True
            result["reason"] = "recorded"
        else:
            expected = [int(tok) for tok in expected]
            passed = got == expected
            if not passed:
                result["expected"] = expected
                result["got"] = got
                diverge = next(
                    (k for k, (a, b) in enumerate(zip(expected, got)) if a != b),
                    min(len(expected), len(got)),
                )
                result["reason"] = f"token mismatch at index {diverge}"
        result["passed"] = passed
        with self._lock:
            if passed:
                self.probes_passed += 1
                self.last_pass_unix_s = t
            else:
                self.probes_failed += 1
            if result.get("ttft_ms") is not None:
                self.last_ttft_ms = result["ttft_ms"]
            self._recent.append(passed)
            if len(self._recent) > self.window:
                del self._recent[: len(self._recent) - self.window]
            self.results.append(result)
            if len(self.results) > self.history:
                del self.results[: len(self.results) - self.history]
            fh = self._fh
        if fh is not None:
            fh.write_line(json.dumps(result))
        if not passed:
            # remediation must not break probing: both hooks best-effort
            if self.on_fail is not None:
                try:
                    self.on_fail(result)
                except Exception:
                    pass
            if self.flight_fn is not None:
                try:
                    self.flight_fn(result["replica"], result)
                except Exception:
                    pass
        return result

    # -- gauges --------------------------------------------------------------

    def pass_ratio(self) -> Optional[float]:
        with self._lock:
            if not self._recent:
                return None
            return sum(1 for p in self._recent if p) / len(self._recent)

    def rollup_keys(self) -> dict:
        """The ``canary/*`` gauge contract (merge policy in
        ``telemetry/fleet.py``: counters sum, ``pass_ratio`` averages,
        ``last_pass_unix_s`` takes the fleet max)."""
        with self._lock:
            out = {
                "canary/probes_sent": self.probes_sent,
                "canary/probes_passed": self.probes_passed,
                "canary/probes_failed": self.probes_failed,
            }
            if self._recent:
                out["canary/pass_ratio"] = round(
                    sum(1 for p in self._recent if p) / len(self._recent), 4
                )
            if self.last_ttft_ms is not None:
                out["canary/e2e_ttft_ms"] = self.last_ttft_ms
            if self.last_pass_unix_s is not None:
                out["canary/last_pass_unix_s"] = round(self.last_pass_unix_s, 3)
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "CanaryProber":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="att-canary", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.probe_once()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self):
        self.stop()
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def load_canary(target: str) -> list:
    """Offline read of ``canary-results.jsonl`` under a telemetry dir —
    the triage data source (which replica served each failing probe, and
    when)."""
    from .artifacts import artifact_files, iter_jsonl

    paths = (artifact_files(target, "canary-results.jsonl")
             if os.path.isdir(target) else artifact_files(target))
    return [rec for rec in iter_jsonl(paths) if "passed" in rec]
