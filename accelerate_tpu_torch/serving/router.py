"""Multi-replica serving router: placement, failover, re-queue.

An own copy of the reference's ``accelerate_tpu/serving/router.py``, but
for how a re-queued request continues (below) and how long a plain JSON
call waits for its answer (:class:`HttpTransport`). One
:class:`~.engine.ServingEngine` process serves one host's devices; a
production deployment is N replica processes behind a front door. This
module is that front door, and its headline property is **robustness**:
kill any replica mid-burst and every request still reaches a definite
outcome, its stream one sequence with no token repeated or skipped.
Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the router runs on a box with no accelerator stack.

- **placement** — least-loaded off the replicas' load-score contract: a
  :class:`~..telemetry.fleet.FleetCollector` polls every replica's
  ``/metrics`` scrape and ``placement_view()`` ranks them by
  ``serving/load_score``; **session affinity** pins a ``session`` id to
  the replica that served it last (its prefix-cache pages make repeat
  TTFT near-zero), falling back to least-loaded — and migrating the
  session's KV through the handoff endpoints — when that replica drains
  or dies.
- **failover + re-queue** — a connection refusal, a read timeout, or a
  stream that ends without a terminal event marks the replica failed
  (excluded immediately, before the health machine's next poll
  confirms) and re-queues the request onto a surviving replica with the
  same ``request_id``, so the per-replica request logs stitch into one
  hop-by-hop timeline.
  A re-queued hop continues the stream rather than replaying it: its
  prompt is the original prompt plus every token already delivered, its
  budget what is left, and ``resumed_tokens`` tells the replica how many
  draws the request's sampling generator has already spent. The client's
  stream is then one sequence, each token drawn from the context the
  client saw, with none repeated or skipped. (The reference replays the
  whole request and skips the delivered prefix, which is exact only when
  the survivor's replay reproduces the dead hop's bits; a survivor with
  other prefix hits or prefill packs can flip a near-tie argmax.)
- **backoff** — capped exponential with deterministic seeded jitter
  (:func:`backoff_schedule`): the schedule is a pure function of
  ``(backoff_seed, request_id)``, so a failing drill replays the exact
  same waits.
- **bounded queues** — admission past ``max_inflight`` sheds with
  ``shed_reason="router_queue_full"`` (a value, not an exception, same
  as the engine's admission control); no-replica and retries-exhausted
  paths shed too. The router never stalls a caller indefinitely.
- **golden signals** — client-observed streaming histograms (TTFT, ITL,
  e2e, queue-wait, placement wall, backoff wait) on the shared
  log-bucket layout (``telemetry/histograms.py``), rendered natively on
  ``/metrics`` so a fleet collector exact-merges them; per-hop timing
  stamps (``place_start``/``connect``/``first_token`` on the router's
  one clock) in the router's request records;
  and a bounded **placement-decision log** (``router-decisions.jsonl``:
  request, candidate scores, chosen replica, affinity reason) answering
  "why was it placed THERE". ``RouterConfig(instrument=False)`` is the
  zero-overhead baseline.
- **elastic membership** — replicas register/deregister at runtime
  (HTTP ``/v1/register`` // ``/v1/deregister`` or
  :meth:`Router.register_replica`); a draining replica takes no new
  placements but stays visible (``placement_view(include_draining=
  True)``) so its in-flight streams finish and its cached KV can be
  exported.

Fault injection: :class:`~.faults.FaultInjector` carries
network-level faults (connection-refused, slow-replica, mid-stream
drop); pass one as ``Router(..., faults=...)`` and the transport layer
consults it — the same seeded injector drives single-engine scheduler
drills and multi-replica kill drills.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..telemetry.fleet import DOWN_STATES, FleetCollector
from ..telemetry.histograms import StreamingHistogram, percentile_keys
from .faults import StreamDropped

# terminal router shed reasons (same bounded-vocabulary contract as the
# engine scheduler's SHED_* constants — dashboards group on these)
SHED_ROUTER_QUEUE_FULL = "router_queue_full"  # max_inflight at submit
SHED_NO_REPLICAS = "no_replicas"              # nothing placeable, ever
SHED_RETRIES_EXHAUSTED = "retries_exhausted"  # every hop failed


def backoff_schedule(seed, request_id, attempts: int, *,
                     base_s: float = 0.05, cap_s: float = 2.0) -> list:
    """The re-queue backoff schedule: capped exponential with
    deterministic seeded jitter. A pure function of
    ``(seed, request_id)`` — the same request under the same router
    config always waits the same intervals, so a failing burst drill is
    a repro, not an anecdote. Jitter spans [0.5x, 1x] of the capped
    exponential term (never zero: a thundering re-queue herd after a
    replica death must decorrelate)."""
    rng = random.Random(f"{seed}/{request_id}")
    out = []
    for i in range(attempts):
        base = min(float(cap_s), float(base_s) * (2.0 ** i))
        out.append(base * (0.5 + 0.5 * rng.random()))
    return out


@dataclass
class RouterConfig:
    """Knobs for :class:`Router` (docs/serving.md has the tuning
    guide)."""

    max_inflight: int = 64            # bounded router queue; past it -> shed
    max_retries: int = 4              # re-queue attempts after the first hop
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    backoff_seed: int = 0
    request_timeout_s: Optional[float] = None  # wall from submit to cancel
    connect_timeout_s: float = 5.0
    read_timeout_s: float = 60.0      # per-read; a silent replica is a failure
    poll_interval_s: float = 0.25     # health/placement scrape cadence
    failure_cooldown_s: float = 10.0  # in-flight failure excludes this long
    affinity: bool = True             # session -> last-replica stickiness
    migrate_session_kv: bool = True   # KV handoff when a session moves
    # -- golden signals (docs/telemetry.md "Router golden signals") --------
    instrument: bool = True           # hop stamps + histograms + decisions
    log_dir: Optional[str] = None     # router-requests.jsonl / router-decisions.jsonl
    decision_log_max: int = 256       # bounded in-memory decision ring
    decision_candidates_max: int = 8  # candidate-score rows kept per decision


@dataclass(eq=False)
class RouterRequest:
    """One logical request and its hop history (``eq=False`` for the
    same identity-not-value reason as the engine's ``Request``). The
    ``request_id`` is stable across hops — every replica's request log
    carries it, which is what makes the re-queue path observable end to
    end."""

    id: object
    prompt: list
    max_new_tokens: int
    seed: int
    session: Optional[str] = None
    tenant: str = "default"
    priority: int = 0

    tokens: list = field(default_factory=list)
    hops: list = field(default_factory=list)   # {replica, t_unix_s, error?}
    replica: Optional[str] = None              # who finished it
    outcome: Optional[str] = None              # finished | shed | cancelled
    finish_reason: Optional[str] = None
    shed_reason: Optional[str] = None
    requeues: int = 0
    prefix_hit: int = 0
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.outcome is not None


class HttpTransport:
    """The stdlib replica transport: JSONL streaming submit plus plain
    JSON POSTs (cancel, KV export/import). Injectable: the router's unit
    tests script a fake; the drills run this one.

    The port's own rule: a plain JSON call connects within the connect
    timeout and then waits up to the read timeout for each read, where
    the reference's waits for its answer only as long as it may take to
    connect. A KV handoff answers once its replica has serialised or
    installed tens of MB (two concurrent 512-token handoffs between
    in-process replicas took 2.1-2.4 s on an H100's host), which a
    loaded host stretches past a 5 s connect timeout; the router then
    dropped a handoff that landed."""

    def __init__(self, *, connect_timeout_s: float = 5.0,
                 read_timeout_s: float = 60.0):
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)

    def _conn(self, base_url: str):
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(base_url)
        if parts.scheme not in ("http", ""):
            raise ValueError(f"replica transport is http-only, got {base_url!r}")
        host = parts.hostname or parts.path.split("/")[0]
        return http.client.HTTPConnection(
            host, parts.port or 80, timeout=self.connect_timeout_s
        )

    def stream_submit(self, base_url: str, payload: dict, *,
                      on_event: Callable[[dict], None]) -> dict:
        """POST ``/v1/submit`` and feed each JSONL event to
        ``on_event``; returns the terminal ``done`` event. EOF before a
        terminal event raises :class:`StreamDropped` — the caller's
        re-queue trigger."""
        conn = self._conn(base_url)
        try:
            body = json.dumps(payload).encode()
            conn.request("POST", "/v1/submit", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise ConnectionError(
                    f"replica {base_url} answered {resp.status} to submit"
                )
            if conn.sock is not None:
                # a replica that stops emitting (wedged, paused mid-kill)
                # is a failure, not a hang: bound every read
                conn.sock.settimeout(self.read_timeout_s)
            while True:
                line = resp.readline()
                if not line:
                    raise StreamDropped(
                        f"stream from {base_url} ended without a terminal event"
                    )
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    # a torn final line IS the mid-write death signature
                    raise StreamDropped(
                        f"torn stream line from {base_url}"
                    ) from None
                on_event(event)
                if event.get("event") == "done":
                    return event
        finally:
            conn.close()

    def _connected(self, base_url: str):
        conn = self._conn(base_url)
        conn.connect()
        conn.sock.settimeout(self.read_timeout_s)
        return conn

    def post_json(self, base_url: str, path: str, payload: dict) -> dict:
        conn = self._connected(base_url)
        try:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                raise ConnectionError(
                    f"replica {base_url}{path} answered {resp.status}: "
                    f"{data[:200]!r}"
                )
            return json.loads(data) if data else {}
        finally:
            conn.close()

    def get_json(self, base_url: str, path: str) -> dict:
        conn = self._connected(base_url)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                raise ConnectionError(
                    f"replica {base_url}{path} answered {resp.status}: "
                    f"{data[:200]!r}"
                )
            return json.loads(data) if data else {}
        finally:
            conn.close()


class Router:
    """Least-loaded + session-affinity placement with failover/re-queue
    over N replica servers. ``replicas`` is ``{name: base_url}`` (or
    ``(name, url)`` pairs); more join/leave at runtime via
    :meth:`register_replica` / :meth:`deregister_replica`.

    ``submit()`` is synchronous (the HTTP front door runs it on its
    handler threads; drills run it on their own): it places, streams,
    and — on a replica failure — re-queues with the failed replica
    excluded, until the request reaches exactly one terminal outcome.
    """

    def __init__(self, replicas=None, *, config: Optional[RouterConfig] = None,
                 transport=None, faults=None, fetch_fn=None,
                 clock: Callable[[], float] = time.time,
                 collector: Optional[FleetCollector] = None):
        self.config = config or RouterConfig()
        self._clock = clock
        pairs = []
        if replicas:
            items = replicas.items() if isinstance(replicas, dict) else replicas
            pairs = [(str(n), str(u).rstrip("/")) for n, u in items]
        self._lock = threading.Lock()
        self._replicas = dict(pairs)           # name -> base_url
        self._sessions: dict = {}              # session -> replica name
        self._failed: dict = {}                # name -> last in-flight failure t
        self._inflight = 0
        self._next_id = 0
        self.transport = transport or HttpTransport(
            connect_timeout_s=self.config.connect_timeout_s,
            read_timeout_s=self.config.read_timeout_s,
        )
        self._faults = faults
        self.canary = None          # optional attached CanaryProber
        self.autoscaler = None      # optional attached Autoscaler
        self.collector = collector or FleetCollector(
            [(n, self._metrics_target(u)) for n, u in pairs],
            poll_interval_s=self.config.poll_interval_s,
            fetch_fn=fetch_fn, clock=clock,
        )
        # counters (the router's own gauge contract, /metrics-rendered)
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_shed = 0
        self.requests_cancelled = 0
        self.requeues = 0           # failed HOPS (a request can add >1)
        self.requests_requeued = 0  # REQUESTS that survived >=1 failed hop
        self.requeue_success = 0    # ...and still finished
        self.kv_migrations = 0
        self.replica_failures: dict = {}       # name -> count
        self.shed_reason_counts: dict = {}     # reason -> count
        # golden signals: client-observed streaming histograms (the same
        # log-bucket layout every session uses, so the fleet collector
        # exact-merges the native /metrics buckets across routers) + the
        # bounded placement-decision ring. config.instrument=False is the
        # zero-overhead baseline.
        self.instrument = bool(self.config.instrument)
        self.hists: dict = {}
        if self.instrument:
            for key in ("router/ttft", "router/itl", "router/e2e",
                        "router/queue_wait", "router/placement",
                        "router/backoff_wait"):
                self.hists[key] = StreamingHistogram()
        self.decisions: list = []   # bounded ring of placement decisions
        self._log_lock = threading.Lock()
        self._decisions_fh = None
        self._requests_fh = None
        if self.config.log_dir and self.instrument:
            from ..telemetry.artifacts import ArtifactWriter

            self._decisions_fh = ArtifactWriter(
                os.path.join(self.config.log_dir, "router-decisions.jsonl")
            )
            self._requests_fh = ArtifactWriter(
                os.path.join(self.config.log_dir, "router-requests.jsonl")
            )

    @staticmethod
    def _metrics_target(base_url: str) -> str:
        return base_url.rstrip("/") + "/metrics"

    # -- membership ---------------------------------------------------------

    def register_replica(self, name: str, base_url: str) -> None:
        """Elastic join: the replica enters placement as soon as its
        first scrape lands (state machine: starting -> healthy)."""
        name, base_url = str(name), str(base_url).rstrip("/")
        with self._lock:
            self._replicas[name] = base_url
            self._failed.pop(name, None)
        self.collector.add_replica(name, self._metrics_target(base_url))

    def deregister_replica(self, name: str) -> bool:
        """Elastic leave: gone from placement immediately. In-flight
        streams on the replica are unaffected (their connections stand);
        sticky sessions fall back to least-loaded on their next
        request."""
        name = str(name)
        with self._lock:
            known = self._replicas.pop(name, None) is not None
            self._failed.pop(name, None)
            for session, replica in list(self._sessions.items()):
                if replica == name:
                    del self._sessions[session]
        self.collector.remove_replica(name)
        return known

    def start(self) -> "Router":
        """Run the health/placement poll on its background cadence."""
        self.collector.start()
        return self

    def close(self):
        if self.autoscaler is not None:
            try:
                self.autoscaler.close()
            except Exception:
                pass
        if self.canary is not None:
            try:
                self.canary.close()
            except Exception:
                pass
        self.collector.close()
        with self._log_lock:
            for fh in (self._decisions_fh, self._requests_fh):
                if fh is not None:
                    try:
                        fh.close()
                    except OSError:
                        pass
            self._decisions_fh = self._requests_fh = None

    # -- golden signals ------------------------------------------------------

    def _observe(self, key: str, seconds: float, exemplar=None):
        h = self.hists.get(key)
        if h is not None:
            h.observe(seconds, exemplar=exemplar)

    @staticmethod
    def _exemplar(req: RouterRequest, replica=None) -> dict:
        ex = {"request_id": req.id}
        replica = replica or getattr(req, "replica", None)
        if replica:
            ex["replica"] = str(replica)
        return ex

    def _note_decision(self, req: RouterRequest, hop_index: int,
                       chosen: str, rows: list, excluded, reason: str,
                       now: float):
        """One placement decision: who won, why, and the candidate-score
        snapshot it won against — the 'why was it placed THERE' record a
        latency regression triage starts from."""
        entry = {
            "t_unix_s": round(now, 3),
            "request_id": req.id,
            "hop": int(hop_index),
            "session": req.session,
            "chosen": chosen,
            "reason": reason,
            "excluded": [str(e) for e in excluded],
            "candidates": [
                {"replica": r.get("replica"),
                 "load_score": r.get("load_score"),
                 "state": r.get("state"),
                 "placeable": bool(r.get("placeable", True))}
                for r in rows[: self.config.decision_candidates_max]
            ],
        }
        with self._log_lock:
            self.decisions.append(entry)
            cap = max(1, int(self.config.decision_log_max))
            if len(self.decisions) > cap:
                del self.decisions[: len(self.decisions) - cap]
            fh = self._decisions_fh
            if fh is not None:
                fh.write_line(json.dumps(entry))

    def _finalize(self, req: RouterRequest):
        """Terminal bookkeeping for every outcome path: the e2e
        histogram and the router request record (the waterfall's
        router-side half)."""
        if not self.instrument:
            return
        if req.finish_t is not None:
            self._observe("router/e2e", max(0.0, req.finish_t - req.submit_t),
                          exemplar=self._exemplar(req))
        fh = self._requests_fh
        if fh is None:
            return
        rec = {
            "request_id": req.id,
            "session": req.session,
            "tenant": req.tenant,
            "submit_unix_s": round(req.submit_t, 6),
            "outcome": req.outcome,
            "finish_reason": req.finish_reason,
            "shed_reason": req.shed_reason,
            "replica": req.replica,
            "tokens": len(req.tokens),
            "requeues": sum(1 for h in req.hops if "error" in h),
            "ttft_ms": (
                round((req.first_token_t - req.submit_t) * 1e3, 3)
                if req.first_token_t is not None else None
            ),
            "e2e_ms": (
                round((req.finish_t - req.submit_t) * 1e3, 3)
                if req.finish_t is not None else None
            ),
            "hops": req.hops,
        }
        with self._log_lock:
            if self._requests_fh is not None:
                self._requests_fh.write_line(json.dumps(rec))

    # -- placement ----------------------------------------------------------

    def _failed_now(self, now: float) -> set:
        with self._lock:
            return {
                n for n, t in self._failed.items()
                if now - t < self.config.failure_cooldown_s
            }

    def _note_failure(self, name: str, now: float):
        with self._lock:
            self._failed[name] = now
            self.replica_failures[name] = self.replica_failures.get(name, 0) + 1

    def candidates(self, session: Optional[str] = None, exclude=()) -> list:
        """Placement order for one hop: the collector's score-ranked
        placeable view, minus excluded/recently-failed replicas, with
        the session's sticky replica promoted to the front when it is
        still placeable. Returns replica names."""
        return self._ranked(session, exclude)[0]

    def _ranked(self, session: Optional[str], exclude=()) -> tuple:
        """``(names, rows, sticky)`` — the ranked placement order plus
        the score rows it was ranked from (the decision log snapshots
        them) and the session's sticky replica (None when absent)."""
        now = self._clock()
        rows = self.collector.placement_view()
        failed = self._failed_now(now)
        with self._lock:
            known = set(self._replicas)
            sticky = self._sessions.get(session) if session else None
        names = [
            r["replica"] for r in rows
            if r["replica"] in known
            and r["replica"] not in exclude
            and r["replica"] not in failed
        ]
        if self.config.affinity and sticky in names:
            names.remove(sticky)
            names.insert(0, sticky)
        return names, rows, sticky

    def _replica_url(self, name: str) -> Optional[str]:
        with self._lock:
            return self._replicas.get(name)

    def _sticky_source(self, session: Optional[str], target: str):
        """(name, url) of the session's previous replica when the
        session is migrating off it and its KV may still be exportable
        (reachable or draining — NOT dead), else None."""
        if not session or not self.config.migrate_session_kv:
            return None
        with self._lock:
            sticky = self._sessions.get(session)
            url = self._replicas.get(sticky) if sticky else None
        if sticky is None or sticky == target or url is None:
            return None
        for row in self.collector.placement_view(include_unplaceable=True):
            if row["replica"] != sticky:
                continue
            if row["state"] in DOWN_STATES:
                return None
            return sticky, url
        return None

    def _migrate_session_kv(self, req: RouterRequest, target: str,
                            target_url: str):
        """Best-effort KV handoff when a sticky session moves: export
        the prompt's cached pages from the old replica, import into the
        new one, so the migrated session's next admission is still a
        prefix hit. Failure is absorbed — the request just pays a cold
        prefill."""
        src = self._sticky_source(req.session, target)
        if src is None:
            return
        src_name, src_url = src
        try:
            handoff = self.transport.post_json(
                src_url, "/v1/kv/export", {"tokens": list(req.prompt)}
            )
            if handoff and handoff.get("n_pages"):
                out = self.transport.post_json(
                    target_url, "/v1/kv/import", handoff
                )
                if out.get("installed_tokens"):
                    with self._lock:
                        self.kv_migrations += 1
                    req.hops.append({
                        "replica": target, "t_unix_s": round(self._clock(), 3),
                        "kv_migrated_from": src_name,
                        "kv_tokens": int(out["installed_tokens"]),
                    })
        except (OSError, ConnectionError, ValueError):
            pass

    def kv_directory(self) -> dict:
        """Merged prefix directory across every reachable replica — the
        fleet's advertised warm-KV inventory (the peer tier's discovery
        contract, ``docs/serving.md``). Each digest maps to its longest
        advertised prefix and the replicas holding it; an unreachable
        replica is simply absent (a directory is a hint, never truth —
        the pull itself re-validates)."""
        with self._lock:
            replicas = dict(self._replicas)
        merged: dict = {}
        for name, url in replicas.items():
            try:
                doc = self.transport.get_json(url, "/v1/kv/directory")
            except (OSError, ConnectionError, ValueError):
                continue
            for row in (doc or {}).get("prefixes") or []:
                if not isinstance(row, dict) or not row.get("digest"):
                    continue
                d = str(row["digest"])
                cur = merged.setdefault(
                    d, {"digest": d, "token_len": 0, "replicas": []}
                )
                cur["token_len"] = max(
                    cur["token_len"], int(row.get("token_len") or 0)
                )
                cur["replicas"].append(name)
        return {"version": 1, "prefixes": sorted(
            merged.values(), key=lambda r: r["digest"]
        )}

    # -- the request path ---------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int = 32, seed: int = 0,
               session: Optional[str] = None, tenant: str = "default",
               priority: int = 0, request_id=None,
               timeout_s: Optional[float] = None,
               on_token: Optional[Callable] = None) -> RouterRequest:
        """Route one request to completion. Returns the terminal
        :class:`RouterRequest` — outcome ``finished``, ``shed`` (with
        ``shed_reason``), or ``cancelled`` (timeout); never raises for a
        replica-side failure and never hangs (bounded retries, bounded
        waits). ``on_token(token, req)`` fires once per emitted token
        across all hops — a re-queued hop continues from the tokens
        already delivered, so none is emitted twice."""
        with self._lock:
            self.requests_submitted += 1
            if request_id is None:
                request_id = f"r{self._next_id}"
                self._next_id += 1
            admitted = self._inflight < max(0, int(self.config.max_inflight))
            if admitted:
                self._inflight += 1
        req = RouterRequest(
            id=request_id, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), seed=int(seed),
            session=session, tenant=str(tenant or "default"),
            priority=int(priority),
        )
        req.submit_t = self._clock()
        if not admitted:
            self._shed(req, SHED_ROUTER_QUEUE_FULL)
            return req
        try:
            self._route(req, timeout_s, on_token)
        finally:
            with self._lock:
                self._inflight -= 1
        return req

    def _shed(self, req: RouterRequest, reason: str):
        req.outcome = "shed"
        req.finish_reason = "shed"
        req.shed_reason = reason
        req.finish_t = self._clock()
        with self._lock:
            self.requests_shed += 1
            self.shed_reason_counts[reason] = (
                self.shed_reason_counts.get(reason, 0) + 1
            )
            if any("error" in h for h in req.hops):
                self.requests_requeued += 1
        self._finalize(req)

    def _deadline(self, req: RouterRequest, timeout_s) -> Optional[float]:
        timeout_s = timeout_s if timeout_s is not None \
            else self.config.request_timeout_s
        return req.submit_t + timeout_s if timeout_s is not None else None

    def _backoff_sleep(self, seconds: float) -> float:
        """One backoff wait, measured (the waterfall's retry_backoff
        stage and the ``router/backoff_wait`` histogram both come from
        the measured wall, not the nominal schedule)."""
        t0 = self._clock()
        time.sleep(seconds)
        waited = max(0.0, self._clock() - t0)
        self._observe("router/backoff_wait", waited)
        return waited

    def _route(self, req: RouterRequest, timeout_s, on_token):
        cfg = self.config
        delays = backoff_schedule(
            cfg.backoff_seed, req.id, cfg.max_retries + 1,
            base_s=cfg.backoff_base_s, cap_s=cfg.backoff_cap_s,
        )
        deadline = self._deadline(req, timeout_s)
        excluded: list = []
        failures = 0
        queued = False        # router/queue_wait observed yet?
        backoff_pending = 0.0  # waits since the last hop (stamped on the next)
        while True:
            now = self._clock()
            if deadline is not None and now >= deadline:
                req.outcome = "cancelled"
                req.finish_reason = "timeout"
                req.finish_t = now
                with self._lock:
                    self.requests_cancelled += 1
                    if any("error" in h for h in req.hops):
                        self.requests_requeued += 1
                self._finalize(req)
                return
            place_start = now
            if not queued:
                queued = True
                self._observe("router/queue_wait",
                              max(0.0, place_start - req.submit_t),
                              exemplar=self._exemplar(req))
            names, rows, sticky = self._ranked(req.session, exclude=excluded)
            place_end = self._clock()
            self._observe("router/placement", max(0.0, place_end - place_start),
                          exemplar=self._exemplar(req))
            if not names:
                with self._lock:
                    any_known = bool(self._replicas)
                if not any_known or failures > cfg.max_retries:
                    # keyed on the hop history, not the (clearable)
                    # exclusion list: a request whose hops failed is
                    # retries_exhausted even after an exclusion reset
                    self._shed(
                        req,
                        SHED_RETRIES_EXHAUSTED
                        if any("error" in h for h in req.hops)
                        else SHED_NO_REPLICAS,
                    )
                    return
                # replicas exist but none is placeable right now (all
                # excluded / scrapes pending): back off, refresh health,
                # then drop the per-request exclusions — the fleet view
                # has caught up, so a genuinely-bad replica stays out
                # via its health state / failure cooldown while a
                # recovered one becomes retryable again
                backoff_pending += self._backoff_sleep(
                    delays[min(failures, len(delays) - 1)]
                )
                failures += 1
                self.collector.poll_once()
                del excluded[:]
                continue
            target = names[0]
            url = self._replica_url(target)
            if url is None:
                excluded.append(target)
                continue
            if self.instrument:
                self._note_decision(
                    req, len(req.hops), target, rows, excluded,
                    "affinity" if (cfg.affinity and target == sticky)
                    else "least_loaded",
                    place_end,
                )
            if req.prompt and not req.tokens:
                self._migrate_session_kv(req, target, url)
            hop = {"replica": target, "t_unix_s": round(self._clock(), 3)}
            if self.instrument:
                # the waterfall's router-side stamps: one clock, so the
                # stage math is pure timestamp differences (waterfall.py)
                hop["place_start_unix_s"] = round(place_start, 6)
                hop["placement_ms"] = round((place_end - place_start) * 1e3, 3)
                if backoff_pending:
                    hop["backoff_before_ms"] = round(backoff_pending * 1e3, 3)
                backoff_pending = 0.0
            req.hops.append(hop)
            resumed = len(req.tokens)
            try:
                if self._faults is not None:
                    self._faults.before_connect(target)
                if self.instrument:
                    hop["connect_unix_s"] = round(self._clock(), 6)
                done = self.transport.stream_submit(
                    url, self._hop_payload(req, deadline),
                    on_event=lambda evt: self._on_event(
                        req, target, hop, evt, on_token, resumed
                    ),
                )
            except (OSError, ConnectionError, StreamDropped) as e:
                hop["error"] = f"{type(e).__name__}: {e}"
                self._note_failure(target, self._clock())
                excluded.append(target)
                failures += 1
                with self._lock:
                    self.requeues += 1
                if len(req.tokens) < req.max_new_tokens:
                    if failures > cfg.max_retries:
                        self._shed(req, SHED_RETRIES_EXHAUSTED)
                        return
                    backoff_pending += self._backoff_sleep(
                        delays[min(failures - 1, len(delays) - 1)]
                    )
                    continue
                # every token reached the client before the stream broke:
                # nothing is left to continue
                done = {"outcome": "finished", "finish_reason": "budget"}
            # terminal event from the replica
            if self.instrument:
                hop["done_unix_s"] = round(self._clock(), 6)
            outcome = str(done.get("outcome") or "finished")
            if outcome == "shed" and done.get("shed_reason") == "draining":
                # the replica started draining between the scrape and our
                # connect: not a failure, just not placeable — try the
                # next one without burning a failure budget slot
                hop["error"] = "shed: draining"
                excluded.append(target)
                continue
            req.replica = target
            req.outcome = outcome
            req.finish_reason = done.get("finish_reason")
            req.shed_reason = done.get("shed_reason")
            req.prefix_hit = int(done.get("prefix_hit") or 0)
            req.finish_t = self._clock()
            with self._lock:
                crossed_failure = any("error" in h for h in req.hops[:-1])
                if crossed_failure:
                    self.requests_requeued += 1
                if outcome == "finished":
                    self.requests_completed += 1
                    if crossed_failure:
                        # survived >=1 failed hop AND finished: the
                        # numerator of router_requeue_success_rate
                        self.requeue_success += 1
                elif outcome == "shed":
                    self.requests_shed += 1
                    self.shed_reason_counts[str(req.shed_reason)] = (
                        self.shed_reason_counts.get(str(req.shed_reason), 0) + 1
                    )
                else:
                    self.requests_cancelled += 1
                if req.session and outcome == "finished":
                    self._sessions[req.session] = target
            self._finalize(req)
            return

    def _hop_payload(self, req: RouterRequest,
                     deadline: Optional[float]) -> dict:
        # a re-queued hop continues the stream: the tokens already
        # delivered join the prompt and leave the budget
        delivered = [int(t) for t in req.tokens]
        payload = {
            "prompt": req.prompt + delivered,
            "max_new_tokens": req.max_new_tokens - len(delivered),
            "seed": req.seed,
            "tenant": req.tenant,
            "priority": req.priority,
            "request_id": req.id,
            "stream": True,
        }
        if delivered:
            payload["resumed_tokens"] = len(delivered)
        if deadline is not None:
            # enforce the wall INSIDE the hop too: the replica's own
            # timeout path cancels mid-stream (terminal event outcome
            # "cancelled"), so a healthy-but-slow stream cannot outlive
            # the caller's budget between the router's loop-top checks
            payload["timeout_s"] = max(0.05, deadline - self._clock())
        return payload

    def _on_event(self, req: RouterRequest, replica: str, hop: dict,
                  event: dict, on_token, resumed: int):
        if self._faults is not None and event.get("event") == "token":
            self._faults.on_stream_event(replica, int(event.get("i", 0)))
        now = self._clock()
        if self.instrument and "first_byte_unix_s" not in hop:
            hop["first_byte_unix_s"] = round(now, 6)
        if event.get("event") != "token":
            return
        # the hop's stream counts from the tokens it resumed after
        if resumed + int(event["i"]) < len(req.tokens):
            return  # already delivered
        token = int(event["token"])
        req.tokens.append(token)
        if req.first_token_t is None:
            # client-observed TTFT: submit at the router to first NEW
            # token back at the router — the number the user felt
            req.first_token_t = now
            if self.instrument:
                hop["first_token_unix_s"] = round(now, 6)
                self._observe("router/ttft", max(0.0, now - req.submit_t),
                              exemplar=self._exemplar(req, hop.get("replica")))
        elif req.last_token_t is not None:
            self._observe("router/itl", max(0.0, now - req.last_token_t),
                          exemplar=self._exemplar(req, hop.get("replica")))
        req.last_token_t = now
        if on_token is not None:
            on_token(token, req)

    # -- introspection ------------------------------------------------------

    def placement(self, include_draining: bool = True) -> list:
        """The ranked placement snapshot the router is acting on (see
        ``FleetCollector.placement_view``; draining replicas included by
        default — they still serve their in-flight streams)."""
        return self.collector.placement_view(include_draining=include_draining)

    def metrics(self) -> dict:
        with self._lock:
            out = {
                "router/replicas": len(self._replicas),
                "router/inflight": self._inflight,
                "router/requests_submitted": self.requests_submitted,
                "router/requests_completed": self.requests_completed,
                "router/requests_shed": self.requests_shed,
                "router/requests_cancelled": self.requests_cancelled,
                "router/requeues": self.requeues,
                "router/requests_requeued": self.requests_requeued,
                "router/requeue_success": self.requeue_success,
                "router/kv_migrations": self.kv_migrations,
                "router/sessions": len(self._sessions),
            }
            for name, n in sorted(self.replica_failures.items()):
                out[f"router/failures/{name}"] = n
            for reason, n in sorted(self.shed_reason_counts.items()):
                out[f"router/shed/{reason}"] = n
        # golden-signal percentiles ride the rollup the same way the
        # engine's serving/* histograms do (the native buckets are also
        # exposed on /metrics, so the fleet collector exact-merges them)
        for name, hist in self.hists.items():
            out.update(percentile_keys(name, hist))
        if self.canary is not None:
            try:
                out.update(self.canary.rollup_keys())
            except Exception:
                pass  # a sick prober must not fail the scrape
        if self.autoscaler is not None:
            try:
                out.update(self.autoscaler.rollup_keys())
            except Exception:
                pass  # same contract as the prober
        return out

    def attach_canary(self, prober) -> "Router":
        """Publish an attached :class:`~..telemetry.canary.CanaryProber`'s
        ``canary/*`` gauges through this router's ``/metrics`` (the
        prober's lifecycle joins ``close()``)."""
        self.canary = prober
        return self

    def attach_autoscaler(self, autoscaler) -> "Router":
        """Publish an attached :class:`~.autoscaler.Autoscaler`'s
        ``autoscale/*`` gauges through this router's ``/metrics`` (its
        lifecycle joins ``close()``)."""
        self.autoscaler = autoscaler
        return self


class _RouterMetricsSession:
    """`prometheus_text` shim over the router's counters (the same
    pattern as the replica server's engine-gauges shim)."""

    def __init__(self, router: Router):
        self.router = router
        # the golden-signal histograms render natively (_bucket{le=...})
        # so a FleetCollector scraping N routers exact-merges quantiles
        self.hists = router.hists
        self.alerts = None
        self.last_sample_unix_s = None  # counters are live, not sampled

    def rollup(self) -> dict:
        return self.router.metrics()


class RouterServer:
    """The stdlib-HTTP/JSONL front door over a :class:`Router`:

    - ``POST /v1/submit`` — body ``{prompt, max_new_tokens, seed,
      session?, tenant?, priority?, request_id?, timeout_s?}``; streams
      ``{"event": "token", ...}`` JSONL lines and one terminal
      ``{"event": "done", ...}`` (failover happens underneath — the
      client sees one uninterrupted stream, continued on the survivor);
    - ``POST /v1/register`` / ``POST /v1/deregister`` — elastic replica
      membership (``{name, url}`` / ``{name}``);
    - ``GET /v1/placement`` — the ranked placement snapshot (JSON);
    - ``GET /metrics`` — the router's own counters as Prometheus text.
    """

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 0):
        import http.server

        from ..telemetry.exporter import http_server

        self.router = router
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            timeout = 30.0

            def do_GET(self):  # noqa: N802 (stdlib casing)
                server._get(self)

            def do_POST(self):  # noqa: N802
                server._post(self)

            def log_message(self, *args):
                pass

        self.httpd = http_server((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="att-router", daemon=True
        )
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5.0)

    # -- handlers (each runs on its own daemon thread) ----------------------

    @staticmethod
    def _read_json(handler) -> dict:
        n = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(n) if n else b"{}"
        return json.loads(body or b"{}")

    @staticmethod
    def _send_json(handler, payload: dict, status: int = 200):
        body = json.dumps(payload).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _get(self, handler):
        if handler.path == "/v1/placement":
            self._send_json(handler, {"placement": self.router.placement()})
        elif handler.path == "/v1/kv/directory":
            self._send_json(handler, self.router.kv_directory())
        elif handler.path in ("/metrics", "/"):
            # ride THE exposition renderer (telemetry/exporter) through a
            # rollup shim, not a hand-rolled formatter: name sanitization
            # and format fixes must live in exactly one place
            from ..telemetry.exporter import prometheus_text

            body = prometheus_text(_RouterMetricsSession(self.router)).encode()
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        else:
            handler.send_error(404)

    def _post(self, handler):
        try:
            body = self._read_json(handler)
        except ValueError:
            handler.send_error(400, "bad json")
            return
        if handler.path == "/v1/register":
            self.router.register_replica(body["name"], body["url"])
            self._send_json(handler, {"ok": True})
        elif handler.path == "/v1/deregister":
            known = self.router.deregister_replica(body.get("name", ""))
            self._send_json(handler, {"ok": True, "known": known})
        elif handler.path == "/v1/submit":
            self._submit(handler, body)
        else:
            handler.send_error(404)

    def _submit(self, handler, body: dict):
        handler.send_response(200)
        handler.send_header("Content-Type", "application/jsonl")
        handler.end_headers()
        client_gone = []

        def emit(evt: dict):
            # a vanished client must not read as a REPLICA failure (the
            # hop keeps finishing replica-side); swallow and stop writing
            if client_gone:
                return
            try:
                handler.wfile.write((json.dumps(evt) + "\n").encode())
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                client_gone.append(True)

        def on_token(token, req):
            emit({"event": "token", "i": len(req.tokens) - 1, "token": token,
                  "request_id": req.id})

        req = self.router.submit(
            [int(t) for t in body.get("prompt") or []],
            max_new_tokens=int(body.get("max_new_tokens") or 32),
            seed=int(body.get("seed") or 0),
            session=body.get("session"),
            tenant=str(body.get("tenant") or "default"),
            priority=int(body.get("priority") or 0),
            request_id=body.get("request_id"),
            timeout_s=body.get("timeout_s"),
            on_token=on_token,
        )
        emit({
            "event": "done", "request_id": req.id,
            "outcome": req.outcome, "finish_reason": req.finish_reason,
            "shed_reason": req.shed_reason, "replica": req.replica,
            "requeues": sum(1 for h in req.hops if "error" in h),
            "hops": req.hops, "tokens": req.tokens,
            "prefix_hit": req.prefix_hit,
        })
