"""Deterministic workload replay plane: the seeded load generator.

An own copy of the reference's ``accelerate_tpu/serving/loadgen.py``: the
same spec gives the same schedule digest on either side, so a workload
file drives the reference and the port alike.

Serving claims are worthless without replayable ground truth. This
module generates *traffic* the way the rest of
the repo generates *programs*: seeded, deterministic, and replayable —
``build_schedule(spec)`` is a pure function of a :class:`WorkloadSpec`,
so the same seed yields a byte-identical request schedule
(:func:`schedule_digest` is the witness) on any host, any day, with no
wall-clock dependence. Runs target three tiers through one entry point:

- a bare :class:`~.engine.ServingEngine` (in-process, single-threaded —
  the tier-1 drill path),
- a :class:`~.replica_server.ReplicaServer` **URL** (stdlib-HTTP/JSONL,
  one thread per in-flight request),
- the :class:`~.router.Router` front door (synchronous ``submit``, so
  concurrency is caller threads — same as the failover drills).

Two traffic shapes:

- **open loop** arrivals ignore completions: Poisson (``expovariate``
  gaps at ``rate_rps``), bursty (``burst_size`` simultaneous arrivals
  per gap), a **ramp** (rate interpolates linearly across the run — the
  saturation sweep's single-run cousin), or **diurnal** (a sinusoid over
  ``period_s`` modulating any of the other processes — the autoscaler
  drill's traffic shape: load that swells past capacity and recedes).
- **closed loop**: ``users`` concurrent users, each submitting its next
  request only after the previous finished plus a drawn think time —
  the arrival rate self-regulates to the service rate, which is what
  makes conservation drills terminate.

Multi-tenant mixes draw each request group's tenant by weight, with
per-tenant prompt/output length distributions, and *session* groups
model multi-turn conversations whose turn ``k`` prompt is turn ``k-1``'s
prompt plus fresh tokens — growing shared prefixes, the exact shape that
exercises the ``PrefixCache``, router session affinity, and KV handoff.

The run returns (and optionally writes, ``loadtest-offered.json``) the
**offered-load record**: one entry per scheduled request with outcome,
client-observed TTFT/ITL/E2E, and the schedule digest —
``telemetry/scorecard.py`` joins it with the server-side artifacts into
the SLO scorecard. ``instrument=False`` drops the per-token callbacks
and timing capture (the ≥0.7x zero-overhead witness baseline).

No torch (a CPU test imports it with torch blocked; numpy stays, for the
prompts): a load box with no accelerator stack replays the same spec.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import math
import random
import threading
import time
import urllib.parse
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from .faults import FaultInjector

# -- workload spec ----------------------------------------------------------

#: JSON-friendly length/time distributions: ``{"fixed": 8}``,
#: ``{"uniform": [lo, hi]}`` (inclusive ints), ``{"choice": [a, b, c]}``.
def _draw(rng: random.Random, dist, lo: int = 1) -> float:
    if isinstance(dist, (int, float)):
        return dist
    if "fixed" in dist:
        return dist["fixed"]
    if "uniform" in dist:
        a, b = dist["uniform"]
        if isinstance(a, float) or isinstance(b, float):
            return rng.uniform(a, b)
        return rng.randint(int(a), int(b))
    if "choice" in dist:
        return rng.choice(list(dist["choice"]))
    raise ValueError(f"unknown distribution {dist!r}")


def _draw_len(rng: random.Random, dist, lo: int = 1) -> int:
    return max(lo, int(_draw(rng, dist, lo)))


@dataclass
class TenantSpec:
    """One tenant's slice of the traffic mix."""

    name: str
    weight: float = 1.0
    priority: int = 0
    prompt_len: dict = field(default_factory=lambda: {"uniform": [8, 24]})
    max_new_tokens: dict = field(default_factory=lambda: {"fixed": 8})
    #: probability a request group is a multi-turn session
    session_prob: float = 0.0
    session_turns: dict = field(default_factory=lambda: {"uniform": [2, 4]})
    #: tokens appended to the shared prefix per follow-up turn
    turn_growth: dict = field(default_factory=lambda: {"uniform": [4, 12]})
    #: open loop: gap between a session's turns; closed loop: think time
    #: before each follow-up request
    think_time_s: dict = field(default_factory=lambda: {"fixed": 0.0})


@dataclass
class WorkloadSpec:
    """The replayable workload description (JSON round-trippable — the
    format the drills and ``python -m accelerate_tpu_torch.commands.loadtest``
    share, and the reference's ``tests/workload_canonical.json`` uses)."""

    name: str = "workload"
    seed: int = 0
    mode: str = "open"                 # open | closed
    num_requests: int = 64
    #: open loop: {"process": "poisson"|"burst"|"ramp"|"diurnal",
    #: "rate_rps": r, "burst_size": k, "rate_rps_to": r2}; diurnal
    #: modulates a "base" process ("poisson"|"burst"|"ramp", default
    #: poisson) by 1 + amplitude*sin(2*pi*t/period_s), with
    #: "period_s" (default 60) and "amplitude" in [0, 1) (default 0.5)
    arrival: dict = field(default_factory=lambda: {
        "process": "poisson", "rate_rps": 32.0,
    })
    users: int = 4                     # closed loop concurrency
    vocab_size: int = 256
    #: cap on any generated prompt length (sessions stop growing here);
    #: keep <= target max_cache_len - max_new_tokens
    prompt_cap: int = 96
    tenants: list = field(default_factory=lambda: [TenantSpec("default")])
    #: SLO targets the scorecard grades against (overridable per run)
    slo: dict = field(default_factory=lambda: {
        "ttft_ms": 1000.0, "itl_ms": 100.0,
    })

    def __post_init__(self):
        if self.mode not in ("open", "closed"):
            raise ValueError(f"mode must be open|closed, got {self.mode!r}")
        self.tenants = [
            t if isinstance(t, TenantSpec) else TenantSpec(**t)
            for t in self.tenants
        ]
        if not self.tenants:
            raise ValueError("workload needs at least one tenant")

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "WorkloadSpec":
        return cls(**doc)

    @classmethod
    def load(cls, path: str) -> "WorkloadSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


# -- schedule generation (pure function of the spec) ------------------------


@dataclass
class ScheduledRequest:
    index: int            # position in the final (time-sorted) schedule
    at_s: float           # open loop: arrival offset from run start
    user: int             # closed loop: issuing user
    tenant: str
    priority: int
    session: Optional[str]
    turn: int
    think_s: float        # closed loop: pause before this request
    prompt: np.ndarray    # int32 token ids
    max_new_tokens: int
    seed: int             # per-request decode seed

    @property
    def request_id(self) -> str:
        return f"lg{self.seed & 0xffff:04x}-{self.index}"


def _arrival_gaps(rng: random.Random, arrival: dict, i: int, n: int,
                  t: float = 0.0) -> float:
    """Gap before arrival-group ``i`` of ``n`` under the arrival spec.
    ``t`` is the schedule clock so far (schedule time, not wall time —
    determinism holds); only ``diurnal`` reads it."""
    process = arrival.get("process", "poisson")
    rate = float(arrival.get("rate_rps", 32.0))
    if process == "poisson":
        return rng.expovariate(rate)
    if process == "burst":
        k = max(1, int(arrival.get("burst_size", 4)))
        # k groups arrive together, then the gap that keeps the mean rate
        return rng.expovariate(rate / k) if i % k == 0 else 0.0
    if process == "ramp":
        r2 = float(arrival.get("rate_rps_to", rate * 4))
        frac = i / max(1, n - 1)
        return rng.expovariate(rate + (r2 - rate) * frac)
    if process == "diurnal":
        # sinusoidal rate modulation composed with a base process: the
        # base draws its gap (identical rng consumption → composable
        # determinism), then the gap stretches/compresses by the local
        # rate multiplier at schedule time t
        base = dict(arrival)
        base["process"] = str(arrival.get("base", "poisson"))
        if base["process"] == "diurnal":
            raise ValueError("diurnal cannot compose with itself")
        period = max(1e-6, float(arrival.get("period_s", 60.0)))
        amp = min(0.99, max(0.0, float(arrival.get("amplitude", 0.5))))
        mod = 1.0 + amp * math.sin(2.0 * math.pi * t / period)
        return _arrival_gaps(rng, base, i, n) / max(1e-3, mod)
    raise ValueError(f"unknown arrival process {process!r}")


def build_schedule(spec: WorkloadSpec) -> list:
    """The full request schedule — a pure function of the spec: one
    ``random.Random(spec.seed)`` drives every draw in a fixed order, so
    the same seed is byte-identical (:func:`schedule_digest`) across
    runs, hosts, and targets. No wall clock anywhere."""
    rng = random.Random(spec.seed)
    weights = [max(0.0, float(t.weight)) for t in spec.tenants]
    out: list = []
    t_clock = 0.0
    group = 0
    user = 0
    while len(out) < spec.num_requests:
        t_clock += _arrival_gaps(rng, spec.arrival, group, spec.num_requests,
                                 t=t_clock)
        tenant = rng.choices(spec.tenants, weights=weights)[0]
        turns = 1
        session = None
        if tenant.session_prob > 0 and rng.random() < tenant.session_prob:
            turns = _draw_len(rng, tenant.session_turns, lo=1)
            session = f"s{spec.seed}-{group}"
        prompt = np.asarray(
            [rng.randrange(3, spec.vocab_size) for _ in
             range(_draw_len(rng, tenant.prompt_len))],
            np.int32,
        )
        at = t_clock
        for turn in range(turns):
            think = 0.0
            if turn:
                grow = _draw_len(rng, tenant.turn_growth)
                if prompt.size < spec.prompt_cap:
                    fresh = [rng.randrange(3, spec.vocab_size)
                             for _ in range(grow)]
                    prompt = np.concatenate(
                        [prompt, np.asarray(fresh, np.int32)]
                    )
                think = max(0.0, float(_draw(rng, tenant.think_time_s)))
                at += think
            prompt = prompt[: spec.prompt_cap]
            out.append(ScheduledRequest(
                index=-1, at_s=round(at, 9), user=user, tenant=tenant.name,
                priority=int(tenant.priority), session=session, turn=turn,
                think_s=round(think, 9), prompt=prompt.copy(),
                max_new_tokens=_draw_len(rng, tenant.max_new_tokens),
                seed=rng.randrange(1 << 31),
            ))
        group += 1
        user = (user + 1) % max(1, int(spec.users))
    out = out[: spec.num_requests]
    if spec.mode == "open":
        # stable sort: a session's turns keep their order at equal times
        out.sort(key=lambda s: s.at_s)
    for i, s in enumerate(out):
        s.index = i
    return out


def schedule_digest(schedule: list) -> str:
    """Canonical digest of a schedule — the byte-identity witness the
    determinism tests (and ``loadtest replay``) compare."""
    h = hashlib.blake2b(digest_size=16)
    for s in schedule:
        h.update((
            f"{s.index}|{s.at_s:.9f}|{s.user}|{s.tenant}|{s.priority}|"
            f"{s.session}|{s.turn}|{s.think_s:.9f}|{s.max_new_tokens}|"
            f"{s.seed}|"
        ).encode())
        h.update(np.ascontiguousarray(s.prompt, np.int32).tobytes())
    return h.hexdigest()


def paired_drill(seed: int, spec: WorkloadSpec):
    """One seed pair -> (workload, fault injector): a fault drill and
    its traffic reproduce together (storm drills ride this instead of
    hand-rolled submit loops)."""
    import dataclasses

    return (
        dataclasses.replace(spec, seed=int(seed)),
        FaultInjector(seed=int(seed)),
    )


def submit_burst(engine, spec: WorkloadSpec) -> list:
    """Submit a spec's entire schedule into a bare engine immediately
    (arrival offsets ignored) and return the live request handles — the
    storm-drill ``fire=`` helper: deterministic burst traffic from the
    same seed that drives the :class:`~.faults.FaultInjector`."""
    return [
        engine.submit(
            s.prompt, max_new_tokens=s.max_new_tokens, seed=s.seed,
            tenant=s.tenant, priority=s.priority, request_id=s.request_id,
        )
        for s in build_schedule(spec)
    ]


# -- offered-load record ----------------------------------------------------


@dataclass
class LoadgenResult:
    """What one run offered and what came back — the scorecard's primary
    input. ``records``: one JSON-safe dict per scheduled request."""

    spec: dict
    records: list
    wall_s: float
    digest: str
    target: str = "engine"

    def counts(self) -> dict:
        c = {"offered": len(self.records), "finished": 0, "shed": 0,
             "cancelled": 0, "in_flight": 0, "tokens_out": 0}
        for r in self.records:
            out = r.get("outcome")
            if out in ("finished", "shed", "cancelled"):
                c[out] += 1
            else:
                c["in_flight"] += 1
            c["tokens_out"] += int(r.get("tokens_out") or 0)
        return c

    @property
    def tokens_per_s(self) -> float:
        return self.counts()["tokens_out"] / self.wall_s if self.wall_s > 1e-9 else 0.0

    def to_json(self) -> dict:
        return {"spec": self.spec, "records": self.records,
                "wall_s": self.wall_s, "digest": self.digest,
                "target": self.target}

    def write(self, out_dir: str) -> str:
        import os

        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "loadtest-offered.json")
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def load_offered(target: str) -> Optional[LoadgenResult]:
    """Read ``loadtest-offered.json`` from a file or artifact dir."""
    import os

    path = target
    if os.path.isdir(target):
        path = os.path.join(target, "loadtest-offered.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    return LoadgenResult(
        spec=doc.get("spec") or {}, records=doc.get("records") or [],
        wall_s=float(doc.get("wall_s") or 0.0),
        digest=doc.get("digest") or "", target=doc.get("target") or "?",
    )


class _Capture:
    """Per-request client-side observation (token timestamps when
    instrumented; outcome mapping either way)."""

    __slots__ = ("sched", "submit_t", "token_t", "handle")

    def __init__(self, sched: ScheduledRequest):
        self.sched = sched
        self.submit_t: float = 0.0
        self.token_t: list = []
        self.handle = None

    def on_token(self, _tok, _req=None):
        self.token_t.append(time.monotonic())

    def record(self, t0: float, *, outcome, finish_reason=None,
               shed_reason=None, tokens_out=0, replica=None,
               first_token_t=None, finish_t=None,
               instrument=True) -> dict:
        s = self.sched
        rec = {
            "index": s.index, "request_id": s.request_id,
            "tenant": s.tenant, "session": s.session, "turn": s.turn,
            "prompt_len": int(s.prompt.size),
            "max_new_tokens": s.max_new_tokens,
            "offered_t_s": s.at_s,
            "outcome": outcome, "finish_reason": finish_reason,
            "shed_reason": shed_reason, "tokens_out": int(tokens_out),
            "replica": replica,
        }
        if not instrument:
            return rec
        rec["submit_t_s"] = round(self.submit_t - t0, 6)
        first = self.token_t[0] if self.token_t else first_token_t
        last = finish_t if finish_t is not None else (
            self.token_t[-1] if self.token_t else None
        )
        if first is not None and self.submit_t:
            rec["ttft_ms"] = round(1e3 * (first - self.submit_t), 3)
        if last is not None and self.submit_t:
            rec["e2e_ms"] = round(1e3 * (last - self.submit_t), 3)
        if len(self.token_t) > 1:
            ts = self.token_t
            rec["itl_ms"] = [
                round(1e3 * (b - a), 3) for a, b in zip(ts, ts[1:])
            ]
        return rec


# -- runners ----------------------------------------------------------------


def run(spec: WorkloadSpec, target, *, instrument: bool = True,
        time_scale: float = 1.0, timeout_s: float = 120.0,
        max_concurrency: int = 32) -> LoadgenResult:
    """Replay ``spec`` against ``target`` and return the offered-load
    record. ``target`` is a bare engine (has ``step``), a router
    (``submit`` but no ``step``), or a replica/router-server base URL
    string. ``time_scale`` stretches/compresses the schedule's arrival
    offsets (0 = as fast as possible); ``instrument=False`` is the
    zero-overhead witness baseline (outcomes only, no token callbacks)."""
    schedule = build_schedule(spec)
    digest = schedule_digest(schedule)
    t0 = time.monotonic()
    if isinstance(target, str):
        records = _run_url(spec, schedule, target, instrument, time_scale,
                           timeout_s, max_concurrency)
        kind = "url"
    elif hasattr(target, "step"):
        records = _run_engine(spec, schedule, target, instrument,
                              time_scale, timeout_s)
        kind = "engine"
    elif hasattr(target, "submit"):
        records = _run_router(spec, schedule, target, instrument,
                              time_scale, timeout_s, max_concurrency)
        kind = "router"
    else:
        raise TypeError(f"unsupported loadgen target {target!r}")
    wall = time.monotonic() - t0
    records.sort(key=lambda r: r["index"])
    return LoadgenResult(
        spec=spec.to_json(), records=records, wall_s=round(wall, 6),
        digest=digest, target=kind,
    )


def _finalize_engine(cap: _Capture, t0: float, instrument: bool) -> dict:
    req = cap.handle
    return cap.record(
        t0, outcome=req.outcome or "in_flight",
        finish_reason=req.finish_reason, shed_reason=req.shed_reason,
        tokens_out=len(req.tokens), replica=req.replica,
        first_token_t=req.first_token_t, finish_t=req.finish_t,
        instrument=instrument,
    )


def _run_engine(spec, schedule, engine, instrument, time_scale, timeout_s):
    """Single-threaded bare-engine runner: the caller thread interleaves
    due submits with ``engine.step()`` — the tier-1 drill path."""
    t0 = time.monotonic()

    def submit(sched: ScheduledRequest) -> _Capture:
        cap = _Capture(sched)
        cap.submit_t = time.monotonic()
        cap.handle = engine.submit(
            sched.prompt, max_new_tokens=sched.max_new_tokens,
            seed=sched.seed, tenant=sched.tenant, priority=sched.priority,
            request_id=sched.request_id,
            on_token=cap.on_token if instrument else None,
        )
        return cap

    records: list = []
    live: list = []
    if spec.mode == "open":
        pending = list(schedule)  # already at_s-sorted
        i = 0
        while i < len(pending) or live:
            now = time.monotonic() - t0
            while i < len(pending) and pending[i].at_s * time_scale <= now:
                live.append(submit(pending[i]))
                i += 1
            progressed = engine.step()
            done = [c for c in live if c.handle.done]
            for c in done:
                live.remove(c)
                records.append(_finalize_engine(c, t0, instrument))
            if not progressed and not done:
                time.sleep(0.0005)  # idle: next arrival is in the future
            if now > timeout_s:
                break
    else:
        # closed loop without threads: per-user state machines advanced
        # between engine steps (one thread drives the engine)
        queues: dict = {}
        for s in schedule:
            queues.setdefault(s.user, []).append(s)
        current: dict = {}
        ready_at = {u: 0.0 for u in queues}
        while queues or current or live:
            now = time.monotonic() - t0
            for u in list(queues):
                if u in current or now < ready_at[u]:
                    continue
                sched = queues[u].pop(0)
                if not queues[u]:
                    del queues[u]
                cap = submit(sched)
                current[u] = cap
                live.append(cap)
            progressed = engine.step()
            reaped = False
            for u, cap in list(current.items()):
                if cap.handle.done:
                    reaped = True
                    del current[u]
                    live.remove(cap)
                    records.append(_finalize_engine(cap, t0, instrument))
                    nxt = queues.get(u)
                    think = nxt[0].think_s if nxt else 0.0
                    ready_at[u] = (time.monotonic() - t0) + think * time_scale
            if not progressed and not reaped:
                time.sleep(0.0005)  # idle: every user is thinking
            if now > timeout_s:
                break
    for cap in live:
        cap.handle.cancel()
    while any(not c.handle.done for c in live):
        if not engine.step():
            break
    records.extend(_finalize_engine(c, t0, instrument) for c in live)
    return records


def _run_router(spec, schedule, router, instrument, time_scale, timeout_s,
                max_concurrency):
    """Router runner: ``Router.submit`` is synchronous, so open-loop
    concurrency is a bounded thread pool and closed-loop concurrency is
    one thread per user (the failover-drill idiom)."""
    t0 = time.monotonic()
    records: list = []
    lock = threading.Lock()

    def send(sched: ScheduledRequest):
        cap = _Capture(sched)
        cap.submit_t = time.monotonic()
        rr = router.submit(
            sched.prompt, max_new_tokens=sched.max_new_tokens,
            seed=sched.seed, session=sched.session, tenant=sched.tenant,
            priority=sched.priority, request_id=sched.request_id,
            timeout_s=timeout_s,
            on_token=cap.on_token if instrument else None,
        )
        rec = cap.record(
            t0, outcome=rr.outcome or "in_flight",
            finish_reason=rr.finish_reason, shed_reason=rr.shed_reason,
            tokens_out=len(rr.tokens), replica=rr.replica,
            first_token_t=rr.first_token_t, finish_t=rr.finish_t,
            instrument=instrument,
        )
        with lock:
            records.append(rec)

    threads: list = []
    if spec.mode == "open":
        gate = threading.Semaphore(max_concurrency)

        def timed(sched):
            with gate:
                send(sched)

        for sched in schedule:
            wait = sched.at_s * time_scale - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(wait)
            th = threading.Thread(target=timed, args=(sched,), daemon=True)
            th.start()
            threads.append(th)
    else:
        queues: dict = {}
        for s in schedule:
            queues.setdefault(s.user, []).append(s)

        def user_loop(items):
            for j, sched in enumerate(items):
                if j and sched.think_s:
                    time.sleep(sched.think_s * time_scale)
                send(sched)

        for items in queues.values():
            th = threading.Thread(target=user_loop, args=(items,), daemon=True)
            th.start()
            threads.append(th)
    deadline = t0 + timeout_s
    for th in threads:
        th.join(timeout=max(0.1, deadline - time.monotonic()))
    return records


def _post_stream(base_url: str, body: dict, cap: _Capture, instrument,
                 timeout_s):
    """POST /v1/submit with ``stream: true`` and walk the JSONL event
    stream, stamping each token event client-side (the ReplicaServer /
    RouterServer wire protocol)."""
    u = urllib.parse.urlparse(base_url)
    conn = http.client.HTTPConnection(
        u.hostname, u.port or 80, timeout=timeout_s
    )
    try:
        payload = json.dumps(body).encode()
        conn.request("POST", "/v1/submit", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        done_doc = {}
        tokens = 0
        buf = b""
        while True:
            chunk = resp.read(1)
            if not chunk:
                break
            if chunk != b"\n":
                buf += chunk
                continue
            if not buf.strip():
                continue
            ev = json.loads(buf.decode())
            buf = b""
            if ev.get("event") == "token":
                tokens += 1
                if instrument:
                    cap.on_token(ev.get("token"))
            elif ev.get("event") == "done":
                done_doc = ev
                break
        return done_doc, tokens
    finally:
        conn.close()


def _run_url(spec, schedule, base_url, instrument, time_scale, timeout_s,
             max_concurrency):
    t0 = time.monotonic()
    records: list = []
    lock = threading.Lock()

    def send(sched: ScheduledRequest):
        cap = _Capture(sched)
        body = {
            "prompt": [int(x) for x in sched.prompt],
            "max_new_tokens": sched.max_new_tokens, "seed": sched.seed,
            "tenant": sched.tenant, "priority": sched.priority,
            "request_id": sched.request_id, "stream": True,
            "timeout_s": timeout_s,
        }
        if sched.session:
            body["session"] = sched.session
        cap.submit_t = time.monotonic()
        try:
            done, tokens = _post_stream(
                base_url, body, cap, instrument, timeout_s
            )
        except (OSError, ValueError):
            done, tokens = {"outcome": "cancelled",
                            "finish_reason": "transport_error"}, 0
        rec = cap.record(
            t0, outcome=done.get("outcome") or "in_flight",
            finish_reason=done.get("finish_reason"),
            shed_reason=done.get("shed_reason"),
            tokens_out=len(done.get("tokens") or []) or tokens,
            replica=done.get("replica"), instrument=instrument,
        )
        with lock:
            records.append(rec)

    threads: list = []
    if spec.mode == "open":
        gate = threading.Semaphore(max_concurrency)

        def timed(sched):
            with gate:
                send(sched)

        for sched in schedule:
            wait = sched.at_s * time_scale - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(wait)
            th = threading.Thread(target=timed, args=(sched,), daemon=True)
            th.start()
            threads.append(th)
    else:
        queues: dict = {}
        for s in schedule:
            queues.setdefault(s.user, []).append(s)

        def user_loop(items):
            for j, sched in enumerate(items):
                if j and sched.think_s:
                    time.sleep(sched.think_s * time_scale)
                send(sched)

        for items in queues.values():
            th = threading.Thread(target=user_loop, args=(items,), daemon=True)
            th.start()
            threads.append(th)
    deadline = t0 + timeout_s
    for th in threads:
        th.join(timeout=max(0.1, deadline - time.monotonic()))
    return records
