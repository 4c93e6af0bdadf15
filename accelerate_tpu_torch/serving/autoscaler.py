"""Burn-rate-actuated autoscaler daemon: the observe→decide→act loop.

An own copy of the reference's ``accelerate_tpu/serving/autoscaler.py``,
but for what it spawns: ``python -m accelerate_tpu_torch.commands.serve
replica``, by default ``--config small_1b`` on the card (``tiny`` has
head_dim 16, which the CUDA decode kernels refuse; a CPU drill passes
``--device cpu --config tiny``).

The fleet already has every mechanism this module needs — burn-rate alerts
that fire when the SLO budget is being spent (``telemetry/alerts.py``),
a fleet collector whose health state machine and merged timeline say
what the fleet is doing (``telemetry/fleet.py``), elastic router
membership (``/v1/register``/``deregister_replica``), drain-on-SIGTERM
replica processes (``replica_server.py``/``commands/serve.py``), and a
token-exact canary (``telemetry/canary.py``). Without it a human is the
actuator. This daemon closes the loop:

- **observe** — :func:`~..telemetry.capacity.extract_signals` over the
  collector's own Timeline rings (queue derivative, arrival slope,
  capacity/headroom) plus the alert manager's firing set;
- **decide** — the hysteresis'd
  :class:`~..telemetry.capacity.Recommender` (cooldown, confirmation
  streaks, min/max clamps, the scale-in overload veto). Every decision
  — including holds — appends to ``autoscale-decisions.jsonl`` with the
  full signal snapshot that justified it: the placement-decision-log
  discipline, applied to scaling;
- **act** — scale-out spawns a replica through the existing
  ``serve replica`` CLI (reading the JSON port handshake
  off its stdout), gates it behind a token-exact canary pass *before*
  ``register_replica`` admits traffic, and waits for the collector to
  mark it placeable; scale-in drains (in-flight streams finish), then
  deregisters, then reaps — with a conservation ledger from the
  router's own counters asserting no request vanished across the
  fleet-size change.

The loop measures itself: ``autoscale_reaction_s`` (burn rule firing →
first verified token out of the new replica) is stamped on each
scale-out decision, decomposed into actuation stages (``decide_lag`` →
``spawn`` → ``canary`` → ``register`` → ``placement`` — the waterfall
discipline from ``telemetry/waterfall.py``, applied to the control
loop) and published as ``autoscale/last_reaction_s`` on the router's
``/metrics``. (The reference also publishes it through its ``report
--diff`` sentry, ROADMAP queue 1 item 11 in the port.)

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the daemon runs beside the router, on boxes with no
accelerator stack — the torch-paying work happens in the subprocesses it
spawns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..telemetry.capacity import (
    AutoscalePolicy,
    Decision,
    Recommender,
    extract_signals,
)
from ..telemetry.fleet import DOWN_STATES, DRAINING, PLACEABLE_STATES

DEFAULT_GOLDEN = {"prompt": [1, 2, 3], "seed": 0, "max_new_tokens": 8}


# -- direct replica probing (the pre-registration canary gate) --------------


def direct_submit_fn(base_url: str, *, timeout_s: float = 30.0) -> Callable:
    """``submit_fn`` for a :class:`~..telemetry.canary.CanaryProber`
    aimed straight at one replica's ``/v1/submit`` — the gate probes the
    candidate *before* the router knows it exists, so a replica serving
    wrong tokens never receives real traffic."""
    import urllib.request

    base = base_url.rstrip("/")

    def submit(golden: dict, request_id) -> dict:
        t0 = time.perf_counter()
        payload = {
            "prompt": list(golden["prompt"]),
            "max_new_tokens": int(golden.get("max_new_tokens") or 16),
            "seed": int(golden.get("seed") or 0),
            "tenant": str(golden.get("tenant") or "_autoscale_canary"),
            "request_id": request_id,
            "stream": False,
        }
        req = urllib.request.Request(
            base + "/v1/submit", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            done = json.loads(resp.read().decode("utf-8", "replace"))
        return {
            "tokens": [int(t) for t in (done.get("tokens") or [])],
            "replica": done.get("replica"),
            "outcome": done.get("outcome"),
            "shed_reason": done.get("shed_reason"),
            "e2e_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }

    return submit


# -- spawning ---------------------------------------------------------------


class SpawnedReplica:
    """Uniform handle over one replica the autoscaler owns — subprocess
    (``proc``) or embedder-provided (``server`` with the ReplicaServer
    surface). ``drain()`` starts a graceful drain, ``wait()`` blocks for
    exit, ``kill()`` is the hard stop for a failed canary gate."""

    def __init__(self, name: str, url: str, *, proc=None, server=None):
        self.name = name
        self.url = url
        self.proc = proc
        self.server = server

    def drain(self):
        if self.proc is not None:
            import signal

            try:
                self.proc.send_signal(signal.SIGTERM)  # handler drains
            except (ProcessLookupError, OSError):
                pass
        elif self.server is not None:
            self.server.request_drain()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
                return True
            except subprocess.TimeoutExpired:
                return False
        if self.server is not None:
            return bool(self.server.serve_until_drained(timeout_s))
        return True

    def kill(self):
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        elif self.server is not None:
            self.server.kill()

    @property
    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return self.server is not None


# intra-op threads of a spawned ``--device cpu`` replica (SubprocessSpawner)
CPU_CHILD_THREADS = 1


class SubprocessSpawner:
    """Spawn replicas via the existing ``serve replica`` CLI
    (``python -m accelerate_tpu_torch.commands.serve replica``) — the same
    launch path the multi-process drills use — and read
    the ``{"role": "replica", "url": ...}`` JSON handshake the replica
    prints on stdout once its port is bound and its engine is warm.

    A child on ``--device cpu`` shares its host's cores with the spawner
    and its siblings, so it starts with ``CPU_CHILD_THREADS`` intra-op
    threads (``OMP_NUM_THREADS``, unless ``env`` sets it): two processes
    whose pools each claim every core stall each other's parallel
    regions, about 60x per op on an 8-core host, long enough for the
    router's 5 s connect timeout to shed the first request routed to the
    child."""

    def __init__(self, *, replica_args=("--config", "small_1b"),
                 startup_timeout_s: float = 120.0, env: Optional[dict] = None,
                 python: Optional[str] = None):
        self.replica_args = tuple(str(a) for a in replica_args)
        self.startup_timeout_s = float(startup_timeout_s)
        self.env = env
        self.python = python or sys.executable

    def child_env(self) -> Optional[dict]:
        """The child's environment: ``env`` (or this process's), with the
        CPU child's thread count added."""
        args = self.replica_args
        on_cpu = any(a == "--device" and b == "cpu" for a, b in zip(args, args[1:]))
        if not on_cpu:
            return self.env
        env = dict(os.environ if self.env is None else self.env)
        env.setdefault("OMP_NUM_THREADS", str(CPU_CHILD_THREADS))
        return env

    def command(self, name: str) -> list:
        return [
            self.python, "-m", "accelerate_tpu_torch.commands.serve",
            "replica", "--port", "0", "--name", name,
            *self.replica_args,
        ]

    def spawn(self, name: str) -> SpawnedReplica:
        proc = subprocess.Popen(
            self.command(name), stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=self.child_env(), text=True,
        )
        try:
            handshake = self._read_handshake(proc)
        except Exception:
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
            raise
        return SpawnedReplica(name, str(handshake["url"]), proc=proc)

    def _read_handshake(self, proc) -> dict:
        """First JSON line with a ``url`` off the child's stdout (library
        chatter and warnings may precede it); a child that exits or goes
        silent past the startup timeout is a spawn failure."""
        import queue

        q: "queue.Queue" = queue.Queue()

        def reader():
            try:
                for line in proc.stdout:
                    q.put(line)
            except (OSError, ValueError):
                pass
            q.put(None)  # EOF sentinel

        threading.Thread(
            target=reader, name="att-autoscale-handshake", daemon=True
        ).start()
        deadline = time.time() + self.startup_timeout_s
        while time.time() < deadline:
            try:
                line = q.get(timeout=0.25)
            except queue.Empty:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"replica exited rc={proc.returncode} before handshake"
                    )
                continue
            if line is None:
                raise RuntimeError(
                    f"replica stdout closed before handshake "
                    f"(rc={proc.poll()})"
                )
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and obj.get("url"):
                return obj
        raise TimeoutError(
            f"no replica handshake within {self.startup_timeout_s:.0f}s"
        )


# -- the daemon -------------------------------------------------------------


class Autoscaler:
    """One evaluate→actuate loop over a live :class:`~.router.Router`.

    ``spawn_fn(name) -> SpawnedReplica``-compatible handle overrides the
    default :class:`SubprocessSpawner` (benches and embedders pass a
    closure that builds an in-process ``ReplicaServer``). ``goldens``
    seeds the canary gate; with none given it borrows the router
    canary's recorded goldens when available, else the default golden
    in record-then-verify mode (the first gated replica records the
    truth every later one must reproduce — sound because the drills
    launch every replica from the same config + ``--init-seed``).

    Drive it deterministically with :meth:`evaluate_once` (what the
    tier-1 drill and the units do) or on a cadence with :meth:`start`.
    """

    def __init__(self, router, *, policy: Optional[AutoscalePolicy] = None,
                 spawner: Optional[SubprocessSpawner] = None,
                 spawn_fn: Optional[Callable] = None,
                 goldens: Optional[list] = None, canary_probes: int = 2,
                 log_dir: Optional[str] = None, interval_s: float = 1.0,
                 name_prefix: str = "auto",
                 placeable_timeout_s: float = 15.0,
                 drain_timeout_s: float = 30.0,
                 probe_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.time):
        self.router = router
        self.policy = policy or AutoscalePolicy()
        self.recommender = Recommender(self.policy, clock=clock)
        self._spawner = spawner
        self._spawn_fn = spawn_fn
        self.goldens = [dict(g) for g in (goldens or [])]
        self.canary_probes = max(1, int(canary_probes))
        self.interval_s = float(interval_s)
        self.name_prefix = str(name_prefix)
        self.placeable_timeout_s = float(placeable_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self.owned: dict = {}          # name -> SpawnedReplica handle
        self.decisions: list = []      # bounded ring of decision records
        self.evals = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.holds = 0
        self.canary_failures = 0
        self.spawn_failures = 0
        self.last_reaction_s: Optional[float] = None
        self._fh = None
        if log_dir:
            from ..telemetry.artifacts import ArtifactWriter

            self._fh = ArtifactWriter(
                os.path.join(log_dir, "autoscale-decisions.jsonl")
            )

    # -- observe -------------------------------------------------------------

    def fleet_size(self) -> int:
        """Replicas that count against min/max: everything not down and
        not draining — a ``starting`` spawn in its canary gate already
        holds a slot, or the loop would double-spawn while it warms."""
        collector = self.router.collector
        with collector._lock:
            return sum(
                1 for r in collector.replicas.values()
                if r.state not in DOWN_STATES and r.state != DRAINING
            )

    def _burn_fired_t(self, alert_states: dict, now: float) -> float:
        """When the justifying burn rule started firing — the reaction
        clock's zero."""
        fired = [
            st.get("since") for name, st in alert_states.items()
            if name in self.policy.burn_rules
            and st.get("state") == "firing"
            and isinstance(st.get("since"), (int, float))
        ]
        return min(fired) if fired else now

    # -- decide + act --------------------------------------------------------

    def evaluate_once(self, now: Optional[float] = None) -> dict:
        """One loop turn: signals → decision → (maybe) actuation.
        Returns the logged decision record."""
        now = self._clock() if now is None else float(now)
        collector = self.router.collector
        alert_states = collector.alerts.states_snapshot()
        signals = extract_signals(
            collector.timeline, now=now,
            fast_s=self.policy.fast_s, slow_s=self.policy.slow_s,
            horizon_s=self.policy.horizon_s, alert_states=alert_states,
        )
        firing = collector.alerts.firing()
        decision = self.recommender.decide(
            signals=signals, firing=firing, replicas=self.fleet_size(),
            now=now,
        )
        with self._lock:
            self.evals += 1
        if decision.action == "scale_out":
            record = self._actuate_out(decision, alert_states)
        elif decision.action == "scale_in":
            record = self._actuate_in(decision)
        else:
            with self._lock:
                self.holds += 1
            record = decision.to_record()
            record["outcome"] = "held"
        self._log(record)
        return record

    def _next_name(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self.name_prefix}-{self._seq}"

    def _gate_goldens(self) -> list:
        if self.goldens:
            return self.goldens
        canary = getattr(self.router, "canary", None)
        if canary is not None and getattr(canary, "goldens", None):
            self.goldens = [dict(g) for g in canary.goldens]
        else:
            self.goldens = [dict(DEFAULT_GOLDEN)]
        return self.goldens

    def _canary_gate(self, handle: SpawnedReplica) -> tuple:
        """Probe the candidate directly until every golden passed once
        (token-exact). Returns ``(passed, first_token_t, results)`` —
        the first passing probe's completion stamps the reaction
        clock."""
        from ..telemetry.canary import CanaryProber

        goldens = self._gate_goldens()
        prober = CanaryProber(
            direct_submit_fn(handle.url, timeout_s=self.probe_timeout_s),
            goldens, clock=self._clock,
        )
        first_token_t = None
        passed = True
        results = []
        probes = max(self.canary_probes, len(goldens))
        try:
            for _ in range(probes):
                result = prober.probe_once()
                results.append({
                    "passed": result["passed"],
                    "reason": result.get("reason"),
                    "e2e_ms": result.get("e2e_ms"),
                })
                if not result["passed"]:
                    passed = False
                    break
                if first_token_t is None:
                    first_token_t = self._clock()
        finally:
            prober.close()
        if passed:
            # keep any goldens the gate just recorded: the next spawn
            # must reproduce THIS replica's tokens, not re-record
            self.goldens = [dict(g) for g in prober.goldens]
        return passed, first_token_t, results

    def _await_placeable(self, name: str, timeout_s: float) -> bool:
        """Wait for the collector to scrape the newcomer into a
        placeable state (traffic is routable within one poll of
        registration)."""
        collector = self.router.collector
        deadline = time.time() + timeout_s
        while True:
            with collector._lock:
                r = collector.replicas.get(name)
                if r is not None and r.state in PLACEABLE_STATES:
                    return True
            if time.time() >= deadline:
                return False
            # nudge a poll if no background cadence is running
            if getattr(collector, "_sampler", None) is None:
                collector.poll_once()
            else:
                time.sleep(min(0.05, timeout_s / 20.0))

    def _actuate_out(self, decision: Decision, alert_states: dict) -> dict:
        fired_t = self._burn_fired_t(alert_states, decision.t_unix_s)
        stages = {"decide_lag_s": round(
            max(0.0, decision.t_unix_s - fired_t), 3
        )}
        record = decision.to_record()
        name = self._next_name()
        record["replica"] = name
        t0 = self._clock()
        try:
            if self._spawn_fn is not None:
                handle = self._spawn_fn(name)
            else:
                if self._spawner is None:
                    self._spawner = SubprocessSpawner()
                handle = self._spawner.spawn(name)
        except Exception as e:
            with self._lock:
                self.spawn_failures += 1
            record["outcome"] = "spawn_failed"
            record["error"] = f"{type(e).__name__}: {e}"
            record["stages"] = stages
            return record
        stages["spawn_s"] = round(self._clock() - t0, 3)

        t1 = self._clock()
        passed, first_token_t, probes = self._canary_gate(handle)
        stages["canary_s"] = round(self._clock() - t1, 3)
        record["canary"] = probes
        if not passed:
            # the gate is the whole point: wrong tokens never serve
            handle.kill()
            with self._lock:
                self.canary_failures += 1
            record["outcome"] = "canary_failed"
            record["stages"] = stages
            return record

        t2 = self._clock()
        self.router.register_replica(name, handle.url)
        stages["register_s"] = round(self._clock() - t2, 3)
        t3 = self._clock()
        placed = self._await_placeable(name, self.placeable_timeout_s)
        stages["placement_s"] = round(self._clock() - t3, 3)
        with self._lock:
            self.owned[name] = handle
            self.scale_outs += 1
            reaction = (
                round(first_token_t - fired_t, 3)
                if first_token_t is not None else None
            )
            self.last_reaction_s = reaction
        record["outcome"] = "scaled_out" if placed else "registered_not_placed"
        record["url"] = handle.url
        record["stages"] = stages
        if reaction is not None:
            record["autoscale_reaction_s"] = reaction
            record["burn_fired_unix_s"] = round(fired_t, 3)
        return record

    def _pick_victim(self) -> Optional[str]:
        """Newest owned replica still registered (LIFO: the autoscaler
        only reaps processes it spawned and still holds a handle to)."""
        with self._lock:
            names = [n for n in self.owned if n in self.router._replicas]
            return names[-1] if names else None

    def _actuate_in(self, decision: Decision) -> dict:
        record = decision.to_record()
        name = self._pick_victim()
        if name is None:
            record["outcome"] = "no_owned_replica"
            return record
        record["replica"] = name
        before = self.conservation()
        handle = self.owned[name]
        stages = {}
        # drain FIRST: the draining gauge flips the replica out of
        # placement on the next scrape while in-flight streams finish —
        # deregistering before the drain would strand them re-queued
        t0 = self._clock()
        handle.drain()
        drained = handle.wait(self.drain_timeout_s)
        stages["drain_s"] = round(self._clock() - t0, 3)
        t1 = self._clock()
        self.router.deregister_replica(name)
        if not drained:
            handle.kill()
        stages["reap_s"] = round(self._clock() - t1, 3)
        with self._lock:
            self.owned.pop(name, None)
            self.scale_ins += 1
        after = self.conservation()
        record["outcome"] = "scaled_in" if drained else "reaped_after_timeout"
        record["stages"] = stages
        record["ledger"] = {
            "before": before, "after": after,
            "conserved": bool(after["conserved"]),
        }
        return record

    # -- ledger / gauges -----------------------------------------------------

    def conservation(self) -> dict:
        """The zero-lost-requests ledger from the router's own counters:
        every submitted request is accounted terminal or in flight."""
        m = self.router.metrics()
        submitted = int(m.get("router/requests_submitted") or 0)
        completed = int(m.get("router/requests_completed") or 0)
        shed = int(m.get("router/requests_shed") or 0)
        cancelled = int(m.get("router/requests_cancelled") or 0)
        inflight = int(m.get("router/inflight") or 0)
        return {
            "submitted": submitted, "completed": completed, "shed": shed,
            "cancelled": cancelled, "inflight": inflight,
            "conserved": submitted == completed + shed + cancelled + inflight,
        }

    def rollup_keys(self) -> dict:
        """``autoscale/*`` gauges for the router's ``/metrics`` (merge
        policy: counters sum, ``last_reaction_s`` is a plain gauge)."""
        with self._lock:
            out = {
                "autoscale/evals": self.evals,
                "autoscale/scale_outs": self.scale_outs,
                "autoscale/scale_ins": self.scale_ins,
                "autoscale/holds": self.holds,
                "autoscale/canary_failures": self.canary_failures,
                "autoscale/spawn_failures": self.spawn_failures,
                "autoscale/replicas_owned": len(self.owned),
            }
            if self.last_reaction_s is not None:
                out["autoscale/last_reaction_s"] = self.last_reaction_s
        return out

    def _log(self, record: dict):
        with self._lock:
            self.decisions.append(record)
            if len(self.decisions) > 512:
                del self.decisions[: len(self.decisions) - 512]
            fh = self._fh
        if fh is not None:
            fh.write_line(json.dumps(record))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="att-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                pass  # the loop must survive one bad evaluation

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self, reap: bool = True):
        """Stop the loop; with ``reap`` (default) drain and reap every
        replica the daemon still owns — an exiting autoscaler must not
        leak subprocesses."""
        self.stop()
        if reap:
            with self._lock:
                owned = list(self.owned.items())
            for name, handle in owned:
                try:
                    handle.drain()
                    if not handle.wait(self.drain_timeout_s):
                        handle.kill()
                except Exception:
                    handle.kill()
                try:
                    self.router.deregister_replica(name)
                except Exception:
                    pass
                with self._lock:
                    self.owned.pop(name, None)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def load_autoscale_decisions(target: str) -> list:
    """Offline read of ``autoscale-decisions.jsonl`` under a telemetry
    dir — what incident reconstruction and the troubleshooting runbook
    read against the timeline."""
    from ..telemetry.artifacts import artifact_files, iter_jsonl

    paths = (artifact_files(target, "autoscale-decisions.jsonl")
             if os.path.isdir(target) else artifact_files(target))
    return [rec for rec in iter_jsonl(paths) if rec.get("action")]
