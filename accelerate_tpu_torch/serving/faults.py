"""Deterministic fault injection for the serving engine.

This package's own copy of the reference's
``accelerate_tpu/serving/faults.py``.

A scheduler that only ever sees healthy traffic is untested where it
matters: the claim worth defending is that the engine **degrades
gracefully** — bounded tenant interference, every request reaching a
definite outcome, zero recompiles — while things go wrong. This module
makes "things go wrong" reproducible:

- **delayed steps** — injected sleeps before decode or prefill
  dispatches (a straggler host, a noisy neighbor on the chip);
- **page exhaustion** — the injector allocates and *holds* pages from
  the engine's allocator for a step window, forcing the overcommit /
  preemption / shed machinery to run without needing a giant traffic
  burst;
- **poisoned requests** — a request whose ``on_token`` callback raises
  (a buggy downstream consumer); the engine must contain the blast
  radius to that one request (outcome ``cancelled``), never the loop;
- **tenant storms** — a callable fired at a chosen engine step,
  typically a burst of ``submit()`` calls mid-flight (the mixed-tenant
  isolation tests ride this);
- **network faults** — connection-refused, slow-replica latency, and
  mid-stream drops injected at the *router's* transport layer
  (a router's transport consults ``before_connect`` /
  ``on_stream_event``): the same
  injector that drives the single-engine scheduler drills drives
  multi-replica failover drills;
- **wrong tokens** — silent content corruption injected at the *replica
  server's* emit path (``ReplicaServer(faults=...)`` consults
  ``corrupt_token``): valid framing, wrong answer, the failure class
  only a synthetic canary catches.

Everything is **seeded and scripted**: probabilistic faults draw from a
private ``random.Random(seed)``, scheduled faults key on the engine's
own ``step_count`` — the same seed and traffic replay the same fault
sequence, so a failing burst test is a repro, not an anecdote. The
module is plain python (neither torch nor jax): the engine consults it
with one attribute check per step when faults are off.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


class PoisonError(RuntimeError):
    """What a poisoned request's ``on_token`` callback raises."""


class StreamDropped(ConnectionError):
    """A replica's token stream ended mid-flight without a terminal
    event — what the router sees when a replica dies while streaming
    (and what the ``drop_stream`` fault injects)."""


def poison_on_token(token, req):
    """Drop-in ``on_token`` callback that blows up on the first token —
    the canonical poisoned request. The engine must cancel the request
    and keep serving."""
    raise PoisonError(f"poisoned request {req.id} (token {token})")


class FaultInjector:
    """Scripted + seeded fault schedule, consulted by ``ServingEngine``.

    Wire it with ``ServingEngine(..., faults=FaultInjector(seed=0)
    .delay_decode(every=4, delay_s=0.002))``. Hooks the engine calls:
    ``on_step(engine)`` once per scheduler iteration (storms fire,
    page squeezes arm/release), ``before_decode(engine)`` /
    ``before_prefill(engine)`` ahead of the respective dispatches
    (delays sleep). ``log`` records every fired fault as
    ``(step, kind, detail)`` so tests assert the schedule actually ran.
    """

    def __init__(self, seed: int = 0, sleep_fn: Callable[[float], None] = time.sleep):
        self.rng = random.Random(seed)
        self._sleep = sleep_fn
        self._delays: list = []     # dicts: phase/every/prob/delay_s/start/stop
        self._squeezes: list = []   # dicts: at_step/pages/hold_steps/held
        self._storms: list = []     # (at_step, fn, fired)
        self._net: list = []        # dicts: kind/replica/count/prob/after_tokens
        self._net_calls = 0         # connection-attempt counter (network clock)
        self.log: list = []         # (step, kind, detail)

    # -- schedule builders (chainable) -------------------------------------

    def delay_decode(self, *, every: Optional[int] = None,
                     prob: Optional[float] = None, delay_s: float = 0.002,
                     start: int = 0, stop: Optional[int] = None) -> "FaultInjector":
        """Sleep ``delay_s`` before decode dispatches — every Nth step,
        or with probability ``prob`` per step (seeded)."""
        if (every is None) == (prob is None):
            raise ValueError("pass exactly one of every= / prob=")
        self._delays.append(dict(phase="decode", every=every, prob=prob,
                                 delay_s=float(delay_s), start=start, stop=stop))
        return self

    def delay_prefill(self, *, every: Optional[int] = None,
                      prob: Optional[float] = None, delay_s: float = 0.002,
                      start: int = 0, stop: Optional[int] = None) -> "FaultInjector":
        """Sleep before prefill-chunk dispatches (makes prefill cost —
        and therefore tenant interference — controlled and visible)."""
        if (every is None) == (prob is None):
            raise ValueError("pass exactly one of every= / prob=")
        self._delays.append(dict(phase="prefill", every=every, prob=prob,
                                 delay_s=float(delay_s), start=start, stop=stop))
        return self

    def squeeze_pages(self, *, at_step: int, pages: int,
                      hold_steps: int = 8) -> "FaultInjector":
        """At engine step ``at_step``, allocate and hold ``pages`` pages
        from the engine's allocator (as many as it will give) for
        ``hold_steps`` steps — synthetic page pressure."""
        self._squeezes.append(dict(at_step=int(at_step), pages=int(pages),
                                   hold_steps=int(hold_steps), held=None,
                                   release_at=None, calls_left=None))
        return self

    def storm(self, *, at_step: int, fire: Callable) -> "FaultInjector":
        """Run ``fire(engine)`` once when the engine reaches ``at_step``
        — e.g. a burst of tenant-A ``submit()`` calls mid-flight."""
        self._storms.append([int(at_step), fire, False])
        return self

    def refuse_connect(self, *, replica: Optional[str] = None,
                       count: Optional[int] = 1,
                       prob: Optional[float] = None) -> "FaultInjector":
        """Raise ``ConnectionRefusedError`` on connection attempts to
        ``replica`` (None = any): the next ``count`` attempts, or each
        attempt with probability ``prob`` (seeded) — a replica that died
        between scrapes, as the router's transport sees it."""
        if (count is None) == (prob is None):
            raise ValueError("pass exactly one of count= / prob=")
        self._net.append(dict(kind="refuse_connect", replica=replica,
                              count=count, prob=prob))
        return self

    def slow_replica(self, *, replica: Optional[str] = None,
                     delay_s: float = 0.05, count: Optional[int] = None,
                     prob: Optional[float] = None) -> "FaultInjector":
        """Sleep ``delay_s`` before connections to ``replica`` complete
        (a straggler host / congested NIC) — forever when neither
        ``count`` nor ``prob`` is given."""
        if count is not None and prob is not None:
            raise ValueError("pass at most one of count= / prob=")
        self._net.append(dict(kind="slow_replica", replica=replica,
                              count=count, prob=prob,
                              delay_s=float(delay_s)))
        return self

    def drop_stream(self, *, replica: Optional[str] = None,
                    after_tokens: int = 3,
                    count: Optional[int] = 1) -> "FaultInjector":
        """Raise :class:`StreamDropped` once a stream from ``replica``
        has delivered ``after_tokens`` tokens — the mid-stream death the
        re-queue path must survive. Fires on the next ``count`` streams
        (None = every stream)."""
        self._net.append(dict(kind="drop_stream", replica=replica,
                              count=count, after_tokens=int(after_tokens)))
        return self

    def wrong_token(self, *, replica: Optional[str] = None,
                    after_tokens: int = 0,
                    count: Optional[int] = None) -> "FaultInjector":
        """Corrupt tokens a replica server emits (``token ^ 1``) from
        stream index ``after_tokens`` on — the **silent correctness
        fault** no latency gauge sees and the synthetic canary exists to
        catch (a drifting quantized replica, a bad KV import, a flaky
        link flipping bits). Consulted by ``ReplicaServer(faults=...)``
        via :meth:`corrupt_token`. ``count`` bounds how many tokens are
        corrupted in total (None = every eligible token until
        :meth:`clear_network`)."""
        self._net.append(dict(kind="wrong_token", replica=replica,
                              count=count, after_tokens=int(after_tokens)))
        return self

    def clear_network(self, kind: Optional[str] = None) -> int:
        """Disarm network-level faults (all, or one ``kind``) — how a
        drill 'fixes' the injected fault so recovery paths (canary
        pending→firing→**resolved**) can be asserted. Returns how many
        faults were removed."""
        keep = [f for f in self._net if kind is not None and f["kind"] != kind]
        removed = len(self._net) - len(keep)
        self._net[:] = keep
        return removed

    # -- router transport hooks ---------------------------------------------

    def _net_fire(self, fault: dict) -> bool:
        if fault.get("prob") is not None:
            return self.rng.random() < fault["prob"]
        if fault.get("count") is None:
            return True
        if fault["count"] <= 0:
            return False
        fault["count"] -= 1
        return True

    def before_connect(self, replica: str):
        """Router hook, ahead of each connection attempt: scripted
        refusals raise, slow-replica faults sleep. The attempt counter is
        the network clock the log records against."""
        self._net_calls += 1
        for fault in self._net:
            if fault["replica"] is not None and fault["replica"] != replica:
                continue
            if fault["kind"] == "slow_replica" and self._net_fire(fault):
                self.log.append(
                    (self._net_calls, "slow_replica", (replica, fault["delay_s"]))
                )
                self._sleep(fault["delay_s"])
            elif fault["kind"] == "refuse_connect" and self._net_fire(fault):
                self.log.append((self._net_calls, "refuse_connect", replica))
                raise ConnectionRefusedError(
                    f"injected connection refusal to replica {replica!r}"
                )

    def corrupt_token(self, replica: str, index: int, token: int) -> int:
        """Replica-server hook, per emitted token: an armed
        ``wrong_token`` fault flips the low bit of eligible tokens. The
        stream framing stays valid — only the *content* lies, which is
        exactly the failure class passive telemetry cannot see."""
        for fault in self._net:
            if fault["kind"] != "wrong_token":
                continue
            if fault["replica"] is not None and fault["replica"] != replica:
                continue
            if index < fault["after_tokens"]:
                continue
            if fault["count"] is not None:
                if fault["count"] <= 0:
                    continue
                fault["count"] -= 1
            self.log.append((self._net_calls, "wrong_token", (replica, index)))
            return int(token) ^ 1
        return int(token)

    def on_stream_event(self, replica: str, index: int):
        """Router hook, per received stream token: an armed
        ``drop_stream`` fault raises once ``index`` reaches its
        ``after_tokens`` threshold."""
        for fault in self._net:
            if fault["kind"] != "drop_stream":
                continue
            if fault["replica"] is not None and fault["replica"] != replica:
                continue
            if index < fault["after_tokens"]:
                continue
            if fault["count"] is not None:
                if fault["count"] <= 0:
                    continue
                fault["count"] -= 1
            self.log.append((self._net_calls, "drop_stream", (replica, index)))
            raise StreamDropped(
                f"injected mid-stream drop from replica {replica!r} "
                f"after {index} tokens"
            )

    # -- engine hooks -------------------------------------------------------

    def _maybe_sleep(self, phase: str, step: int):
        for d in self._delays:
            if d["phase"] != phase or step < d["start"]:
                continue
            if d["stop"] is not None and step >= d["stop"]:
                continue
            fire = (
                step % d["every"] == 0 if d["every"] is not None
                else self.rng.random() < d["prob"]
            )
            if fire:
                self.log.append((step, f"delay_{phase}", d["delay_s"]))
                self._sleep(d["delay_s"])

    def before_decode(self, engine):
        self._maybe_sleep("decode", engine.step_count)

    def before_prefill(self, engine):
        self._maybe_sleep("prefill", engine.step_count)

    def on_step(self, engine):
        """Step boundary: fire due storms, arm/release page squeezes."""
        step = engine.step_count
        for s in self._storms:
            if not s[2] and step >= s[0]:
                s[2] = True
                self.log.append((step, "storm", s[0]))
                s[1](engine)
        alloc = getattr(engine, "_allocator", None)
        for sq in self._squeezes:
            if sq["held"] is None and sq["release_at"] is None and step >= sq["at_step"]:
                if alloc is None:
                    sq["release_at"] = step  # flat arena: nothing to squeeze
                    continue
                held = []
                for _ in range(sq["pages"]):
                    page = alloc.alloc()
                    if page is None:
                        break
                    held.append(page)
                sq["held"] = held
                sq["release_at"] = step + sq["hold_steps"]
                # engine.step_count only advances when a dispatch actually
                # runs — a squeeze that starves every slot would freeze it
                # and hold the pages forever. Bound the hold in on_step
                # invocations too (generous, so the step-paced release
                # wins whenever the engine is making progress).
                sq["calls_left"] = 4 * sq["hold_steps"] + 16
                self.log.append((step, "squeeze_pages", len(held)))
            elif sq["held"] is not None:
                if sq["calls_left"] is not None:
                    sq["calls_left"] -= 1
                if step >= sq["release_at"] or sq["calls_left"] <= 0:
                    for page in sq["held"]:
                        alloc.release(page)
                    self.log.append((step, "release_pages", len(sq["held"])))
                    sq["held"] = None

    def release_all(self, engine):
        """Return any still-held squeeze pages (test teardown)."""
        alloc = getattr(engine, "_allocator", None)
        for sq in self._squeezes:
            if sq["held"] is not None and alloc is not None:
                for page in sq["held"]:
                    alloc.release(page)
                sq["held"] = None
