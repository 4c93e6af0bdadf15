"""The port's router (``accelerate_tpu_torch/serving/router.py``) and its
front door, on the CPU, mirroring the reference's ``tests/test_router.py``
and the two-replica classes of ``tests/test_replica_serving.py``
(``TestKvHandoff``, ``TestKillDrillTwoReplicas``).

The contracts held:
- ``backoff_schedule`` equals the reference's for the same seeds and
  request ids;
- under one scripted fleet and one fake clock, the port's router and the
  reference's place, fail over, re-queue, shed, migrate KV and log their
  decisions identically (requests, hops, decision records, counters); a
  re-queued hop's payload differs by design: the port continues the
  stream (prompt + delivered tokens, the budget left) where the
  reference replays it;
- the reference's scripted cases on the port: least-loaded placement,
  affinity and its fall-back, draining, elastic membership, failover and
  re-queue continuing the stream after its delivered tokens, bounded queues,
  timeouts, network fault injection, KV migration, golden signals, the
  decision log and the request log, the HTTP front door; the canary and
  the autoscaler are later slices and raise;
- with the port's engines behind the port's ReplicaServers: a handoff
  admits as the local warm cache does, bit for bit; a kill mid-burst
  leaves every request finished and token-exact (greedy against a
  single-engine run; a sampled request continued after the kill equals
  its uninterrupted run; a continuation submitted to an engine equals the
  uninterrupted run's tail); a session's KV follows it off a draining
  replica;
- ``serve router`` as a subprocess fronts a port replica and drains on
  SIGTERM;
- ``serving/router.py`` imports with torch and numpy blocked; the tiers,
  fleet, timeline and alerts modules with torch blocked.
"""

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.serving import router as ref_router
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving import router as port_router
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.faults import FaultInjector, StreamDropped
from accelerate_tpu_torch.serving.router import (
    SHED_NO_REPLICAS,
    SHED_RETRIES_EXHAUSTED,
    SHED_ROUTER_QUEUE_FULL,
    Router,
    RouterConfig,
    RouterServer,
    _RouterMetricsSession,
    backoff_schedule,
)
from accelerate_tpu_torch.telemetry.exporter import prometheus_text
from accelerate_tpu_torch.telemetry.fleet import DRAINING, UNREACHABLE

ROOT = Path(__file__).resolve().parent.parent
HTTP_TIMEOUT = 60


def _gauges(load=0.1, draining=False, **over):
    g = {"att_serving_queue_depth": 0, "att_serving_num_slots": 4,
         "att_serving_free_slots": 4, "att_serving_slot_occupancy": 0.0,
         "att_serving_load_score": load}
    if draining:
        g["att_serving_draining"] = 1
        g["att_serving_load_score"] = load + 1e6
    g.update(over)
    return "\n".join(f"{k} {v}" for k, v in g.items()) + "\n"


class ScriptedFleet:
    """fetch_fn for the router's collector: per-replica exposition text
    (or an exception: a dead scrape endpoint)."""

    def __init__(self):
        self.replies = {}

    def set(self, name, *, load=0.1, draining=False, dead=False):
        key = f"http://{name}/metrics"
        self.replies[key] = OSError("connection refused") if dead else \
            _gauges(load=load, draining=draining)

    def __call__(self, target):
        reply = self.replies[target]
        if isinstance(reply, Exception):
            raise reply
        return reply


class ScriptedTransport:
    """Per-replica scripted stream behaviours, consumed in order. Each:
    dict(tokens=[...], outcome=..., drop_after=None, refuse=False,
    shed_reason=None). ``tokens`` is the request's whole stream: a
    continuation (``resumed_tokens`` k in the payload) streams it from k,
    as a deterministic engine would."""

    def __init__(self):
        self.scripts = {}
        self.calls = []
        self.posts = []
        self.post_replies = {}

    def script(self, name, **behaviour):
        self.scripts.setdefault(f"http://{name}", []).append(behaviour)

    def stream_submit(self, base_url, payload, *, on_event):
        self.calls.append((base_url, payload))
        queue = self.scripts.get(base_url) or []
        b = queue.pop(0) if len(queue) > 1 else (queue[0] if queue else {})
        if b.get("refuse"):
            raise ConnectionRefusedError(f"scripted refusal from {base_url}")
        tokens = b.get("tokens", [1, 2, 3])[payload.get("resumed_tokens", 0):]
        for i, t in enumerate(tokens):
            if b.get("drop_after") is not None and i >= b["drop_after"]:
                raise StreamDropped(f"scripted drop from {base_url} at {i}")
            on_event({"event": "token", "i": i, "token": t})
        done = {"event": "done", "outcome": b.get("outcome", "finished"),
                "finish_reason": b.get("finish_reason", "budget"),
                "shed_reason": b.get("shed_reason"), "tokens": tokens,
                "prefix_hit": b.get("prefix_hit", 0)}
        on_event(done)
        return done

    def post_json(self, base_url, path, payload):
        self.posts.append((base_url, path, payload))
        reply = self.post_replies.get((base_url, path))
        if isinstance(reply, Exception):
            raise reply
        return reply or {}


def make_router(names=("A", "B"), *, config=None, faults=None, mod=port_router,
                clock=time.time):
    fleet = ScriptedFleet()
    transport = ScriptedTransport()
    for n in names:
        fleet.set(n)
    router = mod.Router({n: f"http://{n}" for n in names},
                        config=config or mod.RouterConfig(backoff_base_s=0.001,
                                                          backoff_cap_s=0.01,
                                                          failure_cooldown_s=30.0),
                        transport=transport, fetch_fn=fleet, faults=faults, clock=clock)
    router.collector.poll_once()
    return router, fleet, transport


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_backoff_schedule_equals_the_reference():
    for seed in range(4):
        for rid in ("r0", "req-1", 42, "s1-3"):
            for base, cap in ((0.05, 2.0), (0.1, 1.0), (0.001, 0.01)):
                assert backoff_schedule(seed, rid, 9, base_s=base, cap_s=cap) == \
                    ref_router.backoff_schedule(seed, rid, 9, base_s=base, cap_s=cap)


def _scripted_scenario(mod):
    """One scripted fleet's life under a fake clock: placement by load,
    affinity, a refusal, a mid-stream drop, a drain with KV migration, a
    dead replica, a shed. Returns everything observable."""
    from accelerate_tpu.serving.faults import FaultInjector as RefFaults

    faults = (FaultInjector if mod is port_router else RefFaults)(seed=3).refuse_connect(
        replica="C", count=1)
    router, fleet, transport = make_router(
        ("A", "B", "C"), mod=mod, faults=faults, clock=lambda: 1000.0,
        config=mod.RouterConfig(backoff_base_s=0.0001, backoff_cap_s=0.0002,
                                failure_cooldown_s=0.0, max_retries=3))
    out = []

    def submit(*a, **k):
        req = router.submit(*a, **k)
        out.append((req.id, req.outcome, req.shed_reason, req.replica, req.tokens,
                    req.hops, req.requeues))

    fleet.set("A", load=0.5)
    fleet.set("B", load=0.2)
    fleet.set("C", load=0.1)
    router.collector.poll_once()
    transport.script("C", tokens=[7, 8])
    transport.script("B", tokens=[1, 2, 3, 4], drop_after=1)
    transport.script("B", tokens=[1, 2, 3, 4])
    transport.script("A", tokens=[1, 2, 3, 4])
    submit([1, 2, 3], max_new_tokens=2, seed=0, session="s")   # C refuses once -> B drops -> A
    submit([1, 2, 3], max_new_tokens=2, seed=0, session="s")   # affinity
    fleet.set("A", draining=True)
    router.collector.poll_once()
    transport.post_replies[("http://A", "/v1/kv/export")] = {"n_pages": 1, "token_len": 2}
    transport.post_replies[("http://C", "/v1/kv/import")] = {"installed_tokens": 2}
    transport.post_replies[("http://B", "/v1/kv/import")] = {"installed_tokens": 2}
    submit([1, 2, 3], max_new_tokens=2, seed=1, session="s")   # moves off A with its KV
    fleet.set("B", dead=True)
    router.collector.poll_once()
    submit([4], max_new_tokens=1, seed=2, request_id="ext")
    router.config.max_inflight = 0
    submit([5], max_new_tokens=1, seed=3)
    metrics = {k: v for k, v in router.metrics().items() if not k.endswith("_ms")}
    view = [(r["replica"], r["state"], r["placeable"])
            for r in router.collector.placement_view(include_unplaceable=True)]
    return out, router.decisions, metrics, transport.calls, transport.posts, view, \
        [(e.get("replica"), e.get("from"), e.get("to"))
         for e in router.collector.events], faults.log


def _as_replay(calls):
    """The hop payloads with each continuation written as the reference's
    replay of the whole request."""
    out = []
    for url, payload in calls:
        k = payload.get("resumed_tokens", 0)
        if k:
            payload = {key: v for key, v in payload.items() if key != "resumed_tokens"}
            payload.update(prompt=payload["prompt"][:-k],
                           max_new_tokens=payload["max_new_tokens"] + k)
        out.append((url, payload))
    return out


def test_scripted_fleet_decides_as_the_reference():
    """Placement, failover, migration, shedding and the decision log, under
    one scripted fleet and one fake clock, equal the reference router's. The
    one re-queued hop after delivered tokens is a continuation (B dropped
    after one token: A gets prompt + that token and the one token left),
    which the reference sends as a replay of the whole request."""
    port, ref = _scripted_scenario(port_router), _scripted_scenario(ref_router)
    assert [(url, p["prompt"], p["max_new_tokens"]) for url, p in port[3]
            if "resumed_tokens" in p] == [("http://A", [1, 2, 3, 1], 1)]
    assert port[:3] + (_as_replay(port[3]),) + port[4:] == ref


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------


class TestBackoffSchedule:
    def test_deterministic_per_seed_and_request(self):
        a = backoff_schedule(0, "req-1", 5)
        assert a == backoff_schedule(0, "req-1", 5)
        assert a != backoff_schedule(0, "req-2", 5) and a != backoff_schedule(1, "req-1", 5)

    def test_capped_exponential_with_bounded_jitter(self):
        sched = backoff_schedule(7, 42, 8, base_s=0.1, cap_s=1.0)
        for i, delay in enumerate(sched):
            hi = min(1.0, 0.1 * 2 ** i)
            assert hi * 0.5 <= delay <= hi, (i, delay)
        assert max(sched) <= 1.0

    def test_jitter_never_zero(self):
        assert all(d > 0 for d in backoff_schedule(0, "x", 16, base_s=0.01))


class TestPlacementAndAffinity:
    def test_least_loaded_wins(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=2.0)
        fleet.set("B", load=0.1)
        router.collector.poll_once()
        transport.script("B", tokens=[9, 9])
        req = router.submit([1, 2, 3], max_new_tokens=2, seed=0)
        assert (req.outcome, req.replica, [h["replica"] for h in req.hops]) == \
            ("finished", "B", ["B"])

    def test_session_affinity_sticks_then_falls_back(self):
        router, fleet, transport = make_router()
        fleet.set("B", load=2.0)
        router.collector.poll_once()
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        assert router.submit([1], max_new_tokens=1, seed=0, session="s").replica == "A"
        fleet.set("A", load=5.0)
        fleet.set("B", load=0.1)
        router.collector.poll_once()
        assert router.submit([1], max_new_tokens=1, seed=0, session="s").replica == "A"
        fleet.set("A", draining=True)
        router.collector.poll_once()
        assert router.submit([1], max_new_tokens=1, seed=0, session="s").replica == "B"

    def test_draining_visible_via_include_draining_only(self):
        router, fleet, transport = make_router()
        fleet.set("A", draining=True)
        router.collector.poll_once()
        assert [r["replica"] for r in router.collector.placement_view()] == ["B"]
        with_drain = router.collector.placement_view(include_draining=True)
        assert [r["replica"] for r in with_drain] == ["B", "A"]
        assert with_drain[-1]["state"] == DRAINING and not with_drain[-1]["placeable"]
        assert "A" in {r["replica"] for r in router.placement()}

    def test_deregistered_replica_leaves_placement(self):
        router, fleet, transport = make_router()
        assert router.deregister_replica("A")
        assert [r["replica"] for r in router.collector.placement_view()] == ["B"]
        transport.script("B", tokens=[5])
        assert router.submit([1], max_new_tokens=1, seed=0).replica == "B"

    def test_registered_replica_joins_after_first_scrape(self):
        router, fleet, transport = make_router(names=("A",))
        fleet.set("C", load=0.05)
        router.register_replica("C", "http://C")
        router.collector.poll_once()
        assert {r["replica"] for r in router.collector.placement_view()} == {"A", "C"}


class TestFailoverAndRequeue:
    def test_refused_connection_grows_exclusions_and_requeues(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", refuse=True)
        transport.script("B", tokens=[7, 8, 9])
        req = router.submit([1, 2], max_new_tokens=3, seed=0)
        assert (req.outcome, req.replica) == ("finished", "B")
        assert [h["replica"] for h in req.hops] == ["A", "B"]
        assert "error" in req.hops[0] and "error" not in req.hops[1]
        assert (router.requeues, router.requeue_success, router.replica_failures) == \
            (1, 1, {"A": 1})
        assert "A" in router._failed_now(time.time())

    def test_mid_stream_drop_does_not_reemit_prefix(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[10, 11, 12, 13], drop_after=2)
        transport.script("B", tokens=[10, 11, 12, 13])
        seen = []
        req = router.submit([1], max_new_tokens=4, seed=0, on_token=lambda t, r: seen.append(t))
        assert req.tokens == seen == [10, 11, 12, 13]
        assert [h["replica"] for h in req.hops] == ["A", "B"]
        assert "StreamDropped" in req.hops[0]["error"]

    def test_every_replica_failing_sheds_retries_exhausted(self):
        router, fleet, transport = make_router(
            config=RouterConfig(max_retries=2, backoff_base_s=0.001, backoff_cap_s=0.002))
        transport.script("A", refuse=True)
        transport.script("B", refuse=True)
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert (req.outcome, req.shed_reason) == ("shed", SHED_RETRIES_EXHAUSTED)
        assert req.done and req.finish_t is not None

    def test_no_replicas_sheds(self):
        router = Router({}, config=RouterConfig(backoff_base_s=0.001),
                        transport=ScriptedTransport(), fetch_fn=lambda t: "")
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert (req.outcome, req.shed_reason) == ("shed", SHED_NO_REPLICAS)

    def test_replica_shed_draining_tries_next(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", outcome="shed", shed_reason="draining", tokens=[])
        transport.script("B", tokens=[3])
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert (req.outcome, req.replica, router.replica_failures) == ("finished", "B", {})

    def test_bounded_queue_sheds_router_queue_full(self):
        router, _, _ = make_router(config=RouterConfig(max_inflight=0))
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert (req.outcome, req.shed_reason) == ("shed", SHED_ROUTER_QUEUE_FULL)
        assert router.metrics()["router/requests_shed"] == 1

    def test_request_timeout_is_cancelled_not_hung(self):
        router, fleet, transport = make_router(
            config=RouterConfig(max_retries=100, backoff_base_s=0.01, backoff_cap_s=0.02,
                                request_timeout_s=0.05))
        transport.script("A", refuse=True)
        transport.script("B", refuse=True)
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert (req.outcome, req.finish_reason) == ("cancelled", "timeout")

    def test_timeout_budget_is_forwarded_into_the_hop(self):
        router, _, transport = make_router(config=RouterConfig(request_timeout_s=5.0))
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        router.submit([1], max_new_tokens=1, seed=0)
        assert 0 < transport.calls[-1][1]["timeout_s"] <= 5.0
        router2, _, transport2 = make_router()
        transport2.script("A", tokens=[1])
        transport2.script("B", tokens=[1])
        router2.submit([1], max_new_tokens=1, seed=0)
        assert "timeout_s" not in transport2.calls[-1][1]

    def test_exclusions_reset_after_health_refresh(self):
        calls = []

        class OneRefusalTransport(ScriptedTransport):
            def stream_submit(self, base_url, payload, *, on_event):
                calls.append(base_url)
                if len(calls) == 1:
                    raise ConnectionRefusedError("transient blip")
                return super().stream_submit(base_url, payload, on_event=on_event)

        fleet = ScriptedFleet()
        fleet.set("A")
        transport = OneRefusalTransport()
        transport.script("A", tokens=[4])
        router = Router({"A": "http://A"},
                        config=RouterConfig(backoff_base_s=0.001, backoff_cap_s=0.002,
                                            max_retries=4, failure_cooldown_s=0.0),
                        transport=transport, fetch_fn=fleet)
        router.collector.poll_once()
        assert router.submit([1], max_new_tokens=1, seed=0).outcome == "finished"
        assert calls == ["http://A", "http://A"]
        assert (router.requests_requeued, router.requeue_success) == (1, 1)

    def test_requeued_hop_continues_after_the_delivered_tokens(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[5, 6, 7, 8], drop_after=2)
        transport.script("B", tokens=[5, 6, 7, 8])
        seen = []
        req = router.submit([1, 2], max_new_tokens=4, seed=3,
                            on_token=lambda t, r: seen.append(t))
        assert (req.outcome, req.replica, req.tokens, seen) == \
            ("finished", "B", [5, 6, 7, 8], [5, 6, 7, 8])
        first, second = (p for _, p in transport.calls)
        assert "resumed_tokens" not in first
        assert (second["prompt"], second["max_new_tokens"], second["resumed_tokens"],
                second["seed"], second["request_id"]) == ([1, 2, 5, 6], 2, 2, 3, req.id)

    def test_stream_broken_after_its_last_token_needs_no_hop(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[5, 6, 7], drop_after=2)
        req = router.submit([1, 2], max_new_tokens=2, seed=0)
        assert (req.outcome, req.finish_reason, req.replica, req.tokens) == \
            ("finished", "budget", "A", [5, 6])
        assert len(transport.calls) == 1 and "error" in req.hops[0]
        assert (router.requeues, router.requests_completed, router.requests_requeued) == \
            (1, 1, 0)

    def test_requeue_accounting_hops_vs_requests(self):
        router, fleet, transport = make_router(names=("A", "B", "C"))
        fleet.set("A", load=0.01)
        fleet.set("B", load=0.02)
        router.collector.poll_once()
        transport.script("A", refuse=True)
        transport.script("B", refuse=True)
        transport.script("C", tokens=[1])
        assert router.submit([1], max_new_tokens=1, seed=0).replica == "C"
        m = router.metrics()
        assert (m["router/requeues"], m["router/requests_requeued"],
                m["router/requeue_success"]) == (2, 1, 1)

    def test_stitchable_request_id_rides_every_hop(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", refuse=True)
        transport.script("B", tokens=[1])
        req = router.submit([1], max_new_tokens=1, seed=3, request_id="ext-42")
        assert req.id == "ext-42"
        assert all(p["request_id"] == "ext-42" and p["seed"] == 3 for _, p in transport.calls)


class TestNetworkFaultInjection:
    def test_injected_refusal_drives_router_failover(self):
        faults = FaultInjector(seed=0).refuse_connect(replica="A", count=1)
        router, fleet, transport = make_router(faults=faults)
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[1, 2])
        transport.script("B", tokens=[1, 2])
        req = router.submit([1], max_new_tokens=2, seed=0)
        assert (req.outcome, req.replica) == ("finished", "B")
        assert "ConnectionRefusedError" in req.hops[0]["error"]

    def test_injected_mid_stream_drop_requeues(self):
        faults = FaultInjector(seed=0).drop_stream(replica="A", after_tokens=1, count=1)
        router, fleet, transport = make_router(faults=faults)
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[5, 6, 7])
        transport.script("B", tokens=[5, 6, 7])
        req = router.submit([1], max_new_tokens=3, seed=0)
        assert (req.tokens, req.replica) == ([5, 6, 7], "B")


class TestKvMigration:
    def test_sticky_session_moving_off_draining_replica_migrates(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        assert router.submit([5, 6, 7], max_new_tokens=1, seed=0, session="s").replica == "A"
        fleet.set("A", draining=True)
        router.collector.poll_once()
        transport.post_replies[("http://A", "/v1/kv/export")] = {
            "version": 1, "n_pages": 1, "token_len": 2, "tokens": [5, 6], "page_size": 2,
            "leaves": []}
        transport.post_replies[("http://B", "/v1/kv/import")] = {"installed_tokens": 2}
        r2 = router.submit([5, 6, 7], max_new_tokens=1, seed=0, session="s")
        assert r2.replica == "B" and router.kv_migrations == 1
        assert ("http://A", "/v1/kv/export", {"tokens": [5, 6, 7]}) in transport.posts
        assert [h["kv_migrated_from"] for h in r2.hops if "kv_migrated_from" in h] == ["A"]

    def test_migration_failure_is_absorbed(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        assert router.submit([5, 6], max_new_tokens=1, seed=0, session="s").replica == "A"
        fleet.set("A", dead=True)
        router.collector.poll_once()
        transport.post_replies[("http://A", "/v1/kv/export")] = OSError("gone")
        r2 = router.submit([5, 6], max_new_tokens=1, seed=0, session="s")
        assert (r2.outcome, r2.replica, router.kv_migrations) == ("finished", "B", 0)


class TestGoldenSignals:
    def test_histograms_and_hop_stamps_on_a_finished_request(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[7, 8, 9])
        req = router.submit([1, 2], max_new_tokens=3, seed=0)
        for key in ("router/ttft", "router/e2e", "router/queue_wait", "router/placement"):
            assert router.hists[key].count >= 1, key
        assert router.hists["router/itl"].count == 2
        hop = req.hops[0]
        assert hop["place_start_unix_s"] <= hop["connect_unix_s"] <= hop["first_byte_unix_s"]
        assert hop["first_token_unix_s"] <= hop["done_unix_s"] and hop["placement_ms"] >= 0
        m = router.metrics()
        assert m["router/ttft_count"] == 1 and "router/e2e_p99_ms" in m

    def test_backoff_wait_is_measured_and_stamped(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", refuse=True)
        transport.script("B", tokens=[1])
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert router.hists["router/backoff_wait"].count == 1
        assert req.hops[1]["backoff_before_ms"] > 0.0

    def test_decision_log_names_choice_reason_and_candidates(self):
        router, fleet, transport = make_router()
        fleet.set("A", load=0.05)
        fleet.set("B", load=2.0)
        router.collector.poll_once()
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        r1 = router.submit([1], max_new_tokens=1, seed=0, session="s")
        d = router.decisions[-1]
        assert (d["chosen"], d["reason"], d["request_id"], d["hop"]) == \
            ("A", "least_loaded", r1.id, 0)
        scores = {c["replica"]: c["load_score"] for c in d["candidates"]}
        assert scores["A"] < scores["B"]
        r2 = router.submit([1], max_new_tokens=1, seed=0, session="s")
        assert (router.decisions[-1]["reason"], router.decisions[-1]["chosen"], r2.replica) == \
            ("affinity", "A", "A")

    def test_decision_ring_is_bounded(self):
        router, _, transport = make_router(
            config=RouterConfig(backoff_base_s=0.001, decision_log_max=5))
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        for i in range(12):
            router.submit([i], max_new_tokens=1, seed=0)
        assert len(router.decisions) == 5

    def test_log_dir_writes_requests_and_decisions(self, tmp_path):
        router, fleet, transport = make_router(
            config=RouterConfig(backoff_base_s=0.001, log_dir=str(tmp_path), max_inflight=1))
        fleet.set("A", load=0.05)
        router.collector.poll_once()
        transport.script("A", tokens=[4, 5])
        req = router.submit([1], max_new_tokens=2, seed=0)
        router.close()
        recs = [json.loads(line) for line in open(tmp_path / "router-requests.jsonl")]
        assert len(recs) == 1
        rec = recs[0]
        assert (rec["request_id"], rec["outcome"], rec["tokens"], rec["replica"]) == \
            (req.id, "finished", 2, "A")
        assert rec["e2e_ms"] >= rec["ttft_ms"] and rec["hops"][0]["connect_unix_s"] > 0
        decs = [json.loads(line) for line in open(tmp_path / "router-decisions.jsonl")]
        assert decs and decs[0]["chosen"] == "A"

    def test_shed_requests_are_recorded_with_reason_counters(self, tmp_path):
        router, _, _ = make_router(config=RouterConfig(max_inflight=0, log_dir=str(tmp_path)))
        assert router.submit([1], max_new_tokens=1, seed=0).shed_reason == \
            SHED_ROUTER_QUEUE_FULL
        assert router.metrics()["router/shed/router_queue_full"] == 1
        router.close()
        rec = json.loads(open(tmp_path / "router-requests.jsonl").readline())
        assert (rec["outcome"], rec["shed_reason"], rec["ttft_ms"]) == \
            ("shed", SHED_ROUTER_QUEUE_FULL, None)

    def test_instrument_false_is_the_bare_baseline(self, tmp_path):
        router, _, transport = make_router(
            config=RouterConfig(backoff_base_s=0.001, instrument=False, log_dir=str(tmp_path)))
        transport.script("A", tokens=[1])
        transport.script("B", tokens=[1])
        req = router.submit([1], max_new_tokens=1, seed=0)
        assert req.outcome == "finished" and router.hists == {} and router.decisions == []
        assert "place_start_unix_s" not in req.hops[0]
        assert not (tmp_path / "router-requests.jsonl").exists()
        assert not any(k.endswith("_p99_ms") for k in router.metrics())

    def test_metrics_endpoint_renders_native_histograms(self):
        router, _, transport = make_router()
        transport.script("A", tokens=[1, 2])
        transport.script("B", tokens=[1, 2])
        router.submit([1], max_new_tokens=2, seed=0)
        text = prometheus_text(_RouterMetricsSession(router))
        assert "att_router_ttft_seconds_bucket{le=" in text
        assert "att_router_ttft_seconds_count 1" in text
        assert "att_router_requests_completed 1" in text

    def test_canary_and_autoscaler_are_later_slices(self):
        """Ported since (item 5(b)): both attach, publish their gauges in
        the router's rollup as the reference's router does, and close with
        it; a raising one does not fail the scrape."""

        class Attached:
            closed = 0

            def __init__(self, gauges):
                self.gauges = gauges

            def rollup_keys(self):
                if self.gauges is None:
                    raise RuntimeError("sick")
                return dict(self.gauges)

            def close(self):
                Attached.closed += 1

        for mod in (port_router, ref_router):
            router, _, _ = make_router(mod=mod)
            assert router.attach_canary(Attached({"canary/probes_sent": 3})) is router
            assert router.attach_autoscaler(Attached({"autoscale/evals": 2})) is router
            m = router.metrics()
            assert m["canary/probes_sent"] == 3 and m["autoscale/evals"] == 2
            router.attach_canary(Attached(None))
            assert "canary/probes_sent" not in router.metrics()
            router.close()
        assert Attached.closed == 4


def _fake_replica(tokens):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = _gauges(load=0.1).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
            self.send_response(200)
            self.end_headers()
            for i, t in enumerate(tokens):
                self.wfile.write((json.dumps({"event": "token", "i": i, "token": t}) + "\n")
                                 .encode())
            self.wfile.write((json.dumps({
                "event": "done", "outcome": "finished", "finish_reason": "budget",
                "tokens": tokens, "request_id": payload.get("request_id")}) + "\n").encode())

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
        return [json.loads(line) for line in resp.read().splitlines() if line.strip()]


class TestRouterServerHttp:
    def test_submit_register_placement_metrics_round_trip(self):
        replica = _fake_replica([4, 5, 6])
        router = Router({}, config=RouterConfig(poll_interval_s=0.05))
        server = RouterServer(router, port=0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert _post(f"{base}/v1/register", {
                "name": "r0", "url": f"http://127.0.0.1:{replica.server_address[1]}"})[0]["ok"]
            router.collector.poll_once()
            with urllib.request.urlopen(f"{base}/v1/placement", timeout=5) as resp:
                assert [r["replica"] for r in json.loads(resp.read())["placement"]] == ["r0"]
            lines = _post(f"{base}/v1/submit", {"prompt": [1, 2], "max_new_tokens": 3,
                                                "seed": 0})
            assert [e["token"] for e in lines if e["event"] == "token"] == [4, 5, 6]
            done = lines[-1]
            assert (done["event"], done["outcome"], done["replica"], done["requeues"]) == \
                ("done", "finished", "r0", 0)
            with urllib.request.urlopen(f"{base}/metrics", timeout=5) as resp:
                assert "att_router_requests_completed 1" in resp.read().decode()
        finally:
            server.close()
            router.close()
            replica.shutdown()
            replica.server_close()


def test_json_call_waits_past_the_connect_timeout_for_its_answer():
    """A KV handoff's answer may come after the connect timeout (a replica
    that installs tens of MB on a loaded host): the port's transport
    connects within ``connect_timeout_s`` and then waits up to
    ``read_timeout_s`` for each read (``HttpTransport``'s own rule).
    The reference's gives up at the connect timeout, as the port's does
    once the read timeout is short too."""
    import http.server

    class Slow(http.server.BaseHTTPRequestHandler):
        def _answer(self):
            time.sleep(0.6)
            body = json.dumps({"installed_tokens": 16}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self._answer()

        def do_GET(self):
            self._answer()

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        port_t = port_router.HttpTransport(connect_timeout_s=0.2, read_timeout_s=30.0)
        assert port_t.post_json(url, "/v1/kv/import", {"n_pages": 1}) == \
            {"installed_tokens": 16}
        assert port_t.get_json(url, "/v1/kv/directory") == {"installed_tokens": 16}
        for transport in (ref_router.HttpTransport(connect_timeout_s=0.2, read_timeout_s=30.0),
                          port_router.HttpTransport(connect_timeout_s=0.2,
                                                    read_timeout_s=0.2)):
            with pytest.raises(TimeoutError):
                transport.post_json(url, "/v1/kv/import", {"n_pages": 1})
    finally:
        httpd.shutdown()
        httpd.server_close()


class TestRouterHealthIntegration:
    def test_failed_replica_unreachable_within_one_poll(self):
        router, fleet, _ = make_router()
        fleet.set("A", dead=True)
        router.collector.poll_once()
        assert router.collector.replicas["A"].state == UNREACHABLE
        assert [r["replica"] for r in router.collector.placement_view()] == ["B"]


# ---------------------------------------------------------------------------
# port engines behind port replicas (the reference's test_replica_serving)
# ---------------------------------------------------------------------------

PAGE = 4
CACHE = 64
CHUNKS = (4, 8)


@pytest.fixture(scope="module")
def served():
    cfg = DecoderConfig.tiny(max_seq_len=CACHE, num_kv_heads=2)
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=0, device="cpu"))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, (n,)) for n in (12, 8, 5, 10)]
    return model, prompts


def _engine(model, name=None, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_cache_len", CACHE)
    kw.setdefault("prefill_chunks", CHUNKS)
    kw.setdefault("page_size", PAGE)
    return ServingEngine(model, device="cpu", replica=name, **kw)


def _refs(model, prompts, new, seeds, **kw):
    """Each request alone on a fresh engine: the uninterrupted runs."""
    out = []
    for p, s in zip(prompts, seeds):
        eng = _engine(model, **kw)
        req = eng.submit(p, max_new_tokens=new, seed=s)
        eng.run()
        out.append(list(req.tokens))
    return out


class TestKvHandoff:
    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_handoff_prefix_hit_bit_identical_vs_local_warm_cache(self, served, kv_dtype):
        """A warms a prompt and hands its pages to B; B's admission of it is
        a prefix hit of A's own warm re-admission's length, the prefill
        chunks skipped, and the stream equal; a quantized arena ships its
        scale leaves with the payloads."""
        model, prompts = served
        p = prompts[0]
        a, b = _engine(model, "A", kv_cache_dtype=kv_dtype), _engine(model, "B",
                                                                     kv_cache_dtype=kv_dtype)
        a.submit(p, max_new_tokens=4, seed=0)
        a.run()
        ra = a.submit(p, max_new_tokens=4, seed=7)
        a.run()
        assert ra.prefix_hit > 0 and a.prefill_chunks_skipped > 0
        handoff = json.loads(json.dumps(a.export_prefix_kv(p)))
        assert (handoff["page_size"], handoff["replica"]) == (PAGE, "A")
        assert handoff["n_pages"] == -(-handoff["token_len"] // PAGE)
        dtypes = {leaf["dtype"] for leaf in handoff["leaves"]}
        assert dtypes == ({"float32"} if kv_dtype is None else {"int8", "float32"})
        assert b.import_prefix_kv(handoff) == handoff["token_len"]
        rb = b.submit(p, max_new_tokens=4, seed=7)
        b.run()
        assert rb.prefix_hit == ra.prefix_hit and rb.tokens == ra.tokens
        assert b.prefill_chunks_skipped > 0
        assert b.metrics()["serving/kv_pages_imported"] == handoff["n_pages"]
        assert a.metrics()["serving/kv_pages_exported"] == handoff["n_pages"]

    def test_import_rejects_incompatible_wire_format(self, served):
        model, prompts = served
        a, b = _engine(model), _engine(model)
        a.submit(prompts[0], max_new_tokens=2, seed=0)
        a.run()
        handoff = a.export_prefix_kv(prompts[0])
        for key, value, match in (("page_size", PAGE * 2, "page_size"),
                                  ("kv_cache_dtype", "int8", "kv_cache_dtype"),
                                  ("leaves", handoff["leaves"][:-1], "leaves")):
            with pytest.raises(ValueError, match=match):
                b.import_prefix_kv(dict(handoff, **{key: value}))
        flat = ServingEngine(model, device="cpu", num_slots=1, max_cache_len=CACHE,
                             prefill_chunks=CHUNKS)
        with pytest.raises(ValueError, match="paged arena"):
            flat.export_prefix_kv(prompts[0])


def _eos_stream(model, prompt):
    """An eos id the greedy run of ``prompt`` reaches: its uninterrupted
    tokens from a fresh engine without one, cut at the first token (from
    the third on) that has not appeared before it. Returns ``(tokens up
    to and with the eos, the eos's index, the eos)``."""
    ref = _refs(model, [prompt], 24, [5])[0]
    j = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    return ref[:j + 1], j, ref[j]


class _BreakAfterTokenRouter(Router):
    """The port's router whose fault hook is consulted once more after a
    token event has been delivered, as the event of the next index: an
    armed ``drop_stream`` at ``after_tokens = i + 1`` breaks the stream
    right after token ``i`` reached the client, before the next event
    (the done event, when token ``i`` was the last)."""

    def _on_event(self, req, replica, hop, event, on_token, resumed):
        super()._on_event(req, replica, hop, event, on_token, resumed)
        if self._faults is not None and event.get("event") == "token":
            self._faults.on_stream_event(replica, int(event.get("i", 0)) + 1)


def _kill_drill(model, prompts, seeds, **kw):
    """Two port replicas behind the port's router; once tokens flow, the
    replica serving kills mid-stream. Returns the router's requests, the
    victim and the survivor."""
    ea, eb = _engine(model, "A", **kw), _engine(model, "B", **kw)
    a, b = ReplicaServer(ea, name="A").start(), ReplicaServer(eb, name="B").start()
    router = Router({"A": a.url, "B": b.url},
                    config=RouterConfig(backoff_base_s=0.01, backoff_cap_s=0.05,
                                        max_retries=6, poll_interval_s=0.1,
                                        migrate_session_kv=False))
    router.collector.poll_once()
    try:
        flowing = threading.Event()
        results = [None] * len(prompts)

        def one(i):
            results[i] = router.submit([int(t) for t in prompts[i]], max_new_tokens=24,
                                       seed=seeds[i], on_token=lambda t, r: flowing.set())

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        assert flowing.wait(timeout=60), "the burst never started"
        victim, survivor = (a, b) if ea._pending() else (b, a)
        victim.kill()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a request hung through the kill"
        assert victim.name in router._failed_now(time.time())
        router.collector.poll_once()
        assert victim.name not in {r["replica"] for r in router.collector.placement_view()}
        return results, victim, survivor, router
    finally:
        router.close()
        a.close()
        b.close()


class TestKillDrillTwoReplicas:
    def test_kill_mid_burst_every_request_token_exact(self, served):
        model, prompts = served
        seeds = list(range(len(prompts)))
        refs = _refs(model, prompts, 24, seeds)
        results, victim, survivor, router = _kill_drill(model, prompts, seeds)
        assert all(r.outcome == "finished" for r in results), \
            [(r.outcome, r.shed_reason) for r in results]
        for r, ref in zip(results, refs):
            assert r.tokens == ref, (r.hops, r.tokens, ref)
        requeued = [r for r in results if any("error" in h for h in r.hops)]
        assert requeued, "the kill never interrupted a request"
        for r in requeued:
            assert r.replica == survivor.name
            assert all(h["replica"] == victim.name for h in r.hops if "error" in h)
        assert router.requeues >= len(requeued) and router.requeue_success == len(requeued)

    def test_sampled_request_replayed_after_a_kill_equals_its_uninterrupted_run(self, served):
        """Sampled (temperature 1, top-k 8): the survivor's generator, seeded
        alike, draws past the tokens the killed hop delivered before it
        continues, so the stream is the uninterrupted run's."""
        model, prompts = served
        kw = dict(temperature=1.0, top_k=8)
        ref = _refs(model, prompts[:1], 24, [5], **kw)[0]
        results, victim, survivor, _ = _kill_drill(model, prompts[:1], [5], **kw)
        r = results[0]
        assert r.outcome == "finished" and r.replica == survivor.name
        assert [h["replica"] for h in r.hops if "error" in h] == [victim.name]
        assert r.tokens == ref

    @pytest.mark.parametrize("arena", ["paged", "flat"])
    @pytest.mark.parametrize("kw", [{}, dict(temperature=1.0, top_k=8)],
                             ids=["greedy", "sampled"])
    def test_continuation_equals_the_uninterrupted_tail(self, served, arena, kw):
        """What a re-queued hop submits: the prompt + the first k tokens, the
        budget left, ``resumed_tokens=k``. Its tokens are the uninterrupted
        run's from k on, k at the first token, mid-stream and at the last."""
        model, prompts = served
        p = prompts[0]
        if arena == "flat":
            kw = dict(kw, page_size=None)
        ref = _refs(model, [p], 24, [5], **kw)[0]
        for k in (1, 9, 23):
            eng = _engine(model, **kw)
            req = eng.submit(np.concatenate([p, np.asarray(ref[:k])]), max_new_tokens=24 - k,
                             seed=5, resumed_tokens=k)
            eng.run()
            assert ref[:k] + list(req.tokens) == ref, k
        with pytest.raises(ValueError, match="resumed_tokens"):
            _engine(model, **kw).submit(p, max_new_tokens=2, resumed_tokens=p.size)

    def test_continuation_that_ends_in_its_eos_finishes_at_submit(self, served):
        """Resumed tokens whose last is the engine's eos: the request
        finishes at once with "eos", draws nothing and takes no slot; a
        continuation that has not reached its eos decodes on."""
        model, prompts = served
        p = prompts[0]
        ref, j, eos = _eos_stream(model, p)
        for arena in ({}, {"page_size": None}):
            eng = _engine(model, eos_token_id=eos, **arena)
            req = eng.submit(np.concatenate([p, np.asarray(ref)]), max_new_tokens=24 - len(ref),
                             seed=5, resumed_tokens=len(ref))
            assert req.done and (req.outcome, req.finish_reason, req.tokens) == \
                ("finished", "eos", [])
            assert not eng.step() and eng.step_count == 0 and eng.prefill_dispatches == 0
            assert eng.metrics()["serving/requests_completed"] == 1
            assert len(eng._free) == eng.num_slots
            # one token short of the eos: the continuation decodes it
            req = eng.submit(np.concatenate([p, np.asarray(ref[:j])]),
                             max_new_tokens=24 - j, seed=5, resumed_tokens=j)
            eng.run()
            assert (req.finish_reason, ref[:j] + list(req.tokens)) == ("eos", ref)

    def test_stream_broken_after_its_eos_token_ends_at_the_eos(self, served):
        """Two port replicas with an eos id behind the port's router; the
        first hop's stream breaks right after its eos token event, before
        its done event (an injected ``drop_stream`` raised from
        ``faults.on_stream_event`` once the eos token was delivered). The
        re-queued continuation finishes on the survivor at the eos: the
        client's stream is the uninterrupted run's, eos last."""
        model, prompts = served
        p = prompts[0]
        ref, j, eos = _eos_stream(model, p)
        ea, eb = (_engine(model, n, eos_token_id=eos) for n in ("A", "B"))
        a, b = ReplicaServer(ea, name="A").start(), ReplicaServer(eb, name="B").start()
        faults = FaultInjector(seed=0).drop_stream(after_tokens=j + 1, count=1)
        router = _BreakAfterTokenRouter(
            {"A": a.url, "B": b.url}, faults=faults,
            config=RouterConfig(backoff_base_s=0.01, backoff_cap_s=0.05, max_retries=4,
                                poll_interval_s=0.1, migrate_session_kv=False))
        router.collector.poll_once()
        try:
            seen = []
            req = router.submit([int(t) for t in p], max_new_tokens=24, seed=5,
                                on_token=lambda t, r: seen.append(t))
            assert [kind for _, kind, _ in faults.log] == ["drop_stream"]
            assert (req.outcome, req.finish_reason) == ("finished", "eos")
            assert req.tokens == seen == ref and seen[-1] == eos
            assert len(req.hops) == 2 and "error" in req.hops[0]
            survivor = ea if req.replica == "A" else eb
            assert survivor.generated_tokens == 0 and survivor.step_count == 0
        finally:
            router.close()
            a.close()
            b.close()

    def test_session_kv_follows_migration_between_real_engines(self, served):
        """A session's first request lands on A; A drains; the session's next
        request goes to B with its KV migrated through the handoff
        endpoints: a prefix hit, the stream of A's own warm admission."""
        model, prompts = served
        p = prompts[0]
        ea, eb = _engine(model, "A"), _engine(model, "B")
        a, b = ReplicaServer(ea, name="A").start(), ReplicaServer(eb, name="B").start()
        router = Router({"A": a.url}, config=RouterConfig(backoff_base_s=0.01,
                                                          poll_interval_s=0.1))
        router.collector.poll_once()
        try:
            r1 = router.submit([int(t) for t in p], max_new_tokens=4, seed=0,
                               session="chat-1")
            assert (r1.outcome, r1.replica) == ("finished", "A")
            ra = ea.submit(p, max_new_tokens=4, seed=7)
            deadline = time.time() + 60
            while not ra.done and time.time() < deadline:
                time.sleep(0.005)
            assert ra.outcome == "finished" and ra.prefix_hit > 0
            router.register_replica("B", b.url)
            a.request_drain()
            deadline = time.time() + 30
            while time.time() < deadline:
                router.collector.poll_once()
                if not any(r["replica"] == "A" for r in router.collector.placement_view()):
                    break
                time.sleep(0.02)
            r2 = router.submit([int(t) for t in p], max_new_tokens=4, seed=7,
                               session="chat-1")
            assert (r2.outcome, r2.replica, router.kv_migrations) == ("finished", "B", 1)
            assert r2.prefix_hit > 0 and r2.tokens == [int(t) for t in ra.tokens]
            assert eb.kv_pages_imported > 0
        finally:
            router.close()
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# the CLI and the import guards
# ---------------------------------------------------------------------------


def test_serve_router_cli_fronts_a_port_replica(served):
    """``serve router`` as a subprocess: its start line, a stream through it
    to an in-process port replica, SIGTERM, exit code 0."""
    model, prompts = served
    eng = _engine(model, "A")
    replica = ReplicaServer(eng, name="A").start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "router", "--port", "0",
         "--replica", f"A={replica.url}", "--poll-interval", "0.05"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        start = json.loads(proc.stdout.readline())
        assert (start["role"], start["replicas"], start["canary"]) == ("router", 1, False)
        base = f"http://127.0.0.1:{start['port']}"
        deadline = time.time() + 60
        while time.time() < deadline:
            with urllib.request.urlopen(f"{base}/v1/placement", timeout=5) as resp:
                if json.loads(resp.read())["placement"]:
                    break
            time.sleep(0.05)
        lines = _post(f"{base}/v1/submit", {"prompt": [int(t) for t in prompts[1]],
                                            "max_new_tokens": 5, "seed": 0})
        ref = _refs(model, prompts[1:2], 5, [0])[0]
        assert [e["token"] for e in lines if e["event"] == "token"] == ref
        assert lines[-1]["outcome"] == "finished" and lines[-1]["replica"] == "A"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        replica.close()


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import {module}
assert not [m for m in sys.modules if m.split(".")[0] in {blocked}]
"""


@pytest.mark.parametrize("module,blocked", [
    ("accelerate_tpu_torch.serving.router", ("torch", "numpy")),
    ("accelerate_tpu_torch.commands.serve", ("torch", "numpy")),
    ("accelerate_tpu_torch.serving.tiers", ("torch",)),
    ("accelerate_tpu_torch.telemetry.fleet", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.timeline", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.alerts", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.capacity", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.scorecard", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.waterfall", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.incidents", ("torch", "numpy")),
    ("accelerate_tpu_torch.telemetry.canary", ("torch", "numpy")),
    ("accelerate_tpu_torch.serving.autoscaler", ("torch", "numpy")),
    ("accelerate_tpu_torch.commands.loadtest", ("torch", "numpy")),
    ("accelerate_tpu_torch.commands.autoscale", ("torch", "numpy")),
    ("accelerate_tpu_torch.commands.incident", ("torch", "numpy")),
    ("accelerate_tpu_torch.serving.loadgen", ("torch",)),
])
def test_imports_without_the_accelerator_stack(module, blocked):
    """A router box has no accelerator stack: the router (and the CLI that
    starts it), the fleet collector, the timeline, the alerts, the capacity
    model, the scorecard, the waterfall, incident reconstruction, the
    canary, the autoscaler and the loadtest / autoscale / incident commands
    import with torch and numpy blocked; the KV tiers and the load
    generator with torch blocked (both keep numpy arrays)."""
    r = subprocess.run([sys.executable, "-c", BLOCKER.format(module=module,
                                                             blocked=set(blocked))],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
