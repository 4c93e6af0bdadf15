"""The port's fleet plane, timeline and alerts
(``accelerate_tpu_torch/telemetry/fleet.py``, ``timeline.py``,
``alerts.py`` and the session that samples them) on the CPU, mirroring
the reference's ``tests/test_fleet.py`` and the timeline and alert
classes of ``tests/test_timeline.py``.

Every scenario runs once on the port's modules and once on the
reference's, on the same inputs under one fake clock, and the two must
give the same answers:
- the exposition parser on hostile, torn and exemplar-bearing text, and
  on a port replica's own ``/metrics`` (a session with its histograms,
  timeline freshness and alert series);
- the load score, the merge policy table, gauge merges (counters
  conserved over a dead replica) and exact histogram merges;
- the health state machine's walk, its event log file, the
  ``fleet/replica_down`` rule, placement re-ranking and offline artifact
  targets;
- timeline downsampling, windows, series and persistence;
- threshold and burn-rate alert lifecycles and the default ruleset.

Then the port alone: the session's timeline and alerts reach the
exposition and the artifact directory, and a collector over live port
scrape servers conserves counters through a replica's death.
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from accelerate_tpu.telemetry import alerts as ref_alerts
from accelerate_tpu.telemetry import exporter as ref_exporter
from accelerate_tpu.telemetry import fleet as ref_fleet
from accelerate_tpu.telemetry import histograms as ref_hist
from accelerate_tpu.telemetry import timeline as ref_timeline
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
from accelerate_tpu_torch.telemetry import alerts as port_alerts
from accelerate_tpu_torch.telemetry import exporter as port_exporter
from accelerate_tpu_torch.telemetry import fleet as port_fleet
from accelerate_tpu_torch.telemetry import histograms as port_hist
from accelerate_tpu_torch.telemetry import timeline as port_timeline

PORT = types.SimpleNamespace(fleet=port_fleet, hist=port_hist, exporter=port_exporter,
                             timeline=port_timeline, alerts=port_alerts)
REF = types.SimpleNamespace(fleet=ref_fleet, hist=ref_hist, exporter=ref_exporter,
                            timeline=ref_timeline, alerts=ref_alerts)


def both(scenario, *args):
    """``scenario(side, *args)`` on the port and the reference: equal."""
    got, want = scenario(PORT, *args), scenario(REF, *args)
    assert got == want
    return got


class StubReplicaSession:
    """The minimal scrape-able replica: rollup gauges + a native SLO
    histogram, what the exporter renders."""

    def __init__(self, side, **gauges):
        self.hists = {"serving/itl": side.hist.StreamingHistogram()}
        self.alerts = None
        self.last_sample_unix_s = time.time()
        self.gauges = {"serving/queue_depth": 0, "serving/slot_occupancy": 0.0,
                       "serving/num_slots": 4, "serving/free_slots": 4,
                       "serving/generated_tokens": 0, "serving/requests_completed": 0,
                       "serving/tokens_per_s": 100.0, "serving/load_score": 0.0}
        self.gauges.update(gauges)

    def rollup(self):
        return dict(self.gauges)

    def touch(self):
        self.last_sample_unix_s = time.time()


def _snap_tuple(snap):
    return (snap.gauges, snap.alerts, snap.histograms, snap.skipped_lines)


# ---------------------------------------------------------------------------
# the exposition parser
# ---------------------------------------------------------------------------

PARSER_TEXTS = {
    "nan_inf_torn": ("att_ok 1.5\natt_dropme NaN\natt_posinf +Inf\natt_neginf -Inf\n"
                     "att_torn_no_value\natt_torn 1.2.3\natt_half_writ"),
    "hostile_labels": ('att_alert_firing{rule="plain"} 1\n'
                       'att_alert_firing{rule="with \\"quotes\\" and \\\\slash"} 0\n'
                       'att_alert_firing{rule="brace}inside"} 1\n'
                       'att_alert_firing{rule="new\\nline"} 0\n'),
    "timestamped": "att_x 2.0 1700000000\n",
    "torn_exemplars": ('att_h_seconds_bucket{le="0.1"} 3 # {request_id="ok"} 0.09 1.5\n'
                       'att_h_seconds_bucket{le="0.2"} 4 # {request_id="torn\n'
                       'att_h_seconds_bucket{le="0.4"} 5 # {} 0.3\n'
                       'att_h_seconds_bucket{le="0.8"} 6 # {request_id="noval"}\n'
                       'att_h_seconds_bucket{le="1.6"} 7 # {request_id="nanval"} NaN\n'
                       'att_h_seconds_bucket{le="3.2"} 8 # garbage trailing junk\n'
                       'att_g 1.0 # {request_id="on-a-gauge"} 9.9\n'
                       "att_h_seconds_sum 1.0\natt_h_seconds_count 8\n"),
}


@pytest.mark.parametrize("case", sorted(PARSER_TEXTS))
def test_parser_reads_hostile_text_as_the_reference(case):
    snap = both(lambda side: _snap_tuple(side.fleet.parse_exposition(PARSER_TEXTS[case])))
    if case == "nan_inf_torn":
        assert snap[0]["ok"] == 1.5 and "dropme" not in snap[0] and snap[3] >= 2
    elif case == "hostile_labels":
        assert snap[1]["brace}inside"] == 1


def test_parser_round_trips_the_exporter_with_exemplars():
    """The port's exporter renders histograms (with hostile exemplar
    labels) that both parsers read alike, and rebuild into the same
    buckets."""
    def scenario(side):
        h = side.hist.StreamingHistogram()
        rid = 'req "q" \\slash\nnewline'
        for i, v in enumerate((0.001, 0.004, 0.02, 0.02, 0.5)):
            h.observe(v, exemplar={"request_id": rid if i == 2 else f"r{i}", "replica": "r0"})
        sess = StubReplicaSession(side)
        sess.hists = {"serving/ttft": h}
        sess.last_sample_unix_s = None
        text = side.exporter.prometheus_text(sess)
        snap = side.fleet.parse_exposition(text)
        data = snap.histograms["serving_ttft"]
        rebuilt = side.hist.StreamingHistogram.from_cumulative(
            data["buckets"], sum_value=data["sum"], exemplars=data["exemplars"])
        exemplars = sorted((round(e["value"], 9), e["request_id"], e.get("replica"))
                           for _, e in data["exemplars"])
        return (snap.gauges, data["count"], round(data["sum"], 12), rebuilt.counts == h.counts,
                exemplars, [line for line in text.splitlines() if "# {" not in line])

    got = both(scenario)
    assert got[1] == 5 and got[3]


@pytest.fixture(scope="module")
def replica_metrics():
    """A port replica with a telemetry session (timeline sampled by hand,
    the default alert rules) after three requests: its ``/metrics`` text
    and the engine's gauges."""
    cfg = DecoderConfig.tiny(max_seq_len=64, num_kv_heads=2)
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=0, device="cpu"))
    session = TelemetrySession(TelemetryConfig(flight_hooks=False, timeline_interval_s=0))
    engine = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                           prefill_chunks=(4, 8), page_size=8, telemetry=session)
    server = ReplicaServer(engine, name="m").start()
    try:
        rng = np.random.RandomState(0)
        for n in (12, 9, 5):
            req = engine.submit(rng.randint(3, 256, (n,)), max_new_tokens=4)
            while not req.done:
                time.sleep(0.002)
        session.sample_timeline()
        with urllib.request.urlopen(f"{server.url}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        return text, engine.metrics()
    finally:
        server.close()
        session.close()


def test_parser_reads_a_port_replicas_metrics(replica_metrics):
    """Both parsers read a port replica's scrape alike: the load score the
    engine exports, the SLO histograms, the freshness gauge the timeline
    advances and the alert series."""
    text, gauges = replica_metrics
    snap = both(lambda side: _snap_tuple(side.fleet.parse_exposition(text)))
    g, alerts_, hists, skipped = snap
    assert skipped == 0
    assert g["serving_load_score"] == gauges["serving/load_score"]
    assert g["serving_requests_completed"] == 3 and "scrape_age_seconds" in g
    assert hists["serving_ttft"]["count"] == 3
    assert set(alerts_) >= {"shed_burn_rate", "page_arena_watermark"}
    assert not any(alerts_.values())
    unflat = both(lambda side: {side.fleet.unflatten_key(k): v for k, v in g.items()})
    assert unflat["serving/load_score"] == gauges["serving/load_score"]


# ---------------------------------------------------------------------------
# load score and merges
# ---------------------------------------------------------------------------


def test_load_score_and_its_recompute_equal_the_reference():
    rng = np.random.RandomState(1)
    rows = []
    for _ in range(200):
        kw = dict(queue_depth=int(rng.randint(0, 9)), num_slots=int(rng.randint(1, 9)),
                  slot_occupancy=float(rng.rand()), free_pages=float(rng.randint(0, 50)),
                  pages_total=float(rng.choice([0, 50])),
                  itl_recent_p99_ms=None if rng.rand() < 0.3 else float(rng.rand() * 90),
                  itl_slo_ms=None if rng.rand() < 0.5 else 25.0, draining=bool(rng.rand() < .1))
        rows.append(kw)
    got = both(lambda side: [side.fleet.load_score(**kw) for kw in rows])
    assert len(set(got)) > 100
    gauges = [{"serving/queue_depth": r["queue_depth"], "serving/num_slots": r["num_slots"],
               "serving/free_slots": r["num_slots"] - 1, "serving/free_pages": r["free_pages"],
               "serving/pages_total": r["pages_total"]} for r in rows]
    both(lambda side: [side.fleet.load_score_from_gauges(g) for g in gauges])


POLICY_KEYS = [
    "serving/generated_tokens", "usage/acme_decode_tokens", "serving/ttft_count",
    "serving/queue_depth", "serving/pages_total", "serving/slot_occupancy",
    "serving/prefix_hit_ratio", "serving/itl_p99_ms", "scrape_age_seconds",
    "router/requests_submitted", "router/failures/replicaB", "router/failures_replicaB",
    "router/shed/router_queue_full", "router/inflight", "router/ttft_p99_ms",
    "canary/pass_ratio", "canary/last_pass_unix_s", "serving/capacity_tokens_per_s",
    "serving/headroom_frac", "serving/kv_demotions_host", "serving/kv_host_bytes",
    "serving/kv_tier_hits_peer", "serving/kv_tier_hit_ratio_host",
    "serving/kv_restore_overlap_frac", "serving/kv_pages_imported", "serving/ghost_reuses",
    "serving/ghost_hit_ratio_4x", "serving/ghost_reuse_distance_p99", "serving/load_score",
    "serving/prefix_entries", "serving/prefill_chunks_skipped", "alerts/firing_count",
]


def test_merge_policy_table_equals_the_reference():
    table = both(lambda side: [side.fleet.merge_policy(k) for k in POLICY_KEYS])
    assert table[:4] == ["sum_counter", "sum_counter", "sum_counter", "sum_live"]


def test_gauge_and_histogram_merges_equal_the_reference():
    """Random replica gauge sets, some dead: the merged fleet view; and
    exact log-bucket merges of random shards (counts, sums, quantiles)."""
    rng = np.random.RandomState(2)
    replicas = []
    for r in range(5):
        g = {k: float(rng.rand() * 100) for k in POLICY_KEYS if rng.rand() < 0.8}
        replicas.append((g, bool(r % 3)))
    merged = both(lambda side: side.fleet.merge_gauges(replicas))
    live = [g for g, ok in replicas if ok]
    assert merged["serving/queue_depth"] == pytest.approx(
        sum(g.get("serving/queue_depth", 0.0) for g in live))
    shards = [rng.lognormal(mean=m, sigma=s, size=n)
              for m, s, n in ((-4.0, 0.8, 400), (-3.0, 0.5, 300), (-2.5, 0.3, 50))]

    def hists(side):
        snaps = []
        for shard in shards:
            h = side.hist.StreamingHistogram()
            for v in shard:
                h.add(float(v))
            sess = StubReplicaSession(side)
            sess.hists = {"serving/itl": h}
            snaps.append(side.fleet.parse_exposition(side.exporter.prometheus_text(sess))
                         .histograms)
        out = side.fleet.merge_histograms(snaps)["serving_itl"]
        return out.count, round(out.sum, 9), [out.quantile(q) for q in (0.5, 0.95, 0.99)]

    count, _, quantiles = both(hists)
    everything = np.concatenate(shards)
    assert count == everything.size
    for q, est in zip((0.5, 0.95, 0.99), quantiles):
        exact = float(np.quantile(everything, q))
        assert abs(est - exact) / exact < 0.13


# ---------------------------------------------------------------------------
# the health state machine and placement
# ---------------------------------------------------------------------------


class _ScriptedFetch:
    def __init__(self):
        self.replies = {}

    def set(self, target, reply):
        self.replies[target] = reply

    def __call__(self, target):
        reply = self.replies[target]
        if isinstance(reply, Exception):
            raise reply
        return reply


def _snap(side, gauges):
    s = side.fleet.ExpositionSnapshot()
    s.gauges = dict(gauges)
    return s


def _collector(side, log_dir=None, **kw):
    fetch = _ScriptedFetch()
    kw.setdefault("stale_after_s", 5.0)
    kw.setdefault("dead_after_s", 10.0)
    c = side.fleet.FleetCollector([("A", "a"), ("B", "b")], fetch_fn=fetch,
                                  clock=lambda: 0.0, log_dir=log_dir, **kw)
    return c, fetch


def _events(c):
    return [(e["replica"], e["from"], e["to"], e["reason"], e["t_unix_s"]) for e in c.events]


def test_full_walk_and_event_log_equal_the_reference(tmp_path):
    def scenario(side):
        d = tmp_path / ("port" if side is PORT else "ref")
        c, fetch = _collector(side, log_dir=str(d))
        ok = {"serving_queue_depth": 1, "serving_load_score": 0.5, "scrape_age_seconds": 0.1}
        states = []
        for now, a in ((1.0, ok), (2.0, {**ok, "scrape_age_seconds": 30.0}),
                       (3.0, {**ok, "serving_draining": 1.0}), (4.0, OSError("refused")),
                       (14.0, OSError("refused")), (15.0, ok)):
            fetch.set("a", a if isinstance(a, Exception) else _snap(side, a))
            fetch.set("b", _snap(side, ok))
            c.poll_once(now=now)
            states.append({n: r.state for n, r in c.replicas.items()})
        gauges = c.fleet_gauges()
        view = c.placement_view(include_unplaceable=True)
        c.close()
        lines = [json.loads(line) for line in open(d / "fleet-events.jsonl")]
        return states, _events(c), [(e["replica"], e["from"], e["to"]) for e in lines], \
            gauges, view

    states, events, _, _, _ = both(scenario)
    assert [s["A"] for s in states] == [
        port_fleet.HEALTHY, port_fleet.DEGRADED, port_fleet.DRAINING, port_fleet.UNREACHABLE,
        port_fleet.DEAD, port_fleet.HEALTHY]


def test_never_up_replica_and_replica_down_rule_equal_the_reference():
    def scenario(side):
        c, fetch = _collector(side, dead_after_s=5.0, replica_down_for_s=1.5)
        fetch.set("a", OSError("refused"))
        fetch.set("b", _snap(side, {"serving_queue_depth": 0, "serving_load_score": 0.1}))
        out = []
        for now in (1.0, 2.0, 4.0, 20.0):
            c.poll_once(now=now)
            out.append(({n: r.state for n, r in c.replicas.items()},
                        c.alerts.states_snapshot()["fleet/replica_down"]["state"]))
        fetch.set("a", _snap(side, {"serving_queue_depth": 0}))
        c.poll_once(now=21.0)
        out.append([(e["rule"], e["state"]) for e in c.alerts.events])
        return out, _events(c)

    out, _ = both(scenario)
    assert out[0][0]["A"] == port_fleet.STARTING and out[3][0]["A"] == port_fleet.DEAD


def test_placement_reranks_as_the_reference():
    def scenario(side):
        c, fetch = _collector(side)
        base = {"serving_queue_depth": 1, "serving_num_slots": 4,
                "serving_slot_occupancy": 0.25, "serving_free_pages": 30,
                "serving_pages_total": 40, "serving_itl_recent_p99_ms": 10.0}
        out = []
        for now, (a_over, b_over) in enumerate((({}, {"serving_queue_depth": 5}),
                                                ({"serving_queue_depth": 9}, {}),
                                                ({"serving_free_pages": 2}, {}),
                                                ({}, {"serving_itl_recent_p99_ms": 80.0}),
                                                ({"serving_draining": 1.0}, {}))):
            for target, over in (("a", a_over), ("b", b_over)):
                g = {**base, **over}
                g["serving_load_score"] = side.fleet.load_score(
                    queue_depth=g["serving_queue_depth"], num_slots=g["serving_num_slots"],
                    slot_occupancy=g["serving_slot_occupancy"],
                    free_pages=g["serving_free_pages"], pages_total=g["serving_pages_total"],
                    itl_recent_p99_ms=g["serving_itl_recent_p99_ms"])
                fetch.set(target, _snap(side, g))
            c.poll_once(now=float(now + 1))
            out.append(c.placement_view(include_unplaceable=True))
        return out

    views = both(scenario)
    assert [[r["replica"] for r in v if r["placeable"]] for v in views] == \
        [["A", "B"], ["B", "A"], ["B", "A"], ["A", "B"], ["B"]]


def test_offline_targets_cross_between_port_and_reference(tmp_path):
    """A timeline the port's session wrote is a fleet target the reference
    collector reads, and the reverse: the same state and gauges."""
    for writer in (PORT, REF):
        d = tmp_path / ("w_port" if writer is PORT else "w_ref")
        d.mkdir()
        tl = writer.timeline.Timeline()
        tl.add_sample({"serving/queue_depth": 3.0, "serving/load_score": 1.5}, now=1000.0)
        tl.flush_jsonl(str(d / "timeline-host0.jsonl"))

        def scenario(side, d=d):
            out = []
            for now in (1002.0, 2000.0):
                c = side.fleet.FleetCollector([("R", str(d))], clock=lambda: now,
                                              stale_after_s=10.0)
                c.poll_once(now=now)
                out.append((c.replicas["R"].state, c.replicas["R"].gauges,
                            c.placement_view()))
            return out

        out = both(scenario)
        assert [o[0] for o in out] == [port_fleet.HEALTHY, port_fleet.DEGRADED]


# ---------------------------------------------------------------------------
# the timeline
# ---------------------------------------------------------------------------


def test_timeline_downsampling_windows_and_series_equal_the_reference(tmp_path):
    rng = np.random.RandomState(3)
    vals = rng.uniform(0, 100, (3000, 3))

    def scenario(side):
        tl = side.timeline.Timeline(tiers=((1.0, 64), (10.0, 32), (60.0, 16)))
        for i, (x, y, z) in enumerate(vals):
            sample = {"x": float(x), "ctr": float(i * 3), "y": float(y)}
            if z > 50:
                sample["z"] = float(z)
            tl.add_sample(sample, now=1000.5 + i)
        windows = {(k, w): tl.window(k, w) for k in ("x", "ctr", "z", "missing")
                   for w in (5.0, 60.0, 600.0, 3000.0)}
        path = tmp_path / f"{'port' if side is PORT else 'ref'}.jsonl"
        tl.flush_jsonl(str(path))
        back = side.timeline.load_timeline(str(path))
        return (windows, tl.points("x", 600.0), tl.series("x", 3000.0, max_points=40),
                len(tl.raw), [len(t.points) for t in tl.tiers], tl.sample_count,
                back.sample_count, back.window("x", 30.0))

    out = both(scenario)
    assert out[0][("missing", 60.0)] is None and out[3] == 64
    assert out[0][("ctr", 60.0)]["rate"] == pytest.approx(3.0)


def test_timeline_sampler_thread_ticks_and_stops():
    ticks = []
    sampler = port_timeline.TimelineSampler(lambda: ticks.append(1), interval_s=0.01).start()
    deadline = time.time() + 10
    while len(ticks) < 3 and time.time() < deadline:
        time.sleep(0.005)
    sampler.stop()
    n = len(ticks)
    time.sleep(0.05)
    assert n >= 3 and len(ticks) <= n + 1


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------


def _alert_run(side, rules, stream):
    """Drive ``rules`` over ``stream`` (``(t, sample)`` pairs): the events
    and the final states."""
    tl = side.timeline.Timeline(tiers=((1.0, 1024),))
    fired = []
    mgr = side.alerts.AlertManager(tl, rules(side, fired), clock=lambda: 0.0)
    for t, sample in stream:
        tl.add_sample(sample, now=t)
        mgr.evaluate(now=t)
    return ([{k: v for k, v in e.items()} for e in mgr.events], mgr.states_snapshot(),
            mgr.rollup_keys(), fired)


ALERT_CASES = {
    "threshold_lifecycle": (
        lambda side, fired: [side.alerts.AlertRule(
            "hot", key="temp", op=">", threshold=50.0, for_s=3.0,
            actions=(lambda r, s, v: fired.append((r.name, v)),))],
        [(100.0 + i, {"temp": 10.0}) for i in range(5)]
        + [(105.0, {"temp": 90.0}), (106.0, {"temp": 91.0}), (108.0, {"temp": 92.0}),
           (109.0, {"temp": 5.0})]),
    "pending_clears": (
        lambda side, fired: [side.alerts.AlertRule("hot", key="temp", threshold=50.0,
                                                   for_s=10.0)],
        [(10.0, {"temp": 90.0}), (11.0, {"temp": 1.0})]),
    "ratio_zero_hold": (
        lambda side, fired: [side.alerts.AlertRule.parse("arena", "used / total > 0.9")],
        [(1.0, {"used": 95.0, "total": 100.0})]),
    "missing_series": (
        lambda side, fired: [side.alerts.AlertRule("ghost", key="not/there", threshold=1.0)],
        [(1.0, {"x": 1.0})]),
    "gated": (
        lambda side, fired: [side.alerts.AlertRule(
            "collapse", key="goodput/goodput_frac", op="<", threshold=0.5, window_s=5.0,
            stat="mean", gate_key="sys/tokens_per_s")],
        [(float(i), {"goodput/goodput_frac": 0.0}) for i in range(8)]
        + [(float(i), {"goodput/goodput_frac": 0.1, "sys/tokens_per_s": 1000.0})
           for i in range(8, 16)]),
    "delta_storm": (
        lambda side, fired: [side.alerts.AlertRule("storm", key="sys/recompiles_diagnosed",
                                                   stat="delta", window_s=10.0,
                                                   threshold=2.0)],
        [(float(i), {"sys/recompiles_diagnosed": 1.0 + max(0, i - 4) * i}) for i in range(10)]),
    "burn_sustained": (
        lambda side, fired: [side.alerts.BurnRateRule("burn", key="lat", slo=100.0, fast_s=5.0,
                                                      slow_s=20.0, budget=0.1, factor=2.0)],
        [(float(t), {"lat": 10.0 if t < 25 or t >= 31 else 500.0}) for t in range(39)]),
    "burn_spike": (
        lambda side, fired: [side.alerts.BurnRateRule("burn", key="lat", slo=100.0, fast_s=5.0,
                                                      slow_s=20.0, budget=0.3, factor=2.0)],
        [(float(t), {"lat": 500.0 if t == 25 else 10.0}) for t in range(30)]),
    "burn_counter": (
        lambda side, fired: [side.alerts.BurnRateRule("sheds", key="shed", total_key="terminal",
                                                      budget=0.05, fast_s=5.0, slow_s=20.0,
                                                      factor=2.0)],
        [(float(t), {"shed": float(2 * max(0, t - 24)), "terminal": float(4 * (t + 1))})
         for t in range(31)]),
    "default_ruleset": (
        lambda side, fired: side.alerts.default_ruleset(itl_slo_ms=50.0),
        [(float(t), {"serving/itl_recent_p99_ms": 20.0 if t < 30 else 400.0,
                     "serving/pages_in_use": 10.0 + 3 * t, "serving/pages_total": 100.0,
                     "serving/shed": 0.0, "serving/requests_completed": 4.0 * t})
         for t in range(60)]),
}


@pytest.mark.parametrize("case", sorted(ALERT_CASES))
def test_alert_lifecycles_equal_the_reference(case):
    rules, stream = ALERT_CASES[case]
    events, states, _, fired = both(lambda side: _alert_run(side, rules, stream))
    if case == "threshold_lifecycle":
        assert [e["state"] for e in events] == ["pending", "firing", "resolved"]
        assert fired == [("hot", 92.0)]
    elif case == "burn_sustained":
        assert states["burn"]["state"] == "ok" and states["burn"]["fired_count"] == 1
    elif case == "default_ruleset":
        assert states["page_arena_watermark"]["fired_count"] == 1


def test_default_rulesets_and_validation_equal_the_reference():
    def shape(side):
        out = []
        for slo in (None, 50.0):
            out.append([(type(r).__name__, r.name, r.key, getattr(r, "threshold", None),
                         getattr(r, "slo", None)) for r in side.alerts.default_ruleset(
                             itl_slo_ms=slo)])
        for kw in ({"budget": 0.0, "slo": 1.0}, {"budget": 0.1, "slo": 1.0, "fast_s": 60.0,
                                                 "slow_s": 30.0}, {"budget": 0.1}):
            with pytest.raises(ValueError):
                side.alerts.BurnRateRule("x", key="k", **kw)
        r = side.alerts.AlertRule.parse("tiny", "goodput/goodput_frac < 1e-3 for 30s")
        out.append((r.key, r.op, r.threshold, r.for_s))
        return out

    rules = both(shape)
    assert "itl_burn_rate" in {r[1] for r in rules[1]}
    assert "itl_burn_rate" not in {r[1] for r in rules[0]}


# ---------------------------------------------------------------------------
# the port alone: the session's ops plane and a live drill
# ---------------------------------------------------------------------------


def test_session_samples_timeline_and_alerts_into_artifacts(tmp_path):
    """``sample_timeline()`` advances the exposition's freshness clock and
    runs an alert pass; close() persists the timeline and the alert log;
    the exposition carries ``att_scrape_age_seconds`` and the alert
    series, and its ``alerts/*`` gauges ride the rollup."""
    rules = [port_alerts.AlertRule.parse("q", "serving/queue_depth >= 1")]
    session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path), flight_hooks=False,
                                               timeline_interval_s=0, alert_rules=rules))
    try:
        assert session.last_sample_unix_s is None
        class Engine:
            telemetry = session

            def metrics(self):
                return {"serving/queue_depth": 2.0}

        eng = Engine()
        session.attach_serving(eng)
        session.sample_timeline(now=100.0)
        assert session.last_sample_unix_s is not None
        assert session.alerts.states["q"].state == port_alerts.FIRING
        text = port_exporter.prometheus_text(session)
        assert "att_scrape_age_seconds " in text
        assert 'att_alert_firing{rule="q"} 1' in text
        rolled = session.rollup()
        assert (rolled["alerts/firing_count"], rolled["alerts/q_firing"]) == (1, 1)
    finally:
        session.close()
    assert port_timeline.load_timeline(str(tmp_path)).sample_count == 1
    assert [json.loads(line)["state"] for line in open(tmp_path / "alerts-host0.jsonl")] == \
        ["pending", "firing"]


def test_sampler_thread_runs_at_the_session_cadence():
    session = TelemetrySession(TelemetryConfig(flight_hooks=False, timeline_interval_s=0.02))
    try:
        deadline = time.time() + 10
        while session.timeline.sample_count < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert session.timeline.sample_count >= 3
    finally:
        session.close()
    assert not session._sampler._thread.is_alive()


def test_live_drill_conserves_counters_and_reranks(tmp_path):
    """Two port scrape servers under one collector; one dies mid-burst:
    placement drops it within one poll, ``fleet/replica_down`` walks
    pending -> firing, the token counter keeps the victim's last scrape,
    the fleet ITL quantile is the exact merge, and the snapshot loads."""
    sessions = {"A": StubReplicaSession(PORT, **{"serving/load_score": 0.5}),
                "B": StubReplicaSession(PORT, **{"serving/load_score": 0.2})}
    servers = {k: port_exporter.ScrapeServer(s, port=0) for k, s in sessions.items()}
    clock = {"t": 1000.0}
    c = port_fleet.FleetCollector([(k, f"http://127.0.0.1:{srv.port}/metrics")
                                   for k, srv in servers.items()],
                                  clock=lambda: clock["t"], dead_after_s=5.0,
                                  replica_down_for_s=1.0, log_dir=str(tmp_path))
    try:
        def burst():
            for name, s in sessions.items():
                s.gauges["serving/generated_tokens"] += 10 if name == "A" else 7
                s.hists["serving/itl"].add(0.004 if name == "A" else 0.05)
                s.touch()

        for _ in range(3):
            burst()
            clock["t"] += 1.0
            c.poll_once()
        m = c.fleet_gauges()
        assert m["fleet/replicas_healthy"] == 2 and m["serving/generated_tokens"] == 51
        assert [r["replica"] for r in c.placement_view()] == ["B", "A"]
        direct = port_hist.StreamingHistogram()
        for s in sessions.values():
            direct.merge(s.hists["serving/itl"])
        assert m["serving/itl_count"] == direct.count
        b_last = sessions["B"].gauges["serving/generated_tokens"]
        servers["B"].close()
        burst()
        clock["t"] += 1.0
        c.poll_once()
        assert [r["replica"] for r in c.placement_view()] == ["A"]
        assert c.replicas["B"].state == port_fleet.UNREACHABLE
        assert c.alerts.states_snapshot()["fleet/replica_down"]["state"] == "pending"
        clock["t"] += 2.0
        c.poll_once()
        assert c.alerts.states_snapshot()["fleet/replica_down"]["state"] == "firing"
        clock["t"] += 4.0
        c.poll_once()
        assert c.replicas["B"].state == port_fleet.DEAD
        assert c.fleet_gauges()["serving/generated_tokens"] == \
            sessions["A"].gauges["serving/generated_tokens"] + b_last
        c.write_snapshot()
        data = port_fleet.load_fleet(str(tmp_path))
        assert data["replicas"]["B"]["state"] == port_fleet.DEAD
        assert any(e["to"] == port_fleet.DEAD for e in data["events"])
    finally:
        c.close()
        for srv in servers.values():
            srv.close()


def _fleet_threads(exclude=frozenset()) -> list:
    """The live threads of a collector (its sampler and scrape pool),
    but those in ``exclude``: a collector another test left unclosed keeps
    its pool alive in this process, which says nothing of this one."""
    return [t for t in threading.enumerate()
            if t.name.startswith(("att-fleet", "att-timeline")) and t.is_alive()
            and t.ident not in exclude]


def _poll_then_close(names):
    """Polls on its own thread, stops at close(): no poll after it, and no
    thread it started (the sampler, the scrape pool of several replicas)
    outlives it."""
    before = {t.ident for t in threading.enumerate()}
    hits = []

    def fetch(target):
        hits.append(target)
        return "att_serving_load_score 0.1\n"

    c = port_fleet.FleetCollector([(n, n.lower()) for n in names], fetch_fn=fetch,
                                  poll_interval_s=0.01)
    c.start()
    deadline = time.time() + 10
    while c.polls < 3 and time.time() < deadline:
        time.sleep(0.005)
    c.close()
    assert c.polls >= 3 and all(c.replicas[n].state == port_fleet.HEALTHY for n in names)
    n = len(hits)
    time.sleep(0.05)
    assert len(hits) == n
    assert not _fleet_threads(exclude=before)


def test_collector_polls_in_the_background_and_stops():
    _poll_then_close(("A",))


def test_collector_close_joins_its_scrape_pool():
    _poll_then_close(("A", "B", "C"))


def test_servers_queue_a_burst_of_connections():
    """A server whose accept loop is held (as the GIL holds it behind a
    busy engine thread) still completes a burst of 64 connections in the
    kernel: none waits out a SYN resend. socketserver's default backlog
    of 5 completes 6 and leaves the rest to time out."""
    import http.server
    import socket

    from accelerate_tpu_torch.telemetry.exporter import http_server

    def burst(server):
        port = server.server_address[1]
        socks, ok = [], 0
        try:
            for _ in range(64):
                s = socket.socket()
                s.settimeout(0.3)
                try:
                    s.connect(("127.0.0.1", port))
                    ok += 1
                except OSError:
                    pass
                socks.append(s)
        finally:
            for s in socks:
                s.close()
            server.server_close()
        return ok

    handler = http.server.BaseHTTPRequestHandler
    assert burst(http_server(("127.0.0.1", 0), handler)) == 64
    assert burst(http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)) < 64
