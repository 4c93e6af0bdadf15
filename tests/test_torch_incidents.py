"""The port's latency waterfall and incident reconstruction
(``accelerate_tpu_torch/telemetry/waterfall.py``, ``incidents.py``) and the
``incident`` command on the CPU, held against the reference's
``accelerate_tpu/telemetry/waterfall.py`` and ``incidents.py``.

- Waterfalls: ``waterfall_stages`` on the reference tests' hand-built
  records (one hop, clock skew, overrunning replica durations, a
  re-queue, the slow stage, unstamped records, and
  ``tests/test_kv_tiers.py::TestWaterfallStage``'s ``kv_restore`` case)
  and ``build_waterfalls`` / ``summarize_waterfall`` / ``stage_table`` on
  seeded bursts equal the reference's, stages summing exactly; a router
  over port replicas with telemetry sessions writes records whose
  waterfalls sum to each request's client-observed TTFT.
- Incidents: ``incident_windows`` and ``replica_stage_breakdown`` on the
  reference tests' cases and seeded streams, ``reconstruct_incidents`` /
  ``summarize_incidents`` on a synthetic drill dir (also across rotated
  generations) and on the directory a port drill writes (a replica over
  other weights caught by the canary, ``canary_failing`` fired by a fleet
  collector, the flight bundle dumped on that replica) equal the
  reference's; the incident names the rule, the replica, the failed
  probe and the dump, in time order.
- The CLI: ``incident list`` / ``show`` / ``--json`` and the empty-dir
  pointer, rendering the reference command's text.
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.commands import incident as ref_incident_cli
from accelerate_tpu.telemetry import incidents as ref_incidents
from accelerate_tpu.telemetry import waterfall as ref_waterfall
from accelerate_tpu_torch.commands import incident as incident_cli
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving.autoscaler import direct_submit_fn
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.router import Router, RouterConfig
from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
from accelerate_tpu_torch.telemetry import incidents as port_incidents
from accelerate_tpu_torch.telemetry import waterfall as port_waterfall
from accelerate_tpu_torch.telemetry.artifacts import ArtifactWriter, read_jsonl
from accelerate_tpu_torch.telemetry.canary import CanaryProber
from accelerate_tpu_torch.telemetry.fleet import FleetCollector

ROOT = Path(__file__).resolve().parent.parent
T0 = 1_700_000_000.0
BASE = T0


def both(fn_name, *args, mod=("waterfall",), **kw):
    sides = {"waterfall": (port_waterfall, ref_waterfall),
             "incidents": (port_incidents, ref_incidents)}[mod[0]]
    got, want = (getattr(m, fn_name)(*args, **kw) for m in sides)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# waterfalls
# ---------------------------------------------------------------------------


def router_rec(*, submit=T0, hops=None, ttft_ms=None, request_id="r1", outcome="finished",
               replica="A"):
    return {"request_id": request_id, "submit_unix_s": submit, "outcome": outcome,
            "replica": replica, "ttft_ms": ttft_ms, "hops": hops or []}


def hop(replica="A", *, place_start, connect, first_token=None, error=None,
        backoff_before_ms=None):
    h = {"replica": replica, "t_unix_s": round(place_start, 3),
         "place_start_unix_s": place_start, "connect_unix_s": connect,
         "placement_ms": round((connect - place_start) * 1e3, 3)}
    if first_token is not None:
        h["first_token_unix_s"] = first_token
    if error is not None:
        h["error"] = error
    if backoff_before_ms is not None:
        h["backoff_before_ms"] = backoff_before_ms
    return h


STAGE_CASES = {
    "one_hop": (router_rec(hops=[hop(place_start=T0 + 0.003, connect=T0 + 0.005,
                                     first_token=T0 + 0.045)], ttft_ms=45.0),
                {"request_id": "r1", "replica": "A", "queue_wait_ms": 10.0,
                 "ttft_ms": 30.0}),
    "clock_skew": (router_rec(hops=[hop(place_start=T0 + 0.001, connect=T0 + 0.002,
                                        first_token=T0 + 0.062)], ttft_ms=62.0),
                   {"request_id": "r1", "replica": "A", "submit_unix_s": T0 - 300.0,
                    "finish_unix_s": T0 - 299.0, "queue_wait_ms": 15.0, "ttft_ms": 40.0}),
    "overrun": (router_rec(hops=[hop(place_start=T0 + 0.001, connect=T0 + 0.002,
                                     first_token=T0 + 0.012)], ttft_ms=12.0),
                {"request_id": "r1", "replica": "A", "queue_wait_ms": 12.0, "ttft_ms": 30.0}),
    "requeue": (router_rec(hops=[
        hop("A", place_start=T0 + 0.002, connect=T0 + 0.003,
            error="ConnectionRefusedError: injected"),
        hop("B", place_start=T0 + 0.031, connect=T0 + 0.032, first_token=T0 + 0.052,
            backoff_before_ms=20.0)], ttft_ms=52.0, replica="B"), None),
    "slow_prefill": (router_rec(hops=[hop(place_start=T0 + 0.001, connect=T0 + 0.002,
                                          first_token=T0 + 0.202)], ttft_ms=202.0),
                     {"request_id": "r1", "replica": "A", "queue_wait_ms": 5.0,
                      "ttft_ms": 185.0, "prefill_kernel": "ragged"}),
    "kv_restore": ({"request_id": "r1", "submit_unix_s": 100.0, "hops": [{
        "replica": "a", "t_unix_s": 100.0, "place_start_unix_s": 100.010,
        "connect_unix_s": 100.020, "first_token_unix_s": 100.120}]},
        {"request_id": "r1", "queue_wait_ms": 10.0, "kv_restore_ms": 30.0, "ttft_ms": 90.0}),
    "no_restore": ({"request_id": "r1", "submit_unix_s": 100.0, "hops": [{
        "replica": "a", "t_unix_s": 100.0, "place_start_unix_s": 100.010,
        "connect_unix_s": 100.020, "first_token_unix_s": 100.120}]},
        {"request_id": "r1", "queue_wait_ms": 10.0, "ttft_ms": 90.0}),
    "no_hops": (router_rec(hops=[]), None),
    "unstamped": (router_rec(hops=[{"replica": "A", "t_unix_s": T0}]), None),
    "shed": (router_rec(hops=[hop(place_start=T0 + 0.001, connect=T0 + 0.002,
                                  error="ConnectionRefusedError: x")], outcome="shed"), None),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_waterfall_stages_equal_the_reference(case):
    rec, replica = STAGE_CASES[case]
    row = both("waterfall_stages", rec, replica)
    if case in ("no_hops", "unstamped", "shed"):
        assert row is None
        return
    submit = rec["submit_unix_s"]
    win = [h for h in rec["hops"] if "error" not in h][-1]
    wall = (win["first_token_unix_s"] - submit) * 1e3
    assert sum(row["stages"].values()) == pytest.approx(wall, abs=0.02)
    if case == "kv_restore":
        assert row["stages"]["kv_restore"] == 30.0 and row["stages"]["prefill"] == 50.0
    if case == "requeue":
        assert row["requeues"] == 1 and row["stages"]["retry_backoff"] == pytest.approx(28.0)
    if case == "slow_prefill":
        assert row["top_stage"] == "prefill" and row["prefill_kernel"] == "ragged"


def _burst(seed, n=24):
    rng = np.random.RandomState(seed)
    router_recs, replica_recs = [], []
    for i in range(n):
        replica = "AB"[i % 2]
        pf, qw = float(rng.uniform(5, 200)), float(rng.uniform(0, 20))
        kr = float(rng.choice([0.0, rng.uniform(1, 30)]))
        p0 = T0 + i + float(rng.uniform(0, 0.01))
        connect = p0 + float(rng.uniform(0.0005, 0.003))
        ft = connect + (qw + kr + pf + float(rng.uniform(0, 8))) / 1e3
        hops = [hop(replica, place_start=p0, connect=connect, first_token=ft)]
        if rng.rand() < 0.2:
            dead = hop("C", place_start=p0 - 0.03, connect=p0 - 0.029, error="OSError: x")
            hops.insert(0, dead)
        router_recs.append(router_rec(request_id=f"q{i}", submit=hops[0]["place_start_unix_s"]
                                      - 0.001, replica=replica, hops=hops,
                                      ttft_ms=round((ft - T0 - i) * 1e3, 3)))
        replica_recs.append({"request_id": f"q{i}", "replica": replica, "queue_wait_ms": qw,
                             "kv_restore_ms": kr, "ttft_ms": qw + kr + pf,
                             "prefill_kernel": "ragged" if i % 3 else "dense"})
        if i % 5 == 0:  # a stale record from another replica under the same id
            replica_recs.append({"request_id": f"q{i}", "replica": "Z",
                                 "queue_wait_ms": 500.0, "ttft_ms": 900.0})
    return router_recs, replica_recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_summarize_and_table_equal_the_reference(seed, tmp_path):
    router_recs, replica_recs = _burst(seed)
    rows = both("build_waterfalls", router_recs, replica_recs)
    assert len(rows) == len(router_recs) and all(r["joined"] for r in rows)
    for row in rows:
        assert row["replica"] != "Z"
    agg = both("summarize_waterfall", rows)
    assert sum(d["share"] for d in agg["stages"].values()) == pytest.approx(1.0, abs=0.01)
    for mean in (False, True):
        assert both("stage_table", agg, include_mean=mean)[0][0] == "stage"
    with open(tmp_path / "router-requests.jsonl", "w") as fh:
        for rec in router_recs:
            fh.write(json.dumps(rec) + "\n")
        fh.write("torn {\n")
    loaded = both("load_router_requests", str(tmp_path))
    assert [r["request_id"] for r in loaded] == [r["request_id"] for r in router_recs]


# ---------------------------------------------------------------------------
# incidents
# ---------------------------------------------------------------------------


def _alert(t, state, rule="itl_burn_rate", **kv):
    return {"t_unix_s": t, "rule": rule, "state": state, "value": 2.0, "severity": "page",
            "description": "test", **kv}


WINDOW_CASES = {
    "lifecycle": [
        _alert(BASE, "pending"), _alert(BASE + 6, "firing", exemplars=["cul-0", "cul-1"]),
        _alert(BASE + 30, "resolved"), _alert(BASE + 100, "pending"),
        _alert(BASE + 104, "resolved"), _alert(BASE + 200, "pending", rule="shed_burn_rate"),
        _alert(BASE + 204, "firing", rule="shed_burn_rate", exemplars=["cul-2"]),
        _alert(BASE + 300, "resolved", rule="ghost_rule")],
    "out_of_order": [_alert(BASE + 30, "resolved"), _alert(BASE, "pending"),
                     _alert(BASE + 6, "firing")],
    "zero_hold_and_refire": [
        _alert(BASE, "firing", rule="canary_failing", exemplars=["a"]),
        _alert(BASE + 2, "firing", rule="canary_failing", exemplars=["a", "b"]),
        _alert(BASE + 9, "resolved", rule="canary_failing"),
        _alert(BASE + 10, "pending", rule="page_arena_watermark"),
        {"t_unix_s": BASE + 11, "rule": "x", "state": "weird"}, {"state": "firing"}],
}


def _seeded_alerts(seed):
    rng = np.random.RandomState(seed)
    out, t = [], BASE
    for _ in range(60):
        t += float(rng.uniform(0, 20))
        out.append(_alert(t, str(rng.choice(["pending", "firing", "resolved"])),
                          rule=str(rng.choice(["a", "b", "c"])),
                          value=float(rng.uniform(0, 5)),
                          exemplars=[f"r{int(x)}" for x in rng.randint(0, 9, 2)]))
    return out


@pytest.mark.parametrize("case", sorted(WINDOW_CASES) + ["seed0", "seed1"])
def test_incident_windows_equal_the_reference(case):
    events = WINDOW_CASES[case] if case in WINDOW_CASES else _seeded_alerts(int(case[-1]))
    windows = both("incident_windows", [dict(e) for e in events], mod=("incidents",))
    if case == "lifecycle":
        assert [(w["rule"], w["state"]) for w in windows] == [
            ("itl_burn_rate", "resolved"), ("shed_burn_rate", "firing")]
        assert windows[0]["duration_s"] == pytest.approx(24.0)


BREAKDOWN_CASES = [
    {"request_id": "r", "replica": "r0", "queue_wait_ms": 5.0, "kv_restore_ms": 3.0,
     "ttft_ms": 20.0, "total_ms": 520.0, "tokens": 32, "itl_max_ms": 9.0,
     "finish_reason": "budget"},
    {"request_id": "r", "total_ms": 3.0},
    {"request_id": "r", "ttft_ms": 10.0, "queue_wait_ms": 50.0, "kv_restore_ms": 5.0},
    {"request_id": "r", "ttft_ms": 10.0},
]


@pytest.mark.parametrize("i", range(len(BREAKDOWN_CASES)))
def test_replica_stage_breakdown_equals_the_reference(i):
    row = both("replica_stage_breakdown", dict(BREAKDOWN_CASES[i]), mod=("incidents",))
    if i == 0:
        assert row["stages"] == {"replica_queue": 5.0, "kv_restore": 3.0, "prefill": 12.0,
                                 "decode": 500.0}
    if i == 1:
        assert row is None


def _populate_drill_dir(d, *, rotate=False):
    """The reference test's synthetic two-incident artifact directory."""
    def writer(name, **kw):
        return ArtifactWriter(os.path.join(d, name), **kw)

    fh = writer("alerts-host0.jsonl", **({"max_bytes": 512, "max_generations": 2}
                                         if rotate else {}))
    for k in range(2):
        t = BASE + 200.0 * k
        fh.write(_alert(t, "pending"))
        fh.write(_alert(t + 6, "firing", exemplars=[f"cul-{k}", "ghost-req"]))
        fh.write(_alert(t + 30, "resolved"))
    fh.close()
    fh = writer("requests-host0.jsonl")
    for k in range(2):
        t = BASE + 200.0 * k + 8.0
        fh.write({"request_id": f"cul-{k}", "replica": "r0", "queue_wait_ms": 2.0,
                  "kv_restore_ms": 1.0, "ttft_ms": 20.0, "total_ms": 520.0, "tokens": 32,
                  "submit_unix_s": t, "finish_unix_s": t + 0.52})
    for i in range(20):
        fh.write({"request_id": f"req-{i}", "replica": "r0", "queue_wait_ms": 1.0,
                  "ttft_ms": 15.0, "total_ms": 80.0, "tokens": 16, "submit_unix_s": BASE + i,
                  "finish_unix_s": BASE + i + 0.08})
    fh.close()
    fh = writer("router-decisions.jsonl")
    for i in range(40):
        fh.write({"t_unix_s": BASE + 7.0 + i * 0.1, "request_id": f"req-{i}", "hop": 0,
                  "chosen": "r0", "reason": "least_loaded"})
    fh.write({"t_unix_s": BASE + 12.0, "request_id": "req-excl", "hop": 0, "chosen": "r1",
              "reason": "least_loaded", "excluded": ["r0"]})
    fh.close()
    fh = writer("fleet-events.jsonl")
    fh.write({"t_unix_s": BASE + 5.0, "replica": "r0", "from": "healthy", "to": "degraded",
              "reason": "itl breach"})
    fh.close()
    fh = writer("autoscale-decisions.jsonl")
    fh.write({"t_unix_s": BASE + 15.0, "action": "scale_up", "reason": "burn rate",
              "fleet_size": 3})
    fh.close()
    fh = writer("canary-results.jsonl")
    fh.write({"t_unix_s": BASE + 10.0, "request_id": "canary-0", "replica": "r0",
              "passed": False, "reason": "timeout"})
    fh.write({"t_unix_s": BASE + 11.0, "request_id": "canary-1", "replica": "r1",
              "passed": True})
    fh.close()
    with open(os.path.join(d, "flightrec-host0-1.json"), "w") as fh:
        json.dump({"time_unix_s": BASE + 7.5, "reason": "alert:itl_burn_rate",
                   "inflight_requests": [{"request_id": "cul-0"}], "events": [{}, {}]}, fh)
    return d


@pytest.mark.parametrize("variant", ["plain", "rotated", "narrow_pad"])
def test_reconstruction_equals_the_reference(variant, tmp_path):
    d = _populate_drill_dir(str(tmp_path), rotate=variant == "rotated")
    kw = {"pad_s": 3.0, "max_exemplars": 1} if variant == "narrow_pad" else {}
    incidents = both("reconstruct_incidents", d, mod=("incidents",), **kw)
    summary = both("summarize_incidents", incidents, mod=("incidents",))
    if variant == "plain":
        assert summary == {"count": 2, "open": 0, "by_rule": {"itl_burn_rate": 2},
                           "mean_duration_s": 24.0}
        inc = incidents[0]
        ts = [e["t_unix_s"] for e in inc["events"]]
        assert ts == sorted(ts)
        assert {"alert", "fleet", "router", "autoscale", "canary", "request",
                "flight"} <= {e["source"] for e in inc["events"]}
        rows = {r["request_id"]: r for r in inc["exemplar_requests"]}
        assert rows["cul-0"]["top_stage"] == "decode" and rows["ghost-req"]["missing"]
    if variant == "rotated":
        assert os.path.exists(os.path.join(d, "alerts-host0.jsonl.1"))
        assert incidents[-1]["exemplars"][0] == "cul-1"
    assert both("reconstruct_incidents", str(tmp_path / "nowhere"), mod=("incidents",)) == []


def _cli_args(target, action="show", **kw):
    import argparse

    kw.setdefault("index", None)
    kw.setdefault("rule", None)
    kw.setdefault("pad_s", 30.0)
    kw.setdefault("json", False)
    return argparse.Namespace(action=action, target=target, **kw)


def test_incident_cli_renders_the_reference_text(tmp_path, capsys):
    d = _populate_drill_dir(str(tmp_path))
    runs = [dict(action="list"), dict(index=0), dict(rule="itl_burn_rate"), dict(),
            dict(json=True), dict(index=7), dict(rule="nope")]
    for kw in runs:
        outs = []
        for cmd in (incident_cli.incident_command, ref_incident_cli.incident_command):
            rc = cmd(_cli_args(d, **kw))
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
        assert outs[0] == outs[1], kw
    assert incident_cli.main(["list", d]) == 0
    assert "2 incident(s), 0 open" in capsys.readouterr().out
    assert incident_cli.main(["show", d, "--index", "0"]) == 0
    out = capsys.readouterr().out
    assert "incident #0: itl_burn_rate" in out and "decode dominates" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert incident_cli.main(["show", str(empty)]) == 1
    assert "no incidents found" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# a port drill's artifact directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = DecoderConfig.tiny(max_seq_len=64)
    return DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))


def _engine(model, name, **kw):
    eng = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                        prefill_chunks=(4, 8), page_size=4, replica=name, **kw)
    eng.warmup()
    return eng


def _replica(model, name, trace_dir):
    """A replica with the process's one telemetry session (a new session
    closes the one it replaces)."""
    session = TelemetrySession(TelemetryConfig(trace_dir=trace_dir, flight_hooks=False,
                                               timeline_interval_s=0))
    eng = _engine(model, name, telemetry=session)
    return ReplicaServer(eng, name=name).start(), session


def _spawn_replicas(names, tmp_path):
    """``serve replica --device cpu --config tiny --telemetry-dir`` processes,
    started together: ``{name: (process, url)}``."""
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "replica",
         "--device", "cpu", "--config", "tiny", "--num-slots", "2", "--page-size", "4",
         "--prefill-chunks", "4,8", "--max-seq-len", "64", "--port", "0", "--name", n,
         "--telemetry-dir", str(tmp_path / n)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for n in names}
    return {n: (p, json.loads(p.stdout.readline())["url"]) for n, p in procs.items()}


def test_port_drill_waterfalls_sum_to_the_client_ttft(tmp_path):
    """Concurrent requests through a router over two ``serve replica``
    processes whose sessions write their request records
    (``--telemetry-dir``): every waterfall joins its replica record, its
    stages sum to its e2e TTFT, which is the router's client TTFT, and the
    reference computes the same rows from the same files."""
    replicas = _spawn_replicas(("A", "B"), tmp_path)
    router = Router({n: url for n, (_, url) in replicas.items()},
                    config=RouterConfig(poll_interval_s=0.1, log_dir=str(tmp_path),
                                        migrate_session_kv=False))
    try:
        router.collector.poll_once()
        results = []

        def client(k):
            for i in range(k, 12, 4):
                results.append(router.submit([3 + i, 4 + i, 5 + i, 6], max_new_tokens=3,
                                             seed=i, request_id=f"w{i}"))

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert [r.outcome for r in results] == ["finished"] * 12
        for proc, _ in replicas.values():
            proc.send_signal(signal.SIGTERM)
        for proc, _ in replicas.values():
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        router.close()
        for proc, _ in replicas.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()
    router_recs = port_waterfall.load_router_requests(str(tmp_path))
    replica_recs = read_jsonl([str(tmp_path / n) for n in replicas], "requests-host*.jsonl")
    assert len(replica_recs) == 12
    rows = both("build_waterfalls", router_recs, replica_recs)
    assert len(rows) == 12 and all(r["joined"] for r in rows)
    for row in rows:
        assert sum(row["stages"].values()) == pytest.approx(row["e2e_ttft_ms"], abs=0.02)
        assert row["e2e_ttft_ms"] == pytest.approx(row["client_ttft_ms"], abs=0.1)
    both("summarize_waterfall", rows)


def test_port_drill_incident_names_rule_replica_probe_and_dump(model, tmp_path):
    """The chip path's canary control on the CPU: goldens recorded on a
    healthy replica, then probed straight at a replica over other weights
    (``--init-seed 1``'s). Its probes fail, ``canary_failing`` fires in a fleet
    collector's alert log, each failure dumps that replica's flight
    recorder into the log dir, and the reconstructed incident (equal on
    both sides) names the rule, the replica, the failed probes and the
    dump, in time order."""
    d = str(tmp_path)
    good = ReplicaServer(_engine(model, "A"), name="A").start()
    cfg = model.config
    other = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=1, device="cpu"))
    bad, bad_session = _replica(other, "C", d)
    collector = FleetCollector([("C", bad.url + "/metrics")], log_dir=d)
    try:
        recorder = CanaryProber(direct_submit_fn(good.url),
                                [{"prompt": [5, 6, 7, 8], "seed": 0, "max_new_tokens": 4}])
        assert recorder.probe_once()["reason"] == "recorded"

        def dump(replica, info):
            from accelerate_tpu_torch.serving.router import HttpTransport

            HttpTransport().post_json(bad.url, "/v1/flight", {
                "reason": "canary_failed", "request_id": info.get("request_id")})

        prober = CanaryProber(direct_submit_fn(bad.url), recorder.goldens, window=4,
                              log_dir=d, flight_fn=dump)
        for _ in range(3):
            result = prober.probe_once()
            assert not result["passed"] and result["replica"] == "C"
            collector.poll_once()
            collector.timeline.add_sample(prober.rollup_keys())
            collector.alerts.evaluate()
        assert "canary_failing" in collector.alerts.firing()
        prober.close()
    finally:
        collector.close()
        good.close()
        bad.close()
        bad_session.close()
    incidents = both("reconstruct_incidents", d, mod=("incidents",))
    inc = next(i for i in incidents if i["rule"] == "canary_failing")
    ts = [e["t_unix_s"] for e in inc["events"]]
    assert ts == sorted(ts)
    kinds = {(e["source"], e["kind"]) for e in inc["events"]}
    assert {("alert", "firing"), ("canary", "probe_failed"), ("flight", "dump")} <= kinds
    failed = [e for e in inc["events"] if e["source"] == "canary"]
    assert all(e["replica"] == "C" and "mismatch" in e["detail"] for e in failed)
    assert any(os.path.basename(e["path"]).startswith("flightrec-host")
               for e in inc["events"] if e["source"] == "flight")
