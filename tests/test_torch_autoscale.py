"""The port's autoscaler (``accelerate_tpu_torch/serving/autoscaler.py``)
and ``autoscale`` command on the CPU: the reference's actuation cases
(``tests/test_autoscale.py::TestAutoscalerActuation``) with an in-process
spawner over port replicas, a subprocess drill whose spawned replica is
``serve replica --device cpu --config tiny``, and ``autoscale --once``.

- Scale-out below ``min_replicas``: spawned, canary-gated (the gate
  records the golden), registered, placeable, routed traffic lands, the
  ``autoscale/*`` gauges ride the router's rollup; then a drained
  scale-in whose conservation ledger holds, the decision log read alike
  by the reference's ``load_autoscale_decisions``.
- A golden the replica cannot reproduce blocks registration; a spawn
  failure is a logged outcome and the loop goes on.
- The drill: a seeded loadgen burst through the router fires
  ``itl_burn_rate`` (pending, then firing), the autoscaler spawns a real
  ``serve replica`` process through ``SubprocessSpawner``, gates, registers
  and places it, traffic lands on it, the burn resolves, and the scale-in
  drains and reaps the process with the ledger conserved.
- ``autoscale --once`` prints one JSON ``hold`` record and logs it; the
  spawner's command line is the port's ``serve replica`` on
  ``--config small_1b`` unless told otherwise.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.serving import autoscaler as ref_autoscaler
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer, loadgen
from accelerate_tpu_torch.serving.autoscaler import (
    Autoscaler,
    SpawnedReplica,
    SubprocessSpawner,
    load_autoscale_decisions,
)
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.router import Router, RouterConfig
from accelerate_tpu_torch.telemetry.capacity import AutoscalePolicy
from accelerate_tpu_torch.telemetry.fleet import (
    PLACEABLE_STATES,
    FleetCollector,
    fleet_default_ruleset,
)

ROOT = Path(__file__).resolve().parent.parent
CACHE = 64
GOLDEN = {"prompt": [5, 6, 7], "seed": 3, "max_new_tokens": 6}
REPLICA_ARGS = ("--device", "cpu", "--config", "tiny", "--num-slots", "2", "--page-size", "4",
                "--prefill-chunks", "4,8", "--max-seq-len", "64", "--init-seed", "0")


@pytest.fixture(scope="module")
def model():
    cfg = DecoderConfig.tiny(max_seq_len=CACHE)
    return DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=0, device="cpu"))


def _replica(model, name):
    engine = ServingEngine(model, device="cpu", replica=name, num_slots=2, max_cache_len=CACHE,
                           prefill_chunks=(4, 8), page_size=4)
    engine.warmup()
    engine.mark_steady()
    return ReplicaServer(engine, name=name).start()


class InProcessSpawner:
    """``spawn_fn`` over in-process port replicas (the embedder path),
    optionally scripted to fail."""

    def __init__(self, model, fail=None):
        self.model, self.fail, self.spawned = model, fail, []

    def __call__(self, name):
        if self.fail is not None:
            raise self.fail
        server = _replica(self.model, name)
        self.spawned.append(server)
        return SpawnedReplica(name, server.url, server=server)

    def close(self):
        for s in self.spawned:
            s.close()


@pytest.fixture
def stack(model, tmp_path):
    r0 = _replica(model, "r0")
    router = Router({"r0": r0.url},
                    config=RouterConfig(poll_interval_s=0.1, log_dir=str(tmp_path)))
    router.collector.poll_once()
    spawner = InProcessSpawner(model)
    autoscaler = Autoscaler(
        router, policy=AutoscalePolicy(min_replicas=2, max_replicas=2, cooldown_s=0.0,
                                       confirm_evals=1),
        spawn_fn=spawner, goldens=[dict(GOLDEN)], canary_probes=2, log_dir=str(tmp_path))
    router.attach_autoscaler(autoscaler)
    yield r0, router, autoscaler, spawner
    router.close()  # closes the autoscaler too
    spawner.close()
    r0.close()


def test_scale_out_gates_registers_places_then_scale_in_conserves(stack, tmp_path):
    r0, router, autoscaler, spawner = stack
    rec = autoscaler.evaluate_once()
    assert (rec["action"], rec["reason"], rec["outcome"], rec["replica"]) == (
        "scale_out", "below_min_replicas", "scaled_out", "auto-1")
    assert all(p["passed"] for p in rec["canary"]) and len(rec["canary"]) == 2
    assert set(rec["stages"]) == {"decide_lag_s", "spawn_s", "canary_s", "register_s",
                                  "placement_s"}
    assert all(v >= 0.0 for v in rec["stages"].values())
    assert rec["autoscale_reaction_s"] > 0.0 and "signals" in rec and "firing" in rec
    # the gate recorded the truth later spawns must reproduce: this
    # replica's greedy tokens for the golden
    want = r0.engine.submit(np.asarray(GOLDEN["prompt"]), max_new_tokens=6)
    deadline = time.time() + 60
    while not want.done and time.time() < deadline:
        time.sleep(0.01)
    assert autoscaler.goldens[0]["tokens"] == list(want.tokens)
    assert "auto-1" in router._replicas
    assert router.collector.replicas["auto-1"].state in PLACEABLE_STATES
    placed = {router.submit([3, 4, 5, 6], max_new_tokens=4, seed=s).replica
              for s in range(6)}
    assert placed <= {"r0", "auto-1"}
    m = router.metrics()
    assert (m["autoscale/evals"], m["autoscale/scale_outs"], m["autoscale/replicas_owned"]) \
        == (1, 1, 1)
    assert m["autoscale/last_reaction_s"] == rec["autoscale_reaction_s"]

    router.collector.poll_once()
    autoscaler.policy.min_replicas = 1
    autoscaler.policy.scale_in_headroom = -1.0
    autoscaler.policy.scale_in_margin = 0.0
    rec2 = autoscaler.evaluate_once()
    assert (rec2["action"], rec2["outcome"], rec2["replica"]) == ("scale_in", "scaled_in",
                                                                 "auto-1")
    assert rec2["stages"]["drain_s"] >= 0.0 and rec2["stages"]["reap_s"] >= 0.0
    led = rec2["ledger"]
    assert led["conserved"] is True and led["after"]["inflight"] == 0
    assert led["after"]["submitted"] == led["after"]["completed"] + led["after"]["shed"] \
        + led["after"]["cancelled"] + led["after"]["inflight"]
    assert "auto-1" not in router._replicas and not autoscaler.owned
    recs = load_autoscale_decisions(str(tmp_path))
    assert recs == ref_autoscaler.load_autoscale_decisions(str(tmp_path))
    assert [r["action"] for r in recs] == ["scale_out", "scale_in"]


def test_canary_gate_blocks_a_wrong_token_replica(stack):
    r0, router, autoscaler, spawner = stack
    autoscaler.goldens = [dict(GOLDEN, tokens=[-1, -2, -3, -4, -5, -6])]
    rec = autoscaler.evaluate_once()
    assert (rec["action"], rec["outcome"]) == ("scale_out", "canary_failed")
    assert rec["canary"][-1]["passed"] is False
    assert "token mismatch" in rec["canary"][-1]["reason"]
    assert "auto-1" not in router._replicas and not autoscaler.owned
    assert router.metrics()["autoscale/canary_failures"] == 1


def test_spawn_failure_is_a_logged_outcome_not_a_crash(stack, model):
    r0, router, autoscaler, spawner = stack
    autoscaler._spawn_fn = InProcessSpawner(model, fail=RuntimeError("no capacity in zone"))
    rec = autoscaler.evaluate_once()
    assert (rec["action"], rec["outcome"]) == ("scale_out", "spawn_failed")
    assert "RuntimeError" in rec["error"] and autoscaler.spawn_failures == 1
    assert set(router._replicas) == {"r0"}
    assert autoscaler.evaluate_once()["action"] in ("scale_out", "hold")


def test_spawner_runs_the_ports_serve_replica():
    spawner = SubprocessSpawner()
    cmd = spawner.command("auto-7")
    assert cmd[1:5] == ["-m", "accelerate_tpu_torch.commands.serve", "replica", "--port"]
    assert cmd[cmd.index("--name") + 1] == "auto-7"
    assert cmd[-2:] == ["--config", "small_1b"]
    assert SubprocessSpawner(replica_args=REPLICA_ARGS).command("x")[-len(REPLICA_ARGS):] \
        == list(REPLICA_ARGS)


def test_spawner_gives_a_cpu_child_its_thread_share(monkeypatch):
    """A ``--device cpu`` child starts with one intra-op thread
    (OMP_NUM_THREADS), unless the env given sets it: two pools claiming
    every core stall each other's parallel regions (the drill below
    timed out its first routed request on them). A CUDA child's
    environment is left as given."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = SubprocessSpawner(replica_args=REPLICA_ARGS).child_env()
    assert env["OMP_NUM_THREADS"] == "1" and env["PATH"] == os.environ["PATH"]
    given = SubprocessSpawner(replica_args=REPLICA_ARGS, env={"OMP_NUM_THREADS": "4"})
    assert given.child_env() == {"OMP_NUM_THREADS": "4"}
    assert SubprocessSpawner().child_env() is None
    assert SubprocessSpawner(env={"A": "1"}).child_env() == {"A": "1"}


def test_burn_fired_subprocess_scale_out_then_drained_scale_in(model, tmp_path):
    """The reference's acceptance drill on the port: a seeded burst through
    the router breaches an ITL SLO the drill is sure to breach, the rule
    walks pending then firing, a real ``serve replica`` process spawns,
    passes the gate, registers and takes routed traffic; the burn resolved,
    the scale-in drains and reaps it with the ledger conserved."""
    r0 = _replica(model, "r0")
    collector = FleetCollector([("r0", r0.url + "/metrics")],
                               rules=fleet_default_ruleset(itl_slo_ms=0.05, itl_for_s=0.2),
                               log_dir=str(tmp_path))
    router = Router({"r0": r0.url},
                    config=RouterConfig(poll_interval_s=0.1, log_dir=str(tmp_path)),
                    collector=collector)
    policy = AutoscalePolicy(min_replicas=1, max_replicas=2, headroom_floor=2.0,
                             scale_in_headroom=2.0, cooldown_s=0.5, confirm_evals=1,
                             fast_s=10.0, slow_s=30.0, horizon_s=5.0)
    autoscaler = Autoscaler(router, policy=policy,
                            spawner=SubprocessSpawner(replica_args=REPLICA_ARGS),
                            goldens=[dict(GOLDEN)], canary_probes=2, log_dir=str(tmp_path))
    router.attach_autoscaler(autoscaler)
    spec = loadgen.WorkloadSpec(
        name="autoscale-drill", seed=20260807, mode="open", num_requests=48,
        arrival={"process": "diurnal", "base": "burst", "rate_rps": 48.0, "burst_size": 4,
                 "period_s": 1.5, "amplitude": 0.9},
        vocab_size=256, prompt_cap=40,
        tenants=[loadgen.TenantSpec("drill", prompt_len={"uniform": [8, 20]},
                                    max_new_tokens={"fixed": 12})])
    offered = {}
    load = threading.Thread(target=lambda: offered.update(
        result=loadgen.run(spec, router, timeout_s=120.0)), daemon=True)
    try:
        collector.poll_once()
        load.start()
        out_rec, states = None, []
        deadline = time.time() + 120.0
        while out_rec is None and time.time() < deadline:
            collector.poll_once()
            st = collector.alerts.states_snapshot().get("itl_burn_rate")
            if st:
                states.append(st["state"])
            rec = autoscaler.evaluate_once()
            if rec["action"] == "scale_out":
                out_rec = rec
            time.sleep(0.1)
        assert out_rec is not None, f"no scale-out; alert walk {states[-8:]}"
        assert states.index("pending") < states.index("firing")
        assert out_rec["reason"] == "burn_firing_and_headroom_below_floor"
        assert out_rec["signals"]["burn"]["itl_burn_rate"]["state"] == "firing"
        assert (out_rec["outcome"], out_rec["replica"]) == ("scaled_out", "auto-1"), out_rec
        assert all(p["passed"] for p in out_rec["canary"])
        handle = autoscaler.owned["auto-1"]
        assert handle.proc is not None and handle.alive
        assert out_rec["autoscale_reaction_s"] > 0.0
        assert out_rec["burn_fired_unix_s"] <= out_rec["t_unix_s"]
        assert collector.replicas["auto-1"].state in PLACEABLE_STATES
        # a scrape before each request: the router places by the
        # collector's last scrape, which the drill's loop otherwise feeds
        landed, deadline = False, time.time() + 60.0
        while not landed and time.time() < deadline:
            collector.poll_once()
            r = router.submit([5, 6, 7, 8], max_new_tokens=4)
            assert r.outcome == "finished", (r.shed_reason, r.hops)
            landed = r.replica == "auto-1"
        assert landed
        load.join(timeout=120.0)
        counts = offered["result"].counts()
        assert counts["finished"] + counts["shed"] == counts["offered"] == 48
        # the recent-p99 gauge only decays under fresh traffic: the drill
        # clears the breach at the rule, where an operator would
        for rule in collector.alerts.rules:
            if rule.name == "itl_burn_rate":
                rule.slo = 1e9
        deadline = time.time() + 30.0
        while time.time() < deadline and \
                collector.alerts.states_snapshot()["itl_burn_rate"]["state"] != "ok":
            collector.poll_once()
            time.sleep(0.1)
        events = [e["state"] for e in collector.alerts.events if e["rule"] == "itl_burn_rate"]
        assert events[:2] == ["pending", "firing"] and events[-1] == "resolved"
        autoscaler.policy.scale_in_headroom = -1.0
        autoscaler.policy.scale_in_margin = 0.0
        in_rec, deadline = None, time.time() + 60.0
        while in_rec is None and time.time() < deadline:
            collector.poll_once()
            rec = autoscaler.evaluate_once()
            if rec["action"] == "scale_in":
                in_rec = rec
            time.sleep(0.1)
        assert in_rec is not None
        assert (in_rec["outcome"], in_rec["replica"]) == ("scaled_in", "auto-1")
        assert in_rec["ledger"]["conserved"] is True
        assert handle.proc.poll() is not None  # reaped, not leaked
        assert "auto-1" not in router._replicas and not autoscaler.owned
        actions = [r["action"] for r in load_autoscale_decisions(str(tmp_path))]
        assert "scale_out" in actions and "scale_in" in actions
    finally:
        router.close()
        r0.close()


def test_autoscale_once_cli(model, tmp_path):
    """``autoscale --once`` over one replica: one JSON ``hold`` record on
    stdout, the same record in the decision log; the daemon mode prints
    its startup line, serves the router's ``/metrics`` with the
    ``autoscale/*`` gauges and exits 0 on SIGTERM."""
    r0 = _replica(model, "r0")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "accelerate_tpu_torch.commands.autoscale", "--once",
             "--replica", f"r0={r0.url}", "--log-dir", str(tmp_path), "--itl-slo-ms", "50",
             "--poll-interval", "0.1"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
    finally:
        r0.close()
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout)
    assert (record["action"], record["outcome"], record["replicas"]) == ("hold", "held", 1)
    assert "signals" in record
    recs = load_autoscale_decisions(str(tmp_path))
    assert len(recs) == 1 and recs[0]["action"] == "hold"
    assert os.path.exists(tmp_path / "router-decisions.jsonl")

    r0 = _replica(model, "r0")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.autoscale", "--replica",
         f"r0={r0.url}", "--port", "0", "--interval", "0.1", "--poll-interval", "0.1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(daemon.stdout.readline())
        assert (line["role"], line["replicas"], line["max_replicas"]) == ("autoscale", 1, 4)
        deadline, evals = time.time() + 60, 0.0
        while evals < 2 and time.time() < deadline:
            with urllib.request.urlopen(f"http://127.0.0.1:{line['port']}/metrics",
                                        timeout=30) as resp:
                for row in resp.read().decode().splitlines():
                    if row.startswith("att_autoscale_evals "):
                        evals = float(row.split()[1])
            time.sleep(0.05)
        assert evals >= 2
        daemon.send_signal(signal.SIGTERM)
        assert daemon.wait(timeout=60) == 0, daemon.stderr.read()
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait(timeout=30)
        daemon.stdout.close()
        daemon.stderr.close()
        r0.close()
