"""The port's canary prober (``accelerate_tpu_torch/telemetry/canary.py``),
its router attachment and ``serve router --canary-interval`` on the CPU,
held against the reference's ``accelerate_tpu/telemetry/canary.py``.

- ``CanaryProber`` under scripted submit outcomes and one fake clock:
  counters, ``pass_ratio``, the ``canary/*`` gauges, every result and the
  ``canary-results.jsonl`` log equal the reference prober's (record, then
  verify, then catch; a raising submit; the recent window recovering;
  the failure hooks naming the serving replica).
- ``via_engine`` (driving the engine, and waiting on a serving replica's
  loop), ``via_router`` over two port replicas and ``flight_via_router``
  (the flight bundle lands on the replica that served the failing probe)
  on port replicas; a ``wrong_token`` fault at one replica's wire fails
  its probes and walks ``canary_failing`` pending/firing/resolved, as in
  the reference's drill.
- ``Router.attach_canary`` / ``attach_autoscaler`` publish their gauges on
  the router's ``/metrics`` and ``close()`` closes both.
- ``serve router --canary-interval`` as a subprocess: the startup line's
  ``"canary"`` is true, ``/metrics`` carries ``canary/*``, the results
  log lands in ``--log-dir``, SIGTERM exits 0.
"""

import json
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu.telemetry import alerts as ref_alerts
from accelerate_tpu.telemetry import canary as ref_canary
from accelerate_tpu.telemetry import fleet as ref_fleet
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import FaultInjector, ReplicaServer
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.router import Router, RouterConfig
from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession
from accelerate_tpu_torch.telemetry import alerts as port_alerts
from accelerate_tpu_torch.telemetry import canary as port_canary
from accelerate_tpu_torch.telemetry import fleet as port_fleet
from accelerate_tpu_torch.telemetry.timeline import Timeline

ROOT = Path(__file__).resolve().parent.parent
SIDES = (port_canary, ref_canary)
GOOD = {"tokens": [1, 2, 3], "replica": "A", "outcome": "finished", "ttft_ms": 5.0,
        "e2e_ms": 9.0}


def scripted(replies):
    """submit_fn returning scripted results in order (the last repeats);
    an exception in the script is raised."""
    replies = list(replies)

    def submit(golden, request_id):
        r = replies.pop(0) if len(replies) > 1 else replies[0]
        if isinstance(r, Exception):
            raise r
        return dict(r)

    return submit


PROBE_CASES = {
    "record_verify_catch": (
        [dict(GOOD), dict(GOOD), dict(GOOD, tokens=[1, 7, 3], replica="B"),
         dict(GOOD, tokens=[1, 2]), {"outcome": "shed", "shed_reason": "queue_full"},
         {"outcome": "cancelled"}, dict(GOOD, ttft_ms=None)],
        [{"prompt": [10, 11], "seed": 0, "max_new_tokens": 3}], {}),
    "raising_submit": ([OSError("fleet down")], [{"prompt": [1], "tokens": [5]}], {}),
    "recent_window": ([{"tokens": [6], "outcome": "finished"}] * 4
                      + [{"tokens": [5], "outcome": "finished"}] * 5,
                      [{"prompt": [1], "tokens": [5]}], {"window": 4}),
    "round_robin": ([dict(GOOD, tokens=[i % 3]) for i in range(9)],
                    [{"prompt": [1]}, {"prompt": [2], "tokens": [1]}, {"prompt": [3]}],
                    {"history": 5}),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_prober_equals_the_reference(case, tmp_path):
    replies, goldens, kw = PROBE_CASES[case]
    out = []
    for mod in SIDES:
        clock = iter(1000.0 + 0.5 * i for i in range(100))
        hooks = []
        d = tmp_path / mod.__name__.split(".")[0]
        prober = mod.CanaryProber(
            scripted(replies), goldens, log_dir=str(d), clock=lambda: next(clock),
            flight_fn=lambda replica, info: hooks.append(("flight", replica, info["request_id"])),
            on_fail=lambda result: hooks.append(("fail", result["request_id"])), **kw)
        gauges = []
        for _ in range(len(replies)):
            prober.probe_once()
            gauges.append((prober.rollup_keys(), prober.pass_ratio()))
        prober.close()
        out.append((gauges, list(prober.results), hooks, prober.goldens,
                    mod.load_canary(str(d))))
    assert out[0] == out[1]
    gauges, results, hooks, goldens, logged = out[0]
    assert results == logged[-len(results):] and len(logged) == len(replies)
    if case == "record_verify_catch":
        assert [r["passed"] for r in results] == [True, True, False, False, False, False, True]
        assert results[0]["reason"] == "recorded" and goldens[0]["tokens"] == [1, 2, 3]
        assert results[2]["reason"] == "token mismatch at index 1"
        assert results[3]["reason"] == "token mismatch at index 2"
        assert results[4]["reason"] == "queue_full"
        assert ("flight", "B", "canary-2") in hooks
    if case == "raising_submit":
        assert "OSError" in results[0]["reason"] and gauges[0][1] == 0.0
    if case == "recent_window":
        assert gauges[3][1] == 0.0 and gauges[-1][1] == 1.0
        assert gauges[-1][0]["canary/probes_failed"] == 4


def test_canary_rule_and_merge_policies_equal_the_reference():
    for alerts, fleet in ((port_alerts, port_fleet), (ref_alerts, ref_fleet)):
        for rules in (alerts.default_ruleset(), fleet.fleet_default_ruleset()):
            rule = next(r for r in rules if r.name == "canary_failing")
            assert (rule.key, rule.op, rule.threshold) == ("canary/pass_ratio", "<", 1.0)
            assert "flight_dump" in rule.actions
    for key in ("canary/probes_sent", "canary/pass_ratio", "canary/last_pass_unix_s",
                "canary/e2e_ttft_ms", "autoscale/scale_outs", "autoscale/last_reaction_s"):
        assert port_fleet.merge_policy(key) == ref_fleet.merge_policy(key)


# ---------------------------------------------------------------------------
# probes over port engines, replicas and routers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = DecoderConfig.tiny(max_seq_len=64)
    return DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))


def _engine(model, name=None, **kw):
    eng = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                        prefill_chunks=(4, 8), page_size=4, replica=name, **kw)
    eng.warmup()
    eng.mark_steady()
    return eng


GOLDEN = {"prompt": [5, 6, 7, 8, 9], "seed": 3, "max_new_tokens": 6}


def test_via_engine_records_then_verifies(model):
    """Driving a bare engine, then waiting on a serving replica's loop: the
    recorded golden is the engine's own greedy tokens, and every later
    probe reproduces them."""
    eng = _engine(model, "E")
    want = eng.submit(np.asarray(GOLDEN["prompt"]), max_new_tokens=6)
    eng.run()
    prober = port_canary.CanaryProber(port_canary.via_engine(eng, drive=True), [GOLDEN])
    first, second = prober.probe_once(), prober.probe_once()
    assert first["reason"] == "recorded" and second["passed"]
    assert prober.goldens[0]["tokens"] == list(want.tokens)
    assert first["replica"] == "E" and first["ttft_ms"] is not None
    server = ReplicaServer(_engine(model, "S"), name="S").start()
    try:
        waiting = port_canary.CanaryProber(port_canary.via_engine(server.engine),
                                           prober.goldens)
        assert all(waiting.probe_once()["passed"] for _ in range(3))
        assert waiting.rollup_keys()["canary/pass_ratio"] == 1.0
    finally:
        server.close()


def test_via_router_catches_a_wrong_token_replica_and_dumps_its_flight(model, tmp_path):
    """The reference's catch drill on port replicas: probes through the
    router record and pass; a wrong-token fault at B's wire fails B's
    probes, ``canary_failing`` walks pending/firing, the flight bundle
    lands in B's trace dir (not A's), the decision log names B; the fault
    cleared, the window refills and the rule resolves."""
    faults = FaultInjector(seed=0)
    sessions = {n: TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path / n),
                                                    flight_hooks=False,
                                                    timeline_interval_s=0))
                for n in ("A", "B")}
    servers = {n: ReplicaServer(_engine(model, n, telemetry=sessions[n]), name=n,
                                faults=faults if n == "B" else None).start()
               for n in ("A", "B")}
    router = Router({n: s.url for n, s in servers.items()},
                    config=RouterConfig(poll_interval_s=0.1, migrate_session_kv=False,
                                        log_dir=str(tmp_path)))
    router.collector.poll_once()
    timeline = Timeline()
    alerts = port_alerts.AlertManager(timeline, port_alerts.default_ruleset())
    prober = port_canary.CanaryProber(
        port_canary.via_router(router), [dict(GOLDEN)], window=4, log_dir=str(tmp_path),
        flight_fn=port_canary.flight_via_router(router))
    router.attach_canary(prober)

    def tick(now):
        result = prober.probe_once()
        alerts.evaluate(now=timeline.add_sample(prober.rollup_keys(), now=now))
        return result

    try:
        now = 1000.0
        recorded = tick(now)
        assert recorded["reason"] == "recorded" and recorded["replica"] == "A"
        # B alone serves the fault phase: its wire corrupts every token
        router.deregister_replica("A")
        faults.wrong_token(replica="B", after_tokens=0)
        states = []
        for _ in range(3):
            now += 1.0
            result = tick(now)
            assert not result["passed"] and result["replica"] == "B"
            assert result["reason"].startswith("token mismatch")
            states.append(alerts.states["canary_failing"].state)
        assert states[-1] == port_alerts.FIRING
        assert list((tmp_path / "B").glob("flightrec-host*-*.json"))
        assert not list((tmp_path / "A").glob("flightrec-host*-*.json"))
        failing = {r["request_id"] for r in prober.results if not r["passed"]}
        assert {d["chosen"] for d in router.decisions if d["request_id"] in failing} == {"B"}
        faults.clear_network("wrong_token")
        for _ in range(5):
            now += 1.0
            assert tick(now)["passed"]
        assert alerts.states["canary_failing"].state not in (port_alerts.PENDING,
                                                             port_alerts.FIRING)
        m = router.metrics()
        assert m["canary/probes_sent"] == 9 and m["canary/pass_ratio"] == 1.0
        assert m["canary/probes_failed"] == 3
        events = [e["state"] for e in alerts.events if e["rule"] == "canary_failing"]
        assert events[-1] == port_alerts.RESOLVED and port_alerts.FIRING in events
    finally:
        router.close()
        for s in servers.values():
            s.close()
        for s in sessions.values():
            s.close()
    assert prober._thread is None and prober._fh is None  # closed with the router
    assert [r["passed"] for r in port_canary.load_canary(str(tmp_path))][:1] == [True]


def test_router_close_closes_an_attached_prober_and_autoscaler(model):
    """Both attachments publish through ``metrics()`` and join ``close()``."""
    from accelerate_tpu_torch.serving.autoscaler import Autoscaler

    server = ReplicaServer(_engine(model, "A"), name="A").start()
    router = Router({"A": server.url}, config=RouterConfig(poll_interval_s=0.1))
    try:
        router.collector.poll_once()
        prober = port_canary.CanaryProber(port_canary.via_router(router), [dict(GOLDEN)],
                                          interval_s=0.05)
        autoscaler = Autoscaler(router, interval_s=0.05)
        assert router.attach_canary(prober.start()) is router
        assert router.attach_autoscaler(autoscaler.start()) is router
        deadline = time.time() + 60
        while (prober.probes_passed < 2 or autoscaler.evals < 2) and time.time() < deadline:
            time.sleep(0.02)
        m = router.metrics()
        assert m["canary/probes_sent"] >= 2 and m["canary/probes_passed"] >= 2
        assert m["autoscale/evals"] >= 2 and m["autoscale/replicas_owned"] == 0
    finally:
        router.close()
        server.close()
    assert prober._thread is None and autoscaler._thread is None


def test_serve_router_canary_interval_cli(model, tmp_path):
    """``serve router --canary-interval`` in a subprocess over a port
    replica: the startup line reports the prober, ``/metrics`` carries its
    passing probes, the results log lands in ``--log-dir``; SIGTERM exits 0."""
    server = ReplicaServer(_engine(model, "A"), name="A").start()
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "router",
           "--replica", f"A={server.url}", "--port", "0", "--poll-interval", "0.1",
           "--canary-interval", "0.1", "--canary-prompt", "5,6,7", "--canary-seed", "3",
           "--canary-max-new-tokens", "4", "--log-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["role"] == "router" and line["canary"] is True
        base = f"http://127.0.0.1:{line['port']}"
        deadline, passed = time.time() + 60, 0.0
        while time.time() < deadline and passed < 3:
            with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
                snap = port_fleet.parse_exposition(resp.read().decode())
            passed = snap.gauges.get("canary_probes_passed", 0.0)
            time.sleep(0.05)
        assert passed >= 3 and snap.gauges["canary_pass_ratio"] == 1.0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
        server.close()
    logged = port_canary.load_canary(str(tmp_path))
    assert logged and logged[0]["reason"] == "recorded" and all(r["passed"] for r in logged)
    assert {r["replica"] for r in logged} == {"A"}


# ---------------------------------------------------------------------------
# invariant prefill: what the canary's token-exact contract needs on CUDA
# ---------------------------------------------------------------------------


def _packed_rows(model):
    """Record every packed prefill's row positions and slot prefixes."""
    seen = []

    def hook(module, args, kwargs, out):
        if kwargs.get("ragged_slots") is not None:
            seen.append((kwargs["cache_positions"][0].tolist(), kwargs["slot_hist"].tolist()))

    return seen, model.register_forward_hook(hook, with_kwargs=True).remove


def test_invariant_prefill_aligns_hits_and_packed_tails(tmp_path):
    """On CUDA the ragged prefill kernel's online softmax rounds tile by
    tile, so a prompt prefilled over another prefix hit or at another pack
    row gives other bits (PERF.md: 9 of 18 warm golden probes failed on
    the card). ``invariant_prefill=True`` rounds prefix hits down to the
    kernel's 64-position kv tile and starts every packed tail on a tile of
    the pack, so each row walks the same tiles: here every fresh row sits
    at a pack row congruent to its position mod 64 and every slot prefix
    is a tile multiple, where the default layout is not; tokens equal the
    default engine's and the reference engine's (fp32, greedy, the
    reference's Pallas kernels in the interpreter)."""
    import jax

    from accelerate_tpu.models import DecoderConfig as JaxConfig
    from accelerate_tpu.models import DecoderLM as JaxLM
    from accelerate_tpu.parallel.sharding import unbox_params
    from accelerate_tpu.serving.engine import ServingEngine as JaxEngine
    from accelerate_tpu_torch.models.convert import from_reference
    from accelerate_tpu_torch.ops.attention import PREFILL_KV_TILE

    jcfg = JaxConfig.tiny(max_seq_len=256, decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(max_seq_len=256)
    tmodel = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.RandomState(0)
    base = [rng.randint(3, 256, (n,)).astype(np.int32) for n in (24, 100, 150, 70)]
    waves = [base, [np.concatenate([base[1], base[2][:50]]), base[1], base[2], base[0]]]
    kw = dict(num_slots=4, page_size=16, max_cache_len=256, prefill_chunks=(64, 128))

    def serve(engine):
        out = []
        for wave in waves:
            reqs = [engine.submit(p, max_new_tokens=5) for p in wave]
            engine.run()
            out.append([([int(t) for t in r.tokens], r.prefix_hit) for r in reqs])
        return out

    runs, layouts = {}, {}
    for inv in (False, True):
        seen, unhook = _packed_rows(tmodel)
        try:
            runs[inv] = serve(ServingEngine(tmodel, device="cpu", invariant_prefill=inv, **kw))
        finally:
            unhook()
        layouts[inv] = (
            sum((r - p) % PREFILL_KV_TILE != 0 for pos, _ in seen for r, p in enumerate(pos)
                if p >= 0),
            [h for _, hist in seen for h in hist if h % PREFILL_KV_TILE])
    ref = serve(JaxEngine(jmodel, params, **kw))
    assert layouts[True] == (0, [])
    assert layouts[False][0] > 0  # the default packs tails on 8-row token blocks
    hits = [h for wave in runs[True] for _, h in wave]
    assert all(h % PREFILL_KV_TILE == 0 for h in hits) and max(hits) >= PREFILL_KV_TILE
    # the default's hits are the reference's; the tokens are everyone's
    assert [[h for _, h in w] for w in runs[False]] == [[h for _, h in w] for w in ref]
    for wave_t, wave_f, wave_r in zip(runs[True], runs[False], ref):
        assert [t for t, _ in wave_t] == [t for t, _ in wave_f] == [t for t, _ in wave_r]
    with pytest.raises(ValueError, match="paged arena"):
        ServingEngine(tmodel, device="cpu", invariant_prefill=True, num_slots=2,
                      max_cache_len=64)
    from accelerate_tpu_torch.commands import serve as serve_cli
    import argparse

    parser = argparse.ArgumentParser()
    serve_cli.register(parser)
    eng = serve_cli.build_replica_engine(parser.parse_args(
        ["replica", "--device", "cpu", "--invariant-prefill", "--max-seq-len", "64"]))
    assert eng._prefill_align == PREFILL_KV_TILE
