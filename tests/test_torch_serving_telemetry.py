"""The port's serving telemetry through its ``ServingEngine``, its
``ReplicaServer`` and its checkpoint functions, against the JAX package on
the CPU.

The contracts held:
- for the same scripted greedy submissions (a preemption and its resume,
  a cancel, a timeout, sheds at a bounded queue, co-admitted packs) on the
  paged and the flat arena, the port's request records equal the
  reference engine's field for field, except the timing fields (``*_s``,
  ``*_ms``, the ITL series and the per-chunk walls) and
  ``compiles_in_flight`` (the reference compiles its programs lazily on a
  cold engine, so it counts those compiles; the port's counts CUDA graph
  captures and must read 0); usage totals (timing-free fields) and the
  SLO histogram counts are equal too;
- the two reference scheduler tests that need a session: a cancelled
  request lands in the request log as ``cancelled`` before the session
  closes, and a SIGTERM mid-burst (in a subprocess, ``device="cpu"``)
  leaves every request ``finished`` or ``shed``, never ``evicted``, with
  the bundle the hook dumped;
- the reference's ``test_tracing_off_means_no_artifacts_and_no_hooks``;
- the replica's ``/metrics`` and ``/v1/flight`` with a session and with
  none; the checkpoint phases in the span file and the goodput ledger; a
  config asking for an unported part raises; a graph captured while a
  request is in flight shows as its ``compiles_in_flight`` 1.

The JAX engine runs its paged decode and ragged prefill kernels through
the Pallas interpreter, as its own tests do; the port's engine runs the
kernels' plain versions (CPU tensors).
"""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.serving.scheduler import MultiTenantScheduler as JaxScheduler
from accelerate_tpu.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from accelerate_tpu.telemetry import TelemetryConfig as JaxTelemetryConfig
from accelerate_tpu.telemetry import TelemetrySession as JaxTelemetrySession
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer, SchedulerConfig, ServingEngine
from accelerate_tpu_torch.serving.scheduler import MultiTenantScheduler
from accelerate_tpu_torch.telemetry import (TelemetryConfig, TelemetrySession,
                                            current_session, load_chrome_trace)
from accelerate_tpu_torch.utils import cuda_graphs

ROOT = Path(__file__).resolve().parent.parent
PS = 8
HTTP_TIMEOUT = 60

# record keys that carry a wall-clock reading (compared for presence only)
TIMING = ("submit_unix_s", "finish_unix_s", "queue_wait_ms", "ttft_ms", "total_ms",
          "itl_ms", "itl_p50_ms", "itl_max_ms")
# usage fields that integrate wall time
USAGE_TIMED = ("page_seconds", "host_byte_seconds", "disk_byte_seconds", "compute_ms")


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64,
                          decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, (n,)) for n in (5, 8, 12, 3)]
    return jmodel, params, model, prompts


@pytest.fixture(autouse=True)
def no_leaked_session():
    yield
    s = current_session()
    if s is not None:
        s.close()


def _frozen_clock():
    return 0.0


def _kw(ref: bool, sched: dict | None, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("prefill_chunks", (4, 8))
    if sched is not None:
        cls, cfg = (JaxScheduler, JaxSchedulerConfig) if ref else \
            (MultiTenantScheduler, SchedulerConfig)
        # one frozen clock: the quota buckets read it, so both sides
        # admit alike whatever the host's pace
        kw["scheduler"] = cls(cfg(**sched), now_fn=_frozen_clock)
    return kw


def _run_traced(models, ref: bool, script, trace_dir, sched, **kw):
    """``script(engine)`` on one side under a fresh session writing to
    ``trace_dir``; returns (requests, records by id, usage totals,
    histogram counts) once the session is closed."""
    jmodel, params, model, _ = models
    if ref:
        session = JaxTelemetrySession(JaxTelemetryConfig(
            trace_dir=str(trace_dir), flight_hooks=False, timeline_interval_s=0))
        eng = JaxEngine(jmodel, params, telemetry=session, **_kw(True, sched, **kw))
    else:
        session = TelemetrySession(TelemetryConfig(trace_dir=str(trace_dir),
                                                   flight_hooks=False))
        eng = ServingEngine(model, device="cpu", telemetry=session,
                            **_kw(False, sched, **kw))
    try:
        reqs = script(eng)
        assert all(r.done for r in reqs)
        usage = session.usage.totals()
        counts = {k: h.count for k, h in session.hists.items()}
        decode_by_tenant = {name: t.decode_tokens for name, t in session.usage.tenants.items()}
        gen = eng.generated_tokens
    finally:
        session.close()
    recs = [json.loads(line) for line in open(Path(trace_dir) / "requests-host0.jsonl")]
    assert sum(decode_by_tenant.values()) == gen  # the conservation law
    return reqs, {r["request_id"]: r for r in recs}, usage, counts, decode_by_tenant


def _strip(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in TIMING and k != "compiles_in_flight"}
    out["prefill_chunks"] = [{k: v for k, v in c.items() if k != "ms"}
                             for c in rec["prefill_chunks"]]
    return out


def _mixed_script(prompts):
    """A preemption and its resume, a cancel, a timeout and sheds at the
    bounded queue, over two tenants."""
    def script(eng):
        low = eng.submit(prompts[1], max_new_tokens=10, seed=3, priority=0, tenant="batch")
        while len(low.tokens) < 3:
            eng.step()
        high = eng.submit(prompts[0], max_new_tokens=4, seed=7, priority=5,
                          tenant="interactive")
        gone = eng.submit(prompts[2], max_new_tokens=6, seed=1, tenant="batch")
        late = eng.submit(prompts[3], max_new_tokens=6, seed=2, tenant="interactive",
                          timeout_s=0.001)
        shed = [eng.submit(prompts[3], max_new_tokens=2, seed=9, tenant="batch")
                for _ in range(2)]
        gone.cancel()
        time.sleep(0.01)
        eng.run()
        return [low, high, gone, late, *shed]
    return script


def _fifo_script(prompts):
    """Four requests on two slots with no scheduler: on the paged arena the
    later ones co-admit into one packed prefill."""
    def script(eng):
        reqs = [eng.submit(p, max_new_tokens=5, seed=i) for i, p in enumerate(prompts)]
        eng.run()
        return reqs
    return script


CASES = {
    "mixed": (_mixed_script, dict(max_queue_depth=3), dict(num_slots=1)),
    "fifo": (_fifo_script, None, dict(num_slots=2)),
}


@pytest.mark.parametrize("arena", ["paged", "flat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_records_usage_and_histograms_match_reference(models, tmp_path, arena, case):
    """Records equal field for field but the timings, usage totals and
    histogram counts equal, on both arenas."""
    _, _, _, prompts = models
    make, sched, kw = CASES[case]
    kw = dict(kw, page_size=PS if arena == "paged" else None)
    jreqs, jrecs, jusage, jcounts, jdec = _run_traced(
        models, True, make(prompts), tmp_path / "ref", sched, **kw)
    treqs, trecs, tusage, tcounts, tdec = _run_traced(
        models, False, make(prompts), tmp_path / "port", sched, **kw)
    assert [r.outcome for r in treqs] == [r.outcome for r in jreqs]
    assert [r.tokens for r in treqs] == [[int(x) for x in r.tokens] for r in jreqs]
    assert sorted(trecs) == sorted(jrecs) == sorted(r.id for r in treqs)
    for rid in trecs:
        t, j = trecs[rid], jrecs[rid]
        assert set(t) == set(j), (rid, set(t) ^ set(j))
        assert _strip(t) == _strip(j), rid
        assert len(t["itl_ms"]) == len(j["itl_ms"]), rid
        assert t["compiles_in_flight"] == 0
    for f, v in jusage.items():
        if f not in USAGE_TIMED:
            assert tusage[f] == v, f
    assert tdec == jdec
    assert tcounts == jcounts
    outcomes = {r["outcome"] for r in trecs.values()}
    if case == "mixed":
        assert outcomes == {"finished", "cancelled", "shed"}
        assert max(r.get("preemptions", 0) for r in trecs.values()) == 1
        reasons = {r["finish_reason"] for r in trecs.values()}
        assert {"cancelled", "timeout", "shed", "budget"} <= reasons
    # the gaps: one fewer than the tokens of each request that emitted any
    # (a resume restarts the ITL clock, so a preempted request has one less)
    gaps = sum(len(r["itl_ms"]) for r in trecs.values())
    assert tcounts.get("serving/itl", 0) == gaps
    assert tcounts.get("serving/ttft", 0) == sum(1 for r in trecs.values() if "ttft_ms" in r)


# -- the two reference scheduler tests that need a session -------------------


def test_cancelled_lands_in_request_log_as_cancelled(models, tmp_path):
    """A cancelled request is a ``cancelled`` record in requests-host0.jsonl
    at finish time, not an ``evicted`` orphan at tracer close."""
    _, _, model, prompts = models
    session = TelemetrySession(TelemetryConfig(
        trace_dir=str(tmp_path), watchdog=False, flight_hooks=False))
    try:
        engine = ServingEngine(model, device="cpu", num_slots=1, max_cache_len=64,
                               prefill_chunks=(4, 8), page_size=PS,
                               scheduler=SchedulerConfig(), telemetry=session)
        req = engine.submit(prompts[1], max_new_tokens=30, seed=0)
        while len(req.tokens) < 2:
            engine.step()
        req.cancel()
        done = engine.submit(prompts[3], max_new_tokens=2, seed=1)
        engine.run()
        # records exist BEFORE session close: no evicted drain needed
        recs = [json.loads(line) for line in open(tmp_path / "requests-host0.jsonl")]
        by_id = {r["request_id"]: r for r in recs}
        assert by_id[req.id]["outcome"] == "cancelled"
        assert by_id[req.id]["finish_reason"] == "cancelled"
        assert by_id[done.id]["outcome"] == "finished"
        assert by_id[req.id]["tenant"] == "default"
    finally:
        session.close()


def test_sigterm_drains_serving_in_subprocess(tmp_path):
    """The SIGTERM flight-recorder hook requests a drain: shutdown
    mid-burst leaves every submitted request with a definite outcome in
    the request log (finished or shed), never an abandoned ``evicted``."""
    code = (
        "import os, signal, sys, json\n"
        "import numpy as np\n"
        "from accelerate_tpu_torch.models.configs import DecoderConfig\n"
        "from accelerate_tpu_torch.models.convert import random_params\n"
        "from accelerate_tpu_torch.models.decoder import DecoderLM\n"
        "from accelerate_tpu_torch.serving import SchedulerConfig, ServingEngine\n"
        "from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession\n"
        "signal.signal(signal.SIGTERM, lambda *a: None)  # benign chain target\n"
        f"session = TelemetrySession(TelemetryConfig(trace_dir={str(tmp_path)!r}, "
        "spans=False, watchdog=False, flight_hooks=True))\n"
        "cfg = DecoderConfig.tiny(max_seq_len=64)\n"
        "model = DecoderLM(cfg, device='cpu').load_params(random_params(cfg, device='cpu'))\n"
        "rng = np.random.RandomState(0)\n"
        "engine = ServingEngine(model, device='cpu', num_slots=1, max_cache_len=64, "
        "prefill_chunks=(4, 8), page_size=8, scheduler=SchedulerConfig(), "
        "telemetry=session)\n"
        "reqs = [engine.submit(rng.randint(3, cfg.vocab_size, (6,)), "
        "max_new_tokens=4, seed=i) for i in range(4)]\n"
        "while not any(r.tokens for r in reqs):\n"
        "    engine.step()\n"
        "os.kill(os.getpid(), signal.SIGTERM)  # dump + request_drain + chain\n"
        "assert engine._draining, 'SIGTERM hook must request the drain'\n"
        "engine.serve()  # finishes in-flight, queued already shed\n"
        "session.close()\n"
        "print('OUTCOMES ' + json.dumps([r.outcome for r in reqs]))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=240, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    outcomes = json.loads(r.stdout.split("OUTCOMES ", 1)[1])
    assert all(o in ("finished", "shed") for o in outcomes), outcomes
    assert "shed" in outcomes and "finished" in outcomes
    recs = [json.loads(line) for line in open(tmp_path / "requests-host0.jsonl")]
    assert len(recs) == 4
    assert all(rec["outcome"] in ("finished", "shed") for rec in recs)
    assert not any(rec["outcome"] == "evicted" for rec in recs)
    # the bundle the hook dumped before draining is there too
    assert sorted(tmp_path.glob("flightrec-host0-*.json"))


def test_tracing_off_means_no_artifacts_and_no_hooks(models):
    """With no session the engine's tracing layer is a single attribute
    check: no tracer, no histograms, no files."""
    _, _, model, prompts = models
    assert current_session() is None
    engine = ServingEngine(model, device="cpu", num_slots=1, max_cache_len=64,
                           prefill_chunks=(8,))
    assert engine.telemetry is None and engine._tracer() is None
    assert engine._usage() is None
    engine.generate_batched(prompts[:1], max_new_tokens=3)
    assert engine.requests_completed == 1
    assert not engine.flight_dump("probe")


def test_engine_picks_up_current_session_and_flushes_on_drain(models, tmp_path):
    """``telemetry=None`` attaches the process's session, as the
    reference's; ``drain()`` flushes it (the goodput and usage snapshots
    land in the trace dir)."""
    _, _, model, prompts = models
    session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path), flight_hooks=False))
    engine = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                           prefill_chunks=(4, 8), page_size=PS)
    assert engine.telemetry is session
    for p in prompts[:2]:
        engine.submit(p, max_new_tokens=3, tenant="t0")
    engine.run()
    assert not (tmp_path / "usage-host0.json").exists()
    engine.drain()
    snap = json.load(open(tmp_path / "usage-host0.json"))
    assert snap["tenants"]["t0"]["finished"] == 2
    assert snap["tenants"]["t0"]["decode_tokens"] == engine.generated_tokens == 6
    assert snap["tenants"]["t0"]["pages_held"] == 0
    assert (tmp_path / "goodput-host0.json").exists()
    roll = session.rollup()
    assert roll["serving/ttft_count"] == 2 and roll["usage/t0/finished"] == 2
    assert "sys/mfu_pct" not in roll  # no peak off an H100, so no MFU
    session.close()
    assert engine.telemetry is None  # a closed session is detached


def test_capture_in_flight_counts_as_compile(models, tmp_path, monkeypatch):
    """A CUDA graph captured while a request is in flight is the port's
    recompile: the request's record says ``compiles_in_flight`` 1, the
    step window and the bundle see it. After ``warmup()`` the same run
    captures nothing and reads 0."""
    _, _, model, prompts = models

    class Step:
        def __init__(self, body):
            self.body, self.seconds = body, 0.0

        def replay(self):
            return self.body()

    monkeypatch.setattr(cuda_graphs, "captures", lambda device: True)
    monkeypatch.setattr(cuda_graphs, "_record", lambda body, device, restore: Step(body))
    monkeypatch.setattr("accelerate_tpu_torch.ops.kernels.build", lambda names=None: None)
    session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path), flight_hooks=False))
    try:
        for warm in (False, True):
            engine = ServingEngine(model, device="cpu", num_slots=1, max_cache_len=64,
                                   prefill_chunks=(4, 8), page_size=PS, telemetry=session)
            if warm:
                engine.device = torch.device("cuda")
                engine.warmup()
                engine.device = torch.device("cpu")
            n0 = cuda_graphs.capture_counters()["count"]
            req = engine.submit(prompts[0], max_new_tokens=3)
            engine.run()
            assert cuda_graphs.capture_counters()["count"] - n0 == (0 if warm else 1)
            rec = [json.loads(line) for line in open(tmp_path / "requests-host0.jsonl")][-1]
            assert rec["request_id"] == req.id
            assert rec["compiles_in_flight"] == (0 if warm else 1)
        bundle = json.load(open(session.flight.dump("probe")))
        assert bundle["compile_counters"]["count"] == cuda_graphs.capture_counters()["count"]
        assert bundle["inflight_requests"] == []
    finally:
        session.close()


def test_step_records_and_flush_every(models, tmp_path):
    """``metrics_jsonl`` writes one record per decode dispatch (a burst of
    K is one record of ``steps`` K), and ``flush_every`` flushes on the
    step count (every step at 1): the snapshots appear before ``drain()``."""
    _, _, model, prompts = models
    session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path), flight_hooks=False,
                                               metrics_jsonl=True, flush_every=1))
    try:
        engine = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                               prefill_chunks=(4, 8), page_size=PS, steps_per_call=2)
        for p in prompts[:2]:
            engine.submit(p, max_new_tokens=7)
        engine.run()
        recs = [json.loads(line) for line in open(tmp_path / "metrics-host0.jsonl")]
        assert sum(r["steps"] for r in recs) == engine.step_count
        assert sum(r["tokens"] for r in recs) == engine.generated_tokens - 2  # firsts: prefill
        assert {r["steps"] for r in recs} == {1, 2}
        assert all(r["compile_events"] == 0 and r["tokens_per_s"] > 0 for r in recs)
        assert (tmp_path / "usage-host0.json").exists()
        roll = session.rollup()
        assert roll["sys/window_steps"] == engine.step_count
        assert roll["sys/step"] == engine.step_count
    finally:
        session.close()


# -- the replica ---------------------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
        return [json.loads(line) for line in resp.read().splitlines() if line.strip()]


def _get(url):
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as resp:
        return resp.read().decode()


@pytest.mark.parametrize("with_session", [True, False])
def test_replica_metrics_and_flight(models, tmp_path, with_session):
    """With a session the replica scrapes it (the ``att_serving_ttft``
    histogram, its count the requests finished, exemplars naming request
    ids) and ``POST /v1/flight`` answers ok with a bundle written; with
    none, the engine-gauge shim and ``ok: false``."""
    _, _, model, prompts = models
    session = (TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path), flight_hooks=False))
               if with_session else None)
    engine = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                           prefill_chunks=(4, 8), page_size=PS, telemetry=session)
    server = ReplicaServer(engine, name="m").start()
    try:
        for p in prompts[:3]:
            done = _post(f"{server.url}/v1/submit",
                         {"prompt": [int(t) for t in p], "max_new_tokens": 3})[-1]
            assert done["outcome"] == "finished"
        text = _get(f"{server.url}/metrics")
        assert "att_serving_generated_tokens 9" in text
        flight = _post(f"{server.url}/v1/flight", {"reason": "probe"})[0]
        if with_session:
            assert "att_serving_ttft_seconds_count 3" in text
            assert 'att_serving_ttft_seconds_bucket{le="+Inf"} 3' in text
            assert '# {request_id="' in text  # an exemplar on a bucket line
            assert "att_usage_default_decode_tokens 9" in text
            assert flight == {"ok": True, "replica": "m", "reason": "probe"}
            bundles = sorted(tmp_path.glob("flightrec-host0-*.json"))
            assert bundles
            data = json.load(open(bundles[-1]))
            assert data["reason"] == "probe"
            assert sum(e["kind"] == "request_finish" for e in data["events"]) == 3
        else:
            assert "att_serving_ttft_seconds" not in text
            assert flight == {"ok": False, "replica": "m", "reason": "probe"}
    finally:
        server.close()
        if session is not None:
            session.close()


# -- checkpoint phases, unported parts -------------------------------------------


def test_checkpoint_phases_billed_to_goodput(tmp_path):
    """``save_accelerator_state`` and ``load_accelerator_state`` run inside
    ``checkpoint/save`` and ``checkpoint/restore``: one span each in the
    trace, and their walls in the ledger's checkpoint bucket."""
    from accelerate_tpu_torch.checkpointing import load_accelerator_state, save_accelerator_state

    session = TelemetrySession(TelemetryConfig(trace_dir=str(tmp_path / "tel"),
                                               flight_hooks=False))
    try:
        model = torch.nn.Linear(8, 4)
        t0 = time.perf_counter()
        save_accelerator_state(str(tmp_path / "ckpt"), models=[model], step=3)
        t1 = time.perf_counter()
        assert load_accelerator_state(str(tmp_path / "ckpt"), models=[model]) == 3
        t2 = time.perf_counter()
        # the two calls' walls, less only the calls' own entry and exit
        secs = session.goodput.totals()["checkpoint"]
        assert 0.5 * (t2 - t0) <= secs <= (t2 - t0)
        assert t1 > t0
    finally:
        session.close()
    events = load_chrome_trace(str(tmp_path / "tel" / "trace-host0.jsonl"))["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "phase"]
    assert names == ["checkpoint/save", "checkpoint/restore"]
    snap = json.load(open(tmp_path / "tel" / "goodput-host0.json"))
    assert snap["seconds"]["checkpoint"] > 0


@pytest.mark.parametrize("field,value,owner", [
    ("watchdog", True, "item 10"),
    ("heartbeat_dir", "/nonexistent", "item 10"),
    ("profile_steps", (2, 4), "item 4b"),
    ("profile_trigger_itl_p99_ms", 50.0, "item 4b"),
    ("alert_rules", [], "4b(iii)"),
    ("alert_itl_slo_ms", 20.0, "4b(iii)"),
    ("timeline_tiers", ((1.0, 8),), "4b(iii)"),
    ("timeline_interval_s", 5.0, "4b(iii)"),
    ("flops_per_token", 1e9, "4b(ii)"),
])
def test_unported_parts_raise_when_asked_for(field, value, owner, tmp_path):
    """The parts still unported raise, naming their owner. The ops plane's
    timeline and alerts (4b(iii)), the profiler capture window (4b) and
    the training telemetry (4b(ii)) are ported now: their fields build the
    part as asked (the reference's behaviour) instead of raising."""
    if owner in ("item 4b", "4b(ii)"):
        session = TelemetrySession(TelemetryConfig(flight_hooks=False, trace_dir=str(tmp_path),
                                                   **{field: value}))
        try:
            if field == "flops_per_token":
                session.attach_engine(type("Owner", (), {"model_config": None})())
                assert session._flops_fn(2048) == value
            else:
                assert session.capture is not None
                assert session.capture.out_dir == str(tmp_path / "profile")
                assert (session.capture.start_step, session.capture.stop_step) == (
                    tuple(value) if field == "profile_steps" else (None, None))
        finally:
            session.close()
        assert current_session() is None
        return
    if owner == "4b(iii)":
        session = TelemetrySession(TelemetryConfig(flight_hooks=False, **{field: value}))
        try:
            if field == "alert_rules":
                assert session.alerts.rules == []
            elif field == "alert_itl_slo_ms":
                assert any(getattr(r, "slo", None) == value for r in session.alerts.rules)
            elif field == "timeline_tiers":
                assert (session.timeline.raw_interval_s, session.timeline.raw.maxlen,
                        session.timeline.tiers) == (1.0, 8, [])
            else:
                assert session._sampler.interval_s == value
        finally:
            session.close()
        assert current_session() is None
        return
    with pytest.raises(NotImplementedError, match=owner.replace("(", r"\(").replace(")", r"\)")):
        TelemetrySession(TelemetryConfig(**{field: value}))
    assert current_session() is None


def test_defaults_build_nothing_unported_and_name_it():
    """Left at their defaults, the later parts are not built and
    ``unported`` names each with its owner, while the ported timeline and
    alerts are built as the reference builds them; every field of the
    reference's config exists at the reference's default."""
    import dataclasses

    session = TelemetrySession(TelemetryConfig())
    try:
        assert set(session.unported) == {"forensics", "cost_registry", "watchdog"}
        assert session.timeline is not None and session.alerts is not None
        assert session.costs is None
        assert session.watchdog is session.capture is session.forensics is None
        assert session.recorder is None  # no trace_dir: no span file
    finally:
        session.close()
    ref = {f.name: f.default for f in dataclasses.fields(JaxTelemetryConfig)}
    port = {f.name: f.default for f in dataclasses.fields(TelemetryConfig)}
    assert port == ref
