"""The port's replica role (``accelerate_tpu_torch/serving/replica_server.py``,
``commands/serve.py`` and the engine surface the server reads) on the CPU.

- Parity: the port's ``ReplicaServer`` over the port's engine streams
  exactly the reference ``ReplicaServer``'s greedy tokens over the
  reference engine (weights carried through ``models/convert.py``), on
  the paged (page 4) and the flat arena, request after request. The
  reference engine runs its Pallas kernels in the interpreter, as the
  port's other engine tests do.
- Cancel (queued, mid-admission, live; over HTTP and through
  ``Request.cancel()``), timeout and drain end each request as the
  reference's contract says and give its slot and pages back.
- Gauge parity: one submit / cancel / step / drain sequence on both
  engines gives the same gauge keys and integer gauges, and each side's
  ``load_score`` is the copied formula over its own components.
- The scrape, health and flight endpoints; the CLI as a subprocess
  (startup line, a stream, SIGTERM drain, exit code 0); the port's own
  rule that an exception in ``step()`` is re-raised by
  ``serve_until_drained()``; a sampled replica; concurrent submits.

Every HTTP call has a timeout of at most 60 s, the subprocess 120 s.
"""

import argparse
import http.client
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving.engine import ServingEngine as JaxEngine
from accelerate_tpu.serving.replica_server import ReplicaServer as JaxReplicaServer
from accelerate_tpu_torch.commands import serve as serve_cli
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.telemetry.fleet import load_score

ROOT = Path(__file__).resolve().parent.parent
PAGE = 4
CACHE = 64
CHUNKS = (4, 8)
HTTP_TIMEOUT = 60
ARENAS = {"paged": PAGE, "flat": None}


@pytest.fixture(scope="module")
def served():
    """The reference replica tests' fixture (tiny, PRNGKey(0), four prompts
    from RandomState(0)), with the port's model on the same weights."""
    jcfg = JaxConfig.tiny(max_seq_len=CACHE, decode_kernel="interpret",
                          prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"]
    )
    cfg = DecoderConfig.tiny(max_seq_len=CACHE)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, jcfg.vocab_size, (n,)) for n in (12, 8, 5, 10)]
    return jmodel, params, model, prompts


def _engine(model, arena, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_cache_len", CACHE)
    kw.setdefault("prefill_chunks", CHUNKS)
    return ServingEngine(model, device="cpu", page_size=ARENAS[arena], **kw)


def _jax_engine(jmodel, params, arena, **kw):
    return JaxEngine(jmodel, params, num_slots=2, max_cache_len=CACHE,
                     prefill_chunks=CHUNKS, page_size=ARENAS[arena], **kw)


def _post(url, payload, timeout=HTTP_TIMEOUT):
    """POST JSON; the response's JSON lines (one document unless streamed)."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(line) for line in resp.read().splitlines() if line.strip()]


def _get(url, timeout=HTTP_TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _stream(url, payload, events: list, first: threading.Event = None):
    """Stream ``/v1/submit`` JSONL into ``events`` line by line, setting
    ``first`` at the first event; a connection dropped mid-stream ends it
    quietly (the caller checks for the terminal event)."""
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/v1/submit", body=json.dumps({**payload, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        while True:
            line = resp.readline()
            if not line:
                return
            events.append(json.loads(line))
            if first is not None:
                first.set()
    except (http.client.HTTPException, OSError):
        return
    finally:
        conn.close()


def _wait(cond, what: str, timeout: float = HTTP_TIMEOUT):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


class StepGate:
    """Hands the engine's steps to the test: the server's loop thread runs
    one ``step()`` per :meth:`steps` permit, so a request can be held
    queued, mid-admission or live while the test acts over HTTP."""

    def __init__(self, engine):
        self._inner = engine.step
        self._go = threading.Semaphore(0)
        self._done = threading.Semaphore(0)
        self._open = False
        engine.step = self.step

    def step(self):
        while not self._open and not self._go.acquire(timeout=0.01):
            pass
        out = self._inner()
        self._done.release()
        return out

    def steps(self, n: int = 1):
        for _ in range(n):
            self._go.release()
            assert self._done.acquire(timeout=HTTP_TIMEOUT), "the loop thread stalled"

    def open(self):
        self._open = True


# ---------------------------------------------------------------------------
# parity with the reference replica
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_replica_streams_the_reference_replicas_tokens(served, arena):
    """Sequential greedy streamed submits to both replicas: the streamed
    tokens and the terminal events' outcome, finish_reason, tokens and
    prefix_hit are identical, request for request."""
    jmodel, params, model, prompts = served
    jserver = JaxReplicaServer(_jax_engine(jmodel, params, arena), name="r").start()
    server = ReplicaServer(_engine(model, arena), name="r").start()
    try:
        for i, p in enumerate(prompts + prompts[:1]):  # the replay hits the prefix cache
            body = {"prompt": [int(t) for t in p], "max_new_tokens": 6, "seed": i,
                    "stream": True}
            jevents = _post(f"{jserver.url}/v1/submit", body)
            events = _post(f"{server.url}/v1/submit", body)
            jtoks = [e["token"] for e in jevents if e["event"] == "token"]
            toks = [e["token"] for e in events if e["event"] == "token"]
            assert len(toks) == 6 and toks == jtoks
            assert events[-1]["event"] == jevents[-1]["event"] == "done"
            for key in ("outcome", "finish_reason", "tokens", "prefix_hit", "replica"):
                assert events[-1][key] == jevents[-1][key], key
            assert events[-1]["outcome"] == "finished"
        assert events[-1]["prefix_hit"] == (8 if arena == "paged" else 0)
    finally:
        jserver.close()
        server.close()


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_wrong_token_drill_matches_the_reference_replica(served, arena):
    """``ReplicaServer(faults=...)`` with a ``wrong_token`` fault: the wire
    carries ``token ^ 1`` from stream index 2 for 3 tokens, on both sides
    alike, while the engine's tokens (the terminal event's) stay right.
    The engines run under a scheduler, the body carrying tenant, priority
    and deadline_s."""
    from accelerate_tpu.serving import FaultInjector as JaxFaults
    from accelerate_tpu.serving import SchedulerConfig as JaxSchedulerConfig
    from accelerate_tpu_torch.serving import FaultInjector, SchedulerConfig

    jmodel, params, model, prompts = served
    jfaults = JaxFaults(seed=0).wrong_token(after_tokens=2, count=3)
    faults = FaultInjector(seed=0).wrong_token(after_tokens=2, count=3)
    jserver = JaxReplicaServer(
        _jax_engine(jmodel, params, arena, scheduler=JaxSchedulerConfig()), name="r",
        faults=jfaults).start()
    server = ReplicaServer(_engine(model, arena, scheduler=SchedulerConfig()), name="r",
                           faults=faults).start()
    try:
        for i, p in enumerate(prompts[:2]):
            body = {"prompt": [int(t) for t in p], "max_new_tokens": 6, "seed": i,
                    "tenant": "drill", "priority": 3, "deadline_s": 5.0, "stream": True}
            jevents = _post(f"{jserver.url}/v1/submit", body)
            events = _post(f"{server.url}/v1/submit", body)
            toks = [e["token"] for e in events if e["event"] == "token"]
            assert toks == [e["token"] for e in jevents if e["event"] == "token"]
            true = events[-1]["tokens"]
            assert events[-1]["outcome"] == "finished" and true == jevents[-1]["tokens"]
            flipped = [j for j, (a, b) in enumerate(zip(toks, true)) if a != b]
            assert all(toks[j] == true[j] ^ 1 for j in flipped)
            assert flipped == ([2, 3, 4] if i == 0 else [])  # the count ran out
        assert faults.log == jfaults.log
        assert [k for _, k, _ in faults.log] == ["wrong_token"] * 3
        m = server.engine.metrics()
        assert m["serving/tenant_drill_queued"] == 0
        assert m["serving/quota_drill_tokens_used"] == 12
    finally:
        jserver.close()
        server.close()


# ---------------------------------------------------------------------------
# cancel, timeout, drain
# ---------------------------------------------------------------------------


def _prefix_pages(engine) -> int:
    """Pages the prefix cache holds a reference to."""
    return len({p for e in engine._prefix.entries.values() for p in e.pages})


def _assert_released(engine, num_slots: int = 2):
    m = engine.metrics()
    assert m["serving/free_slots"] == num_slots
    assert not engine._pending()
    if engine.page_size:
        assert m["serving/pages_in_use"] == _prefix_pages(engine)


# the prompt each case cancels: mid-admission needs one whose prefill takes
# several dispatches (20 tokens: flat chunks 8 + 8 + 4, paged packs of 8)
CANCEL_PROMPT = {"queued": 5, "admitting": 20, "live": 5}


def _bring_to(engine, step, req_state, state: str):
    """Step until the request is in ``state``: queued (no step),
    admitting (one dispatch of a multi-dispatch prefill) or live."""
    if state == "admitting":
        step()
        assert engine._admitting is not None and engine._admitting[0] is req_state()
    elif state == "live":
        _wait(lambda: (step() or True) and req_state().slot is not None, "a live slot")
        assert not req_state().done


@pytest.mark.parametrize("state", sorted(CANCEL_PROMPT))
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_request_cancel(served, arena, state):
    """``Request.cancel()`` on a queued, a mid-admission and a live request:
    it ends ``cancelled`` at the next step, the slot returns, and on the
    paged arena only the prefix cache's pages stay in use (a request
    cancelled mid-admission published nothing)."""
    _, _, model, _ = served
    engine = _engine(model, arena)
    req = engine.submit(np.arange(3, 3 + CANCEL_PROMPT[state]), max_new_tokens=30)
    _bring_to(engine, engine.step, lambda: req, state)
    assert req.cancel()
    engine.step()
    assert (req.outcome, req.finish_reason) == ("cancelled", "cancelled")
    assert not req.cancel()  # already terminal
    _assert_released(engine)
    if state != "live" and engine.page_size:
        assert engine.metrics()["serving/pages_in_use"] == 0
    m = engine.metrics()
    assert (m["serving/cancelled"], m["serving/shed"]) == (1, 0)


@pytest.mark.parametrize("state", sorted(CANCEL_PROMPT))
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_http_cancel(served, arena, state):
    """``POST /v1/cancel`` on a streamed request held queued, mid-admission
    or live: the stream ends with ``done`` / ``cancelled`` and the slot and
    pages return."""
    _, _, model, _ = served
    engine = _engine(model, arena)
    server = ReplicaServer(engine, name="c")
    gate = StepGate(engine)
    server.start()
    events, rid = [], f"cancel-{state}"
    client = threading.Thread(target=_stream, daemon=True, args=(
        f"{server.url}/v1/submit",
        {"prompt": list(range(3, 3 + CANCEL_PROMPT[state])), "max_new_tokens": 30,
         "request_id": rid}, events))
    try:
        client.start()
        _wait(lambda: engine._queue or engine._pending(), "the submit")
        req = engine._queue[0]
        _bring_to(engine, gate.steps, lambda: req, state)
        assert _post(f"{server.url}/v1/cancel", {"request_id": rid}) == [{"ok": True}]
        gate.steps(1)
        client.join(timeout=HTTP_TIMEOUT)
        assert not client.is_alive()
        assert events[-1]["event"] == "done"
        assert (events[-1]["outcome"], events[-1]["finish_reason"]) == ("cancelled", "cancelled")
        assert [e["token"] for e in events[:-1]] == events[-1]["tokens"]
        _assert_released(engine)
        with pytest.raises(urllib.error.HTTPError) as err:  # no longer live
            _post(f"{server.url}/v1/cancel", {"request_id": rid})
        assert err.value.code == 404
    finally:
        gate.open()
        server.close()


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_timeout_reaps_live_and_queued(served, arena):
    """``timeout_s=0.0`` on a live request ends it cancelled with reason
    ``timeout`` at the next step; over HTTP a request submitted with
    ``timeout_s`` 0 ends alike."""
    _, _, model, prompts = served
    engine = _engine(model, arena)
    req = engine.submit(prompts[2], max_new_tokens=30)
    _bring_to(engine, engine.step, lambda: req, "live")
    req.timeout_s = 0.0
    engine.step()
    assert (req.outcome, req.finish_reason) == ("cancelled", "timeout")
    _assert_released(engine)
    server = ReplicaServer(engine).start()
    try:
        done = _post(f"{server.url}/v1/submit", {
            "prompt": [int(t) for t in prompts[1]], "max_new_tokens": 30,
            "timeout_s": 0.0, "stream": False})
        assert (done[0]["outcome"], done[0]["finish_reason"]) == ("cancelled", "timeout")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{server.url}/v1/submit", {"prompt": [5, 6], "timeout_s": "soon"})
        assert err.value.code == 400
    finally:
        server.close()
    assert engine.metrics()["serving/cancelled"] == 2


def test_drain_sheds_new_work_finishes_streams(served):
    """The drain choreography: request_drain() mid-stream, the in-flight
    stream still reaches its terminal event; a later submit sheds with
    shed_reason "draining"; /metrics exports the draining gauge."""
    _, _, model, prompts = served
    engine = _engine(model, "paged")
    engine.warmup()
    server = ReplicaServer(engine).start()
    try:
        events = []
        t = threading.Thread(target=_stream, daemon=True, args=(
            f"{server.url}/v1/submit",
            {"prompt": [int(x) for x in prompts[1]], "max_new_tokens": 12}, events))
        t.start()
        _wait(lambda: engine._slot_req, "a live request")
        server.request_drain()
        t.join(timeout=HTTP_TIMEOUT)
        assert not t.is_alive()
        assert events[-1]["event"] == "done"
        assert events[-1]["outcome"] == "finished"
        assert len(events[-1]["tokens"]) == 12
        late = _post(f"{server.url}/v1/submit", {
            "prompt": [int(x) for x in prompts[2]], "max_new_tokens": 4})
        assert late[-1]["outcome"] == "shed"
        assert late[-1]["shed_reason"] == "draining"
        assert server.serve_until_drained(timeout_s=HTTP_TIMEOUT)
        assert "att_serving_draining 1" in _get(f"{server.url}/metrics")
        assert json.loads(_get(f"{server.url}/v1/health"))["draining"] is True
    finally:
        server.close()


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_engine_drain_returns_outcomes(served, arena):
    """``drain()`` on the owner thread: the queue is shed, the in-flight
    request finishes, the counts come back; with a zero timeout the live
    stragglers are cancelled with reason ``drain_timeout``."""
    _, _, model, prompts = served
    engine = _engine(model, arena)
    reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
    engine.step()  # one admission under way, the rest queued
    assert engine.drain() == {"completed": 1, "shed": 3, "cancelled": 0}
    assert [r.shed_reason for r in reqs[1:]] == ["draining"] * 3
    engine = _engine(model, arena)
    live = engine.submit(prompts[2], max_new_tokens=30)
    _bring_to(engine, engine.step, lambda: live, "live")
    assert engine.drain(timeout_s=0.0)["cancelled"] == 1
    assert live.finish_reason == "drain_timeout"
    _assert_released(engine)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_warmup_builds_the_engines_kernels(served, arena, kv, monkeypatch):
    """``warmup()`` needs an idle engine; on CUDA it builds exactly the
    kernels the engine's arena and KV dtype launch (so the first request
    holds no nvcc build) and captures the decode step's CUDA graph (so it
    holds no capture either), serving nothing; on the CPU it does
    neither. The capture is stubbed here: it runs only on the card."""
    from accelerate_tpu_torch.ops import kernels
    from accelerate_tpu_torch.utils import cuda_graphs

    _, _, model, prompts = served
    built, captured = [], []

    class Captured:
        seconds = 0.0

        def __init__(self, body, device, restore=()):
            captured.append(body.__name__)

        def replay(self):
            raise AssertionError("warmup() replays nothing")

    monkeypatch.setattr(kernels, "build", lambda names=None: built.append(tuple(names)))
    monkeypatch.setattr(cuda_graphs, "capture", Captured)
    engine = _engine(model, arena, kv_cache_dtype=kv)
    engine.warmup()
    assert built == [] and captured == []
    engine.device = torch.device("cuda")  # the branch a CUDA engine takes
    engine.warmup()
    quant = "_quant" if kv == "int8" else ""
    want = ((f"paged_decode{quant}", f"ragged_prefill{quant}") if arena == "paged"
            else (f"dense_decode{quant}",))
    assert built == [want] and set(want) <= set(kernels.KERNELS)
    assert captured == ["_decode_body"] and list(engine._graphs) == ["decode"]
    assert engine.step_count == engine.prefill_dispatches == 0
    engine.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="idle engine"):
        engine.warmup()


def test_engine_serve_returns_on_drain(served):
    """``serve()`` schedules what another thread submits while it runs and
    returns once a drain has finished the in-flight work; with no
    ``should_stop`` it returns as soon as the engine is idle."""
    _, _, model, prompts = served
    engine = _engine(model, "paged")
    engine.serve()  # idle: returns at once
    stop = threading.Event()
    loop = threading.Thread(target=engine.serve, args=(stop.is_set,), daemon=True)
    loop.start()
    try:
        reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
        _wait(lambda: all(r.done for r in reqs), "the served requests")
        assert loop.is_alive()  # should_stop has not fired: it keeps serving
        engine.request_drain()
        loop.join(timeout=HTTP_TIMEOUT)
        assert not loop.is_alive()
    finally:
        stop.set()
    assert [r.outcome for r in reqs] == ["finished"] * 4


# ---------------------------------------------------------------------------
# gauges, scrape, health, flight
# ---------------------------------------------------------------------------

GAUGE_KEYS = ("serving/shed", "serving/cancelled", "serving/preemptions",
              "serving/resumptions", "serving/draining", "serving/itl_p50_ms",
              "serving/itl_p95_ms", "serving/itl_recent_p99_ms", "serving/page_size",
              "serving/num_slots", "serving/free_slots", "serving/free_pages",
              "serving/load_score", "serving/requests_terminal",
              "serving/capacity_tokens_per_s", "serving/headroom_frac")
INT_GAUGES = ("serving/queue_depth", "serving/free_slots", "serving/free_pages",
              "serving/requests_completed", "serving/shed", "serving/cancelled",
              "serving/requests_terminal")


def _own_load_score(m: dict, itl_slo_ms=None) -> float:
    return load_score(
        queue_depth=m["serving/queue_depth"], num_slots=m["serving/num_slots"],
        slot_occupancy=m["serving/slot_occupancy"], free_pages=m.get("serving/free_pages"),
        pages_total=m.get("serving/pages_total"),
        itl_recent_p99_ms=m.get("serving/itl_recent_p99_ms"), itl_slo_ms=itl_slo_ms,
        draining=bool(m.get("serving/draining")))


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_gauges_match_the_reference_engine(served, arena):
    """One submit / cancel / step / drain sequence on both engines: after
    every step the same gauge keys, equal integer gauges, and a
    load_score that is the copied formula over each side's components."""
    jmodel, params, model, prompts = served
    jeng = _jax_engine(jmodel, params, arena)
    teng = _engine(model, arena)
    sides = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new_tokens=8, seed=i) for i, p in enumerate(prompts)]
        snaps = []

        def snap():
            snaps.append(eng.metrics())

        snap()
        eng.step()
        reqs[3].cancel()  # queued
        for _ in range(4):
            eng.step()
            snap()
        reqs[0].cancel()  # live by now on both arenas
        for _ in range(3):
            eng.step()
            snap()
        eng.request_drain()
        eng.step()
        snap()
        late = eng.submit(prompts[1], max_new_tokens=2)
        assert late.shed_reason == "draining"
        while eng._pending():
            eng.step()
        snap()
        sides.append(snaps)
    for jm, tm in zip(*sides):
        assert {k for k in GAUGE_KEYS if k in tm} == {k for k in GAUGE_KEYS if k in jm}
        for key in INT_GAUGES:
            assert tm.get(key) == jm.get(key), key
        for m in (jm, tm):
            assert m["serving/load_score"] == _own_load_score(m)
    assert tm["serving/cancelled"] == 2 and tm["serving/shed"] == 1
    assert tm["serving/draining"] is True
    assert tm["serving/requests_terminal"] == 2 + 1 + tm["serving/requests_completed"]


def _shed_script(eng):
    """Submit past a two-deep queue (two shed), cancel one queued request,
    step, drain with a late submit (shed "draining"), finish. Returns the
    metrics after every step."""
    prompts = [np.arange(3 + i, 9 + i) for i in range(5)]
    reqs = [eng.submit(p, max_new_tokens=3, seed=i) for i, p in enumerate(prompts)]
    snaps = [eng.metrics()]
    reqs[1].cancel()
    for _ in range(2):
        eng.step()
        snaps.append(eng.metrics())
    eng.request_drain()
    eng.submit(prompts[0], max_new_tokens=2)
    while eng._pending():
        eng.step()
        snaps.append(eng.metrics())
    snaps.append(eng.metrics())
    return snaps


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_requests_terminal_and_shed_burn_match_the_reference(served, arena):
    """A submit / shed / cancel / drain sequence under a scheduler that
    sheds: ``serving/requests_terminal`` (completed + shed + cancelled) is
    equal on both engines after every step, and the ``shed_burn_rate``
    rule, which divides by it, walks the same states on each side's
    timeline and alert manager under one fake clock and fires."""
    from accelerate_tpu.serving import SchedulerConfig as JaxSchedulerConfig
    from accelerate_tpu.telemetry import alerts as ref_alerts
    from accelerate_tpu.telemetry import timeline as ref_timeline
    from accelerate_tpu_torch.serving import SchedulerConfig
    from accelerate_tpu_torch.telemetry import alerts as port_alerts
    from accelerate_tpu_torch.telemetry import timeline as port_timeline

    jmodel, params, model, _ = served
    runs = []
    for eng, alerts, timeline in (
            (_jax_engine(jmodel, params, arena,
                         scheduler=JaxSchedulerConfig(max_queue_depth=2)),
             ref_alerts, ref_timeline),
            (_engine(model, arena, scheduler=SchedulerConfig(max_queue_depth=2)),
             port_alerts, port_timeline)):
        snaps = _shed_script(eng)
        tl = timeline.Timeline()
        rules = [r for r in alerts.default_ruleset(shed_fast_s=4.0, shed_slow_s=40.0)
                 if r.name == "shed_burn_rate"]
        mgr = alerts.AlertManager(tl, rules, clock=lambda: 0.0)
        states = []
        for t, m in enumerate(snaps):
            tl.add_sample(m, now=1000.0 + t)
            mgr.evaluate(now=1000.0 + t)
            states.append(mgr.states_snapshot()["shed_burn_rate"]["state"])
        runs.append(([m["serving/requests_terminal"] for m in snaps], states))
    assert runs[1] == runs[0]
    terminal, states = runs[1]
    assert terminal[-1] == 6 and "firing" in states


@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_load_score_reads_the_schedulers_itl_slo(served, arena):
    """Under a scheduler with ``itl_slo_ms=20`` both engines' load score
    is the formula with the recent ITL p99 over 20 ms, not over the 100 ms
    default."""
    from accelerate_tpu.serving import SchedulerConfig as JaxSchedulerConfig
    from accelerate_tpu_torch.serving import SchedulerConfig

    jmodel, params, model, prompts = served
    for eng in (_jax_engine(jmodel, params, arena,
                            scheduler=JaxSchedulerConfig(itl_slo_ms=20.0)),
                _engine(model, arena, scheduler=SchedulerConfig(itl_slo_ms=20.0))):
        reqs = [eng.submit(p, max_new_tokens=6, seed=i) for i, p in enumerate(prompts)]
        seen = 0
        while not all(r.done for r in reqs):
            eng.step()
            m = eng.metrics()
            assert m["serving/load_score"] == _own_load_score(m, itl_slo_ms=20.0)
            seen += "serving/itl_recent_p99_ms" in m
        assert seen and m["serving/load_score"] != _own_load_score(m)


def test_metrics_health_flight_endpoints(served):
    """``/metrics`` is Prometheus text carrying the load score, ``/v1/health``
    carries the reference's five keys, ``/v1/flight`` answers ok false
    (no telemetry session, so no flight recorder), and the KV endpoints
    answer with the reference's codes: the directory lists the served
    prompt's prefixes, an export of it is a handoff that imports back, an
    export of uncached tokens is 404 and an import that does not fit the
    arena is 409."""
    _, _, model, prompts = served
    engine = _engine(model, "paged")
    server = ReplicaServer(engine, name="m").start()
    try:
        _post(f"{server.url}/v1/submit", {"prompt": [int(t) for t in prompts[0]],
                                          "max_new_tokens": 4, "stream": False})
        series = {}
        for line in _get(f"{server.url}/metrics").splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                series[name] = float(value)
        assert series["att_serving_load_score"] == engine.metrics()["serving/load_score"]
        assert series["att_serving_requests_completed"] == 1
        assert "att_scrape_age_seconds" in series
        health = json.loads(_get(f"{server.url}/v1/health"))
        assert set(health) == {"replica", "draining", "load_score", "queue_depth",
                               "free_slots"}
        assert (health["replica"], health["draining"], health["free_slots"]) == ("m", False, 2)
        flight = _post(f"{server.url}/v1/flight", {"reason": "probe"})[0]
        assert flight == {"ok": False, "replica": "m", "reason": "probe"}
        assert not engine.flight_dump("probe")
        directory = json.loads(_get(f"{server.url}/v1/kv/directory"))
        assert (directory["replica"], directory["page_size"]) == ("m", PAGE)
        assert {row["token_len"] for row in directory["prefixes"]} == {4, 8, 12}
        prompt = [int(t) for t in prompts[0]]
        handoff = _post(f"{server.url}/v1/kv/export", {"tokens": prompt})[0]
        assert (handoff["token_len"], handoff["n_pages"]) == (12, 3)
        installed = _post(f"{server.url}/v1/kv/import", handoff)[0]
        assert installed == {"installed_tokens": 12, "replica": "m"}
        for path, body, code in (("/v1/kv/export", {"tokens": [1, 2, 3, 4, 5]}, 404),
                                 ("/v1/kv/import", {}, 409),
                                 ("/v1/kv/import", {"version": 1}, 409),
                                 ("/v1/kv/import", {**handoff, "page_size": 8}, 409)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{server.url}{path}", body)
            assert err.value.code == code
    finally:
        server.close()


# ---------------------------------------------------------------------------
# the CLI, errors, sampling, concurrency
# ---------------------------------------------------------------------------

CLI = [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "replica", "--config",
       "tiny", "--device", "cpu", "--port", "0", "--page-size", "4", "--max-cache-len",
       "64", "--prefill-chunks", "4,8"]


def test_cli_serves_and_drains_on_sigterm():
    """The CLI as a subprocess: its startup line, one streamed request whose
    tokens equal an in-process engine on the same seeded weights, then
    SIGTERM mid-stream: the stream still ends with ``done`` and the
    process exits 0."""
    proc = subprocess.Popen(CLI, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        lines = []
        reader = threading.Thread(target=lambda: lines.append(proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert lines and lines[0], proc.stderr.read() if proc.poll() is not None else ""
        start = json.loads(lines[0])
        assert start["role"] == "replica" and start["port"] > 0
        prompt = [int(t) for t in np.random.RandomState(1).randint(3, 256, (7,))]
        first = _post(f"{start['url']}/v1/submit", {"prompt": prompt, "max_new_tokens": 8})
        cfg = DecoderConfig.tiny(max_seq_len=256)
        model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, seed=0,
                                                                       device="cpu"))
        ref = ServingEngine(model, device="cpu", num_slots=4, max_cache_len=64,
                            prefill_chunks=(4, 8), page_size=4).generate_batched(
            [np.asarray(prompt)], max_new_tokens=8)[0][len(prompt):]
        assert [e["token"] for e in first if e["event"] == "token"] == ref.tolist()
        events, got_first = [], threading.Event()
        client = threading.Thread(target=_stream, daemon=True, args=(
            f"{start['url']}/v1/submit", {"prompt": [5, 6, 7, 8], "max_new_tokens": 60},
            events, got_first))
        client.start()
        assert got_first.wait(HTTP_TIMEOUT)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
        client.join(timeout=HTTP_TIMEOUT)
        assert events[-1]["event"] == "done" and events[-1]["outcome"] == "finished"
        assert len(events[-1]["tokens"]) == 60
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def _args(*argv):
    parser = argparse.ArgumentParser()
    serve_cli.register(parser)
    return parser.parse_args(["replica", *argv])


def test_cli_device_rules(monkeypatch):
    """Without ``--device`` the replica means CUDA and raises without it
    (before any model is built); on CUDA ``tiny`` fails the decode
    kernels' gate with an error that names the config and the gate; the
    KV-tier flags build the tiers (not on the flat arena, and the disk tier
    not without its directory); `--steps-per-call` builds; the router role
    builds a router, but not with the canary prober, a later slice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.build_replica_engine(_args("--config", "small_1b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for page in ("16", "0"):
        with pytest.raises(ValueError, match=r"--config tiny cannot serve on cuda.*gate.*"
                                             r"head_dim 16"):
            serve_cli.build_replica_engine(_args("--config", "tiny", "--page-size", page))
    tiered = serve_cli.build_replica_engine(_args("--device", "cpu", "--kv-host-entries", "4",
                                                  "--kv-peers", "A=http://127.0.0.1:1"))
    assert tiered._tiers.config.host_entries == 4
    assert tiered._tiers.config.peers == (("A", "http://127.0.0.1:1"),)
    with pytest.raises(ValueError, match="paged arena"):
        serve_cli.build_replica_engine(_args("--device", "cpu", "--page-size", "0",
                                             "--kv-host-entries", "4"))
    with pytest.raises(ValueError, match="--kv-disk-dir"):
        serve_cli.build_replica_engine(_args("--device", "cpu", "--kv-disk-entries", "4"))
    # decode bursts are this port's now
    assert serve_cli.build_replica_engine(
        _args("--device", "cpu", "--steps-per-call", "2")).steps_per_call == 2
    parser = argparse.ArgumentParser()
    serve_cli.register(parser)
    router = serve_cli.build_router(parser.parse_args(
        ["router", "--replica", "A=http://127.0.0.1:1", "--poll-interval", "60"]))
    try:
        assert list(router._replicas) == ["A"] and router.config.poll_interval_s == 60
    finally:
        router.close()
    # the canary is ported since: --canary-interval attaches a started prober
    router = serve_cli.build_router(parser.parse_args(
        ["router", "--replica", "A=http://127.0.0.1:1", "--poll-interval", "60",
         "--canary-interval", "60", "--canary-prompt", "4,5", "--canary-seed", "2"]))
    try:
        assert router.canary is not None and router.canary._thread is not None
        assert router.canary.goldens == [{"prompt": [4, 5], "seed": 2, "max_new_tokens": 8}]
    finally:
        router.close()
    assert router.canary._thread is None


def test_loop_exception_is_reraised(served, monkeypatch):
    """The port's rule: an exception in ``step()`` kills the replica (its
    in-flight stream breaks off without ``done``) and
    ``serve_until_drained()`` re-raises it; ``serve replica`` then exits
    non-zero instead of serving from a dead loop."""
    _, _, model, prompts = served
    engine = _engine(model, "paged")
    real_step, broken = engine.step, threading.Event()

    def step():
        if broken.is_set():
            raise RuntimeError("kernel launch failed")
        return real_step()

    engine.step = step
    server = ReplicaServer(engine).start()
    events = []
    client = threading.Thread(target=_stream, daemon=True, args=(
        f"{server.url}/v1/submit", {"prompt": [int(t) for t in prompts[2]],
                                    "max_new_tokens": 50}, events))
    try:
        client.start()
        _wait(lambda: engine._slot_req, "a live request")
        broken.set()
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            server.serve_until_drained(timeout_s=HTTP_TIMEOUT)
        client.join(timeout=HTTP_TIMEOUT)
        assert not client.is_alive()
        assert all(e["event"] == "token" for e in events)
    finally:
        server.close()

    def broken_step(self):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ServingEngine, "step", broken_step)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            serve_cli._serve_replica(_args("--device", "cpu", "--page-size", "4",
                                           "--max-cache-len", "64"))
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_sampled_replica_is_seeded(served):
    """temperature 0.7: each request's generator is made on its handler
    thread from its seed, so one seed streams the same tokens twice and
    the tokens of an in-process engine with that seed."""
    _, _, model, prompts = served
    server = ReplicaServer(_engine(model, "paged", temperature=0.7,
                                  prefix_cache=False)).start()
    body = {"prompt": [int(t) for t in prompts[0]], "max_new_tokens": 8, "stream": False}
    try:
        runs = [_post(f"{server.url}/v1/submit", {**body, "seed": s})[0]["tokens"]
                for s in (3, 3, 4)]
    finally:
        server.close()
    ref = _engine(model, "paged", temperature=0.7)
    want = ref.generate_batched([prompts[0]], max_new_tokens=8, seeds=[3])[0][prompts[0].size:]
    assert runs[0] == runs[1] == want.tolist()
    assert runs[2] != runs[0]


def test_concurrent_submits_get_distinct_ids_and_finish(served):
    """24 client threads submit at once with a shortened switch interval:
    every auto-assigned id is distinct (the id lock), every stream ends
    ``done`` with its budget, and the completed count adds up."""
    _, _, model, _ = served
    engine = _engine(model, "paged", num_slots=4)
    server = ReplicaServer(engine).start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = [[] for _ in range(24)]
    try:
        threads = [threading.Thread(target=_stream, daemon=True, args=(
            f"{server.url}/v1/submit", {"prompt": [3 + i, 4, 5], "max_new_tokens": 3},
            results[i])) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        server.close()
    done = [events[-1] for events in results]
    assert all(d["event"] == "done" and d["outcome"] == "finished" for d in done)
    assert all(len(d["tokens"]) == 3 for d in done)
    assert len({d["request_id"] for d in done}) == 24
    assert engine.metrics()["serving/requests_completed"] == 24


class _BusyEngine:
    """An engine that always has work: each step holds the GIL for 3 ms,
    then waits 1 ms as a device sync does. Enough of the engine's surface
    for ``ReplicaServer``'s loop, drain and ``/v1/kv/directory``."""

    replica = None
    telemetry = None

    def __init__(self):
        self._draining = False
        self.steps = 0

    def step(self):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.003:
            pass
        time.sleep(0.001)
        self.steps += 1
        return True

    def _pending(self):
        return not self._draining

    def request_drain(self):
        self._draining = True

    def _flight_dump(self, reason):
        return None

    def metrics(self):
        return {}

    def kv_directory(self):
        return {"version": 1, "prefixes": [], "steps": self.steps}


def test_kv_endpoint_gets_the_engine_between_busy_steps():
    """A KV endpoint waits at most about one step for the engine lock,
    however busy the loop: the port's rule (module docstring of
    ``replica_server``). On a plain lock the busy loop re-takes it before
    the waiting handler wakes, and a call waited up to 12 s on the CPU,
    past the router's 5 s timeout for a KV handoff. Eight calls each
    answer within 2 s, and the loop steps between them."""
    engine = _BusyEngine()
    server = ReplicaServer(engine).start()
    try:
        _wait(lambda: engine.steps > 10, "the loop's first steps")
        walls, steps = [], []
        for _ in range(8):
            time.sleep(0.05)
            t = time.perf_counter()
            doc = json.loads(_get(f"{server.url}/v1/kv/directory", timeout=30))
            walls.append(time.perf_counter() - t)
            steps.append(doc["steps"])
    finally:
        server.close()
    assert max(walls) < 2.0, walls
    assert all(b > a for a, b in zip(steps, steps[1:])), steps
