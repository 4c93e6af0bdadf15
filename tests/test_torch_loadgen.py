"""The port's load generator, SLO scorecard and ``loadtest`` command
(``accelerate_tpu_torch/serving/loadgen.py``, ``telemetry/scorecard.py``,
``commands/loadtest.py``) on the CPU, held against the reference's
``accelerate_tpu/serving/loadgen.py`` and ``telemetry/scorecard.py``.

- Schedules: every arrival process (poisson, burst, ramp, diurnal over
  each base), closed loop, sessions, multi-tenant mixes and the
  reference's ``tests/workload_canonical.json`` give the reference's
  schedule, request for request, and its ``schedule_digest``; specs
  round-trip through JSON across the two packages.
- Runs: ``loadgen.run`` of the canonical spec against the port's tiny CPU
  engine (weights converted from the reference's) and the reference's
  engine gives equal outcomes, counts and greedy tokens, reconciled
  against each engine's ``serving/requests_terminal``; it also runs
  against a port ``ReplicaServer`` URL, a port ``Router`` and a port
  ``RouterServer`` URL, every request finished.
- Scorecards: ``build_scorecard`` (with and without a telemetry dir),
  ``format_scorecard``, ``sweep_rows`` and ``find_knee`` equal the
  reference's on the same records; the zero-span rates read 0.
- The CLI: ``loadtest run`` / ``replay`` / ``sweep`` against a replica
  URL, and ``run`` on the demo engine with ``--device cpu --config tiny``.

The reference engine runs its Pallas kernels in the interpreter.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import loadgen as ref_loadgen
from accelerate_tpu.serving.engine import ServingEngine as JaxEngine
from accelerate_tpu.telemetry import scorecard as ref_sc
from accelerate_tpu.telemetry import timeline as ref_timeline
from accelerate_tpu_torch.commands import loadtest as loadtest_cli
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving import loadgen as port_loadgen
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.router import Router, RouterConfig, RouterServer
from accelerate_tpu_torch.telemetry import scorecard as port_sc
from accelerate_tpu_torch.telemetry import timeline as port_timeline

HERE = os.path.dirname(os.path.abspath(__file__))
CANONICAL = os.path.join(HERE, "workload_canonical.json")
PS = 8
CACHE = 64
CHUNKS = (8, 32)


def _mix(**kw):
    """A session-heavy two-tenant mix (the reference test's ``_mix_spec``)."""
    kw.setdefault("name", "mix")
    kw.setdefault("seed", 7)
    kw.setdefault("num_requests", 48)
    kw.setdefault("prompt_cap", 40)
    kw.setdefault("tenants", [
        {"name": "chat", "weight": 2.0, "priority": 5, "session_prob": 0.8,
         "prompt_len": {"uniform": [6, 12]}, "max_new_tokens": {"fixed": 4},
         "think_time_s": {"uniform": [0.0, 0.01]}},
        {"name": "batch", "prompt_len": {"uniform": [10, 20]},
         "max_new_tokens": {"fixed": 4}},
    ])
    return kw


SPECS = {
    "poisson": dict(seed=3, arrival={"process": "poisson", "rate_rps": 20.0}),
    "burst": dict(seed=4, arrival={"process": "burst", "rate_rps": 16.0, "burst_size": 4}),
    "ramp": dict(seed=5, arrival={"process": "ramp", "rate_rps": 4.0, "rate_rps_to": 64.0}),
    "diurnal_poisson": dict(seed=6, arrival={"process": "diurnal", "rate_rps": 32.0,
                                             "period_s": 1.5, "amplitude": 0.9}),
    "diurnal_burst": dict(seed=20260807, arrival={
        "process": "diurnal", "base": "burst", "rate_rps": 48.0, "burst_size": 4,
        "period_s": 1.5, "amplitude": 0.9}),
    "diurnal_ramp": dict(seed=8, arrival={"process": "diurnal", "base": "ramp",
                                          "rate_rps": 8.0, "rate_rps_to": 40.0}),
    "closed": dict(seed=9, mode="closed", users=5),
    "sessions": _mix(),
    "sessions_closed": _mix(mode="closed", users=3, seed=12),
    "multi_tenant": dict(seed=13, num_requests=60, prompt_cap=64, tenants=[
        {"name": "a", "weight": 3.0, "priority": 2, "prompt_len": {"choice": [4, 9, 33]},
         "max_new_tokens": {"uniform": [2, 9]}},
        {"name": "b", "weight": 0.5, "session_prob": 0.5, "session_turns": {"fixed": 3},
         "turn_growth": {"choice": [1, 50]}, "think_time_s": {"uniform": [0.0, 0.5]}},
        {"name": "c", "weight": 1.0, "prompt_len": {"fixed": 70},
         "max_new_tokens": 5}]),
}


def _spec(mod, case):
    if case == "canonical":
        return mod.WorkloadSpec.load(CANONICAL)
    return mod.WorkloadSpec(**SPECS[case])


def _rows(schedule):
    return [(s.index, s.at_s, s.user, s.tenant, s.priority, s.session, s.turn, s.think_s,
             s.prompt.tolist(), s.max_new_tokens, s.seed, s.request_id) for s in schedule]


@pytest.mark.parametrize("case", sorted(SPECS) + ["canonical"])
def test_schedule_and_digest_equal_the_reference(case):
    port = port_loadgen.build_schedule(_spec(port_loadgen, case))
    ref = ref_loadgen.build_schedule(_spec(ref_loadgen, case))
    assert _rows(port) == _rows(ref)
    assert port_loadgen.schedule_digest(port) == ref_loadgen.schedule_digest(ref)
    # a pure function of the spec: a second build is byte-identical
    again = port_loadgen.build_schedule(_spec(port_loadgen, case))
    assert port_loadgen.schedule_digest(again) == port_loadgen.schedule_digest(port)
    if case != "canonical":
        other = port_loadgen.WorkloadSpec(**{**SPECS[case], "seed": SPECS[case]["seed"] + 1})
        assert (port_loadgen.schedule_digest(port_loadgen.build_schedule(other))
                != port_loadgen.schedule_digest(port))


@pytest.mark.parametrize("case", ["sessions", "multi_tenant", "canonical"])
def test_spec_json_round_trips_across_packages(case, tmp_path):
    port, ref = _spec(port_loadgen, case), _spec(ref_loadgen, case)
    assert port.to_json() == ref.to_json()
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    back = ref_loadgen.WorkloadSpec.load(str(tmp_path / "port.json"))
    assert ref_loadgen.schedule_digest(ref_loadgen.build_schedule(back)) == \
        port_loadgen.schedule_digest(port_loadgen.build_schedule(port))


def test_sessions_grow_a_shared_prefix_and_bad_specs_raise():
    sched = port_loadgen.build_schedule(port_loadgen.WorkloadSpec(**_mix()))
    by_session = {}
    for s in sched:
        if s.session:
            by_session.setdefault(s.session, []).append(s)
    grown = [turns for turns in by_session.values() if len(turns) > 1]
    assert grown
    for turns in grown:
        turns.sort(key=lambda s: s.turn)
        for a, b in zip(turns, turns[1:]):
            assert b.prompt.size >= a.prompt.size
            assert np.array_equal(b.prompt[:a.prompt.size], a.prompt)
    for mod in (port_loadgen, ref_loadgen):
        bad = mod.WorkloadSpec(arrival={"process": "diurnal", "base": "diurnal"})
        with pytest.raises(ValueError, match="compose"):
            mod.build_schedule(bad)
        with pytest.raises(ValueError, match="mode"):
            mod.WorkloadSpec(mode="sideways")


# ---------------------------------------------------------------------------
# scorecards
# ---------------------------------------------------------------------------

RECORDS = [
    {"index": 0, "request_id": "r0", "tenant": "chat", "outcome": "finished",
     "tokens_out": 10, "ttft_ms": 50.0, "itl_ms": [5.0] * 9},
    {"index": 1, "request_id": "r1", "tenant": "chat", "outcome": "finished",
     "tokens_out": 10, "ttft_ms": 5000.0, "itl_ms": [5.0] * 9},
    {"index": 2, "request_id": "r2", "tenant": "batch", "outcome": "finished",
     "tokens_out": 4, "ttft_ms": 50.0, "itl_ms": [500.0] * 3},
    {"index": 3, "request_id": "r3", "tenant": "batch", "outcome": "shed", "tokens_out": 0},
    {"index": 4, "request_id": "r4", "tenant": "batch", "outcome": None, "tokens_out": 1},
    {"index": 5, "request_id": "r5", "tenant": "chat", "outcome": "cancelled",
     "tokens_out": 2},
    {"index": 6, "request_id": "r6", "tenant": "chat", "outcome": "finished",
     "tokens_out": 1, "ttft_ms": 7.0},
]


def _result(records, wall_s=2.0):
    spec = port_loadgen.WorkloadSpec(**_mix(num_requests=len(records)))
    return {"spec": spec.to_json(), "records": records, "wall_s": wall_s,
            "digest": "d" * 32, "target": "synthetic"}


def _telemetry_dir(d, timeline_mod):
    """Server request records (one torn line) and a timeline with the
    capacity gauges, as a replica's session writes them."""
    with open(os.path.join(d, "requests-host0.jsonl"), "w") as f:
        for i, rid in enumerate(("r0", "r1", "r2", "r6")):
            rec = {"request_id": rid, "prefix_hit": 8 * i}
            if i % 2:
                rec.update(kv_restore_tier="host", kv_restore_ms=1.5 + i)
            f.write(json.dumps(rec) + "\n")
        f.write('{"request_id": "torn"')
    tl = timeline_mod.Timeline()
    tl.add_sample({"serving/capacity_tokens_per_s": 40.0, "serving/headroom_frac": 0.25},
                  now=1000.0)
    tl.flush_jsonl(os.path.join(d, "timeline-host0.jsonl"))


@pytest.mark.parametrize("variant", ["plain", "slo_override", "zero_span", "telemetry_dir"])
def test_scorecard_equals_the_reference(variant, tmp_path):
    kw, wall = {}, 2.0
    if variant == "slo_override":
        kw = dict(ttft_slo_ms=1000.0, itl_slo_ms=100.0, chips=2)
    elif variant == "zero_span":
        wall = 0.0
    elif variant == "telemetry_dir":
        _telemetry_dir(str(tmp_path), port_timeline)
        kw = dict(telemetry_dir=str(tmp_path))
    port = port_sc.build_scorecard(_result(RECORDS, wall), **kw)
    ref = ref_sc.build_scorecard(_result(RECORDS, wall), **kw)
    assert port == ref
    assert port_sc.format_scorecard(port) == ref_sc.format_scorecard(ref)
    assert port["conserved"] and port["counts"]["offered"] == len(RECORDS)
    if variant == "slo_override":
        assert port["fleet"]["slo_attainment_frac"] == pytest.approx(2 / 4)
        assert port["fleet"]["goodput_tokens_per_chip_s"] == pytest.approx(28 / 2 / 2)
    if variant == "zero_span":
        assert port["fleet"]["goodput_tokens_per_s"] == 0.0
        assert port["fleet"]["goodput_tokens_per_chip_s"] == 0.0
    if variant == "telemetry_dir":
        assert port["join"]["joined"] == 4 and port["join"]["kv_restores"] == 2
        assert port["capacity"]["capacity_tokens_per_s"] == 40.0
        # the reference reads the port's timeline file alike
        assert ref_timeline.load_timeline(str(tmp_path)).last(
            "serving/capacity_tokens_per_s") == 40.0


def test_zero_span_rates_read_zero():
    for mod in (port_sc, ref_sc):
        assert [mod.safe_rate(100.0, s) for s in (0.0, 1e-9, None, 2.0)] == \
            [0.0, 0.0, 0.0, 50.0]


def test_fleet_percentiles_merge_histograms_not_averages():
    records = [{"index": i, "request_id": f"f{i}", "tenant": "fast" if i < 50 else "slow",
                "outcome": "finished", "tokens_out": 1,
                "ttft_ms": 10.0 if i < 50 else 200.0} for i in range(100)]
    port = port_sc.build_scorecard(_result(records))
    assert port == ref_sc.build_scorecard(_result(records))
    slow = port["tenants"]["slow"]["ttft_p99_ms"]
    assert port["fleet"]["ttft_p99_ms"] == pytest.approx(slow, rel=0.15)


def test_sweep_rows_and_knee_equal_the_reference():
    def card_at(p99, attain):
        return {"fleet": {"goodput_tokens_per_s": 100.0, "ttft_p99_ms": p99,
                          "slo_attainment_frac": attain},
                "counts": {"finished": 10, "shed": 0}}

    sweeps = [[(4, card_at(10.0, 1.0)), (8, card_at(12.0, 1.0)), (16, card_at(50.0, 0.95)),
               (32, card_at(400.0, 0.4))],
              [(4, card_at(10.0, 1.0)), (8, card_at(11.0, 1.0))],
              [(4, card_at(None, 1.0)), (8, card_at(11.0, 0.5))],
              []]
    knees = []
    for cards in sweeps:
        rows = port_sc.sweep_rows(cards)
        assert rows == ref_sc.sweep_rows(cards)
        for kw in ({}, {"p99_factor": 5.0, "attain_floor": 0.3}):
            knee = port_sc.find_knee(rows, **kw)
            assert knee == ref_sc.find_knee(rows, **kw)
            knees.append(knee)
    assert knees == [2, 3, None, None, 1, None, None, None]


# ---------------------------------------------------------------------------
# runs against engines, replica URLs and routers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(max_seq_len=CACHE, decode_kernel="interpret",
                          prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(max_seq_len=CACHE)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model


def _port_engine(model, **kw):
    eng = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=CACHE,
                        prefill_chunks=CHUNKS, page_size=PS, **kw)
    eng.warmup()
    eng.mark_steady()
    return eng


def _kept(engine):
    """Keep the handle of every request ``engine.submit`` makes, by id."""
    kept, submit = {}, engine.submit

    def wrapped(*args, **kw):
        req = submit(*args, **kw)
        kept[kw.get("request_id")] = req
        return req

    engine.submit = wrapped
    return kept


def test_run_against_both_engines_gives_equal_outcomes_and_tokens(models):
    """The canonical closed-loop spec replayed on the port's engine and the
    reference's: the same offered records but timings, the same tokens a
    request, counts that conserve and reconcile with each engine's
    ``serving/requests_terminal``."""
    jmodel, params, model = models
    sides = []
    for mod, sc, engine in (
            (port_loadgen, port_sc, _port_engine(model)),
            (ref_loadgen, ref_sc, JaxEngine(jmodel, params, num_slots=2, max_cache_len=CACHE,
                                            prefill_chunks=CHUNKS, page_size=PS))):
        kept = _kept(engine)
        spec = mod.WorkloadSpec.load(CANONICAL)
        result = mod.run(spec, engine, time_scale=0.0, timeout_s=240)
        card = sc.build_scorecard(result)
        assert card["conserved"] and card["counts"]["in_flight"] == 0
        counts = card["counts"]
        assert counts["finished"] + counts["shed"] + counts["cancelled"] == \
            engine.metrics()["serving/requests_terminal"]
        timing = ("submit_t_s", "ttft_ms", "e2e_ms", "itl_ms")
        records = [{k: v for k, v in r.items() if k not in timing} for r in result.records]
        tokens = {rid: [int(t) for t in req.tokens] for rid, req in kept.items()}
        sides.append((result.digest, records, counts, tokens))
    assert sides[0] == sides[1]
    digest, records, counts, tokens = sides[0]
    assert counts["offered"] == counts["finished"] == 24
    assert all(len(t) == r["tokens_out"] for r in records for t in [tokens[r["request_id"]]])


def test_submit_burst_and_paired_drill_equal_the_reference(models):
    """``paired_drill`` gives the spec at the drill's seed and an injector
    seeded alike; ``submit_burst`` puts the whole schedule into an engine
    at once: the same ids, outcomes and greedy tokens as the reference's
    on its engine."""
    jmodel, params, model = models
    spec = port_loadgen.WorkloadSpec(**_mix(num_requests=6))
    drill, injector = port_loadgen.paired_drill(21, spec)
    import random

    from accelerate_tpu_torch.serving import FaultInjector

    assert drill.seed == 21 and isinstance(injector, FaultInjector)
    assert injector.rng.random() == random.Random(21).random()
    ref_drill, _ = ref_loadgen.paired_drill(21, ref_loadgen.WorkloadSpec(**_mix(num_requests=6)))
    sides = []
    for mod, engine, sp in ((port_loadgen, _port_engine(model), drill),
                            (ref_loadgen, JaxEngine(jmodel, params, num_slots=2,
                                                    max_cache_len=CACHE, prefill_chunks=CHUNKS,
                                                    page_size=PS), ref_drill)):
        reqs = mod.submit_burst(engine, sp)
        engine.run()
        sides.append([(r.id, r.outcome, [int(t) for t in r.tokens]) for r in reqs])
    assert sides[0] == sides[1]
    assert [rid for rid, _, _ in sides[0]] == [
        s.request_id for s in port_loadgen.build_schedule(drill)]


def test_run_against_a_replica_url_a_router_and_a_router_url(models):
    """The same spec through a port ReplicaServer's URL, a port Router
    over two replicas and that router's RouterServer: every request
    finished, the digest the in-process run's, and the replicas' terminal
    counters the client's ledger."""
    _, _, model = models
    spec = dataclasses.replace(port_loadgen.WorkloadSpec.load(CANONICAL), num_requests=12,
                               seed=11)
    want = port_loadgen.schedule_digest(port_loadgen.build_schedule(spec))
    a = ReplicaServer(_port_engine(model, replica="A"), name="A").start()
    b = ReplicaServer(_port_engine(model, replica="B"), name="B").start()
    router = Router({"A": a.url, "B": b.url},
                    config=RouterConfig(backoff_base_s=0.01, backoff_cap_s=0.05,
                                        poll_interval_s=0.1, migrate_session_kv=False))
    router.collector.poll_once()
    front = RouterServer(router)
    try:
        served = 0
        for target, kind in ((a.url, "url"), (router, "router"),
                             (f"http://127.0.0.1:{front.port}", "url")):
            result = port_loadgen.run(spec, target, time_scale=0.0, timeout_s=120)
            counts = result.counts()
            assert result.target == kind and result.digest == want
            assert counts["finished"] == counts["offered"] == 12, counts
            assert {r["replica"] for r in result.records} <= {"A", "B"}
            assert all("ttft_ms" in r for r in result.records)
            served += counts["finished"]
        terminal = sum(s.engine.metrics()["serving/requests_terminal"] for s in (a, b))
        assert terminal == served
    finally:
        front.close()
        router.close()
        a.close()
        b.close()


def test_loadtest_cli_run_replay_sweep_and_demo(models, tmp_path, capsys):
    """``loadtest run --url --json --out`` writes both artifacts,
    ``replay`` finds the schedule IDENTICAL (exit 0) and a reseeded replay
    DIVERGED, ``sweep`` prints its table, and ``run`` without ``--url``
    serves the demo engine on the CPU."""
    _, _, model = models
    server = ReplicaServer(_port_engine(model, replica="A"), name="A").start()
    try:
        out_a = str(tmp_path / "a")
        assert loadtest_cli.main(["run", CANONICAL, "--url", server.url, "--out", out_a,
                                  "--json", "--time-scale", "0"]) == 0
        card = json.loads(capsys.readouterr().out)
        assert card["conserved"] and card["counts"]["finished"] == 24
        assert card["target"] == "url"
        for name in ("loadtest-offered.json", "loadtest-scorecard.json"):
            assert os.path.exists(os.path.join(out_a, name))
        assert port_sc.load_scorecard(out_a) == card
        assert loadtest_cli.main(["replay", out_a, "--url", server.url,
                                  "--time-scale", "0"]) == 0
        assert "IDENTICAL" in capsys.readouterr().out
        assert loadtest_cli.main(["replay", out_a, "--url", server.url, "--seed", "5",
                                  "--json", "--time-scale", "0"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["replay"]["schedule_identical"] is False
        sweep_spec = tmp_path / "sweep.json"
        port_loadgen.WorkloadSpec(**_mix(num_requests=6, mode="open")).save(str(sweep_spec))
        assert loadtest_cli.main(["sweep", str(sweep_spec), "--url", server.url,
                                  "--rates", "50,100", "--json", "--time-scale", "0.01"]) == 0
        sweep = json.loads(capsys.readouterr().out)
        assert [r["rate_rps"] for r in sweep["rows"]] == [50.0, 100.0]
        assert all(r["finished"] == 6 for r in sweep["rows"])
    finally:
        server.close()
    assert loadtest_cli.main(["run", str(sweep_spec), "--device", "cpu", "--config", "tiny",
                              "--time-scale", "0"]) == 0
    text = capsys.readouterr().out
    assert "== loadtest ==" in text and "finished 6" in text and "schedule digest" in text
