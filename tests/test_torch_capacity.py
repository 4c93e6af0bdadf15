"""The port's capacity model, forecaster and recommender
(``accelerate_tpu_torch/telemetry/capacity.py``) and the engine's capacity
gauges on the CPU, held against the reference's
``accelerate_tpu/telemetry/capacity.py``.

- ``CapacityModel`` (roofline, the registry fallback, the bandwidth
  ceiling, the busy-window EWMA witness, headroom), ``fleet_capacity``
  over merged gauges and ``extract_signals`` over timelines give the
  reference's answers on the reference test's cases and on numpy-seeded
  gauge and timeline sequences, exactly.
- ``Recommender`` walks the reference's decisions (records included)
  over the reference test's hysteresis cases and seeded sequences of
  signals, firing sets, fleet sizes and times under one fake clock.
- The port's engine exports ``serving/capacity_tokens_per_s`` and
  ``serving/headroom_frac`` once it has decoded, as the reference's
  does, with the capacity at least the achieved rate; the replica's
  ``/metrics`` carries them and the fleet merge sums capacity and
  averages headroom.
"""

import json
import urllib.request

import numpy as np
import pytest

from accelerate_tpu.telemetry import capacity as ref_cap
from accelerate_tpu.telemetry import fleet as ref_fleet
from accelerate_tpu.telemetry import timeline as ref_timeline
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import random_params
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import ReplicaServer
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.telemetry import capacity as port_cap
from accelerate_tpu_torch.telemetry import fleet as port_fleet
from accelerate_tpu_torch.telemetry import timeline as port_timeline

CAP, HEAD = port_cap.CAPACITY_KEY, port_cap.HEADROOM_KEY
SIDES = ((port_cap, port_fleet, port_timeline), (ref_cap, ref_fleet, ref_timeline))


def both(scenario):
    """``scenario(capacity, fleet, timeline)`` on the port's modules and the
    reference's: equal answers."""
    got, want = (scenario(*side) for side in SIDES)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the capacity model
# ---------------------------------------------------------------------------

GAUGE_CASES = {
    "step_gauge": [{"serving/num_slots": 4, "serving/decode_step_ms_p50": 8.0}],
    "registry_fallback": [{"serving/num_slots": 4, "exe/decode_step_wall_s": 2.0,
                           "exe/decode_step_calls": 500}],
    "unmeasured": [{}, {"serving/num_slots": 4}],
    "bandwidth_ceiling": [{"serving/num_slots": 8, "serving/decode_step_ms_p50": 1.0,
                           "serving/tokens_per_s": 900.0,
                           "exe/decode_step_bw_util_pct": 90.0}],
    "achieved_floor": [{"serving/num_slots": 2, "serving/decode_step_ms_p50": 10.0,
                        "serving/tokens_per_s": 500.0, "serving/slot_occupancy": 1.0}],
    "headroom": [{"serving/num_slots": 4, "serving/decode_step_ms_p50": 8.0,
                  "serving/tokens_per_s": 106.25, "serving/slot_occupancy": 0.3}],
    "ewma_witness": [{"serving/tokens_per_s": 990.0, "serving/slot_occupancy": 0.2},
                     {"serving/tokens_per_s": 400.0, "serving/slot_occupancy": 0.9},
                     {"serving/tokens_per_s": 10.0, "serving/slot_occupancy": 0.1}],
}


def _seeded_gauges(seed: int, n: int = 60) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        g = {"serving/num_slots": int(rng.choice([2, 4, 8]))}
        if rng.rand() < 0.8:
            g["serving/decode_step_ms_p50"] = float(rng.uniform(0.5, 20.0))
        if rng.rand() < 0.7:
            g["serving/tokens_per_s"] = float(rng.uniform(0.0, 3000.0))
        g["serving/slot_occupancy"] = float(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0]))
        if rng.rand() < 0.2:
            g["exe/decode_step_bw_util_pct"] = float(rng.uniform(1.0, 120.0))
        if rng.rand() < 0.2:
            g["exe/decode_step_wall_s"] = float(rng.uniform(0.1, 3.0))
            g["exe/decode_step_calls"] = int(rng.randint(1, 900))
        out.append(g)
    return out


@pytest.mark.parametrize("case", sorted(GAUGE_CASES) + ["seed0", "seed1", "seed2"])
def test_capacity_model_equals_the_reference(case):
    seq = (GAUGE_CASES[case] if case in GAUGE_CASES
           else _seeded_gauges(int(case[-1])))

    def scenario(cap, fleet, timeline):
        kw = {"busy_occupancy": 0.6, "blend": 0.5} if case.startswith("seed") else {}
        model = cap.CapacityModel(**kw)
        return [(model.roofline_tokens_per_s(dict(g)), model.observe(dict(g)),
                 model._achieved_ewma) for g in seq]

    out = both(scenario)
    if case == "step_gauge":
        assert out[0][0] == pytest.approx(0.85 * 4 * 1e3 / 8.0)
    if case == "unmeasured":
        assert out[-1][1] == {}
    if case == "achieved_floor":
        assert out[0][1] == {CAP: 500.0, HEAD: 0.0}
    if case == "ewma_witness":
        assert out[-1][1][CAP] == pytest.approx(400.0)


def test_fleet_capacity_over_merged_gauges_equals_the_reference():
    snaps = [
        [({CAP: 100.0, HEAD: 0.5, "serving/tokens_per_s": 40.0}, True),
         ({CAP: 50.0, HEAD: 0.1, "serving/tokens_per_s": 20.0}, True)],
        [({CAP: 100.0}, True), ({CAP: 100.0}, False)],
        [({"serving/tokens_per_s": 10.0}, True)],
        [({CAP: 10.0, "serving/tokens_per_s": 40.0}, True)],
    ]

    def scenario(cap, fleet, timeline):
        merged = [fleet.merge_gauges(s) for s in snaps]
        return merged, [cap.fleet_capacity(m) for m in merged], cap.fleet_capacity({})

    merged, caps, empty = both(scenario)
    assert merged[0][CAP] == pytest.approx(150.0) and merged[0][HEAD] == pytest.approx(0.3)
    assert merged[1][CAP] == 100.0 and caps[2] is None and empty is None
    assert caps[3]["utilization_frac"] == 1.0
    assert port_fleet.merge_policy(CAP) == port_fleet.SUM_LIVE
    assert port_fleet.merge_policy(HEAD) == port_fleet.MEAN


# ---------------------------------------------------------------------------
# the forecaster
# ---------------------------------------------------------------------------


def _steady(timeline):
    tl = timeline.Timeline(tiers=((0.5, 512),))
    for i in range(21):
        tl.add_sample({"serving/queue_depth": 2.0 * i, "serving/requests_terminal": 10.0 * i,
                       "serving/tokens_per_s": 100.0, CAP: 400.0, HEAD: 0.75},
                      now=1000.0 + i)
    return tl


def _surge(timeline):
    tl = timeline.Timeline(tiers=((0.5, 512),))
    total = 0.0
    for i in range(21):
        total += 2.0 if i <= 10 else 12.0
        tl.add_sample({"serving/requests_terminal": total, "serving/tokens_per_s": 100.0,
                       "serving/queue_depth": 0.0}, now=1000.0 + i)
    return tl


def _seeded_timeline(timeline, seed=0):
    rng = np.random.RandomState(seed)
    tl = timeline.Timeline()
    terminal = 0.0
    for i in range(120):
        terminal += float(rng.poisson(4))
        sample = {"serving/requests_terminal": terminal,
                  "serving/queue_depth": float(rng.randint(0, 9)),
                  "serving/tokens_per_s": float(rng.uniform(50, 900))}
        if i % 7:
            sample[CAP] = float(rng.uniform(800, 1200))
            sample[HEAD] = float(rng.uniform(0, 1))
        tl.add_sample(sample, now=5000.0 + 0.5 * i + float(rng.uniform(0, 0.2)))
    return tl


SIGNAL_CASES = {
    "steady": (_steady, dict(now=1020.0, fast_s=10.0, slow_s=20.0, horizon_s=5.0)),
    "surge": (_surge, dict(now=1020.0, fast_s=8.0, slow_s=20.0, horizon_s=6.0)),
    "burn": (_steady, dict(now=1020.0, alert_states={
        "itl_burn_rate": {"state": "firing", "value": 50.0, "since": 1017.0,
                          "fired_count": 1},
        "shed_burn_rate": {"state": "ok", "value": 0.0}})),
    "empty": (lambda timeline: timeline.Timeline(), dict(now=1000.0)),
    "seeded_short": (_seeded_timeline, dict(now=5060.0, fast_s=5.0, slow_s=30.0,
                                            horizon_s=10.0)),
    "seeded_default": (_seeded_timeline, dict(now=5061.3)),
}


@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_extract_signals_equals_the_reference(case):
    build, kw = SIGNAL_CASES[case]
    sig = both(lambda cap, fleet, timeline: cap.extract_signals(build(timeline), **kw))
    if case == "steady":
        assert sig["projected_tokens_per_s"] == pytest.approx(120.0)
    if case == "surge":
        assert sig["arrival_slope_rps_per_s"] > 0
        assert sig["projected_tokens_per_s"] > sig["tokens_per_s"]
    if case == "burn":
        assert sig["burn"]["itl_burn_rate"] == {"state": "firing", "value": 50.0}
    if case == "empty":
        assert sig["queue_depth"] is None and sig["headroom_frac"] is None


# ---------------------------------------------------------------------------
# the recommender
# ---------------------------------------------------------------------------


def _sig(headroom=0.05, capacity=400.0, projected=350.0):
    return {"headroom_frac": headroom, "capacity_tokens_per_s": capacity,
            "projected_tokens_per_s": projected}


BURN = ["itl_burn_rate"]
DECISION_CASES = {
    "confirmations": (dict(confirm_evals=3, cooldown_s=0.0),
                      [(_sig(), BURN, 1, 100.0), (_sig(), BURN, 1, 101.0),
                       (_sig(), BURN, 1, 102.0)]),
    "noisy_reset": (dict(confirm_evals=2, cooldown_s=0.0),
                    [(_sig(), BURN, 1, 0.0), (_sig(), [], 1, 1.0), (_sig(), BURN, 1, 2.0)]),
    "cooldown": (dict(confirm_evals=2, cooldown_s=10.0),
                 [(_sig(), BURN, 1, 0.0), (_sig(), BURN, 1, 1.0), (_sig(), BURN, 2, 2.0),
                  (_sig(), BURN, 2, 6.0), (_sig(), BURN, 2, 9.9), (_sig(), BURN, 2, 11.1)]),
    "max_clamp": (dict(confirm_evals=1, cooldown_s=0.0, max_replicas=2),
                  [(_sig(), BURN, 2, 0.0)]),
    "below_min": (dict(min_replicas=2, confirm_evals=5, cooldown_s=0.0),
                  [(_sig(headroom=1.0), [], 1, 0.0)]),
    "overload_veto": (dict(confirm_evals=1, cooldown_s=0.0, scale_in_margin=1.25),
                      [(_sig(0.9, 400.0, 180.0), [], 2, 0.0),
                       (_sig(0.9, 400.0, 100.0), [], 2, 1.0)]),
    "min_floor": (dict(confirm_evals=1, cooldown_s=0.0),
                  [(_sig(headroom=0.95, projected=1.0), [], 1, 0.0)]),
    "burn_with_headroom": (dict(confirm_evals=1, cooldown_s=0.0, headroom_floor=0.15),
                           [(_sig(headroom=0.6), BURN, 1, 0.0)]),
    "shed_burn": (dict(confirm_evals=1, cooldown_s=0.0),
                  [(_sig(), ["shed_burn_rate", "page_arena_watermark"], 1, 123.456)]),
}


def _seeded_decisions(seed: int, n: int = 80) -> list:
    rng = np.random.RandomState(seed)
    steps, t = [], 1000.0
    for _ in range(n):
        t += float(rng.uniform(0.1, 8.0))
        sig = _sig(headroom=None if rng.rand() < 0.1 else float(rng.uniform(0, 1)),
                   capacity=None if rng.rand() < 0.1 else float(rng.uniform(100, 900)),
                   projected=None if rng.rand() < 0.1 else float(rng.uniform(0, 900)))
        firing = [r for r in ("itl_burn_rate", "shed_burn_rate", "canary_failing")
                  if rng.rand() < 0.3]
        steps.append((sig, firing, int(rng.randint(0, 6)), t))
    return steps


@pytest.mark.parametrize("case", sorted(DECISION_CASES) + ["seed3", "seed4"])
def test_recommender_decides_as_the_reference(case):
    if case in DECISION_CASES:
        policy_kw, steps = DECISION_CASES[case]
    else:
        policy_kw = dict(min_replicas=1, max_replicas=4, confirm_evals=2, cooldown_s=6.0,
                         scale_in_headroom=0.4, headroom_floor=0.3)
        steps = _seeded_decisions(int(case[-1]))
    clock = [0.0]

    def scenario(cap, fleet, timeline):
        rec = cap.Recommender(cap.AutoscalePolicy(**policy_kw), clock=lambda: clock[0])
        out = []
        for sig, firing, replicas, now in steps:
            d = rec.decide(signals=dict(sig), firing=list(firing), replicas=replicas, now=now)
            out.append((d.to_record(), rec.last_action_t))
        return out

    out = both(scenario)
    actions = [(r["action"], r["reason"]) for r, _ in out]
    if case == "confirmations":
        assert actions[-1] == ("scale_out", "burn_firing_and_headroom_below_floor")
    if case == "cooldown":
        assert [a for a, _ in actions] == ["hold", "scale_out", "hold", "hold", "hold",
                                           "scale_out"]
    if case == "overload_veto":
        assert actions == [("hold", "scale_in_would_overload"),
                           ("scale_in", "sustained_surplus_headroom")]
        assert out[0][0]["signals"]["capacity_n_minus_1_tokens_per_s"] == 200.0
    if case.startswith("seed"):
        assert {a for a, _ in actions} >= {"hold", "scale_out"}


# ---------------------------------------------------------------------------
# the engine's capacity gauges
# ---------------------------------------------------------------------------


def test_capacity_gauges_ride_the_engine_rollup_and_the_scrape():
    """No capacity before a decode step; after one, the model's gauges over
    the engine's own, capacity at least the achieved rate (the reference's
    test), on ``/metrics`` and summed by the fleet merge."""
    cfg = DecoderConfig.tiny(max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    engine = ServingEngine(model, device="cpu", num_slots=2, max_cache_len=64,
                           prefill_chunks=(4, 8), page_size=4)
    engine.warmup()
    assert CAP not in engine.metrics()
    r = engine.submit(np.arange(3, 11, dtype=np.int32), max_new_tokens=6, seed=0)
    while not r.done:
        engine.step()
    out = engine.metrics()
    assert out[CAP] > 0.0 and 0.0 <= out[HEAD] <= 1.0
    assert out[CAP] >= out["serving/tokens_per_s"] * 0.999
    # the model over the engine's gauges is the reference's model
    fresh = ref_cap.CapacityModel()
    inputs = {k: v for k, v in out.items() if k not in (CAP, HEAD)}
    want = fresh.observe(inputs)
    assert want[CAP] == pytest.approx(out[CAP], rel=1e-6, abs=1e-3)
    server = ReplicaServer(engine, name="cap").start()
    try:
        with urllib.request.urlopen(f"{server.url}/metrics", timeout=60) as resp:
            snap = port_fleet.parse_exposition(resp.read().decode())
        gauges = {port_fleet.unflatten_key(k): v for k, v in snap.gauges.items()}
        assert CAP in gauges and HEAD in gauges
        merged = port_fleet.merge_gauges([(gauges, True), (gauges, True)])
        assert merged[CAP] == pytest.approx(2 * gauges[CAP])
        assert merged[HEAD] == pytest.approx(gauges[HEAD])
        with urllib.request.urlopen(f"{server.url}/v1/health", timeout=60) as resp:
            assert json.loads(resp.read())["free_slots"] == 2
    finally:
        server.close()
