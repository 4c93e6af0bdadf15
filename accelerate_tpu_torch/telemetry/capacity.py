"""Serving capacity model + headroom forecaster (the autoscaler's eyes).

An own copy of the reference's ``accelerate_tpu/telemetry/capacity.py``.
The port's engine has no roofline registry yet (ROADMAP queue 1 item 11),
so its capacity gauges come from the measured step wall and the achieved
rate alone; the ``exe/decode_step_*`` fallback stays for gauges that
carry it.

The burn-rate alerts (``telemetry/alerts.py``) say the SLO is being
spent; they do not say whether the fix is *more replicas* or a bug. The
missing input is capacity: how many tokens/s can this replica sustain,
and how close to that is it running? This module estimates it online,
per replica, from signals every engine already exports:

- **roofline estimate** — the fused decode step serves at most
  ``num_slots`` tokens per step, so the measured step wall
  (``serving/decode_step_ms_p50``, or the roofline registry's
  ``exe/decode_step_wall_s``/``_calls`` attribution) bounds the
  sustainable rate at ``num_slots / step_wall``. When the registry also
  reports achieved HBM bandwidth against the device peak
  (``exe/decode_step_bw_util_pct``), the estimate is clamped by the
  memory-bound ceiling — a step already at 90% of peak bandwidth
  cannot be driven ~faster by admitting more work.
- **achieved witness** — whenever the engine is actually busy
  (slot occupancy at/above ``busy_occupancy``), the measured
  ``serving/tokens_per_s`` IS a sustainable rate by demonstration; an
  EWMA of those busy windows floors the estimate so a conservative
  roofline can never talk the fleet into scaling out of a rate it is
  visibly serving.

The blend exports two gauges with deliberate merge semantics
(``telemetry/fleet.py``): ``serving/capacity_tokens_per_s`` has no
mean/max suffix so the fleet view SUMS it over live replicas (fleet
capacity is additive), while ``serving/headroom_frac`` ends in ``_frac``
so it AVERAGES (fleet headroom is a utilization, not a sum).

On top of the gauges sit the forecaster (:func:`extract_signals` —
short-horizon trends out of the existing Timeline rings) and the
hysteresis'd :class:`Recommender` the autoscaler daemon
(``serving/autoscaler.py``) actuates. Decision *logic* lives here —
pure, clocked from the caller, unit-testable without processes; the
daemon owns subprocesses and sockets.

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the autoscaler runs on the router box, which has no accelerator
stack.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

CAPACITY_KEY = "serving/capacity_tokens_per_s"
HEADROOM_KEY = "serving/headroom_frac"


class CapacityModel:
    """Online per-replica sustainable-rate estimator over the engine's
    own gauge dict (``engine.metrics()`` feeds each flush through
    :meth:`observe`; the returned gauges join the same rollup)."""

    def __init__(self, *, safety_frac: float = 0.85,
                 busy_occupancy: float = 0.75, blend: float = 0.25,
                 exe_name: str = "decode_step"):
        self.safety_frac = float(safety_frac)
        self.busy_occupancy = float(busy_occupancy)
        self.blend = float(blend)
        self.exe_name = exe_name
        self._achieved_ewma: Optional[float] = None

    def roofline_tokens_per_s(self, gauges: dict) -> Optional[float]:
        """Step-wall bound on the sustainable rate (None until the
        engine has measured a decode step)."""
        slots = gauges.get("serving/num_slots")
        step_ms = gauges.get("serving/decode_step_ms_p50")
        if not step_ms:
            # fall back to the roofline registry's attributed wall
            wall = gauges.get(f"exe/{self.exe_name}_wall_s")
            calls = gauges.get(f"exe/{self.exe_name}_calls")
            if wall and calls:
                step_ms = 1e3 * float(wall) / float(calls)
        if not slots or not step_ms or step_ms <= 0:
            return None
        est = self.safety_frac * float(slots) * 1e3 / float(step_ms)
        # memory-bound ceiling: achieved bytes/s already near peak means
        # the step wall cannot shrink by ~more than the remaining
        # bandwidth headroom, whatever the occupancy
        bw_util = gauges.get(f"exe/{self.exe_name}_bw_util_pct")
        achieved = gauges.get("serving/tokens_per_s")
        if bw_util and bw_util > 0 and achieved:
            ceiling = float(achieved) * 100.0 / min(float(bw_util), 100.0)
            est = min(est, max(ceiling, float(achieved)))
        return est

    def observe(self, gauges: dict) -> dict:
        """Fold one gauge snapshot in; return the capacity gauges (empty
        until any estimate exists — an engine that has never decoded has
        no claimable capacity)."""
        achieved = gauges.get("serving/tokens_per_s")
        occupancy = gauges.get("serving/slot_occupancy") or 0.0
        if achieved and occupancy >= self.busy_occupancy:
            if self._achieved_ewma is None:
                self._achieved_ewma = float(achieved)
            else:
                self._achieved_ewma += self.blend * (
                    float(achieved) - self._achieved_ewma
                )
        candidates = [c for c in (
            self.roofline_tokens_per_s(gauges), self._achieved_ewma,
        ) if c]
        if not candidates:
            return {}
        capacity = max(candidates)
        if achieved:
            # a rate the engine is serving right now is sustainable by
            # demonstration, busy or not
            capacity = max(capacity, float(achieved))
        headroom = 1.0
        if achieved and capacity > 0:
            headroom = max(0.0, min(1.0, 1.0 - float(achieved) / capacity))
        return {
            CAPACITY_KEY: round(capacity, 3),
            HEADROOM_KEY: round(headroom, 4),
        }


def fleet_capacity(gauges: dict) -> Optional[dict]:
    """Offered-vs-capacity from fleet-MERGED gauges
    (``FleetCollector.fleet_gauges()``): capacity/offered arrive summed
    over live replicas, headroom arrives averaged. None until any
    replica exports a capacity estimate — callers render nothing rather
    than a made-up ceiling."""
    capacity = gauges.get(CAPACITY_KEY)
    if not capacity:
        return None
    offered = float(gauges.get("serving/tokens_per_s") or 0.0)
    return {
        "capacity_tokens_per_s": round(float(capacity), 3),
        "offered_tokens_per_s": round(offered, 3),
        "utilization_frac": round(
            min(1.0, offered / float(capacity)), 4
        ) if capacity else None,
        "headroom_frac": gauges.get(HEADROOM_KEY),
    }


# -- forecaster -------------------------------------------------------------


def _rate(window: Optional[dict]) -> Optional[float]:
    return None if window is None else window.get("rate")


def extract_signals(timeline, *, now: Optional[float] = None,
                    fast_s: float = 60.0, slow_s: float = 600.0,
                    horizon_s: float = 60.0,
                    alert_states: Optional[dict] = None) -> dict:
    """Short-horizon trend snapshot out of the fleet Timeline rings —
    the full evidence a scaling decision is logged with.

    - queue pressure: current ``serving/queue_depth`` + its derivative
      over the fast window (a growing queue is demand the fleet is NOT
      serving — invisible to ``tokens_per_s``);
    - arrival trend: the ``serving/requests_terminal`` counter rate over
      fast vs slow windows, extrapolated ``horizon_s`` ahead (the
      diurnal ramp shows up here before the burn alert fires);
    - load vs capacity: offered ``serving/tokens_per_s`` against the
      merged capacity/headroom gauges, with the projected offered rate
      scaled by the arrival trend and queue growth;
    - burn trajectory: the alert manager's per-rule state/value snapshot
      when the caller passes ``alert_states``.
    """
    sig: dict = {
        "fast_s": fast_s, "slow_s": slow_s, "horizon_s": horizon_s,
    }
    qw = timeline.window("serving/queue_depth", fast_s, now=now)
    sig["queue_depth"] = qw["last"] if qw else None
    sig["queue_slope_per_s"] = _rate(qw)
    fast = timeline.window("serving/requests_terminal", fast_s, now=now)
    slow = timeline.window("serving/requests_terminal", slow_s, now=now)
    rate_fast, rate_slow = _rate(fast), _rate(slow)
    sig["arrival_rate_fast_rps"] = rate_fast
    sig["arrival_rate_slow_rps"] = rate_slow
    slope = None
    if rate_fast is not None and rate_slow is not None:
        # fast window centered ~fast_s/2 ago, slow ~slow_s/2 ago: the
        # rate difference over the center gap is the arrival slope
        gap_s = max(1.0, (slow_s - fast_s) / 2.0)
        slope = (rate_fast - rate_slow) / gap_s
    sig["arrival_slope_rps_per_s"] = slope
    tok = timeline.window("serving/tokens_per_s", fast_s, now=now)
    offered = tok["mean"] if tok else None
    sig["tokens_per_s"] = offered
    capacity = timeline.last(CAPACITY_KEY)
    sig["capacity_tokens_per_s"] = capacity
    sig["headroom_frac"] = timeline.last(HEADROOM_KEY)
    projected = offered
    if offered:
        growth = 1.0
        if slope is not None and rate_fast:
            growth = max(0.0, 1.0 + (slope * horizon_s) / rate_fast)
        projected = offered * growth
        if rate_fast and (sig["queue_slope_per_s"] or 0) > 0:
            # queued demand converted to tokens/s at the observed
            # tokens-per-request exchange rate
            projected += (
                sig["queue_slope_per_s"] * offered / rate_fast
            )
    sig["projected_tokens_per_s"] = (
        round(projected, 3) if projected is not None else None
    )
    if alert_states:
        sig["burn"] = {
            name: {"state": st.get("state"), "value": st.get("value")}
            for name, st in sorted(alert_states.items())
        }
    return sig


# -- recommender ------------------------------------------------------------


@dataclass
class AutoscalePolicy:
    """The tuning surface: the scale-out and scale-in gates, the
    hysteresis and the forecaster's windows."""

    min_replicas: int = 1
    max_replicas: int = 4
    # scale-out gate: burn firing AND fleet headroom below this
    headroom_floor: float = 0.15
    # scale-in gate: headroom above this AND no burn firing
    scale_in_headroom: float = 0.5
    # N-1 capacity must clear projected load with this margin
    scale_in_margin: float = 1.25
    cooldown_s: float = 30.0
    # consecutive eligible evaluations before acting (flap suppression)
    confirm_evals: int = 2
    horizon_s: float = 60.0
    fast_s: float = 60.0
    slow_s: float = 600.0
    burn_rules: tuple = ("itl_burn_rate", "shed_burn_rate")


@dataclass
class Decision:
    """One evaluated decision — every field lands in
    ``autoscale-decisions.jsonl`` (the placement-decision-log
    discipline, applied to scaling)."""

    action: str                 # scale_out | scale_in | hold
    reason: str
    replicas: int
    target_replicas: int
    signals: dict
    firing: list
    t_unix_s: float
    stages: dict = field(default_factory=dict)    # actuation waterfall
    reaction_s: Optional[float] = None

    def to_record(self) -> dict:
        rec = {
            "t_unix_s": round(self.t_unix_s, 3),
            "action": self.action,
            "reason": self.reason,
            "replicas": self.replicas,
            "target_replicas": self.target_replicas,
            "firing": list(self.firing),
            "signals": self.signals,
        }
        if self.stages:
            rec["stages"] = self.stages
        if self.reaction_s is not None:
            rec["autoscale_reaction_s"] = round(self.reaction_s, 3)
        return rec


class Recommender:
    """Hysteresis'd scale decision over a signal snapshot. Pure and
    caller-clocked: the daemon (and the unit tests) drive
    :meth:`decide` with whatever clock they own.

    The hysteresis is three-layered — **confirmation streaks** (an
    eligible condition must hold ``confirm_evals`` consecutive
    evaluations before it acts: one noisy poll cannot flap the fleet),
    **cooldown** (after any action the loop holds ``cooldown_s`` so the
    new membership's signals settle before the next verdict), and the
    **scale-in overload veto** (shrinking is refused unless the N−1
    fleet would still clear the *projected* load with margin — scaling
    in must never be what causes the next scale-out).
    """

    def __init__(self, policy: Optional[AutoscalePolicy] = None, *,
                 clock=time.time):
        self.policy = policy or AutoscalePolicy()
        self._clock = clock
        self._out_streak = 0
        self._in_streak = 0
        self.last_action_t: Optional[float] = None

    def _hold(self, reason: str, replicas: int, signals: dict,
              firing: list, now: float) -> Decision:
        return Decision(
            action="hold", reason=reason, replicas=replicas,
            target_replicas=replicas, signals=signals,
            firing=firing, t_unix_s=now,
        )

    def decide(self, *, signals: dict, firing, replicas: int,
               now: Optional[float] = None) -> Decision:
        """One evaluation: ``signals`` from :func:`extract_signals`,
        ``firing`` the alert manager's currently-firing rule names,
        ``replicas`` the live placeable count."""
        now = self._clock() if now is None else float(now)
        pol = self.policy
        firing = sorted(firing or [])
        burn_firing = any(r in firing for r in pol.burn_rules)
        headroom = signals.get("headroom_frac")
        capacity = signals.get("capacity_tokens_per_s")
        projected = signals.get("projected_tokens_per_s")

        want_out = (
            burn_firing
            and headroom is not None and headroom < pol.headroom_floor
        )
        clears_with_one_less = None
        if capacity and replicas > 1:
            n_minus_1 = float(capacity) * (replicas - 1) / replicas
            clears_with_one_less = (
                (projected or 0.0) * pol.scale_in_margin <= n_minus_1
            )
            signals = dict(signals)
            signals["capacity_n_minus_1_tokens_per_s"] = round(n_minus_1, 3)
        want_in = (
            not burn_firing
            and headroom is not None and headroom > pol.scale_in_headroom
            and replicas > pol.min_replicas
        )

        # streaks advance on raw eligibility, before cooldown/clamps:
        # a condition that persists through the cooldown acts the
        # moment the cooldown lifts
        self._out_streak = self._out_streak + 1 if want_out else 0
        self._in_streak = self._in_streak + 1 if want_in else 0

        in_cooldown = (
            self.last_action_t is not None
            and now - self.last_action_t < pol.cooldown_s
        )
        if in_cooldown:
            return self._hold("cooldown", replicas, signals, firing, now)
        if replicas < pol.min_replicas:
            # bootstrap/repair: below the floor there is nothing to
            # confirm — the fleet is under-provisioned by definition
            self.last_action_t = now
            return Decision(
                action="scale_out", reason="below_min_replicas",
                replicas=replicas, target_replicas=replicas + 1,
                signals=signals, firing=firing, t_unix_s=now,
            )
        if want_out:
            if replicas >= pol.max_replicas:
                return self._hold(
                    "at_max_replicas", replicas, signals, firing, now
                )
            if self._out_streak < pol.confirm_evals:
                return self._hold(
                    f"confirming_scale_out_{self._out_streak}"
                    f"/{pol.confirm_evals}",
                    replicas, signals, firing, now,
                )
            self.last_action_t = now
            self._out_streak = 0
            return Decision(
                action="scale_out",
                reason="burn_firing_and_headroom_below_floor",
                replicas=replicas, target_replicas=replicas + 1,
                signals=signals, firing=firing, t_unix_s=now,
            )
        if want_in:
            if clears_with_one_less is False:
                return self._hold(
                    "scale_in_would_overload", replicas, signals,
                    firing, now,
                )
            if self._in_streak < pol.confirm_evals:
                return self._hold(
                    f"confirming_scale_in_{self._in_streak}"
                    f"/{pol.confirm_evals}",
                    replicas, signals, firing, now,
                )
            self.last_action_t = now
            self._in_streak = 0
            return Decision(
                action="scale_in", reason="sustained_surplus_headroom",
                replicas=replicas, target_replicas=replicas - 1,
                signals=signals, firing=firing, t_unix_s=now,
            )
        return self._hold("steady", replicas, signals, firing, now)
