"""Declarative alerting over the telemetry timeline.

An own copy of the reference's ``accelerate_tpu/telemetry/alerts.py``.

The timeline (``telemetry/timeline.py``) answers windowed queries; this
module turns them into **alert state** — the thing a pager, a router, or
the engine's own remediation hooks act on. Two rule shapes:

- :class:`AlertRule` — a windowed threshold over one gauge (or a ratio
  of two), with a ``for_s`` hold before firing, e.g.::

      AlertRule.parse("page_arena_watermark",
                      "serving/pages_in_use / serving/pages_total > 0.9 for 30s")

- :class:`BurnRateRule` — multi-window SLO **burn rate** in the
  Google-SRE style: the fraction of recent samples breaching the SLO
  (or, in counter mode, bad events over total events), divided by the
  error budget, evaluated over a *fast* and a *slow* window at once. A
  fast-only spike or a slow-only residue does not page; sustained burn
  in both windows does, and recovery resolves quickly because the fast
  window clears first.

Every rule walks one lifecycle: ``ok → pending → firing → resolved →
ok``. Transitions append to ``alerts-host<i>.jsonl``, surface as
``alert_firing{rule="..."}`` series in the Prometheus exposition and as
``alerts/*`` rollup gauges, and — on the pending→firing edge — run the
rule's **actions**, closing the observe→act loop with machinery that
already exists: ``"flight_dump"`` (FlightRecorder debug bundle),
``"capture"`` (arm the session's profiler capture window, when it has
one: the port's sessions do not build one yet), or any callable
``fn(rule, state, value)``.

:func:`default_ruleset` covers the failure modes this stack has already
built detectors for: ITL SLO burn, shed-rate burn, goodput
compute-fraction collapse, recompile storms, the page-arena watermark,
and the synthetic-canary correctness check (``canary_failing`` pages on
``canary/pass_ratio`` dropping below 1, the series an active prober
exports; a missing series never fires, so sessions with no canary pay
nothing).

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

OK = "ok"
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_EXPR_RE = re.compile(
    r"^\s*(?P<key>\S+)\s*(?:/\s*(?P<den>\S+)\s*)?"
    r"(?P<op>>=|<=|>|<)\s*(?P<thr>[-+]?[0-9.]+(?:[eE][-+]?[0-9]+)?)"
    r"(?:\s+for\s+(?P<for>[0-9.]+)\s*s)?\s*$"
)


@dataclass
class AlertRule:
    """Windowed threshold rule over one timeline series (optionally a
    ratio of two). ``stat`` picks the window statistic: ``last``,
    ``mean``, ``min``, ``max``, ``rate`` (counter per-second), or
    ``delta`` (counter increase over the window). ``gate_key`` makes the
    rule conditional: it only evaluates while the gate series' windowed
    mean exceeds ``gate_min`` (e.g. goodput collapse only while training
    throughput exists — an idle session is not an incident)."""

    name: str
    key: str
    threshold: float
    op: str = ">"
    denominator: Optional[str] = None
    window_s: float = 0.0          # 0 = latest sample only
    stat: str = "last"
    for_s: float = 0.0             # hold pending this long before firing
    min_points: int = 1
    gate_key: Optional[str] = None
    gate_min: float = 0.0
    severity: str = "page"
    description: str = ""
    actions: tuple = ()

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; one of {sorted(_OPS)}")
        if self.stat not in ("last", "mean", "min", "max", "rate", "delta"):
            raise ValueError(f"unknown stat {self.stat!r}")
        if self.stat != "last" and self.window_s <= 0:
            raise ValueError(f"stat {self.stat!r} needs window_s > 0")

    @classmethod
    def parse(cls, name: str, expr: str, **kw) -> "AlertRule":
        """``"serving/pages_in_use / serving/pages_total > 0.9 for 30s"``
        → a ratio threshold rule holding 30 s before firing."""
        m = _EXPR_RE.match(expr)
        if m is None:
            raise ValueError(
                f"cannot parse alert expression {expr!r}; expected "
                "'<key> [/ <key>] <op> <number> [for <N>s]'"
            )
        return cls(
            name=name, key=m.group("key"), denominator=m.group("den"),
            op=m.group("op"), threshold=float(m.group("thr")),
            for_s=float(m.group("for") or 0.0), **kw,
        )

    # -- evaluation --------------------------------------------------------

    def _stat_of(self, timeline, key, now):
        if self.window_s <= 0:
            return timeline.last(key)
        w = timeline.window(key, self.window_s, now)
        if w is None or w["n"] < self.min_points:
            return None
        return w[self.stat]

    def evaluate(self, timeline, now) -> tuple:
        """→ ``(value, breached)``; a missing series is never a breach
        (absence of evidence pages nobody)."""
        if self.gate_key is not None:
            g = timeline.window(self.gate_key, max(self.window_s, 1.0), now)
            if g is None or g["mean"] is None or g["mean"] <= self.gate_min:
                return None, False
        v = self._stat_of(timeline, self.key, now)
        if v is None:
            return None, False
        if self.denominator is not None:
            d = self._stat_of(timeline, self.denominator, now)
            if d is None or d == 0:
                return None, False
            v = v / d
        return v, _OPS[self.op](v, self.threshold)


@dataclass
class BurnRateRule:
    """Multi-window error-budget burn rate.

    Gauge mode (``total_key=None``): a sample is *bad* when its value of
    ``key`` breaches ``slo`` under ``op``; the window's breach fraction
    over ``budget`` is the burn rate. Counter mode: burn is the window
    delta of ``key`` (bad events) over the delta of ``total_key`` (all
    events), divided by ``budget``. The rule breaches only when BOTH the
    fast and slow windows burn at ≥ ``factor`` — the standard
    fast-catches-it / slow-confirms-it pairing."""

    name: str
    key: str
    budget: float                 # allowed bad fraction (error budget)
    fast_s: float = 60.0
    slow_s: float = 600.0
    factor: float = 4.0           # fire at this multiple of budget pace
    slo: Optional[float] = None   # gauge mode: per-sample breach threshold
    op: str = ">"
    total_key: Optional[str] = None  # counter mode denominator
    for_s: float = 0.0
    min_points: int = 3           # fast window needs this many samples
    severity: str = "page"
    description: str = ""
    actions: tuple = ()

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; one of {sorted(_OPS)}")
        if not (0 < self.budget <= 1):
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.fast_s >= self.slow_s:
            raise ValueError(
                f"fast window ({self.fast_s}s) must be shorter than the "
                f"slow window ({self.slow_s}s)"
            )
        if self.total_key is None and self.slo is None:
            raise ValueError("gauge mode needs slo=; counter mode needs total_key=")

    def _bad_fraction(self, timeline, seconds, now):
        if self.total_key is not None:
            bad = timeline.window(self.key, seconds, now)
            total = timeline.window(self.total_key, seconds, now)
            if bad is None or total is None:
                return None, 0
            d_bad = max(bad["delta"], 0.0)
            d_total = max(total["delta"], 0.0)
            if d_bad <= 0 and d_total <= 0:
                return 0.0, bad["n"]
            return min(d_bad / max(d_total, 1.0), 1.0), bad["n"]
        pts = timeline.points(self.key, seconds, now)
        if not pts:
            return None, 0
        cmp = _OPS[self.op]
        # an aggregated bucket counts as bad by its mean — one outlier in
        # a 60s bucket must not retroactively mark the whole minute bad
        bad = sum(1 for _, a in pts if cmp(a[2] / max(a[3], 1), self.slo))
        return bad / len(pts), len(pts)

    def evaluate(self, timeline, now) -> tuple:
        fast, n_fast = self._bad_fraction(timeline, self.fast_s, now)
        slow, _ = self._bad_fraction(timeline, self.slow_s, now)
        if fast is None or slow is None or n_fast < self.min_points:
            return None, False
        burn_fast = fast / self.budget
        burn_slow = slow / self.budget
        breached = burn_fast >= self.factor and burn_slow >= self.factor
        return round(burn_fast, 4), breached


def default_ruleset(
    *,
    itl_slo_ms: Optional[float] = None,
    ttft_slo_ms: Optional[float] = None,
    itl_budget: float = 0.02,
    itl_fast_s: float = 60.0,
    itl_slow_s: float = 600.0,
    itl_factor: float = 4.0,
    itl_for_s: float = 0.0,
    shed_budget: float = 0.05,
    shed_fast_s: float = 120.0,
    shed_slow_s: float = 1200.0,
    shed_factor: float = 2.0,
    page_watermark: float = 0.9,
    page_for_s: float = 30.0,
    goodput_floor: float = 0.5,
    goodput_for_s: float = 60.0,
    recompile_burst: float = 2.0,
    recompile_window_s: float = 120.0,
    canary_pass_floor: float = 1.0,
    canary_for_s: float = 0.0,
) -> list:
    """The built-in ruleset: every detector this stack already measures,
    promoted to an alert. ITL/TTFT burn rules only exist when their SLO
    is known (pass ``itl_slo_ms``/``ttft_slo_ms``, or set
    ``TelemetryConfig.alert_itl_slo_ms`` /
    ``profile_trigger_itl_p99_ms``)."""
    rules = []
    if itl_slo_ms is not None:
        rules.append(BurnRateRule(
            name="itl_burn_rate",
            key="serving/itl_recent_p99_ms", slo=float(itl_slo_ms),
            budget=itl_budget, fast_s=itl_fast_s, slow_s=itl_slow_s,
            factor=itl_factor, for_s=itl_for_s,
            description=(
                f"recent ITL p99 is burning the {itl_slo_ms}ms SLO error "
                "budget in both the fast and slow windows"
            ),
            actions=("flight_dump", "capture"),
        ))
    if ttft_slo_ms is not None:
        rules.append(BurnRateRule(
            name="ttft_burn_rate",
            key="serving/ttft_p99_ms", slo=float(ttft_slo_ms),
            budget=itl_budget, fast_s=itl_fast_s, slow_s=itl_slow_s,
            factor=itl_factor,
            description=f"TTFT p99 is burning the {ttft_slo_ms}ms SLO budget",
            actions=("flight_dump",),
        ))
    rules.append(BurnRateRule(
        name="shed_burn_rate",
        key="serving/shed", total_key="serving/requests_terminal",
        budget=shed_budget, fast_s=shed_fast_s, slow_s=shed_slow_s,
        factor=shed_factor,
        description="the engine is shedding more than the request error budget",
        actions=("flight_dump",),
        severity="page",
    ))
    rules.append(AlertRule(
        name="page_arena_watermark",
        key="serving/pages_in_use", denominator="serving/pages_total",
        op=">", threshold=page_watermark, for_s=page_for_s,
        description="the paged KV arena is nearly full; admissions will "
                    "shed or preempt next",
        severity="warn",
    ))
    rules.append(AlertRule(
        name="goodput_collapse",
        key="goodput/goodput_frac", op="<", threshold=goodput_floor,
        window_s=60.0, stat="mean", for_s=goodput_for_s,
        gate_key="sys/tokens_per_s", gate_min=0.0,
        description="compute fraction of wall collapsed while the step "
                    "loop is live — look at compile/data_wait/stall",
        severity="warn",
    ))
    rules.append(AlertRule(
        name="canary_failing",
        key="canary/pass_ratio", op="<", threshold=canary_pass_floor,
        for_s=canary_for_s,
        description="synthetic canary probes are returning wrong tokens "
                    "or not finishing — an ACTIVE correctness failure "
                    "(drift? bad KV import? corrupting transport?); "
                    "canary-results.jsonl names the replica that served "
                    "each failing probe, and its flight bundle was "
                    "dumped at failure time (docs/troubleshooting.md "
                    "'The canary is failing')",
        severity="page",
        actions=("flight_dump",),
    ))
    rules.append(AlertRule(
        name="recompile_storm",
        key="sys/recompiles_diagnosed", stat="delta",
        window_s=recompile_window_s, op=">", threshold=recompile_burst,
        description="diagnosed recompiles are accumulating; see "
                    "forensics-host*.jsonl for the argument causes",
        severity="warn",
        actions=("flight_dump",),
    ))
    return rules


@dataclass
class _RuleState:
    state: str = OK
    since: Optional[float] = None     # when the current state began
    value: Optional[float] = None     # last evaluated value
    fired_count: int = 0
    last_fired: Optional[float] = None
    exemplars: Optional[list] = None  # culprit ids at the last firing edge


class AlertManager:
    """Evaluates a ruleset against the timeline on the sampling cadence
    and owns the pending→firing→resolved lifecycle + the event log."""

    def __init__(self, timeline, rules, *, session=None,
                 log_path: Optional[str] = None, clock=time.time,
                 max_events: int = 512, exemplar_source=None):
        names = [r.name for r in rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.timeline = timeline
        self.rules = list(rules)
        self.session = session
        self.log_path = log_path
        self._clock = clock
        self._fh = None
        # ``exemplar_source(rule_key) -> [request_id, ...]`` names the
        # culprit requests behind the breached series at firing edge
        # (the session wires its own histograms in; the fleet collector
        # its merged ones). Read-only dict walks — safe under the lock.
        self.exemplar_source = exemplar_source
        # reentrant: an action (flight dump) may re-enter rollup_keys()
        # on the same thread via session.host_rollup()
        self._lock = threading.RLock()
        self.states = {r.name: _RuleState() for r in self.rules}
        self.events: list = []        # bounded in-memory mirror of the log
        self._max_events = max_events
        self.evaluations = 0

    # -- lifecycle ---------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> list:
        """One evaluation pass (called per timeline sample). Returns the
        transition events it emitted."""
        now = self._clock() if now is None else float(now)
        emitted = []
        fired = []
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                st = self.states[rule.name]
                try:
                    value, breached = rule.evaluate(self.timeline, now)
                except Exception:
                    # a rule over a sick series must not kill the pass
                    continue
                st.value = value
                hold = float(getattr(rule, "for_s", 0.0) or 0.0)
                if breached:
                    if st.state == OK:
                        st.state, st.since = PENDING, now
                        emitted.append(self._event(rule, st, PENDING, now))
                        # fall through: a zero hold fires on this pass
                    if st.state == PENDING and now - st.since >= hold:
                        st.state, st.since = FIRING, now
                        st.fired_count += 1
                        st.last_fired = now
                        emitted.append(self._event(rule, st, FIRING, now))
                        fired.append((rule, st))
                else:
                    if st.state == FIRING:
                        st.state, st.since = OK, now
                        emitted.append(self._event(rule, st, RESOLVED, now))
                    elif st.state == PENDING:
                        st.state, st.since = OK, now
        # log first, then act, both OUTSIDE the lock: a flight dump
        # snapshots the session rollup, which reads this manager's own
        # rollup_keys() — and may take arbitrarily long on a sick host
        for evt in emitted:
            self._log(evt)
        for rule, st in fired:
            self._run_actions(rule, st)
        return emitted

    def _event(self, rule, st: _RuleState, state: str, now: float) -> dict:
        evt = {
            "t_unix_s": round(now, 3),
            "rule": rule.name,
            "state": state,
            "value": st.value,
            "severity": getattr(rule, "severity", "page"),
            "description": getattr(rule, "description", ""),
        }
        if state == FIRING and self.exemplar_source is not None:
            key = getattr(rule, "key", None)
            try:
                ids = list(self.exemplar_source(key) or []) if key else []
            except Exception:
                ids = []  # a sick exemplar source must not break the edge
            if ids:
                # the firing-edge event names culprit requests — the
                # entry point for `trace summary --request-id` and the
                # incident correlator's waterfall stitching
                evt["exemplars"] = ids[:8]
                st.exemplars = ids[:8]
        return evt

    def _run_actions(self, rule, st: _RuleState):
        session = self.session
        for action in getattr(rule, "actions", ()) or ():
            try:
                if callable(action):
                    action(rule, st.state, st.value)
                elif action == "flight_dump" and session is not None:
                    flight = getattr(session, "flight", None)
                    if flight is not None:
                        flight.note("alert_firing", rule=rule.name, value=st.value)
                        flight.dump(f"alert_{rule.name}",
                                    extra={"alert_value": st.value})
                elif action == "capture" and session is not None:
                    capture = getattr(session, "capture", None)
                    if capture is not None:
                        capture.arm(f"alert_{rule.name}")
            except Exception:
                # remediation failing must not break alert evaluation
                pass

    def _log(self, evt: dict):
        self.events.append(evt)
        if len(self.events) > self._max_events:
            del self.events[: len(self.events) - self._max_events]
        if not self.log_path:
            return
        try:
            if self._fh is None:
                from .artifacts import ArtifactWriter

                self._fh = ArtifactWriter(self.log_path)
            self._fh.write(evt)
        except OSError:
            pass

    # -- consumers ---------------------------------------------------------

    def firing(self) -> list:
        with self._lock:
            return sorted(
                name for name, st in self.states.items() if st.state == FIRING
            )

    def states_snapshot(self) -> dict:
        """{rule: {state, value, fired_count, since}} — what the exporter
        and ``watch`` render."""
        with self._lock:
            out = {}
            for name, st in self.states.items():
                row = {
                    "state": st.state,
                    "value": st.value,
                    "fired_count": st.fired_count,
                    "since": st.since,
                }
                if st.exemplars and st.state == FIRING:
                    # watch renders the culprit request ids next to the
                    # firing rule — the four-command path starts here
                    row["exemplars"] = list(st.exemplars)
                out[name] = row
            return out

    def rollup_keys(self) -> dict:
        """Flat ``alerts/*`` gauges for the session rollup (and through
        it the timeline itself — alert state is history too)."""
        with self._lock:
            out = {"alerts/firing_count": sum(
                1 for st in self.states.values() if st.state == FIRING
            )}
            for name, st in self.states.items():
                out[f"alerts/{name}_firing"] = int(st.state == FIRING)
            return out

    def close(self):
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def exemplars_for_key(hists: dict, key: Optional[str], k: int = 4) -> list:
    """Culprit request ids behind a rule key: strip the percentile
    suffix (``serving/itl_recent_p99_ms`` -> ``serving/itl``), find the
    matching histogram, and return its worst exemplars value-descending
    (deduped by request id). Empty when the key names no histogram —
    fleet/canary counter rules have no per-request story to tell."""
    if not key or not hists:
        return []
    base = key
    for suffix in ("_recent_p99_ms", "_recent_p95_ms", "_recent_p50_ms",
                   "_p99_ms", "_p95_ms", "_p50_ms", "_mean_ms", "_max_ms",
                   "_count"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    hist = hists.get(base)
    if hist is None:
        return []
    from .histograms import _entry_dict

    entries = [_entry_dict(e)
               for res in dict(getattr(hist, "exemplars", {})).values()
               for e in res]
    entries.sort(key=lambda e: (e.get("value") or 0.0,
                                e.get("unix_s") or 0.0), reverse=True)
    out: list = []
    for e in entries:
        rid = e.get("request_id")
        if rid is not None and rid not in out:
            out.append(rid)
        if len(out) >= k:
            break
    return out


def load_alerts(target: str) -> dict:
    """Offline read of ``alerts-host*.jsonl`` under a telemetry dir
    (every rotated generation included): event list (time-ordered,
    host-tagged) plus per-rule summary with each rule's final state —
    the ``report``/``watch`` data source."""
    from .artifacts import artifact_files

    if os.path.isdir(target):
        paths = (
            artifact_files(target, "alerts-host*.jsonl")
            # the fleet collector's rule evaluations (telemetry/fleet.py)
            # land beside the per-host logs and merge the same way
            + artifact_files(target, "alerts-fleet.jsonl")
        )
    elif os.path.exists(target):
        paths = artifact_files(target)
    else:
        paths = []
    events = []
    for path in paths:
        host = os.path.basename(path).split(".", 1)[0]
        host = (host.replace("alerts-host", "") if host.startswith("alerts-host")
                else host.replace("alerts-", ""))
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        evt = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(evt, dict) and evt.get("rule"):
                        evt.setdefault("host", host)
                        events.append(evt)
        except OSError:
            continue
    events.sort(key=lambda e: e.get("t_unix_s", 0))
    rules: dict = {}
    for evt in events:
        r = rules.setdefault(evt["rule"], {
            "rule": evt["rule"], "state": OK, "fired_count": 0,
            "resolved_count": 0, "last_value": None, "severity":
            evt.get("severity"),
        })
        if evt["state"] == FIRING:
            r["fired_count"] += 1
            r["state"] = FIRING
        elif evt["state"] == RESOLVED:
            r["resolved_count"] += 1
            r["state"] = OK
        elif evt["state"] == PENDING and r["state"] == OK:
            r["state"] = PENDING
        r["last_value"] = evt.get("value", r["last_value"])
        r["last_t"] = evt.get("t_unix_s")
    return {"events": events, "rules": rules}
