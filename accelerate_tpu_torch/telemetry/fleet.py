"""Fleet observability plane: N replicas, one control-plane view.

An own copy of the reference's ``accelerate_tpu/telemetry/fleet.py``.
The timeline, burn-rate alerting and usage accounting each see exactly
one process. A production serving deployment is N replicas behind a router,
and Google-SRE-style multi-window burn alerting only means something for
a *service* when it is evaluated over the fleet's aggregate, not one
replica's. This module is that aggregation tier, built so the router
(``serving/router.py``) consumes an existing, tested signal contract
instead of inventing one inline:

- :func:`parse_exposition` — the hardened Prometheus-text parser:
  tolerates ``NaN``/``+Inf``/``-Inf`` values, escaped label values, and
  torn lines from a mid-write scrape, and parses native histogram
  ``_bucket{le=...}`` series back into mergeable bucket lists.
- :class:`FleetCollector` — polls N replica scrape endpoints (or
  artifact dirs for offline analysis), maintains a per-replica **health
  state machine** (``starting → healthy → degraded → draining →
  unreachable → dead``) with an ``alerts.py``-style transition event
  log, merges every replica's gauges into a **fleet-aggregate timeline**
  under the documented per-key merge policy (sum for counters, max for
  watermarks, exact log-bucket histogram merge for latency quantiles —
  growth factors align by construction, so fleet p99 is a real merged
  quantile, never an average of per-replica p99s), and evaluates
  ``AlertRule``/``BurnRateRule`` unchanged over the fleet series — with
  a ``fleet/replica_down`` default rule.
- :func:`load_score` — THE placement-signal formula every
  ``ServingEngine`` exports as ``serving/load_score`` (free pages, queue
  depth, recent ITL p99, drain folded into one comparable scalar; lower
  = more attractive). ``FleetCollector.placement_view()`` returns the
  ranked per-replica snapshot the router consumes; a dead/unreachable/
  draining replica drops out within one poll interval.

Health-state semantics:

- ``starting`` — registered, never successfully scraped yet;
- ``healthy`` — scrape succeeded and the replica's own sample clock
  (``att_scrape_age_seconds``) is fresh;
- ``degraded`` — scrape succeeded but the replica's exported sample age
  exceeds ``stale_after_s``: the HTTP endpoint is alive while the
  session behind it stopped sampling (a frozen gauge, not a frozen
  replica — exactly the distinction the staleness gauge exists for);
- ``draining`` — the replica exports ``serving/draining`` (the engine's
  ``request_drain()`` flag as a gauge): finish in-flight, place nothing;
- ``unreachable`` — the scrape failed (refused/timeout); transient;
- ``dead`` — unreachable for ``dead_after_s`` (or never came up that
  long): the router should forget it. A later successful scrape
  resurrects it (logged).

Counter conservation across replica loss: monotone counters
(``serving/generated_tokens``, usage totals, histogram counts) merge
over every replica's **last-known** snapshot — a killed replica's final
scrape keeps contributing, so fleet token totals never step backward
when a replica dies. Instantaneous gauges (queue depth, pages, rates)
merge over reachable replicas only.

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the same module runs on a router or a laptop that only reaches
the scrape endpoints.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .histograms import StreamingHistogram, percentile_keys
from .timeline import Timeline, TimelineSampler

# -- replica health states (the state machine's full walk) ------------------

STARTING = "starting"
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
UNREACHABLE = "unreachable"
DEAD = "dead"

HEALTH_STATES = (STARTING, HEALTHY, DEGRADED, DRAINING, UNREACHABLE, DEAD)
# states a router may place new work on (degraded = slow but serving)
PLACEABLE_STATES = (HEALTHY, DEGRADED)
# states counted by the fleet/replicas_down gauge (and through it the
# fleet/replica_down default alert rule)
DOWN_STATES = (UNREACHABLE, DEAD)


# -- exposition parsing (the watch/FleetCollector shared parser) ------------

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?[0-9]+))?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESC_RE = re.compile(r"\\(.)")
# OpenMetrics exemplar suffix on a _bucket line: `# {labels} value [ts]`
_EXEMPLAR_RE = re.compile(
    r"^\{(?P<labels>.*)\}\s+(?P<value>[^\s]+)(?:\s+(?P<ts>[0-9.eE+-]+))?$"
)


def _parse_exemplar(suffix: str):
    """``{request_id="..",replica=".."} 0.087 1700000000.123`` -> entry
    dict, or None on any malformation (an exemplar is a debug hint; a
    torn or hostile suffix must cost nothing but itself)."""
    m = _EXEMPLAR_RE.match(suffix.strip())
    if m is None:
        return None
    labels = {k: _unescape(raw)
              for k, raw in _LABEL_RE.findall(m.group("labels"))}
    rid = labels.get("request_id")
    if rid is None:
        return None
    try:
        value = float(m.group("value"))
    except ValueError:
        return None
    if value != value:
        return None
    entry = {"request_id": rid, "value": value}
    if labels.get("replica"):
        entry["replica"] = labels["replica"]
    ts = m.group("ts")
    if ts is not None:
        try:
            entry["unix_s"] = float(ts)
        except ValueError:
            pass
    return entry


def _unescape(value: str) -> str:
    """Inverse of ``exporter.escape_label_value`` (0.0.4 escaping)."""
    return _ESC_RE.sub(
        lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), value
    )


@dataclass
class ExpositionSnapshot:
    """One parsed scrape: flat ``att_``-stripped gauges, alert-firing
    states, and native histograms as mergeable cumulative bucket lists."""

    gauges: dict = field(default_factory=dict)      # flat name -> float
    alerts: dict = field(default_factory=dict)      # rule -> 0/1
    histograms: dict = field(default_factory=dict)  # base -> {buckets, sum, count}
    parsed_lines: int = 0
    skipped_lines: int = 0


def parse_exposition(text: str) -> ExpositionSnapshot:
    """Parse Prometheus text exposition back into gauges/alerts/histograms.

    Hardened for the realities of scraping a live process: ``NaN`` gauge
    values are dropped (a NaN poisons every merge it touches),
    ``+Inf``/``-Inf`` parse through, label values may carry 0.0.4 escapes
    (``\\\\``, ``\\"``, ``\\n``) and any raw character including ``}``,
    and a torn line from a mid-write scrape is skipped — never an
    exception. Histogram ``_bucket{le=...}`` series fold into per-name
    cumulative bucket lists (``+Inf`` excluded; ``_sum``/``_count`` ride
    along) so :class:`FleetCollector` can rebuild and exactly merge the
    log-bucket histograms behind them."""
    snap = ExpositionSnapshot()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # an OpenMetrics exemplar rides after ` # ` on bucket lines; it
        # must come off BEFORE the series match (the greedy label group
        # would otherwise swallow the exemplar's own label block and
        # misparse the exemplar value as the bucket count)
        exemplar = None
        if " # " in line:
            line, _, suffix = line.partition(" # ")
            line = line.rstrip()
            exemplar = _parse_exemplar(suffix)
        m = _LINE_RE.match(line)
        if m is None:
            snap.skipped_lines += 1
            continue
        name = m.group("name")
        try:
            v = float(m.group("value"))
        except ValueError:
            snap.skipped_lines += 1
            continue
        labels = {}
        if m.group("labels") is not None:
            labels = {
                k: _unescape(raw) for k, raw in _LABEL_RE.findall(m.group("labels"))
            }
        snap.parsed_lines += 1
        if name == "att_alert_firing":
            rule = labels.get("rule")
            if rule is not None and v == v:
                snap.alerts[rule] = int(v)
            continue
        if name.endswith("_bucket") and "le" in labels:
            base = name[: -len("_bucket")]
            if base.startswith("att_"):
                base = base[len("att_"):]
            if base.endswith("_seconds"):
                base = base[: -len("_seconds")]
            try:
                le = float(labels["le"])
            except ValueError:
                continue
            hist = snap.histograms.setdefault(
                base, {"buckets": [], "sum": 0.0, "count": 0, "exemplars": []}
            )
            if le != float("inf") and v == v:
                hist["buckets"].append((le, int(v)))
                if exemplar is not None:
                    hist["exemplars"].append((le, exemplar))
            continue
        if labels:
            # other labeled families (future exporters): not flat gauges
            continue
        hist_meta = False
        for suffix, fkey in (("_seconds_sum", "sum"), ("_seconds_count", "count")):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                if base.startswith("att_"):
                    base = base[len("att_"):]
                if base in snap.histograms and v == v:
                    snap.histograms[base][fkey] = (
                        float(v) if fkey == "sum" else int(v)
                    )
                    hist_meta = True
                break
        if hist_meta:
            continue
        if name.startswith("att_") and v == v:  # drop NaN, keep +/-Inf
            snap.gauges[name[len("att_"):]] = v
    return snap


# the rollup namespaces the exporter flattens ("serving/x" -> "serving_x");
# unflatten_key restores the namespace so fleet-timeline keys match the
# per-replica rollup keys and AlertRule/BurnRateRule evaluate unchanged
_NAMESPACES = ("serving", "usage", "goodput", "sys", "exe", "alerts",
               "fleet", "train", "fp8", "router", "canary", "autoscale")


def unflatten_key(name: str) -> str:
    """``serving_itl_recent_p99_ms`` → ``serving/itl_recent_p99_ms``.
    Only the leading namespace segment is restored (tenant ids and
    executable names may themselves contain ``_`` — the merge policy
    matches on prefix/suffix, so the inner separators don't matter)."""
    if "/" in name:
        return name
    head, sep, rest = name.partition("_")
    if sep and rest and head in _NAMESPACES:
        return f"{head}/{rest}"
    return name


# -- the placement-signal contract ------------------------------------------

# a draining/unplaceable replica's score is pushed past anything a live
# replica can reach — routers comparing raw scores still never pick it
DRAINING_PENALTY = 1e6
# ITL term normalizer when no SLO is configured: p99 at 100 ms counts as
# one full "unit" of load, comparable to a 100%-occupied slot arena
DEFAULT_ITL_NORM_MS = 100.0


def load_score(
    *,
    queue_depth: float = 0.0,
    num_slots: float = 1.0,
    slot_occupancy: float = 0.0,
    free_pages: Optional[float] = None,
    pages_total: Optional[float] = None,
    itl_recent_p99_ms: Optional[float] = None,
    itl_slo_ms: Optional[float] = None,
    draining: bool = False,
) -> float:
    """THE load-score formula (the stable router contract; lower = more
    attractive)::

        score = queue_depth / num_slots              # queued work per slot
              + slot_occupancy                       # 0..1 slots busy
              + (1 - free_pages / pages_total)       # paged arena only
              + itl_recent_p99_ms / (itl_slo_ms or 100)   # latency pressure
              + 1e6 if draining                      # never place on a drain

    Every term is monotone in the obvious direction — more queue, fewer
    free pages, or worse recent ITL strictly raises the score — which is
    what the ranking tests assert. Raw components stay exported beside
    the scalar (``serving/queue_depth``, ``serving/free_slots``,
    ``serving/free_pages``, ``serving/itl_recent_p99_ms``,
    ``serving/draining``) so a router that wants its own weighting can
    recompute without a replica-side change."""
    score = float(queue_depth) / max(float(num_slots), 1.0)
    score += float(slot_occupancy)
    if pages_total:
        used = 1.0 - float(free_pages or 0.0) / float(pages_total)
        score += min(max(used, 0.0), 1.0)
    if itl_recent_p99_ms is not None:
        score += float(itl_recent_p99_ms) / float(itl_slo_ms or DEFAULT_ITL_NORM_MS)
    if draining:
        score += DRAINING_PENALTY
    return round(score, 6)


def load_score_from_gauges(gauges: dict) -> Optional[float]:
    """Score out of a replica's (unflattened) gauge dict: the replica's
    own exported ``serving/load_score`` when present, else recomputed
    from the raw components (an older replica that predates the gauge
    still ranks)."""
    v = gauges.get("serving/load_score")
    if isinstance(v, (int, float)) and v == v:
        return float(v)
    if "serving/queue_depth" not in gauges and "serving/slot_occupancy" not in gauges:
        return None
    num_slots = gauges.get("serving/num_slots") or 1.0
    occ = gauges.get("serving/slot_occupancy") or 0.0
    free_slots = gauges.get("serving/free_slots")
    if free_slots is not None and occ == 0.0 and free_slots < num_slots:
        occ = 1.0 - free_slots / max(num_slots, 1.0)
    return load_score(
        queue_depth=gauges.get("serving/queue_depth") or 0.0,
        num_slots=num_slots,
        slot_occupancy=occ,
        free_pages=gauges.get("serving/free_pages"),
        pages_total=gauges.get("serving/pages_total"),
        itl_recent_p99_ms=gauges.get("serving/itl_recent_p99_ms"),
        draining=bool(gauges.get("serving/draining")),
    )


# -- per-key merge policy ---------------------------------------------------

SUM_COUNTER = "sum_counter"   # monotone counters: sum over last-known of ALL
SUM_LIVE = "sum_live"         # instantaneous: sum over reachable replicas
MAX = "max"                   # watermarks / ages: fleet-worst
MEAN = "mean"                 # fractions / ratios: fleet-average

# monotone counters by exact key — these keep a dead replica's last-known
# contribution so fleet totals are conserved across a loss. The router/*
# and canary/* families joined with the edge-observability PR: N routers
# (or a router + a standalone prober) merge the same way N engines do.
_COUNTER_KEYS = frozenset({
    "serving/requests_completed", "serving/generated_tokens",
    "serving/requests_terminal", "serving/shed", "serving/cancelled",
    "serving/preemptions", "serving/resumptions",
    "serving/spec_proposed", "serving/spec_accepted",
    "serving/prefill_chunks_skipped", "serving/page_forks",
    "serving/prefix_hit_tokens", "serving/admission_recompiles",
    "serving/itl_slo_breaches", "serving/itl_budget_adjustments",
    "serving/kv_pages_exported", "serving/kv_pages_imported",
    "sys/recompiles_diagnosed", "fleet/scrapes_ok", "fleet/scrapes_failed",
    "router/requests_submitted", "router/requests_completed",
    "router/requests_shed", "router/requests_cancelled",
    "router/requeues", "router/requests_requeued",
    "router/requeue_success", "router/kv_migrations",
    "canary/probes_sent", "canary/probes_passed", "canary/probes_failed",
    "serving/ghost_reuses",
    # KV-tiering counters: demotions/restores/pulls are monotone
    # work done — a dead replica's contribution stays in the fleet total
    "serving/kv_demotions_host", "serving/kv_demotions_disk",
    "serving/kv_disk_corrupt_dropped",
    "serving/kv_peer_pulls", "serving/kv_peer_pull_failures",
    "serving/kv_tier_hits_hbm", "serving/kv_tier_hits_host",
    "serving/kv_tier_hits_disk", "serving/kv_tier_hits_peer",
    "serving/kv_restores", "serving/kv_restores_aborted",
    "serving/kv_restore_batches",
})
# per-member counter families under a dynamic tail (tenant ids, replica
# names, shed reasons): counters by prefix. No trailing slash on the
# router families — a scraped gauge unflattens only its leading
# namespace ("router/failures_A"), while an in-process rollup keeps the
# full path ("router/failures/A"); both must land on SUM_COUNTER.
_COUNTER_PREFIXES = ("usage/", "router/failures", "router/shed")
_MEAN_SUFFIXES = ("_frac", "_ratio", "_pct", "occupancy", "_rate",
                  "load_score", "itl_budget", "kv_cache_bits",
                  # ghost-cache simulated hit ratios (a "_ratio" family,
                  # but the capacity-multiple tail hides the suffix)
                  "ghost_hit_ratio_2x", "ghost_hit_ratio_4x",
                  "ghost_hit_ratio_10x",
                  # per-tier hit ratios (same hidden-suffix shape)
                  "kv_tier_hit_ratio_hbm", "kv_tier_hit_ratio_host",
                  "kv_tier_hit_ratio_disk", "kv_tier_hit_ratio_peer")
# last_pass_unix_s: the canary freshness watermark is "when did ANY
# probe last verify the service" — fleet-newest; e2e_ttft_ms gauges are
# last-probe latencies — fleet-worst
_MAX_SUFFIXES = ("_age_seconds", "_watermark", "draining", "_age_s",
                 "last_pass_unix_s", "e2e_ttft_ms")
# percentile/latency gauges: fleet-worst unless the native histogram
# buckets are available, in which case the exact merged quantile wins
# (covers both the rollup spelling `*_p99_ms` and the exposition's
# histogram-gauge spelling `*_seconds_p99`)
_LATENCY_SUFFIXES = ("_p50_ms", "_p95_ms", "_p99_ms", "_mean_ms", "_max_ms",
                     "_ms_p50", "_p50", "_p95", "_p99")


def merge_policy(key: str) -> str:
    """The per-key merge policy (the reference's): counters sum over every replica ever seen, capacities
    and rates sum over live replicas, fractions average, watermarks and
    latency gauges take the fleet-worst."""
    if (key in _COUNTER_KEYS or key.startswith(_COUNTER_PREFIXES)
            or key.endswith("_count")):
        return SUM_COUNTER
    if key.endswith(_MAX_SUFFIXES) or key.endswith(_LATENCY_SUFFIXES):
        return MAX
    if key.endswith(_MEAN_SUFFIXES):
        return MEAN
    return SUM_LIVE


def merge_gauges(snapshots: list) -> dict:
    """Fold per-replica gauge dicts into one fleet dict. ``snapshots`` is
    ``[(gauges, live), ...]`` — ``gauges`` unflattened and last-known,
    ``live`` whether the replica's latest scrape succeeded."""
    out: dict = {}
    acc: dict = {}
    for gauges, live in snapshots:
        for key, v in gauges.items():
            if isinstance(v, bool):
                v = float(v)
            elif not isinstance(v, (int, float)):
                continue
            if v != v:  # NaN
                continue
            policy = merge_policy(key)
            if policy != SUM_COUNTER and not live:
                continue
            slot = acc.setdefault(key, [policy, 0.0, 0])
            if policy == MAX:
                slot[1] = v if slot[2] == 0 else max(slot[1], v)
            else:
                slot[1] += v
            slot[2] += 1
    for key, (policy, total, n) in acc.items():
        if n == 0:
            continue
        out[key] = total / n if policy == MEAN else total
    return out


def merge_histograms(snapshots: list, *, lo: float = 1e-6,
                     growth: float = 1.25) -> dict:
    """Exact log-bucket merge of parsed exposition histograms:
    ``{base_flat_name: merged StreamingHistogram}``. The growth factors
    align by construction (every session uses the default layout), so
    the merged quantile is the quantile of the union of all replicas'
    samples at the usual ~12% bucket error — never an average of
    per-replica percentiles. A replica whose layout doesn't align is
    skipped for that family (the MAX-policy gauges still cover it)."""
    merged: dict = {}
    for hists in snapshots:
        for base, data in (hists or {}).items():
            try:
                h = StreamingHistogram.from_cumulative(
                    data.get("buckets") or [], sum_value=data.get("sum", 0.0),
                    lo=lo, growth=growth,
                    exemplars=data.get("exemplars"),
                )
            except ValueError:
                continue
            if base in merged:
                merged[base].merge(h)
            else:
                merged[base] = h
    return merged


# -- the collector ----------------------------------------------------------


@dataclass
class ReplicaStatus:
    """One replica's scrape bookkeeping + last-known snapshot."""

    name: str
    target: str
    state: str = STARTING
    since: float = 0.0               # when the current state began
    registered_t: float = 0.0
    last_ok_t: Optional[float] = None
    last_err: Optional[str] = None
    consecutive_failures: int = 0
    scrapes_ok: int = 0
    scrapes_failed: int = 0
    transitions: int = 0
    gauges: dict = field(default_factory=dict)      # unflattened, last-known
    histograms: dict = field(default_factory=dict)  # parsed, last-known
    alerts: dict = field(default_factory=dict)
    sample_age_s: Optional[float] = None  # the replica's own exported age

    @property
    def live(self) -> bool:
        return self.state not in DOWN_STATES and self.last_ok_t is not None

    def summary(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        return {
            "replica": self.name,
            "target": self.target,
            "state": self.state,
            "since_s": round(now - self.since, 3) if self.since else None,
            "last_ok_age_s": (
                round(now - self.last_ok_t, 3) if self.last_ok_t else None
            ),
            "sample_age_s": self.sample_age_s,
            "consecutive_failures": self.consecutive_failures,
            "scrapes_ok": self.scrapes_ok,
            "scrapes_failed": self.scrapes_failed,
            "last_err": self.last_err,
            "load_score": load_score_from_gauges(self.gauges),
        }


def fleet_default_ruleset(*, replica_down_for_s: float = 0.0,
                          itl_slo_ms: Optional[float] = None, **kw) -> list:
    """``fleet/replica_down`` plus the standard single-host ruleset
    re-aimed at the fleet-aggregate series (same keys by construction —
    the merge restores the per-replica rollup names), so ITL burn, shed
    burn and the page watermark page on the *service*, not one host."""
    from .alerts import AlertRule, default_ruleset

    rules = [AlertRule(
        name="fleet/replica_down",
        key="fleet/replicas_down", op=">", threshold=0.0,
        for_s=replica_down_for_s,
        description="one or more replicas are unreachable or dead; "
                    "placement_view() has already dropped them",
        severity="page",
    )]
    rules.extend(default_ruleset(itl_slo_ms=itl_slo_ms, **kw))
    return rules


class FleetCollector:
    """Polls N replicas, owns their health states, and feeds the fleet
    timeline + alert rules. ``targets`` is a list of scrape URLs and/or
    telemetry artifact dirs (offline analysis), or ``(name, target)``
    pairs / a ``{name: target}`` dict to pin replica names.

    ``fetch_fn(target) -> exposition text | ExpositionSnapshot`` is
    injectable (tests script it); the default fetches URLs over HTTP
    and reads a dir's ``timeline-host*.jsonl`` tail. ``poll_once()`` is
    the manual cadence (deterministic tests pass ``now=``);
    ``start()``/``stop()`` run it on a background daemon thread."""

    def __init__(
        self,
        targets,
        *,
        poll_interval_s: float = 1.0,
        stale_after_s: float = 10.0,
        dead_after_s: float = 15.0,
        timeout_s: float = 2.0,
        itl_slo_ms: Optional[float] = None,
        replica_down_for_s: float = 0.0,
        rules: Optional[list] = None,
        log_dir: Optional[str] = None,
        fetch_fn: Optional[Callable] = None,
        clock: Callable[[], float] = time.time,
        tiers=None,
        max_events: int = 1024,
    ):
        if isinstance(targets, dict):
            pairs = list(targets.items())
        else:
            pairs = []
            for i, t in enumerate(targets):
                if isinstance(t, (tuple, list)) and len(t) == 2:
                    pairs.append((str(t[0]), str(t[1])))
                else:
                    pairs.append((_replica_name(str(t), i), str(t)))
        # an EMPTY target list is legal: an elastic deployment's router
        # starts the collector before any replica has registered and
        # grows it through add_replica() as they join
        names = [n for n, _ in pairs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate replica names in {names}")
        now = clock()
        self._clock = clock
        self.poll_interval_s = float(poll_interval_s)
        self.stale_after_s = float(stale_after_s)
        self.dead_after_s = float(dead_after_s)
        self.timeout_s = float(timeout_s)
        self._fetch_fn = fetch_fn
        self.replicas = {
            name: ReplicaStatus(
                name=name, target=target, since=now, registered_t=now
            )
            for name, target in pairs
        }
        self.timeline = Timeline(tiers=tiers)
        self.events: list = []
        self._max_events = int(max_events)
        self.polls = 0
        self.scrapes_ok = 0
        self.scrapes_failed = 0
        self._lock = threading.Lock()
        self._sampler: Optional[TimelineSampler] = None
        self.log_dir = log_dir
        self._events_fh = None
        alert_log = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            from .artifacts import ArtifactWriter

            self._events_fh = ArtifactWriter(
                os.path.join(log_dir, "fleet-events.jsonl")
            )
            alert_log = os.path.join(log_dir, "alerts-fleet.jsonl")
        from .alerts import AlertManager

        if rules is None:
            rules = fleet_default_ruleset(
                replica_down_for_s=replica_down_for_s, itl_slo_ms=itl_slo_ms
            )
        self.alerts = AlertManager(
            self.timeline, rules, log_path=alert_log, clock=clock,
            exemplar_source=self._alert_exemplars,
        )
        self._last_merged: dict = {}
        self._last_hists: dict = {}  # unflattened name -> merged histogram
        self._executor = None  # lazy scrape pool (poll_once builds it)
        self._retired: list = []  # pools replaced on a membership change
        self._dir_cache: dict = {}  # target -> (file sig, gauges, last_t)
        self._dir_cache_lock = threading.Lock()

    def _pool(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=min(16, max(1, len(self.replicas))),
                thread_name_prefix="att-fleet-scrape",
            )
        return self._executor

    # -- elastic membership (router join/leave) -----------------------------

    def add_replica(self, name: str, target: str) -> None:
        """Register a replica mid-flight (elastic scale-out): it enters
        the state machine at ``starting`` and joins the next poll —
        *regardless of poll timing*. A re-registration under the same
        name (scale-in then scale-out reusing the slot name) is a NEW
        incarnation: status resets to a fresh ``starting`` with a fresh
        ``registered_t``, so neither the old incarnation's terminal
        state nor a scrape of the old process still in flight can make
        the newcomer's first transition read ``unreachable``/``dead``
        (``poll_once`` discards results whose ``registered_t`` predates
        the re-registration). Cumulative scrape counters survive — they
        count the name's lifetime, not the incarnation's."""
        name, target = str(name), str(target)
        now = self._clock()
        with self._lock:
            r = self.replicas.get(name)
            if r is not None:
                if r.state != STARTING:
                    self._transition(r, STARTING, now, "re-registered")
                r.target = target
                # fresh incarnation: the dead-deadline anchor restarts
                # now, and stale last-known gauges leave the aggregate
                r.registered_t = now
                r.since = now
                r.last_ok_t = None
                r.last_err = None
                r.consecutive_failures = 0
                r.gauges = {}
                r.histograms = {}
                r.alerts = {}
                r.sample_age_s = None
                return
            self.replicas[name] = ReplicaStatus(
                name=name, target=target, since=now, registered_t=now
            )
            # the scrape pool is sized to the membership; a pool built
            # when the fleet was smaller would serialize scrapes (K
            # unreachable replicas -> K x timeout per poll, exactly when
            # the plane must stay responsive) — rebuild it lazily
            stale = self._executor
            self._executor = None
        if stale is not None:
            # its in-flight scrapes finish on their own; close() joins it
            stale.shutdown(wait=False)
            self._retired.append(stale)

    def remove_replica(self, name: str) -> bool:
        """Deregister a replica (elastic scale-in / permanent death):
        dropped from placement and future polls immediately. Its
        last-known counters leave the fleet aggregate — deregistration
        means 'forget it', unlike a death, which conserves them."""
        with self._lock:
            return self.replicas.pop(str(name), None) is not None

    # -- scraping ----------------------------------------------------------

    def _fetch(self, target: str) -> ExpositionSnapshot:
        fn = self._fetch_fn
        if fn is not None:
            result = fn(target)
        elif target.startswith(("http://", "https://")):
            import urllib.request

            with urllib.request.urlopen(target, timeout=self.timeout_s) as resp:
                result = resp.read().decode("utf-8", "replace")
        else:
            result = self._fetch_dir(target)
        if isinstance(result, ExpositionSnapshot):
            return result
        return parse_exposition(str(result))

    def _fetch_dir(self, target: str) -> ExpositionSnapshot:
        """Offline replica: the tail of its ``timeline-host*.jsonl`` is
        the gauge snapshot; freshness is the last sample's age. The parse
        is cached per file signature (path, mtime, size) — re-reading a
        multi-MB jsonl every poll interval for an unchanged file is pure
        waste, and an appended file invalidates by size."""
        import glob

        from .timeline import load_timeline

        if not os.path.isdir(target):
            raise FileNotFoundError(target)
        paths = sorted(glob.glob(os.path.join(target, "timeline-host*.jsonl")))
        sig = tuple(
            (p,) + ((st.st_mtime_ns, st.st_size) if st else (None, None))
            for p, st in ((p, _stat(p)) for p in paths)
        )
        with self._dir_cache_lock:
            cached = self._dir_cache.get(target)
        if cached is None or cached[0] != sig:
            tl = load_timeline(target)
            if tl.last_t is None:
                raise ValueError(f"no timeline samples under {target}")
            gauges: dict = {}
            for _, values in reversed(tl.raw):
                gauges.update(values)
                break
            cached = (sig, gauges, tl.last_t)
            with self._dir_cache_lock:
                self._dir_cache[target] = cached
        snap = ExpositionSnapshot()
        snap.gauges = dict(cached[1])
        snap.gauges["scrape_age_seconds"] = max(0.0, self._clock() - cached[2])
        return snap

    # -- health state machine ----------------------------------------------

    def _transition(self, r: ReplicaStatus, state: str, now: float, reason: str):
        if state == r.state:
            return
        evt = {
            "t_unix_s": round(now, 3),
            "replica": r.name,
            "from": r.state,
            "to": state,
            "reason": reason,
        }
        r.state = state
        r.since = now
        r.transitions += 1
        self.events.append(evt)
        if len(self.events) > self._max_events:
            del self.events[: len(self.events) - self._max_events]
        if self._events_fh is not None:
            try:
                self._events_fh.write(evt)
            except OSError:
                pass

    def _on_scrape_ok(self, r: ReplicaStatus, snap: ExpositionSnapshot, now: float):
        r.scrapes_ok += 1
        self.scrapes_ok += 1
        r.consecutive_failures = 0
        r.last_ok_t = now
        r.last_err = None
        r.gauges = {unflatten_key(k): v for k, v in snap.gauges.items()}
        r.histograms = snap.histograms
        r.alerts = snap.alerts
        age = snap.gauges.get("scrape_age_seconds")
        r.sample_age_s = round(float(age), 3) if isinstance(age, (int, float)) else None
        if r.gauges.get("serving/draining"):
            self._transition(r, DRAINING, now, "serving/draining gauge set")
        elif r.sample_age_s is not None and r.sample_age_s > self.stale_after_s:
            # the endpoint answers but the session behind it stopped
            # sampling: a frozen gauge source, not a frozen replica
            self._transition(
                r, DEGRADED, now,
                f"sample age {r.sample_age_s:.1f}s > stale_after_s "
                f"{self.stale_after_s:.1f}s",
            )
        else:
            self._transition(r, HEALTHY, now, "scrape ok")

    def _on_scrape_fail(self, r: ReplicaStatus, err: Exception, now: float):
        r.scrapes_failed += 1
        self.scrapes_failed += 1
        r.consecutive_failures += 1
        r.last_err = f"{type(err).__name__}: {err}"
        if r.state == DEAD:
            return
        anchor = r.last_ok_t if r.last_ok_t is not None else r.registered_t
        if now - anchor >= self.dead_after_s:
            self._transition(
                r, DEAD, now,
                f"unreachable for {now - anchor:.1f}s "
                f">= dead_after_s {self.dead_after_s:.1f}s ({r.last_err})",
            )
        elif r.state != STARTING or r.last_ok_t is not None:
            self._transition(r, UNREACHABLE, now, r.last_err)
        # a STARTING replica that has never answered stays STARTING until
        # the dead deadline — it is "not up yet", not "down"

    # -- polling -----------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> dict:
        """One collection pass: scrape every replica, advance health
        states, fold the merged fleet sample into the timeline, evaluate
        the alert rules. Returns the merged gauge dict."""
        now = self._clock() if now is None else float(now)
        # fetch CONCURRENTLY and outside the lock: with K unreachable
        # replicas a serial scrape pass costs K × timeout_s — past one
        # poll interval the moment two replicas die, which is exactly
        # when the plane must stay responsive. A pool bounds the pass at
        # ~max(timeout), and the lock stays free for placement_view()
        # readers. The replica set can change elastically (add_replica /
        # remove_replica), so the pass runs over a locked snapshot and
        # re-checks membership before folding each result back in.
        def one(r):
            # registered_t is the incarnation stamp: fold-back discards
            # this result if the name was re-registered (a NEW process
            # behind the same name) while the scrape was in flight — a
            # stale scrape must never become the newcomer's first
            # transition
            gen = r.registered_t
            try:
                return (r.name, gen, self._fetch(r.target), None)
            except Exception as e:
                return (r.name, gen, None, e)

        with self._lock:
            replicas = list(self.replicas.values())
        if not replicas:
            with self._lock:
                self.polls += 1
                merged = self._merged_sample(now)
                self._last_merged = merged
            t = self.timeline.add_sample(merged, now=now)
            self.alerts.evaluate(now=t)
            return merged
        if len(replicas) == 1:
            results = [one(replicas[0])]
        else:
            results = list(self._pool().map(one, replicas))
        with self._lock:
            self.polls += 1
            for name, gen, snap, err in results:
                r = self.replicas.get(name)
                if r is None:
                    continue  # deregistered while the scrape was in flight
                if r.registered_t != gen:
                    continue  # re-registered: result is the OLD incarnation's
                if err is not None:
                    self._on_scrape_fail(r, err, now)
                else:
                    self._on_scrape_ok(r, snap, now)
            merged = self._merged_sample(now)
            self._last_merged = merged
        t = self.timeline.add_sample(merged, now=now)
        self.alerts.evaluate(now=t)
        return merged

    def _merged_sample(self, now: float) -> dict:
        merged = merge_gauges([
            (r.gauges, r.live) for r in self.replicas.values()
        ])
        # exact quantiles from the merged native histograms override the
        # MAX-policy latency gauges wherever buckets are available
        hists = merge_histograms([
            r.histograms for r in self.replicas.values() if r.histograms
        ])
        by_name = {}
        for base, hist in hists.items():
            name = unflatten_key(base)
            by_name[name] = hist
            merged.update(percentile_keys(name, hist))
        # the merged histograms (with their unioned exemplars) are what
        # names culprit requests at a fleet alert's firing edge
        self._last_hists = by_name
        counts: dict = {s: 0 for s in HEALTH_STATES}
        for r in self.replicas.values():
            counts[r.state] += 1
        merged["fleet/replicas"] = len(self.replicas)
        for state, n in counts.items():
            merged[f"fleet/replicas_{state}"] = n
        merged["fleet/replicas_down"] = sum(counts[s] for s in DOWN_STATES)
        merged["fleet/replicas_placeable"] = sum(
            counts[s] for s in PLACEABLE_STATES
        )
        merged["fleet/scrapes_ok"] = self.scrapes_ok
        merged["fleet/scrapes_failed"] = self.scrapes_failed
        merged["fleet/poll_t_unix_s"] = round(now, 3)
        return merged

    def _alert_exemplars(self, key: str) -> list:
        """Culprit request ids for an alert keyed on ``key`` (e.g.
        ``serving/itl_recent_p99_ms`` -> the merged ``serving/itl``
        histogram's worst exemplars) — the firing-edge link from a fleet
        alert to concrete requests."""
        from .alerts import exemplars_for_key

        with self._lock:
            hists = dict(self._last_hists)
        return exemplars_for_key(hists, key)

    def start(self) -> "FleetCollector":
        if self._sampler is None:
            self._sampler = TimelineSampler(
                self.poll_once, self.poll_interval_s
            ).start()
        return self

    def stop(self):
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None

    # -- consumers ---------------------------------------------------------

    def fleet_gauges(self) -> dict:
        """The latest merged fleet sample (what the last poll folded into
        the timeline)."""
        with self._lock:
            return dict(self._last_merged)

    def placement_view(self, include_unplaceable: bool = False,
                       now: Optional[float] = None,
                       include_draining: bool = False) -> list:
        """The ranked per-replica placement snapshot — THE router input.
        Rows ascend by ``load_score`` (lower = place here first); a
        replica that is draining, unreachable, or dead is dropped (or
        trails with ``placeable: False`` under ``include_unplaceable``),
        so one poll interval after a kill the victim is gone.

        ``include_draining=True`` keeps DRAINING replicas in the view
        (trailing, still ``placeable: False``): a draining replica takes
        no *new* placements but keeps serving its in-flight streams, and
        a router that dropped it entirely would orphan those streams —
        it still needs the replica's target to route stream reads (and
        as the KV-handoff source when a sticky session migrates off
        it)."""
        now = self._clock() if now is None else float(now)
        rows = []
        with self._lock:
            for r in self.replicas.values():
                g = r.gauges
                score = load_score_from_gauges(g)
                placeable = (
                    r.state in PLACEABLE_STATES
                    and score is not None
                    and not g.get("serving/draining")
                )
                rows.append({
                    "replica": r.name,
                    "target": r.target,
                    "state": r.state,
                    "placeable": placeable,
                    "load_score": score,
                    "queue_depth": g.get("serving/queue_depth"),
                    "free_slots": g.get("serving/free_slots"),
                    "free_pages": g.get("serving/free_pages"),
                    "slot_occupancy": g.get("serving/slot_occupancy"),
                    "itl_recent_p99_ms": g.get("serving/itl_recent_p99_ms"),
                    "tokens_per_s": g.get("serving/tokens_per_s"),
                    "draining": bool(g.get("serving/draining")),
                    "last_ok_age_s": (
                        round(now - r.last_ok_t, 3) if r.last_ok_t else None
                    ),
                })
        rows.sort(key=lambda row: (
            not row["placeable"],
            row["load_score"] if row["load_score"] is not None else float("inf"),
            row["replica"],
        ))
        if include_unplaceable:
            return rows
        return [
            row for row in rows
            if row["placeable"]
            or (include_draining
                and (row["draining"] or row["state"] == DRAINING))
        ]

    def health(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else float(now)
        with self._lock:
            return {name: r.summary(now) for name, r in self.replicas.items()}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """One JSON-serializable control-plane snapshot (what
        ``write_snapshot`` persists and ``report``'s fleet section
        renders)."""
        now = self._clock() if now is None else float(now)
        return {
            "t_unix_s": round(now, 3),
            "polls": self.polls,
            "replicas": self.health(now),
            "placement": self.placement_view(include_unplaceable=True, now=now),
            "fleet": self.fleet_gauges(),
            "events": list(self.events[-64:]),
            "alerts": self.alerts.states_snapshot(),
        }

    def write_snapshot(self, directory: Optional[str] = None) -> Optional[str]:
        d = directory or self.log_dir
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "fleet.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh, indent=1)
        os.replace(tmp, path)
        return path

    def close(self):
        """Stop polling and join every scrape thread this collector
        started: none outlives the call (a scrape in flight ends within its
        fetch timeout)."""
        self.stop()
        pools, self._retired = self._retired + [self._executor], []
        self._executor = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        if self.log_dir:
            try:
                self.write_snapshot()
            except OSError:
                pass
        self.alerts.close()
        if self._events_fh is not None:
            try:
                self._events_fh.close()
            except OSError:
                pass
            self._events_fh = None


def _stat(path: str):
    try:
        return os.stat(path)
    except OSError:
        return None


def _replica_name(target: str, index: int) -> str:
    """Default replica naming: ``host:port`` for URLs, basename for
    dirs, ``r<i>`` as the last resort."""
    if target.startswith(("http://", "https://")):
        body = target.split("://", 1)[1]
        host = body.split("/", 1)[0]
        if host:
            return host
    base = os.path.basename(target.rstrip("/"))
    return base or f"r{index}"


def load_fleet(target: str) -> dict:
    """Offline read of a collector's artifacts under ``target``:
    ``fleet.json`` (replica table, placement, merged gauges, alert
    states) plus the full ``fleet-events.jsonl`` transition log — the
    ``report`` fleet section's data source."""
    out: dict = {}
    path = os.path.join(target, "fleet.json") if os.path.isdir(target) else target
    try:
        with open(path) as fh:
            out = json.load(fh)
    except (OSError, ValueError):
        out = {}
    d = target if os.path.isdir(target) else os.path.dirname(target)
    from .artifacts import read_jsonl

    events = [evt for evt in read_jsonl(d, "fleet-events.jsonl")
              if evt.get("replica")]
    if events:
        events.sort(key=lambda e: e.get("t_unix_s", 0))
        out["events"] = events
    return out
