"""Cross-plane incident reconstruction: one alert, one ordered story.

An own copy of the reference's ``accelerate_tpu/telemetry/incidents.py``.

When a rule fires, the evidence is scattered across artifact families
that each answer one question: ``alerts-*.jsonl`` (what breached, when),
``fleet-events.jsonl`` (which replicas changed health state),
``router-decisions.jsonl`` (where requests were placed and who was
excluded), ``autoscale-decisions.jsonl`` (what the actuator did about
it), ``canary-results.jsonl`` (whether correctness held), the
``flightrec-host*-*.json`` debug bundles the firing edge dumped, and the
request records whose exemplars the alert named. This module joins all
of them around each alert's pending→firing→resolved window into one
time-ordered, source-tagged timeline, and decomposes the culprit
exemplar requests into latency stages — the router-joined TTFT
waterfall when router records exist, or a replica-only breakdown
(``replica_queue → kv_restore → prefill → decode``) when only the
replica's own record is available.

``reconstruct_incidents(dir)`` is the one entry point; it runs offline
from any artifact directory (or a live FleetCollector's ``log_dir`` —
same files) and reads every rotated generation through
``telemetry/artifacts.py``. ``python -m
accelerate_tpu_torch.commands.incident`` renders its output.

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): incidents are reconstructed wherever the log files land.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Optional

from .alerts import FIRING, PENDING, RESOLVED, load_alerts
from .artifacts import read_jsonl
from .waterfall import load_router_requests, waterfall_stages

# how far beyond the alert window each plane is scanned: decisions and
# health flaps that *caused* a breach precede the pending edge
DEFAULT_PAD_S = 30.0
# a storm emits thousands of placement decisions; the timeline keeps the
# causally interesting ones (exemplar-linked, exclusions, failures) and
# summarizes the rest
MAX_EVENTS_PER_INCIDENT = 200
MAX_EXEMPLAR_REQUESTS = 8

# the replica-only stage order (no router in the artifact dir): the
# replica's own durations partition submit→finish exactly
REPLICA_STAGES = ("replica_queue", "kv_restore", "prefill", "decode")


def load_replica_requests(target) -> list:
    """Every replica-side request record (``requests-host*.jsonl``)
    under ``target``, across rotated generations."""
    if isinstance(target, str) and not os.path.isdir(target):
        return [r for r in read_jsonl(target) if r.get("request_id") is not None]
    return [r for r in read_jsonl(target, "requests-host*.jsonl")
            if r.get("request_id") is not None]


def load_flight_dumps(target: str) -> list:
    """Headers of every flight-recorder bundle under ``target`` —
    ``{t_unix_s, reason, path, inflight, events}`` per dump (the bundle
    body stays on disk; the timeline links, it does not inline)."""
    if not os.path.isdir(target):
        return []
    out = []
    for path in sorted(_glob.glob(os.path.join(target, "flightrec-host*-*.json"))):
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        out.append({
            "t_unix_s": doc.get("time_unix_s"),
            "reason": doc.get("reason"),
            "path": path,
            "inflight": len(doc.get("inflight_requests") or []),
            "ring_events": len(doc.get("events") or []),
        })
    return out


def replica_stage_breakdown(rec: dict) -> Optional[dict]:
    """Stage decomposition from one replica-side request record alone:
    ``queue_wait_ms`` → replica_queue, ``kv_restore_ms`` → kv_restore,
    the rest of TTFT → prefill, and ``total_ms - ttft_ms`` → decode.
    The stages sum to the record's ``total_ms`` exactly; None when the
    record never reached a first token (a shed has no breakdown)."""
    ttft = rec.get("ttft_ms")
    if ttft is None:
        return None
    ttft = float(ttft)
    rq = min(float(rec.get("queue_wait_ms") or 0.0), ttft)
    kr = min(float(rec.get("kv_restore_ms") or 0.0), max(0.0, ttft - rq))
    pf = max(0.0, ttft - rq - kr)
    total = rec.get("total_ms")
    decode = max(0.0, float(total) - ttft) if total is not None else 0.0
    stages = {
        "replica_queue": round(rq, 3),
        "kv_restore": round(kr, 3),
        "prefill": round(pf, 3),
        "decode": round(decode, 3),
    }
    top = max(REPLICA_STAGES, key=lambda s: stages[s])
    row = {
        "request_id": rec.get("request_id"),
        "replica": rec.get("replica"),
        "ttft_ms": round(ttft, 3),
        "total_ms": total,
        "tokens": rec.get("tokens"),
        "stages": stages,
        "top_stage": top,
        "joined": False,
        "source": "replica",
    }
    if rec.get("itl_max_ms") is not None:
        row["itl_max_ms"] = rec["itl_max_ms"]
    if rec.get("finish_reason"):
        row["finish_reason"] = rec["finish_reason"]
    return row


# -- alert windows -----------------------------------------------------------


def incident_windows(alert_events: list) -> list:
    """Group a time-ordered alert event stream into per-rule incident
    windows. A window opens at the pending edge (or straight at firing
    for zero-hold rules), collects every firing re-edge, and closes at
    resolved. Pending episodes that never fired are dropped unless they
    are the rule's live tail (still building toward a fire)."""
    open_by_rule: dict = {}
    windows = []
    for evt in sorted(alert_events, key=lambda e: e.get("t_unix_s", 0)):
        rule, state = evt.get("rule"), evt.get("state")
        t = evt.get("t_unix_s")
        if not rule or state not in (PENDING, FIRING, RESOLVED) or t is None:
            continue
        w = open_by_rule.get(rule)
        if w is None:
            if state == RESOLVED:
                continue  # resolution of a window the log rotated away
            w = open_by_rule[rule] = {
                "rule": rule,
                "severity": evt.get("severity"),
                "description": evt.get("description") or "",
                "start_t": t,
                "fired_t": None,
                "resolved_t": None,
                "peak_value": None,
                "exemplars": [],
                "alert_events": [],
            }
        w["alert_events"].append(evt)
        v = evt.get("value")
        if isinstance(v, (int, float)) and (
            w["peak_value"] is None or v > w["peak_value"]
        ):
            w["peak_value"] = v
        if state == FIRING:
            if w["fired_t"] is None:
                w["fired_t"] = t
            for rid in evt.get("exemplars") or []:
                if rid not in w["exemplars"]:
                    w["exemplars"].append(rid)
        elif state == RESOLVED:
            w["resolved_t"] = t
            windows.append(open_by_rule.pop(rule))
    # live tails: still firing (open incident) or still pending
    windows.extend(open_by_rule.values())
    out = []
    for w in windows:
        if w["fired_t"] is None and w["resolved_t"] is not None:
            continue  # pending that silently cleared: not an incident
        if w["resolved_t"] is not None:
            w["state"] = "resolved"
            w["duration_s"] = round(w["resolved_t"] - w["fired_t"], 3)
        elif w["fired_t"] is not None:
            w["state"] = "firing"
            w["duration_s"] = None
        else:
            w["state"] = "pending"
            w["duration_s"] = None
        w["end_t"] = w["resolved_t"] if w["resolved_t"] is not None else (
            w["alert_events"][-1]["t_unix_s"] if w["alert_events"] else w["start_t"]
        )
        out.append(w)
    out.sort(key=lambda w: (w["start_t"], w["rule"]))
    for i, w in enumerate(out):
        w["index"] = i
    return out


# -- the correlator ----------------------------------------------------------


def _evt(t, source: str, kind: str, detail: str, **extra) -> dict:
    e = {"t_unix_s": t, "source": source, "kind": kind, "detail": detail}
    e.update(extra)
    return e


def _fmt_ms(v) -> str:
    try:
        return f"{float(v):.1f}ms"
    except (TypeError, ValueError):
        return "?"


def reconstruct_incidents(target: str, pad_s: float = DEFAULT_PAD_S,
                          max_exemplars: int = MAX_EXEMPLAR_REQUESTS) -> list:
    """Rebuild every incident under ``target`` (a telemetry artifact dir
    or a FleetCollector log_dir — the same files): for each alert
    window, one time-ordered, source-tagged event timeline plus the
    stage-decomposed exemplar requests the alert named."""
    windows = incident_windows(load_alerts(target).get("events") or [])
    if not windows:
        return []
    is_dir = os.path.isdir(target)
    fleet_events = [e for e in read_jsonl(target, "fleet-events.jsonl")
                    if e.get("replica") and e.get("to")] if is_dir else []
    decisions = read_jsonl(target, "router-decisions.jsonl") if is_dir else []
    canary = []
    autoscale = []
    flights = []
    router_recs = []
    replica_recs = []
    if is_dir:
        from .canary import load_canary
        from ..serving.autoscaler import load_autoscale_decisions

        canary = load_canary(target)
        autoscale = load_autoscale_decisions(target)
        flights = load_flight_dumps(target)
        router_recs = load_router_requests(target)
        replica_recs = load_replica_requests(target)
    router_by_id: dict = {}
    for rec in router_recs:
        router_by_id[str(rec.get("request_id"))] = rec
    replica_by_id: dict = {}
    for rec in replica_recs:
        replica_by_id.setdefault(str(rec.get("request_id")), []).append(rec)

    incidents = []
    for w in windows:
        t0 = w["start_t"] - pad_s
        t1 = w["end_t"] + pad_s
        exemplars = list(w["exemplars"])[:max_exemplars]
        exemplar_set = set(str(r) for r in exemplars)
        events = []
        for evt in w["alert_events"]:
            events.append(_evt(
                evt["t_unix_s"], "alert", evt["state"],
                f'{evt["rule"]} {evt["state"]}'
                + (f' (value={evt["value"]:.4g})'
                   if isinstance(evt.get("value"), (int, float)) else "")
                + (f' exemplars={",".join(str(x) for x in evt["exemplars"])}'
                   if evt.get("exemplars") else ""),
                value=evt.get("value"),
            ))
        for evt in fleet_events:
            t = evt.get("t_unix_s")
            if t is None or not (t0 <= t <= t1):
                continue
            events.append(_evt(
                t, "fleet", "health",
                f'replica {evt["replica"]}: {evt.get("from")} -> {evt["to"]}'
                f' ({evt.get("reason") or "?"})',
                replica=evt["replica"], to=evt["to"],
            ))
        in_window = [d for d in decisions
                     if d.get("t_unix_s") is not None
                     and t0 <= d["t_unix_s"] <= t1]
        shown = 0
        for d in in_window:
            interesting = (str(d.get("request_id")) in exemplar_set
                           or d.get("excluded") or d.get("hop", 0))
            if not interesting:
                continue
            events.append(_evt(
                d["t_unix_s"], "router", "placement",
                f'request {d.get("request_id")} hop {d.get("hop", 0)} -> '
                f'{d.get("chosen")} ({d.get("reason") or "?"})'
                + (f' excluded={",".join(d["excluded"])}'
                   if d.get("excluded") else ""),
                request_id=d.get("request_id"),
            ))
            shown += 1
        if len(in_window) > shown:
            events.append(_evt(
                in_window[0]["t_unix_s"], "router", "placement_summary",
                f'{len(in_window)} placement decisions in window '
                f'({len(in_window) - shown} routine ones folded)',
                count=len(in_window),
            ))
        for d in autoscale:
            t = d.get("t_unix_s")
            if t is None or not (t0 <= t <= t1):
                continue
            events.append(_evt(
                t, "autoscale", str(d.get("action")),
                f'autoscale {d.get("action")}: {d.get("reason") or "?"}'
                + (f' (fleet {d.get("fleet_size")})'
                   if d.get("fleet_size") is not None else ""),
            ))
        for probe in canary:
            t = probe.get("t_unix_s")
            if t is None or not (t0 <= t <= t1) or probe.get("passed"):
                continue
            events.append(_evt(
                t, "canary", "probe_failed",
                f'canary {probe.get("request_id")} FAILED on '
                f'{probe.get("replica") or "?"}: {probe.get("reason") or "?"}',
                replica=probe.get("replica"),
            ))
        for dump in flights:
            t = dump.get("t_unix_s")
            if t is None or not (t0 <= t <= t1):
                continue
            events.append(_evt(
                t, "flight", "dump",
                f'flight bundle {os.path.basename(dump["path"])} '
                f'({dump.get("reason")}; {dump["inflight"]} in flight)',
                path=dump["path"],
            ))
        exemplar_rows = []
        for rid in exemplars:
            rid = str(rid)
            row = None
            rrec = router_by_id.get(rid)
            reps = replica_by_id.get(rid) or []
            if rrec is not None:
                row = waterfall_stages(rrec, reps[-1] if reps else None)
            if row is None and reps:
                row = replica_stage_breakdown(reps[-1])
            if row is None:
                row = {"request_id": rid, "stages": {}, "top_stage": None,
                       "joined": False, "missing": True}
            exemplar_rows.append(row)
            if not row.get("missing"):
                t = None
                if reps:
                    t = reps[-1].get("finish_unix_s") or reps[-1].get("submit_unix_s")
                if t is None and rrec is not None:
                    t = rrec.get("submit_unix_s")
                stages = row.get("stages") or {}
                top = row.get("top_stage")
                events.append(_evt(
                    t if t is not None else w["fired_t"] or w["start_t"],
                    "request", "exemplar",
                    f'exemplar {rid}: '
                    + ", ".join(f"{s}={_fmt_ms(v)}" for s, v in stages.items()
                                if v)
                    + (f" — {top} dominates" if top else ""),
                    request_id=rid, top_stage=top,
                ))
        events.sort(key=lambda e: (e["t_unix_s"] if e["t_unix_s"] is not None
                                   else 0.0))
        truncated = max(0, len(events) - MAX_EVENTS_PER_INCIDENT)
        if truncated:
            events = events[:MAX_EVENTS_PER_INCIDENT]
        incident = {
            "index": w["index"],
            "rule": w["rule"],
            "severity": w["severity"],
            "description": w["description"],
            "state": w["state"],
            "start_t": w["start_t"],
            "fired_t": w["fired_t"],
            "resolved_t": w["resolved_t"],
            "duration_s": w["duration_s"],
            "peak_value": w["peak_value"],
            "exemplars": exemplars,
            "exemplar_requests": exemplar_rows,
            "events": events,
            "events_truncated": truncated,
        }
        incidents.append(incident)
    return incidents


def summarize_incidents(incidents: list) -> dict:
    """Flat incident gauges: count, still-open count, mean resolved
    duration, and per-rule counts. (The reference also feeds them to its
    ``report --diff``, ROADMAP queue 1 item 11 in the port.)"""
    durations = [i["duration_s"] for i in incidents
                 if i.get("duration_s") is not None]
    by_rule: dict = {}
    for i in incidents:
        by_rule[i["rule"]] = by_rule.get(i["rule"], 0) + 1
    out = {
        "count": len(incidents),
        "open": sum(1 for i in incidents if i.get("state") != "resolved"),
        "by_rule": by_rule,
    }
    if durations:
        out["mean_duration_s"] = round(sum(durations) / len(durations), 3)
    return out
