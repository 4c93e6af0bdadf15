"""Client-observed latency waterfall: decompose one request's TTFT.

An own copy of the reference's ``accelerate_tpu/telemetry/waterfall.py``.

A p99 TTFT regression at the router is an aggregate; fixing it needs a
*stage*: did the request wait in the router queue, burn retries against
a dead replica, crawl the wire, sit in the replica's admission queue, or
pay a slow prefill? This module joins the router's hop records (each hop
stamped with ``place_start_unix_s``/``connect_unix_s``/
``first_token_unix_s`` on the router's own clock — ``serving/router.py``)
with the replica-side request records (``requests-host<i>.jsonl``,
``telemetry/requests.py``) and partitions the client-observed
end-to-end TTFT into:

    router_queue → placement → retry_backoff → transport →
    replica_queue → prefill

**The stages sum to the client-observed TTFT exactly** (the tier-1
waterfall test asserts it): every router-side stage is a difference of
timestamps on ONE clock, the replica-side stages are the replica's own
*durations* (``queue_wait_ms``, ``ttft_ms`` — skew-free by
construction, the same reason the trace merge anchors on each
host's ``epoch_unix_s`` instead of trusting wall clocks to agree), and
``transport`` is the residual of the winning hop's connect→first-token
wall after the replica's durations are subtracted — so replica clock
skew can never make the table lie about the total, only shift weight
between transport and the replica stages (and a skew large enough to
overrun the hop wall is scaled back into it, never summed past it).

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): the waterfall is computed wherever the log files land.
"""

from __future__ import annotations

import os
from typing import Optional

from .histograms import StreamingHistogram

# stage order IS the request's causal order; renderers keep it.
# kv_restore is the tiered-KV pull (host/disk/peer → HBM) a warm
# session-resume pays instead of a cold prefill — carved out of the
# replica's TTFT so a tier regression shows up as its own row
STAGES = ("router_queue", "placement", "retry_backoff", "transport",
          "replica_queue", "kv_restore", "prefill")


def load_router_requests(target) -> list:
    """Every router request record under the dir(s)/file(s) —
    ``router-requests*.jsonl`` written by a ``Router(log_dir=...)``."""
    from .artifacts import artifact_files, iter_jsonl

    targets = [target] if isinstance(target, str) else list(target)
    paths = []
    for t in targets:
        if os.path.isdir(t):
            paths.extend(artifact_files(t, "router-requests*.jsonl"))
        elif os.path.basename(t).startswith("router-requests"):
            paths.extend(artifact_files(t))
    out = [rec for rec in iter_jsonl(paths)
           if rec.get("request_id") is not None]
    out.sort(key=lambda r: r.get("submit_unix_s", 0))
    return out


def _winning_hop(hops: list) -> Optional[dict]:
    """The hop that delivered the first token (error-free hops only; a
    re-queued request's failed hops are the retry_backoff stage, not the
    serving stage)."""
    for hop in hops:
        if "error" not in hop and hop.get("first_token_unix_s") is not None:
            return hop
    for hop in reversed(hops):
        if "error" not in hop:
            return hop
    return None


def _ms(a, b) -> Optional[float]:
    if a is None or b is None:
        return None
    return max(0.0, (b - a) * 1e3)


def waterfall_stages(router_rec: dict, replica_rec: Optional[dict] = None) -> Optional[dict]:
    """One request's stage decomposition, or None when the router record
    carries no timing stamps (an uninstrumented router, or a request
    that shed before placement).

    ``router_rec`` is one ``router-requests*.jsonl`` record;
    ``replica_rec`` the winning replica's ``requests-host*.jsonl`` record
    for the same ``request_id`` (optional — without it the whole
    connect→first-token wall stays in ``transport``)."""
    hops = [h for h in (router_rec.get("hops") or []) if "t_unix_s" in h]
    submit = router_rec.get("submit_unix_s")
    win = _winning_hop(hops)
    if win is None or submit is None:
        return None
    first_token = win.get("first_token_unix_s")
    if first_token is None:
        return None
    p0 = hops[0].get("place_start_unix_s")
    stages = dict.fromkeys(STAGES, 0.0)
    stages["router_queue"] = _ms(submit, p0) or 0.0
    # placement walls of every hop up to and including the winner; the
    # rest of submit→connect (failed-hop transport walls + backoff
    # sleeps + health re-polls) is the retry_backoff stage
    placement = 0.0
    for hop in hops:
        w = _ms(hop.get("place_start_unix_s"), hop.get("connect_unix_s"))
        if w is not None:
            placement += w
        if hop is win:
            break
    stages["placement"] = placement
    span_to_connect = _ms(p0, win.get("connect_unix_s"))
    if span_to_connect is not None:
        stages["retry_backoff"] = max(0.0, span_to_connect - placement)
    # inside the winning hop: transport + replica queue + prefill
    inside = _ms(win.get("connect_unix_s"), first_token) or 0.0
    rq = kr = pf = 0.0
    if replica_rec is not None:
        rq = float(replica_rec.get("queue_wait_ms") or 0.0)
        kr = float(replica_rec.get("kv_restore_ms") or 0.0)
        ttft = replica_rec.get("ttft_ms")
        # the replica's TTFT contains the tier restore (it runs inside
        # admission); carve it out so prefill means compute
        pf = max(0.0, float(ttft) - rq - kr) if ttft is not None else 0.0
        if rq + kr + pf > inside and (rq + kr + pf) > 0:
            # replica durations overran the hop wall (coarse clocks /
            # sub-ms rounding): scale them into it so the stages still
            # sum — the split shifts, the total never lies
            scale = inside / (rq + kr + pf)
            rq *= scale
            kr *= scale
            pf *= scale
    stages["replica_queue"] = rq
    stages["kv_restore"] = kr
    stages["prefill"] = pf
    stages["transport"] = max(0.0, inside - rq - kr - pf)
    stages = {k: round(v, 3) for k, v in stages.items()}
    e2e = round(sum(stages.values()), 3)
    top = max(STAGES, key=lambda s: stages[s])
    row = {
        "request_id": router_rec.get("request_id"),
        "replica": win.get("replica"),
        "requeues": sum(1 for h in hops if "error" in h),
        "e2e_ttft_ms": e2e,
        "client_ttft_ms": router_rec.get("ttft_ms"),
        "stages": stages,
        "top_stage": top,
        "joined": replica_rec is not None,
    }
    if replica_rec is not None and replica_rec.get("prefill_kernel"):
        # annotate the prefill stage with which path ran it ("ragged" =
        # the packed flash prefill kernel, "dense" = bucketed chunks), so
        # a prefill-bound waterfall says whether the kernel was even on
        row["prefill_kernel"] = str(replica_rec["prefill_kernel"])
    return row


def build_waterfalls(router_records: list, replica_records: list) -> list:
    """Join router records with replica request records by
    ``request_id`` (and the winning hop's replica identity when a
    re-queued request left one record per replica) and decompose each.
    Records that never reached a first token are skipped — a shed has no
    waterfall."""
    by_id: dict = {}
    for rec in replica_records or []:
        by_id.setdefault(str(rec.get("request_id")), []).append(rec)
    rows = []
    for rrec in router_records:
        candidates = by_id.get(str(rrec.get("request_id"))) or []
        win = _winning_hop([h for h in (rrec.get("hops") or []) if "t_unix_s" in h])
        replica_rec = None
        if candidates:
            if win is not None and win.get("replica") is not None:
                matched = [c for c in candidates
                           if str(c.get("replica")) == str(win["replica"])]
                candidates = matched or candidates
            replica_rec = candidates[-1]
        row = waterfall_stages(rrec, replica_rec)
        if row is not None:
            rows.append(row)
    return rows


def summarize_waterfall(rows: list) -> dict:
    """Aggregate per-stage percentiles over waterfall rows: ``{requests,
    joined, stages: {stage: {p50_ms, p95_ms, p99_ms, mean_ms,
    share}}, top_stages: {stage: count}}``. ``share`` is the stage's
    fraction of total summed latency — where the fleet's TTFT actually
    goes, not just where one bad request went."""
    hists = {s: StreamingHistogram() for s in STAGES}
    totals = dict.fromkeys(STAGES, 0.0)
    top: dict = {}
    pk_counts: dict = {}
    e2e = StreamingHistogram()
    for row in rows:
        for s in STAGES:
            v = row["stages"].get(s) or 0.0
            hists[s].add(v / 1e3)
            totals[s] += v
        e2e.add((row.get("e2e_ttft_ms") or 0.0) / 1e3)
        top[row["top_stage"]] = top.get(row["top_stage"], 0) + 1
        pk = row.get("prefill_kernel")
        if pk:
            pk_counts[pk] = pk_counts.get(pk, 0) + 1
    grand = sum(totals.values())
    stages = {}
    for s in STAGES:
        snap = hists[s].snapshot()
        if not snap:
            continue
        stages[s] = {
            "p50_ms": round(snap["p50_s"] * 1e3, 3),
            "p95_ms": round(snap["p95_s"] * 1e3, 3),
            "p99_ms": round(snap["p99_s"] * 1e3, 3),
            "mean_ms": round(snap["mean_s"] * 1e3, 3),
            "share": round(totals[s] / grand, 4) if grand > 0 else 0.0,
        }
    out = {"requests": len(rows),
           "joined": sum(1 for r in rows if r.get("joined")),
           "stages": stages, "top_stages": top}
    if pk_counts:
        # kernel-vs-dense split over the joined requests: a prefill-heavy
        # share with "dense" dominating here is the tuning signal
        out["prefill_kernel"] = pk_counts
    snap = e2e.snapshot()
    if snap:
        out["e2e_ttft_p50_ms"] = round(snap["p50_s"] * 1e3, 3)
        out["e2e_ttft_p99_ms"] = round(snap["p99_s"] * 1e3, 3)
    return out


def stage_table(agg: dict, include_mean: bool = False) -> list:
    """``[header, *rows]`` for the per-stage percentile table (one table
    for every renderer, so a new stage or column shows up in all)."""
    header = ("stage", "p50_ms", "p95_ms", "p99_ms")
    header += (("mean_ms",) if include_mean else ()) + ("share",)
    rows = [header]
    stages = agg.get("stages") or {}
    for s in STAGES:
        d = stages.get(s)
        if not d:
            continue
        row = (s, d["p50_ms"], d["p95_ms"], d["p99_ms"])
        row += ((d["mean_ms"],) if include_mean else ())
        rows.append(row + (f"{100 * d['share']:.1f}%",))
    return rows
