"""SLO scorecard: grade a load-generator run against its targets.

An own copy of the reference's ``accelerate_tpu/telemetry/scorecard.py``.

Joins the offered-load record ``serving/loadgen.py`` emits with the
server-side request artifacts (``requests-host*.jsonl``) into one
judgement: **attainment** (the fraction of finished requests meeting the
TTFT/ITL targets — per tenant, and fleet-wide via the exact log-bucket
histogram merges the fleet plane uses, never an average of per-tenant
percentiles), **goodput** (finished tokens/s per chip — tokens that shed
or cancelled requests streamed before dying do not count), and the
**conservation ledger**: every offered request lands in exactly one of
finished/shed/cancelled/in-flight, and the totals must reconcile against
the engine's own ``serving/requests_terminal`` when the drill drained.

Every rate in this module divides by an observed duration; a run graded
at (or near) zero elapsed wall time reports **0, never inf/NaN** — the
same zero-span guard ``usage.UsageAccountant.rates`` applies.

The saturation sweep (``loadtest sweep``) builds one
scorecard per arrival rate; :func:`find_knee` marks where throughput
stops buying latency — the first rate whose p99 TTFT blows past the
low-rate baseline or whose attainment falls through the floor.

Plain stdlib, no torch and no numpy (a CPU test imports it with both
blocked): scorecards render on log-only machines, like every other
telemetry reader. The reference also renders a scorecard as a section of
its ``report`` command and grades it under ``report --diff``; that
command is ROADMAP queue 1 item 11 in the port.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

from .histograms import StreamingHistogram, percentile_keys

#: durations at or below this are "no time has passed": rates report 0
EPS_SPAN_S = 1e-6

DEFAULT_TTFT_SLO_MS = 1000.0
DEFAULT_ITL_SLO_MS = 100.0


def safe_rate(numerator: float, span_s: float) -> float:
    """``numerator / span_s`` with the zero/near-zero-span guard: the
    first window after start (or an instant replay) grades as 0, it does
    not raise or report inf."""
    if span_s is None or span_s <= EPS_SPAN_S:
        return 0.0
    return numerator / span_s


def _req_itl_p95_ms(rec: dict) -> Optional[float]:
    itl = rec.get("itl_ms")
    if not itl:
        return None
    xs = sorted(itl)
    return xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))]


def _load_server_records(telemetry_dir: str) -> dict:
    out = {}
    for path in sorted(glob.glob(
            os.path.join(telemetry_dir, "requests-host*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn mid-write tail
                    rid = rec.get("request_id")
                    if rid is not None:
                        out[str(rid)] = rec
        except OSError:
            continue
    return out


def build_scorecard(result, *, ttft_slo_ms: Optional[float] = None,
                    itl_slo_ms: Optional[float] = None, chips: int = 1,
                    telemetry_dir: Optional[str] = None) -> dict:
    """Grade one :class:`~..serving.loadgen.LoadgenResult` (or its
    ``to_json()`` dict). SLO targets default to the workload spec's
    ``slo`` block. A finished request *attains* when its client-observed
    TTFT meets the TTFT target AND its per-request p95 ITL meets the ITL
    target (requests with no ITL samples — single-token outputs or an
    uninstrumented run — grade on TTFT alone)."""
    doc = result if isinstance(result, dict) else result.to_json()
    spec = doc.get("spec") or {}
    records = doc.get("records") or []
    wall_s = float(doc.get("wall_s") or 0.0)
    slo_spec = spec.get("slo") or {}
    ttft_slo = float(ttft_slo_ms if ttft_slo_ms is not None
                     else slo_spec.get("ttft_ms", DEFAULT_TTFT_SLO_MS))
    itl_slo = float(itl_slo_ms if itl_slo_ms is not None
                    else slo_spec.get("itl_ms", DEFAULT_ITL_SLO_MS))

    tenants: dict = {}
    fleet_ttft = StreamingHistogram()
    fleet_itl = StreamingHistogram()
    for rec in records:
        name = rec.get("tenant") or "default"
        t = tenants.setdefault(name, {
            "offered": 0, "finished": 0, "shed": 0, "cancelled": 0,
            "in_flight": 0, "tokens_out": 0, "attained": 0, "graded": 0,
            "ttft_hist": StreamingHistogram(),
            "itl_hist": StreamingHistogram(),
        })
        t["offered"] += 1
        outcome = rec.get("outcome")
        if outcome in ("finished", "shed", "cancelled"):
            t[outcome] += 1
        else:
            t["in_flight"] += 1
        t["tokens_out"] += int(rec.get("tokens_out") or 0)
        if outcome != "finished":
            continue
        ttft = rec.get("ttft_ms")
        if ttft is not None:
            t["ttft_hist"].add(ttft / 1e3)
        for gap in rec.get("itl_ms") or ():
            t["itl_hist"].add(gap / 1e3)
        if ttft is None:
            continue  # uninstrumented run: nothing to grade
        t["graded"] += 1
        itl95 = _req_itl_p95_ms(rec)
        if ttft <= ttft_slo and (itl95 is None or itl95 <= itl_slo):
            t["attained"] += 1

    counts = {"offered": 0, "finished": 0, "shed": 0, "cancelled": 0,
              "in_flight": 0, "tokens_out": 0}
    attained = graded = 0
    tenant_out = {}
    for name, t in sorted(tenants.items()):
        for k in counts:
            counts[k] += t[k]
        attained += t["attained"]
        graded += t["graded"]
        # the fleet view merges the per-tenant histograms EXACTLY (the
        # fleet plane's contract): fleet p99 is the quantile of the union of
        # samples, never an average of per-tenant p99s
        fleet_ttft.merge(t["ttft_hist"])
        fleet_itl.merge(t["itl_hist"])
        row = {k: t[k] for k in
               ("offered", "finished", "shed", "cancelled", "in_flight",
                "tokens_out")}
        row["slo_attainment_frac"] = (
            t["attained"] / t["graded"] if t["graded"] else 0.0
        )
        row["goodput_tokens_per_s"] = round(
            safe_rate(t["tokens_out"], wall_s), 3
        )
        row.update(percentile_keys("ttft", t["ttft_hist"]))
        row.update(percentile_keys("itl", t["itl_hist"]))
        tenant_out[name] = row

    fleet = dict(counts)
    fleet["slo_attainment_frac"] = attained / graded if graded else 0.0
    fleet["goodput_tokens_per_s"] = round(
        safe_rate(counts["tokens_out"], wall_s), 3
    )
    fleet["goodput_tokens_per_chip_s"] = round(
        safe_rate(counts["tokens_out"], wall_s) / max(1, int(chips)), 3
    )
    fleet.update(percentile_keys("ttft", fleet_ttft))
    fleet.update(percentile_keys("itl", fleet_itl))

    card = {
        "workload": spec.get("name", "?"),
        "seed": spec.get("seed"),
        "mode": spec.get("mode"),
        "target": doc.get("target"),
        "digest": doc.get("digest"),
        "wall_s": round(wall_s, 3),
        "chips": int(chips),
        "slo": {"ttft_ms": ttft_slo, "itl_ms": itl_slo},
        "counts": counts,
        "conserved": (
            counts["offered"] == counts["finished"] + counts["shed"]
            + counts["cancelled"] + counts["in_flight"]
        ),
        "tenants": tenant_out,
        "fleet": fleet,
    }
    if telemetry_dir:
        server = _load_server_records(telemetry_dir)
        joined = prefix_hit = 0
        restores = 0
        restore_ms = []
        tier_hits: dict = {}
        for rec in records:
            srv = server.get(str(rec.get("request_id")))
            if srv is None:
                continue
            joined += 1
            prefix_hit += int(srv.get("prefix_hit") or 0)
            tier = srv.get("kv_restore_tier")
            if tier:
                restores += 1
                tier_hits[tier] = tier_hits.get(tier, 0) + 1
                kr = srv.get("kv_restore_ms")
                if kr:
                    restore_ms.append(float(kr))
        card["join"] = {
            "server_records": len(server),
            "joined": joined,
            "prefix_hit_tokens": prefix_hit,
        }
        if restores:
            # tiered-KV restores joined from the request records: how
            # many admissions resumed from a lower tier and what the
            # pull cost client-side (serving/tiers.py)
            restore_ms.sort()
            card["join"]["kv_restores"] = restores
            card["join"]["kv_restore_tiers"] = tier_hits
            if restore_ms:
                card["join"]["kv_restore_ms_p50"] = round(
                    restore_ms[len(restore_ms) // 2], 3
                )
        # offered-vs-capacity: grade the run's offered token rate
        # against the capacity model's sustainable-rate estimate
        # (telemetry/capacity.py) as sampled into the timeline — across
        # hosts the key fleet-merges by SUM over live replicas, so this
        # is the whole fleet's ceiling
        try:
            from .timeline import load_timeline

            tl = load_timeline(telemetry_dir)
            cap = tl.last("serving/capacity_tokens_per_s")
        except (OSError, ValueError):
            cap = None
        if isinstance(cap, (int, float)) and cap > 0:
            offered_rate = safe_rate(counts["tokens_out"], wall_s)
            headroom = tl.last("serving/headroom_frac")
            card["capacity"] = {
                "capacity_tokens_per_s": round(float(cap), 3),
                "offered_tokens_per_s": round(offered_rate, 3),
                "utilization_frac": round(offered_rate / float(cap), 4),
            }
            if isinstance(headroom, (int, float)):
                card["capacity"]["headroom_frac"] = round(float(headroom), 4)
    return card


def write_scorecard(out_dir: str, card: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "loadtest-scorecard.json")
    with open(path, "w") as f:
        json.dump(card, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_scorecard(target: str) -> Optional[dict]:
    """Read ``loadtest-scorecard.json`` from a file or artifact dir."""
    path = target
    if os.path.isdir(target):
        path = os.path.join(target, "loadtest-scorecard.json")
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def format_scorecard(card: dict) -> list:
    """Human-readable scorecard lines (the ``loadtest`` CLI renders
    through this)."""
    fleet = card.get("fleet") or {}
    counts = card.get("counts") or {}
    slo = card.get("slo") or {}
    lines = [
        f"workload {card.get('workload', '?')} (seed {card.get('seed')}, "
        f"{card.get('mode', '?')} loop, target {card.get('target', '?')}) "
        f"over {card.get('wall_s', 0)}s:",
        "  offered {offered}  finished {finished}  shed {shed}  "
        "cancelled {cancelled}  in-flight {in_flight}".format(**{
            k: counts.get(k, 0) for k in
            ("offered", "finished", "shed", "cancelled", "in_flight")
        })
        + ("" if card.get("conserved", True) else "  [NOT CONSERVED]"),
        f"  SLO (ttft<={slo.get('ttft_ms')}ms, itl<={slo.get('itl_ms')}ms): "
        f"attainment {fleet.get('slo_attainment_frac', 0.0):.3f}  "
        f"goodput {fleet.get('goodput_tokens_per_s', 0.0)} tok/s "
        f"({fleet.get('goodput_tokens_per_chip_s', 0.0)} tok/s/chip)",
    ]
    if "ttft_p99_ms" in fleet:
        lines.append(
            f"  ttft p50/p99: {fleet.get('ttft_p50_ms')}/"
            f"{fleet.get('ttft_p99_ms')} ms"
            + (f"  itl p50/p99: {fleet.get('itl_p50_ms')}/"
               f"{fleet.get('itl_p99_ms')} ms" if "itl_p99_ms" in fleet
               else "")
        )
    tenants = card.get("tenants") or {}
    if len(tenants) > 1:
        for name, row in sorted(tenants.items()):
            lines.append(
                f"    {name}: offered {row.get('offered', 0)} "
                f"finished {row.get('finished', 0)} "
                f"attainment {row.get('slo_attainment_frac', 0.0):.3f} "
                f"ttft_p99 {row.get('ttft_p99_ms', '-')} ms"
            )
    join = card.get("join")
    if join:
        lines.append(
            f"  joined {join.get('joined', 0)}/{counts.get('offered', 0)} "
            f"with server records ({join.get('prefix_hit_tokens', 0)} "
            "prefix-hit tokens)"
        )
    cap = card.get("capacity")
    if cap:
        lines.append(
            f"  capacity: offered {cap.get('offered_tokens_per_s', 0.0)} / "
            f"{cap.get('capacity_tokens_per_s', 0.0)} tok/s sustainable "
            f"(utilization {cap.get('utilization_frac', 0.0):.3f}"
            + (f", headroom {cap['headroom_frac']:.3f}"
               if cap.get("headroom_frac") is not None else "")
            + ")"
        )
    return lines


# -- saturation sweep -------------------------------------------------------


def sweep_rows(cards: list) -> list:
    """Flatten ``[(rate_rps, card), ...]`` into the sweep table rows the
    CLI renders — the throughput-vs-p99 knee data."""
    rows = []
    for rate, card in cards:
        fleet = card.get("fleet") or {}
        rows.append({
            "rate_rps": rate,
            "tokens_per_s": fleet.get("goodput_tokens_per_s", 0.0),
            "ttft_p99_ms": fleet.get("ttft_p99_ms"),
            "slo_attainment_frac": round(
                fleet.get("slo_attainment_frac", 0.0), 4
            ),
            "finished": (card.get("counts") or {}).get("finished", 0),
            "shed": (card.get("counts") or {}).get("shed", 0),
        })
    return rows


def find_knee(rows: list, *, p99_factor: float = 2.0,
              attain_floor: float = 0.9) -> Optional[int]:
    """Index of the first sweep row past the saturation knee: p99 TTFT
    above ``p99_factor`` x the lowest-rate baseline, or attainment below
    ``attain_floor``. None when the sweep never saturates."""
    if not rows:
        return None
    base = next((r["ttft_p99_ms"] for r in rows
                 if r.get("ttft_p99_ms") is not None), None)
    for i, row in enumerate(rows):
        p99 = row.get("ttft_p99_ms")
        if base and p99 is not None and p99 > p99_factor * base:
            return i
        if row.get("slo_attainment_frac", 1.0) < attain_floor:
            return i
    return None
