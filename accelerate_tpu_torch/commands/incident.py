"""``incident`` — reconstruct incidents from artifacts.

An own copy of the reference's ``accelerate_tpu/commands/incident.py``,
run as ``python -m accelerate_tpu_torch.commands.incident``.

The on-call path after an alert: the fleet's alert log shows the rule
firing and names exemplar requests; this command rebuilds the whole story —
``incident list <dir>`` enumerates every pending→firing→resolved window
found in the alert logs, ``incident show <dir>`` (``--index N`` /
``--rule NAME``) prints one incident's cross-plane timeline (alert
edges, replica health flaps, placement/autoscale decisions, canary
failures, flight dumps) and the stage-decomposed exemplar requests, and
``--json`` emits the raw reconstruction for tooling. Works offline from
any telemetry artifact dir or a live FleetCollector log_dir; rotated
artifact generations are read transparently.

Plain stdlib, no torch and no numpy: incidents are reconstructed
wherever the log files land.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _ts(t) -> str:
    if t is None:
        return "?"
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(t)))
    except (TypeError, ValueError, OverflowError):
        return "?"


def _fmt_dur(s) -> str:
    if s is None:
        return "open"
    s = float(s)
    if s < 120:
        return f"{s:.1f}s"
    return f"{s / 60:.1f}m"


def format_incident_line(inc: dict) -> str:
    ex = ",".join(str(r) for r in (inc.get("exemplars") or [])[:3]) or "-"
    return (f'#{inc["index"]}  {inc["rule"]:<22} {inc.get("state", "?"):<9}'
            f' fired={_ts(inc.get("fired_t"))}'
            f' dur={_fmt_dur(inc.get("duration_s")):<7}'
            f' events={len(inc.get("events") or []):<4} exemplars={ex}')


def format_incident(inc: dict) -> str:
    """One incident's full render: header, ordered cross-plane timeline
    (source-tagged), and the exemplar stage breakdowns."""
    lines = [
        f'incident #{inc["index"]}: {inc["rule"]} '
        f'[{inc.get("severity") or "?"}] — {inc.get("state")}',
    ]
    if inc.get("description"):
        lines.append(f'  {inc["description"]}')
    lines.append(
        f'  window: start={_ts(inc.get("start_t"))} '
        f'fired={_ts(inc.get("fired_t"))} '
        f'resolved={_ts(inc.get("resolved_t"))} '
        f'({_fmt_dur(inc.get("duration_s"))})'
    )
    if inc.get("peak_value") is not None:
        lines.append(f'  peak value: {inc["peak_value"]:.4g}')
    lines.append("")
    lines.append("  timeline:")
    for evt in inc.get("events") or []:
        lines.append(
            f'    {_ts(evt.get("t_unix_s"))}  [{evt.get("source", "?"):<9}] '
            f'{evt.get("detail", "")}'
        )
    if inc.get("events_truncated"):
        lines.append(f'    ... {inc["events_truncated"]} more events folded')
    rows = inc.get("exemplar_requests") or []
    if rows:
        lines.append("")
        lines.append("  exemplar requests:")
        for row in rows:
            if row.get("missing"):
                lines.append(
                    f'    {row["request_id"]}: no request record in this dir '
                    "(rotated away, or logged on another host)"
                )
                continue
            stages = row.get("stages") or {}
            parts = ", ".join(f"{s}={v:.1f}ms" for s, v in stages.items() if v)
            top = row.get("top_stage")
            lines.append(
                f'    {row["request_id"]} '
                f'(replica {row.get("replica") or "?"}): {parts}'
                + (f"  <- {top} dominates" if top else "")
            )
    return "\n".join(lines)


def incident_command(args) -> int:
    from ..telemetry.incidents import reconstruct_incidents, summarize_incidents

    incidents = reconstruct_incidents(args.target, pad_s=args.pad_s)
    if args.json:
        print(json.dumps({"incidents": incidents,
                          "summary": summarize_incidents(incidents)}))
        return 0
    if not incidents:
        print(f"no incidents found under {args.target} — no alert ever "
              "reached firing in alerts-*.jsonl",
              file=sys.stderr)
        return 1
    if args.action == "list":
        for inc in incidents:
            print(format_incident_line(inc))
        s = summarize_incidents(incidents)
        dur = (f', mean duration {s["mean_duration_s"]:.1f}s'
               if s.get("mean_duration_s") is not None else "")
        print(f'{s["count"]} incident(s), {s["open"]} open{dur}')
        return 0
    # show
    chosen = incidents
    if args.rule:
        chosen = [i for i in incidents if i["rule"] == args.rule]
        if not chosen:
            print(f'no incident for rule {args.rule!r}; rules seen: '
                  f'{sorted(set(i["rule"] for i in incidents))}',
                  file=sys.stderr)
            return 1
    if args.index is not None:
        chosen = [i for i in incidents if i["index"] == args.index]
        if not chosen:
            print(f"no incident #{args.index} (have 0..{len(incidents) - 1})",
                  file=sys.stderr)
            return 1
    elif not args.rule:
        chosen = [incidents[-1]]  # default: the most recent incident
    print("\n\n".join(format_incident(i) for i in chosen))
    return 0


def register(parser):
    """Add the ``list`` / ``show`` action and its flags to ``parser``."""
    parser.add_argument("action", choices=("list", "show"),
                        help="list all incident windows, or show one timeline")
    parser.add_argument("target",
                        help="telemetry artifact dir (or FleetCollector "
                             "log_dir) holding alerts-*.jsonl")
    parser.add_argument("--index", type=int, default=None,
                        help="incident number from `incident list` "
                             "(default: most recent)")
    parser.add_argument("--rule", default=None,
                        help="show every incident of one alert rule")
    parser.add_argument("--pad-s", type=float, default=30.0,
                        help="seconds scanned beyond the alert window on "
                             "each side (default 30)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.set_defaults(func=incident_command)
    return parser


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.incident",
        description="Reconstruct incidents from a telemetry dir: per-alert "
                    "cross-plane timeline (health flaps, placements, autoscale, "
                    "canary, flight dumps) + exemplar request stage breakdowns",
    )
    register(parser)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
