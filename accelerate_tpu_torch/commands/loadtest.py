"""``loadtest`` — replayable load generation + SLO scorecard.

An own copy of the reference's ``accelerate_tpu/commands/loadtest.py``,
run as ``python -m accelerate_tpu_torch.commands.loadtest``. Three verbs
over one workload-spec JSON:

- ``loadtest run SPEC.json`` replays the spec's deterministic schedule
  against a target and prints the scorecard (text or ``--json``). The
  target is ``--url http://host:port`` (a live ReplicaServer or
  RouterServer — **no torch end to end**, the load box needs no
  accelerator stack) or, without ``--url``, the demo in-process engine:
  ``--config small_1b`` over seeded random weights on CUDA unless
  ``--device`` names another device (torch loads lazily; a CPU drill
  passes ``--device cpu --config tiny``).
- ``loadtest replay RESULT`` re-runs the spec embedded in a previous
  run's ``loadtest-offered.json`` and verifies the schedule digest
  matches — the determinism witness as a command.
- ``loadtest sweep SPEC.json --rates 8,16,32`` steps the open-loop
  arrival rate against a fresh demo engine per step and prints the
  throughput-vs-p99 table with the saturation knee marked.

``--out DIR`` writes ``loadtest-offered.json`` + ``loadtest-scorecard.json``
into DIR. (The reference's ``report`` command also reads them and grades
attainment under ``report --diff``; that command is ROADMAP queue 1 item
11 in the port.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def register(parser):
    """Add the ``run`` / ``replay`` / ``sweep`` verbs to ``parser``."""
    sub = parser.add_subparsers(dest="verb")

    def _common(p, spec_help):
        p.add_argument("spec", help=spec_help)
        p.add_argument("--url", default=None,
                       help="target a live ReplicaServer/RouterServer "
                            "base URL (no torch); default: in-process "
                            "demo engine")
        p.add_argument("--config", default="small_1b",
                       help="the demo engine's DecoderConfig (without --url)")
        p.add_argument("--device", default=None,
                       help="the demo engine's torch device (default: CUDA; "
                            "cpu runs the kernels' plain versions)")
        p.add_argument("--out", default=None, metavar="DIR",
                       help="write loadtest-offered.json + "
                            "loadtest-scorecard.json here")
        p.add_argument("--json", action="store_true")
        p.add_argument("--ttft-slo-ms", type=float, default=None)
        p.add_argument("--itl-slo-ms", type=float, default=None)
        p.add_argument("--chips", type=int, default=1,
                       help="chip count for goodput tokens/s-per-chip")
        p.add_argument("--time-scale", type=float, default=1.0,
                       help="stretch (>1) or compress (<1, 0 = as fast "
                            "as possible) the arrival schedule")
        p.add_argument("--timeout", type=float, default=120.0, metavar="S")
        p.add_argument("--no-instrument", action="store_true",
                       help="outcomes only, no per-token timing (the "
                            "zero-overhead witness baseline)")
        p.add_argument("--seed", type=int, default=None,
                       help="override the spec's seed")

    run = sub.add_parser("run", help="replay a workload spec, grade it")
    _common(run, "workload-spec JSON path")

    replay = sub.add_parser(
        "replay", help="re-run a previous result's embedded spec and "
                       "verify the schedule digest matches"
    )
    _common(replay, "previous loadtest-offered.json (or its dir)")

    sweep = sub.add_parser(
        "sweep", help="step the open-loop arrival rate, emit the "
                      "throughput-vs-p99 knee"
    )
    _common(sweep, "workload-spec JSON path")
    sweep.add_argument("--rates", default="4,8,16,32",
                       help="comma-separated arrival rates (requests/s)")

    parser.set_defaults(func=loadtest_command)
    return parser


def _demo_engine(args):
    """The in-process demo engine (torch loads here, lazily): the serve
    CLI's ``build_replica_engine``, shrunk for load drills (paged arena +
    a small prefix cache so the ghost gauges have evictions to simulate)."""
    from .serve import build_replica_engine

    ns = argparse.Namespace(
        config=args.config, device=args.device, max_seq_len=256, init_seed=0,
        num_slots=4, max_cache_len=160, prefill_chunks="16,64", page_size=16,
        temperature=0.0, top_k=None, steps_per_call=1, kv_cache_dtype=None,
        kv_host_entries=0, kv_disk_entries=0, kv_disk_dir=None, kv_peers=[],
        name="loadtest",
    )
    engine = build_replica_engine(ns)
    engine.warmup()
    engine.mark_steady()
    return engine


def _spec_from_args(args):
    from ..serving.loadgen import WorkloadSpec

    spec = WorkloadSpec.load(args.spec)
    if args.seed is not None:
        spec = dataclasses.replace(spec, seed=int(args.seed))
    return spec


def _run_once(args, spec, target=None):
    from ..serving import loadgen
    from ..telemetry import scorecard as sc

    target = target if target is not None else (args.url or _demo_engine(args))
    result = loadgen.run(
        spec, target, instrument=not args.no_instrument,
        time_scale=args.time_scale, timeout_s=args.timeout,
    )
    card = sc.build_scorecard(
        result, ttft_slo_ms=args.ttft_slo_ms, itl_slo_ms=args.itl_slo_ms,
        chips=args.chips, telemetry_dir=args.out,
    )
    if args.out:
        result.write(args.out)
        sc.write_scorecard(args.out, card)
    return result, card


def loadtest_command(args) -> int:
    verb = getattr(args, "verb", None)
    if verb == "run":
        return _cmd_run(args)
    if verb == "replay":
        return _cmd_replay(args)
    if verb == "sweep":
        return _cmd_sweep(args)
    print("usage: python -m accelerate_tpu_torch.commands.loadtest "
          "{run|replay|sweep} [--help]")
    return 1


def _cmd_run(args) -> int:
    from ..telemetry.scorecard import format_scorecard

    spec = _spec_from_args(args)
    result, card = _run_once(args, spec)
    if args.json:
        print(json.dumps(card, indent=2, sort_keys=True))
    else:
        print("== loadtest ==")
        for line in format_scorecard(card):
            print(line)
        print(f"schedule digest: {result.digest}")
    return 0


def _cmd_replay(args) -> int:
    from ..serving.loadgen import WorkloadSpec, load_offered
    from ..telemetry.scorecard import format_scorecard

    prev = load_offered(args.spec)
    if prev is None:
        print(f"no loadtest-offered.json at {args.spec}")
        return 1
    spec = WorkloadSpec.from_json(prev.spec)
    if args.seed is not None:
        spec = dataclasses.replace(spec, seed=int(args.seed))
    result, card = _run_once(args, spec)
    deterministic = result.digest == prev.digest and args.seed is None
    if args.json:
        doc = dict(card)
        doc["replay"] = {
            "previous_digest": prev.digest, "digest": result.digest,
            "schedule_identical": deterministic,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print("== loadtest replay ==")
        for line in format_scorecard(card):
            print(line)
        print(
            f"schedule {'IDENTICAL' if deterministic else 'DIVERGED'}: "
            f"{prev.digest} -> {result.digest}"
        )
    return 0 if deterministic or args.seed is not None else 1


def _cmd_sweep(args) -> int:
    from ..telemetry.scorecard import find_knee, sweep_rows

    spec = _spec_from_args(args)
    rates = [float(r) for r in str(args.rates).split(",") if r.strip()]
    cards = []
    for rate in rates:
        arrival = dict(spec.arrival)
        arrival["rate_rps"] = rate
        stepped = dataclasses.replace(spec, mode="open", arrival=arrival)
        # fresh target per step: saturation at rate k must not poison
        # the queue the k+1 measurement starts from
        _, card = _run_once(args, stepped,
                            target=args.url or _demo_engine(args))
        cards.append((rate, card))
    rows = sweep_rows(cards)
    knee = find_knee(rows)
    if args.json:
        print(json.dumps({"rows": rows, "knee_index": knee},
                         indent=2, sort_keys=True))
        return 0
    print("== loadtest sweep ==")
    print(f"{'rate_rps':>9} {'tok/s':>9} {'ttft_p99_ms':>12} "
          f"{'attainment':>11} {'finished':>9} {'shed':>6}")
    for i, row in enumerate(rows):
        mark = "  <-- knee" if knee == i else ""
        print(f"{row['rate_rps']:>9g} {row['tokens_per_s']:>9} "
              f"{str(row['ttft_p99_ms']):>12} "
              f"{row['slo_attainment_frac']:>11} {row['finished']:>9} "
              f"{row['shed']:>6}{mark}")
    if knee is None:
        print("no saturation knee within the swept rates")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.loadtest",
        description="deterministic load generator + SLO scorecard "
                    "(run / replay / sweep)",
    )
    register(parser)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
