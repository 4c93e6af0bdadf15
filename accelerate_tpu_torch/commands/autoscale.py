"""``autoscale`` — the closed-loop serving front door.

An own copy of the reference's ``accelerate_tpu/commands/autoscale.py``,
run as ``python -m accelerate_tpu_torch.commands.autoscale``. It runs the
same torch-free router tier ``serve router`` runs, with the
burn-rate-actuated autoscaler daemon (``serving/autoscaler.py``)
attached: the fleet collector is built with the ITL SLO so the default
``itl_burn_rate``/``shed_burn_rate`` rules evaluate over the merged
timeline, and every firing can become a canary-gated scale-out (and
every sustained surplus a drained scale-in) instead of a page.

    python -m accelerate_tpu_torch.commands.autoscale \\
        --replica r0=http://127.0.0.1:8900 --itl-slo-ms 50 \\
        --min-replicas 1 --max-replicas 4 --log-dir runs/serve

Every decision (holds included) appends to ``autoscale-decisions.jsonl``
under ``--log-dir`` with the full signal snapshot that justified it.
``--once`` evaluates a single decision, prints it as JSON, and exits
(scripting / drills). Spawned replicas are ``serve replica --config
small_1b`` on the card unless ``--replica-arg`` says otherwise (a CPU
drill passes ``--replica-arg=--device --replica-arg=cpu
--replica-arg=--config --replica-arg=tiny``). SIGTERM stops it (exit 0),
draining and reaping every replica it spawned.

No torch and no numpy in this process — the torch-paying work happens
in the replica subprocesses the daemon spawns via ``serve replica``.
"""

from __future__ import annotations

import argparse
import json
import sys


def register(parser):
    """Add the autoscaler's flags to ``parser``."""
    parser.add_argument("--replica", action="append", default=[],
                        metavar="[NAME=]URL",
                        help="initial replica base URL (repeatable); the "
                             "daemon spawns more via 'serve replica'")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8790)
    parser.add_argument("--log-dir", default=None, metavar="DIR",
                        help="write autoscale-decisions.jsonl, the router "
                             "logs and fleet events here")
    parser.add_argument("--poll-interval", type=float, default=0.5,
                        metavar="S", help="fleet scrape cadence")
    parser.add_argument("--interval", type=float, default=1.0, metavar="S",
                        help="autoscaler evaluation cadence")
    parser.add_argument("--itl-slo-ms", type=float, default=None,
                        help="ITL SLO the burn-rate rule spends against "
                             "(unset = shed-rate burn only)")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--max-replicas", type=int, default=4)
    parser.add_argument("--headroom-floor", type=float, default=0.15,
                        help="scale out when burn fires AND fleet headroom "
                             "is below this fraction")
    parser.add_argument("--scale-in-headroom", type=float, default=0.5,
                        help="consider scale-in above this headroom "
                             "fraction (and no burn firing)")
    parser.add_argument("--scale-in-margin", type=float, default=1.25,
                        help="N-1 capacity must clear projected load "
                             "times this margin")
    parser.add_argument("--cooldown", type=float, default=30.0, metavar="S",
                        help="hold after any action while the new "
                             "membership's signals settle")
    parser.add_argument("--confirm-evals", type=int, default=2,
                        help="consecutive eligible evaluations before "
                             "acting (flap suppression)")
    parser.add_argument("--fast-window", type=float, default=60.0,
                        metavar="S")
    parser.add_argument("--slow-window", type=float, default=600.0,
                        metavar="S")
    parser.add_argument("--horizon", type=float, default=60.0, metavar="S",
                        help="forecast horizon for the projected load")
    parser.add_argument("--replica-arg", action="append", default=[],
                        metavar="ARG",
                        help="'serve replica' CLI argument for spawned "
                             "replicas (repeatable, e.g. "
                             "--replica-arg=--num-slots "
                             "--replica-arg=8; default --config small_1b)")
    parser.add_argument("--startup-timeout", type=float, default=120.0,
                        metavar="S", help="spawn-to-handshake deadline")
    parser.add_argument("--canary-prompt", default="1,2,3",
                        help="comma-separated golden prompt token ids for "
                             "the pre-registration readiness gate")
    parser.add_argument("--canary-max-new-tokens", type=int, default=8)
    parser.add_argument("--canary-seed", type=int, default=0)
    parser.add_argument("--canary-probes", type=int, default=2,
                        help="passing probes required before a spawned "
                             "replica may register")
    parser.add_argument("--once", action="store_true",
                        help="evaluate one decision, print it as JSON, "
                             "exit (no actuation daemon)")
    parser.set_defaults(func=autoscale_command)
    return parser


def _policy_from_args(args):
    from ..telemetry.capacity import AutoscalePolicy

    return AutoscalePolicy(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        headroom_floor=args.headroom_floor,
        scale_in_headroom=args.scale_in_headroom,
        scale_in_margin=args.scale_in_margin,
        cooldown_s=args.cooldown,
        confirm_evals=args.confirm_evals,
        horizon_s=args.horizon,
        fast_s=args.fast_window,
        slow_s=args.slow_window,
    )


def autoscale_command(args) -> int:
    # no torch by construction: router + fleet + autoscaler only
    from ..serving.autoscaler import Autoscaler, SubprocessSpawner
    from ..serving.router import Router, RouterConfig, RouterServer
    from ..telemetry.fleet import FleetCollector
    from .serve import _parse_replica_flags

    pairs = _parse_replica_flags(args.replica)
    collector = FleetCollector(
        [(n, u.rstrip("/") + "/metrics") for n, u in pairs],
        poll_interval_s=args.poll_interval,
        itl_slo_ms=args.itl_slo_ms,
        log_dir=args.log_dir,
    )
    cfg = RouterConfig(
        poll_interval_s=args.poll_interval,
        log_dir=args.log_dir,
    )
    router = Router(pairs, config=cfg, collector=collector).start()
    prompt = [int(t) for t in str(args.canary_prompt).split(",") if t.strip()]
    goldens = [{"prompt": prompt, "seed": int(args.canary_seed),
                "max_new_tokens": int(args.canary_max_new_tokens)}]
    autoscaler = Autoscaler(
        router,
        policy=_policy_from_args(args),
        spawner=SubprocessSpawner(
            replica_args=tuple(args.replica_arg) or ("--config", "small_1b"),
            startup_timeout_s=args.startup_timeout,
        ),
        goldens=goldens,
        canary_probes=args.canary_probes,
        log_dir=args.log_dir,
        interval_s=args.interval,
    )
    router.attach_autoscaler(autoscaler)
    if args.once:
        try:
            collector.poll_once()
            record = autoscaler.evaluate_once()
            print(json.dumps(record, indent=1, sort_keys=True))
        finally:
            router.close()
        return 0
    autoscaler.start()
    server = RouterServer(router, host=args.host, port=args.port)
    print(json.dumps({
        "role": "autoscale", "port": server.port,
        "replicas": len(pairs),
        "min_replicas": args.min_replicas,
        "max_replicas": args.max_replicas,
        "log_dir": args.log_dir,
    }), flush=True)
    import signal
    import threading

    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    except ValueError:
        pass  # not the main thread: the embedder owns signals
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        router.close()  # closes the autoscaler, which reaps its replicas
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.autoscale",
        description="run the router with the burn-rate-actuated autoscaler "
                    "daemon (canary-gated scale-out, drained scale-in)",
    )
    register(parser)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
