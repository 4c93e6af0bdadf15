"""``serve replica`` and ``serve router``: one engine process behind HTTP,
and the front door over several, the port's counterparts of the
reference's ``accelerate-tpu serve`` roles (``accelerate_tpu/commands/serve.py``).

    python -m accelerate_tpu_torch.commands.serve replica --config small_1b \\
        --page-size 16 --num-slots 8 --max-cache-len 2048 --prefill-chunks 128,512

builds a ``DecoderLM`` over seeded random weights (``--init-seed``: two
replicas with one config and seed serve one set of weights; the port's
init does not reproduce a JAX replica's), wraps its ``ServingEngine`` in a
:class:`~..serving.replica_server.ReplicaServer`, prints one JSON line
``{"role", "replica", "port", "url"}`` and serves until SIGTERM has
drained it. The model and the engine live on CUDA unless ``--device``
names another device (``--device cpu`` runs the kernels' plain versions).
``--steps-per-call K`` serves decode bursts of K steps. On CUDA every
decode step runs as a CUDA graph captured before the port is bound, and
the config must pass the decode kernels' gate, which is checked before a
port is bound too: ``tiny`` (head_dim 16) serves only with
``--device cpu``. ``--kv-host-entries`` / ``--kv-disk-entries`` /
``--kv-disk-dir`` / ``--kv-peers`` put KV tiers under the prefix cache.
``--invariant-prefill`` makes a prompt's tokens the same bits on every
admission and replica (``ServingEngine(invariant_prefill=True)``), which a
token-exact canary needs on CUDA. ``--telemetry-dir DIR`` attaches a
telemetry session whose artifacts land in DIR (the request records a
waterfall joins, the timeline, the alerts, the flight bundles ``POST
/v1/flight`` dumps); ``/metrics`` then carries its histograms. (The
reference's replica builds no session; an embedder attaches one.)

    python -m accelerate_tpu_torch.commands.serve router \
        --replica A=http://127.0.0.1:8901 --replica B=http://127.0.0.1:8902

runs the router (``serving/router.py``, which imports neither torch nor
numpy) and prints ``{"role", "port", "replicas", "canary", "log_dir"}``.
``--canary-interval S`` attaches a canary prober (``telemetry/canary.py``)
that sends the golden prompt (``--canary-prompt``, ``--canary-seed``,
``--canary-max-new-tokens``) through the router every S seconds and holds
each reply token for token to the first one it recorded; its ``canary/*``
gauges join the router's ``/metrics``, its results
``canary-results.jsonl`` under ``--log-dir``, and a failing probe dumps
the flight recorder of the replica that served it.
"""

from __future__ import annotations

import argparse
import json
import sys

CONFIGS = ("tiny", "small_1b")


def register(parser):
    """Add the ``router`` and ``replica`` roles, with the reference's
    replica flags plus ``--device``, to ``parser``."""
    sub = parser.add_subparsers(dest="role")
    router = sub.add_parser(
        "router", help="stdlib-HTTP/JSONL front door over N replicas (no torch; "
                       "failover, re-queue, elastic membership)")
    router.add_argument("--replica", action="append", default=[], metavar="[NAME=]URL",
                        help="replica base URL (repeatable); more can join at runtime "
                             "via POST /v1/register")
    router.add_argument("--host", default="127.0.0.1")
    router.add_argument("--port", type=int, default=8790)
    router.add_argument("--max-inflight", type=int, default=64,
                        help="bounded router queue; past it submits shed with "
                             "shed_reason=router_queue_full")
    router.add_argument("--max-retries", type=int, default=4)
    router.add_argument("--backoff-base", type=float, default=0.05, metavar="S")
    router.add_argument("--backoff-cap", type=float, default=2.0, metavar="S")
    router.add_argument("--backoff-seed", type=int, default=0)
    router.add_argument("--request-timeout", type=float, default=None, metavar="S")
    router.add_argument("--poll-interval", type=float, default=0.25, metavar="S",
                        help="replica health / placement scrape cadence")
    router.add_argument("--no-affinity", action="store_true",
                        help="disable session -> replica stickiness")
    router.add_argument("--no-kv-migration", action="store_true",
                        help="disable the KV handoff when a session moves off a "
                             "draining replica")
    router.add_argument("--log-dir", default=None, metavar="DIR",
                        help="write router-requests.jsonl (the latency waterfall's "
                             "router half), router-decisions.jsonl and "
                             "canary-results.jsonl here")
    router.add_argument("--no-instrument", action="store_true",
                        help="disable golden-signal histograms, hop stamps and the "
                             "decision log")
    router.add_argument("--canary-interval", type=float, default=0.0, metavar="S",
                        help="probe the fleet with a seeded golden prompt every S "
                             "seconds, verifying token-exactness (0 = off); gauges "
                             "land on /metrics as canary/*")
    router.add_argument("--canary-prompt", default="1,2,3",
                        help="comma-separated golden prompt token ids (the first "
                             "finished probe records the golden output every later "
                             "probe must reproduce)")
    router.add_argument("--canary-max-new-tokens", type=int, default=8)
    router.add_argument("--canary-seed", type=int, default=0)

    replica = sub.add_parser(
        "replica", help="one engine process behind HTTP (random weights from "
                        "--init-seed; production embeds ReplicaServer over its "
                        "own engine)"
    )
    replica.add_argument("--config", default="tiny",
                         help=f"named DecoderConfig constructor ({', '.join(CONFIGS)})")
    replica.add_argument("--device", default=None,
                         help="torch device of the model and the engine (default: "
                              "CUDA, which raises without it; cpu runs the "
                              "kernels' plain versions)")
    replica.add_argument("--name", default=None,
                         help="replica identity (default host:port); stamped "
                              "into every request")
    replica.add_argument("--host", default="127.0.0.1")
    replica.add_argument("--port", type=int, default=0,
                         help="0 binds an ephemeral port (printed as JSON "
                              "on stdout at startup)")
    replica.add_argument("--num-slots", type=int, default=4)
    replica.add_argument("--max-cache-len", type=int, default=None)
    replica.add_argument("--prefill-chunks", default="16,64",
                         help="comma-separated prefill bucket sizes")
    replica.add_argument("--page-size", type=int, default=16,
                         help="0 = flat slot arena (no paging, no prefix cache)")
    replica.add_argument("--kv-cache-dtype", default=None,
                         choices=["bf16", "int8", "int4"])
    replica.add_argument("--kv-host-entries", type=int, default=0,
                         help="host-RAM KV tier capacity in prefix entries (0 = "
                              "tiering off; evictions drop)")
    replica.add_argument("--kv-disk-entries", type=int, default=0,
                         help="disk KV tier capacity in prefix entries (needs "
                              "--kv-disk-dir)")
    replica.add_argument("--kv-disk-dir", default=None, metavar="DIR",
                         help="directory for demoted KV blobs (durable across "
                              "restarts; torn or corrupt blobs are rejected and deleted)")
    replica.add_argument("--kv-peers", action="append", default=[],
                         metavar="[NAME=]URL",
                         help="peer replica of the fleet KV tier (repeatable): a "
                              "local miss pulls a warm prefix over /v1/kv/export "
                              "after checking the peer's /v1/kv/directory")
    replica.add_argument("--temperature", type=float, default=0.0)
    replica.add_argument("--top-k", type=int, default=None)
    replica.add_argument("--steps-per-call", type=int, default=1,
                         help="decode steps per burst: K steps replayed back to back "
                              "with one host read, where no admission waits")
    replica.add_argument("--init-seed", type=int, default=0,
                         help="random-weight seed (two replicas launched with "
                              "the same config and seed serve the same weights)")
    replica.add_argument("--max-seq-len", type=int, default=256)
    replica.add_argument("--invariant-prefill", action="store_true",
                         help="lay prefills out so a prompt's tokens are the same bits "
                              "on every admission and replica (prefix hits round down "
                              "to the prefill kernel's 64-position kv tile, packed tails "
                              "start on one): what a token-exact canary needs on CUDA")
    replica.add_argument("--telemetry-dir", default=None, metavar="DIR",
                         help="attach a telemetry session writing its artifacts "
                              "(requests-host0.jsonl, timeline, alerts, flight "
                              "bundles) here")
    parser.set_defaults(func=serve_command)


def serve_command(args) -> int:
    role = getattr(args, "role", None)
    if role == "router":
        return _serve_router(args)
    if role == "replica":
        return _serve_replica(args)
    print("usage: python -m accelerate_tpu_torch.commands.serve {router|replica} [--help]")
    return 1


def _parse_replica_flags(values) -> list:
    """``[NAME=]URL`` flags as ``(name, url)`` pairs (``r<i>`` unnamed)."""
    pairs = []
    for i, item in enumerate(values):
        name, url = item.split("=", 1) if "=" in item else (f"r{i}", item)
        pairs.append((name.strip(), url.strip()))
    return pairs


def build_router(args):
    """The :class:`~..serving.router.Router` the ``router`` role serves,
    started (its fleet collector polling), with a started canary prober
    attached when ``--canary-interval`` is above 0. Imports no torch."""
    from ..serving.router import Router, RouterConfig

    cfg = RouterConfig(
        max_inflight=args.max_inflight, max_retries=args.max_retries,
        backoff_base_s=args.backoff_base, backoff_cap_s=args.backoff_cap,
        backoff_seed=args.backoff_seed, request_timeout_s=args.request_timeout,
        poll_interval_s=args.poll_interval, affinity=not args.no_affinity,
        migrate_session_kv=not args.no_kv_migration,
        instrument=not args.no_instrument, log_dir=args.log_dir,
    )
    router = Router(_parse_replica_flags(args.replica), config=cfg).start()
    if args.canary_interval and args.canary_interval > 0:
        from ..telemetry.canary import CanaryProber, flight_via_router, via_router

        prompt = [int(t) for t in str(args.canary_prompt).split(",") if t.strip()]
        prober = CanaryProber(
            via_router(router),
            [{"prompt": prompt, "seed": int(args.canary_seed),
              "max_new_tokens": int(args.canary_max_new_tokens)}],
            interval_s=float(args.canary_interval),
            log_dir=args.log_dir,
            flight_fn=flight_via_router(router),
        ).start()
        router.attach_canary(prober)
    return router


def _serve_router(args) -> int:
    import signal
    import threading

    from ..serving.router import RouterServer

    router = build_router(args)
    server = RouterServer(router, host=args.host, port=args.port)
    print(json.dumps({"role": "router", "port": server.port,
                      "replicas": len(args.replica),
                      "canary": router.canary is not None,
                      "log_dir": args.log_dir}), flush=True)
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
        router.close()
    return 0


def build_replica_engine(args):
    """Build the engine the ``replica`` role serves (what a test builds to
    hold a replica's tokens against: the same config, ``--init-seed`` and
    engine flags give the same engine). Raises before any model is built
    when the device is CUDA and absent, or when the config fails the
    decode kernels' gate on CUDA."""
    from ..models.configs import DecoderConfig
    from ..models.convert import random_params
    from ..models.decoder import DecoderLM, resolve_device
    from ..ops import kernels
    from ..serving.engine import ServingEngine

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown --config {args.config!r} (have: {', '.join(CONFIGS)})")
    cfg = getattr(DecoderConfig, args.config)(max_seq_len=int(args.max_seq_len))
    dev = resolve_device(args.device)
    page_size = int(args.page_size) or None
    if dev.type == "cuda":
        shape = (cfg.num_heads, 1, cfg.head_dim, cfg.num_kv_heads)
        if page_size:
            gate, gate_args = kernels._decode_kernel_check, (*shape, page_size)
        else:
            gate, gate_args = kernels._decode_rows_check, (*shape, "dense decode")
        try:
            gate(*gate_args)
        except ValueError as exc:
            raise ValueError(
                f"--config {args.config} cannot serve on {dev}: the decode kernels' "
                f"gate (ops/kernels.py {gate.__name__}) refuses it: {exc}. Serve it "
                "with --device cpu"
            ) from exc
    model = DecoderLM(cfg, device=dev).load_params(
        random_params(cfg, seed=int(args.init_seed), device=dev))
    chunks = tuple(int(c) for c in str(args.prefill_chunks).split(",") if c.strip())
    kv_tiers = None
    host, disk = int(args.kv_host_entries or 0), int(args.kv_disk_entries or 0)
    peers = _parse_replica_flags(args.kv_peers or [])
    if host or disk or peers:
        if not page_size:
            raise ValueError("--kv-host-entries / --kv-disk-entries / --kv-peers need "
                             "the paged arena (--page-size > 0)")
        if disk and not args.kv_disk_dir:
            raise ValueError("--kv-disk-entries needs --kv-disk-dir")
        from ..serving.tiers import TierConfig

        # demotion reaches disk and peers only through the host tier
        kv_tiers = TierConfig(host_entries=max(host, 1 if (disk or peers) else 0),
                              disk_entries=disk, disk_dir=args.kv_disk_dir,
                              peers=tuple(peers))
    return ServingEngine(
        model,
        num_slots=int(args.num_slots),
        max_cache_len=args.max_cache_len,
        prefill_chunks=chunks,
        page_size=page_size,
        temperature=float(args.temperature),
        top_k=args.top_k,
        steps_per_call=int(args.steps_per_call),
        kv_cache_dtype=args.kv_cache_dtype,
        replica=args.name,
        device=dev,
        kv_tiers=kv_tiers,
        invariant_prefill=bool(getattr(args, "invariant_prefill", False)),
    )


def _serve_replica(args) -> int:
    from ..serving.replica_server import ReplicaServer

    session = None
    if getattr(args, "telemetry_dir", None):
        from ..telemetry import TelemetryConfig, TelemetrySession

        # SIGTERM stays the server's (drain, then exit): no flight hooks
        session = TelemetrySession(TelemetryConfig(trace_dir=args.telemetry_dir,
                                                   flight_hooks=False))
    engine = build_replica_engine(args)
    # the kernels' build and, on CUDA, the capture of the decode (or
    # verify) step's graph happen here, before a port is bound: no request
    # waits on either, and no HTTP thread runs while the loop captures
    engine.warmup()
    engine.mark_steady()
    server = ReplicaServer(
        engine, host=args.host, port=int(args.port), name=args.name,
        handle_signals=True,
    ).start()
    print(json.dumps({"role": "replica", "replica": server.name,
                      "port": server.port, "url": server.url}), flush=True)
    try:
        # SIGTERM drains (finish in-flight) and unblocks this wait; an
        # exception that killed the serving loop is re-raised here
        server.serve_until_drained()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if session is not None:
            session.close()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.serve",
        description="serve a replica of the PyTorch/CUDA port over HTTP, or the "
                    "router in front of several",
    )
    register(parser)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
