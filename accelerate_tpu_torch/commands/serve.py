"""``serve replica``: one engine process behind HTTP, the port's
counterpart of the reference's ``accelerate-tpu serve replica``
(``accelerate_tpu/commands/serve.py``).

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
``--device cpu``. The ``router`` role is a later slice of the port.
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
    router = sub.add_parser("router", help="the multi-replica router (a later slice "
                                           "of the port)")
    router.add_argument("rest", nargs=argparse.REMAINDER)

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
                         help="host-RAM KV tier (a later slice: nonzero raises)")
    replica.add_argument("--kv-disk-entries", type=int, default=0,
                         help="disk KV tier (a later slice: nonzero raises)")
    replica.add_argument("--kv-disk-dir", default=None, metavar="DIR",
                         help="directory of the disk KV tier (a later slice)")
    replica.add_argument("--kv-peers", action="append", default=[],
                         metavar="[NAME=]URL",
                         help="peer replica of the fleet KV tier (a later slice: "
                              "any raises)")
    replica.add_argument("--temperature", type=float, default=0.0)
    replica.add_argument("--top-k", type=int, default=None)
    replica.add_argument("--steps-per-call", type=int, default=1,
                         help="decode steps per burst: K steps replayed back to back "
                              "with one host read, where no admission waits")
    replica.add_argument("--init-seed", type=int, default=0,
                         help="random-weight seed (two replicas launched with "
                              "the same config and seed serve the same weights)")
    replica.add_argument("--max-seq-len", type=int, default=256)
    parser.set_defaults(func=serve_command)


def serve_command(args) -> int:
    role = getattr(args, "role", None)
    if role == "router":
        print("serve router is a later slice of the port (ROADMAP queue 1 item 5)",
              file=sys.stderr)
        return 1
    if role == "replica":
        return _serve_replica(args)
    print("usage: python -m accelerate_tpu_torch.commands.serve {router|replica} [--help]")
    return 1


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
    if args.kv_host_entries or args.kv_disk_entries or args.kv_peers or args.kv_disk_dir:
        raise NotImplementedError(
            "--kv-host-entries, --kv-disk-entries, --kv-disk-dir and --kv-peers: "
            "hierarchical KV tiers belong to a later slice of the port "
            "(ROADMAP queue 1 item 5)"
        )
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
    )


def _serve_replica(args) -> int:
    from ..serving.replica_server import ReplicaServer

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
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.serve",
        description="serve a replica of the PyTorch/CUDA port over HTTP",
    )
    register(parser)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
