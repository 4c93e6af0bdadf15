"""Launch a world of processes from Python.

Counterpart of ``accelerate_tpu/launchers.py``'s ``debug_launcher``:
``num_processes`` CPU workers over gloo on 127.0.0.1 and a free port,
each started in ``spawn`` mode (never ``fork``: a parent that has
initialised threads or a device must not be copied) with torch's launch
contract in its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), so the port's state starts the group
(``state.init_process_group``) when the function builds a
``PartialState(cpu=True)`` or an ``Accelerator(cpu=True)``. gloo binds to
the loopback device unless ``GLOO_SOCKET_IFNAME`` says otherwise; each
worker runs torch's CPU operators on ``OMP_NUM_THREADS`` threads, 1 unless
it is set (as ``torchrun`` does for several processes on one host: n
workers each taking every core oversubscribe it n times).
``notebook_launcher`` is the CLI's slice (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Optional


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, function: Callable, args: tuple, env: dict):
    import torch
    import torch.distributed as dist

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    function(*args)
    if dist.is_initialized():
        # leave together and tear the group down before the interpreter
        # exits: no rank's exit cuts a peer's open connection, and no gloo
        # thread is left running into the process's teardown
        dist.barrier()
        dist.destroy_process_group()


def debug_launcher(function: Callable, args: tuple = (), num_processes: int = 2,
                   timeout: Optional[float] = None):
    """Run ``function(*args)`` in ``num_processes`` spawned CPU workers of
    one gloo world (``function`` must be importable by name: a module's
    top-level function). A worker that raises fails the launcher with its
    traceback; past ``timeout`` seconds every worker is killed and
    ``TimeoutError`` raised (their output went to this process's)."""
    import torch.multiprocessing as mp

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(num_processes),
           "GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
           "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    ctx = mp.start_processes(_worker, args=(function, tuple(args), env),
                             nprocs=num_processes, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"debug_launcher: {num_processes} workers of {function.__name__} still "
                    f"running after {timeout} s (their output is above)")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
