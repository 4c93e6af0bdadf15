"""CUDA graphs of the port's fixed-shape steps.

The reference compiles each serving decode step, verify step, decode
burst and ``generate()`` loop into one XLA program (``jax.jit``,
``lax.scan``). Eager PyTorch launches the same step as ~1000 kernels
from Python, one at a time, and the host's launch cost then sets the
step's pace. The port's counterpart of those compiled programs is a CUDA
graph: the step's launches captured once over static device buffers and
replayed as one launch. The reference has no module like this one; its
counterpart is ``jax.jit``.

:func:`capture` runs the step body a few times on a side stream (the
warm-up: kernel libraries load, cuBLAS sets up its workspace on that
stream, the decode split plan reads the SM count), puts back the buffers
the body moves forward, then captures one call with ``torch.cuda.graph``
on the same stream. What the body allocates while it is captured lives
in the graph's private memory pool and keeps its address, so the body's
return value is each replay's output.

The kernel launch counters (``ops/kernels.launch_counts``) count on the
host, and a replay runs no wrapper: the capture records the launches the
body made (``kernels.recording``), and every replay adds them. The
warm-up calls compute the step that the first replay computes again, and
count nowhere.

There is no fallback: a capture that fails raises, and a CPU device
raises (the CPU runs the body itself).

Every capture adds one to a process-wide counter
(:func:`capture_counters`). A capture is the port's counterpart of the
reference's compile, so the telemetry reads this counter where the
reference reads its compile counters (the request records'
``compiles_in_flight``, the flight bundle's ``compile_counters``): after
``warmup()`` an engine captures nothing, and both read 0.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from ..ops import kernels

WARMUP_CALLS = 2

# process-wide capture counters, under the reference's compile-counter
# keys (``cache_hits`` stays 0: a graph is captured once per owner)
_COUNTERS = {"count": 0, "seconds": 0.0, "cache_hits": 0}


def capture_counters() -> dict:
    """``{"count", "seconds", "cache_hits"}``: the graphs captured in this
    process so far and their capture wall, warm-up included."""
    return dict(_COUNTERS)


def captures(device) -> bool:
    """Whether the port runs its fixed-shape steps on ``device`` as CUDA
    graphs: on CUDA always, elsewhere never (the CPU runs the bodies)."""
    return torch.device(device).type == "cuda"


class CapturedStep:
    """A captured step: ``replay()`` relaunches the graph, adds the
    launches the capture recorded to the counters, and returns the body's
    output tensors (overwritten in place by every replay). ``seconds`` is
    the capture's own wall time, warm-up included."""

    def __init__(self, graph, out, launches: dict, seconds: float):
        self.graph = graph
        self.out = out
        self.launches = launches
        self.seconds = seconds

    def replay(self):
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.out


def capture(body: Callable, device, restore: Sequence[torch.Tensor] = ()) -> CapturedStep:
    """Capture ``body()`` (no arguments: it reads and writes static device
    buffers) as a CUDA graph on ``device``. ``restore`` lists the buffers
    the body moves forward (a token fed back, positions advanced): each
    warm-up call is undone on them, so the first replay starts from the
    state the caller left. Raises on a device that is not CUDA. Counts in
    :func:`capture_counters`."""
    step = _record(body, torch.device(device), restore)
    _COUNTERS["count"] += 1
    _COUNTERS["seconds"] += step.seconds
    return step


def _record(body: Callable, device, restore) -> CapturedStep:
    """The capture itself: warm-up calls on a side stream, then one
    captured call."""
    if device.type != "cuda":
        raise RuntimeError(
            f"a CUDA graph needs a CUDA device, got {device}: the CPU runs the step body itself"
        )
    t0 = time.perf_counter()
    saved = [t.clone() for t in restore]
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), kernels.recording():
        for _ in range(WARMUP_CALLS):
            body()
            for t, s in zip(restore, saved):
                t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    # thread_local: the replica's HTTP threads may make CUDA calls of their
    # own (a sampled request's generator) while the loop thread captures
    with kernels.recording() as launches:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = body()
    torch.cuda.synchronize(device)
    return CapturedStep(graph, out, dict(launches), time.perf_counter() - t0)
