"""A ``torch.profiler`` region and named trace ranges.

Counterpart of ``accelerate_tpu/utils/profiler.py``, which wraps
``jax.profiler``. ``ProfileContext`` (what ``Accelerator.profile()``
returns) starts a ``torch.profiler.profile`` on entry; on exit it stops
it, writes a Chrome trace (``trace_<suffix>.json``) into
``output_trace_dir`` (a fresh temporary directory when that is None) and
then calls ``on_trace_ready(ctx)``, as the reference does. With a
``schedule_option`` the region calls ``ctx.step()`` once a step, and
each finished cycle writes ``trace_<suffix>_<step>.json``.
"""

from __future__ import annotations

import os
import tempfile


def _activities(names):
    from torch.profiler import ProfilerActivity

    table = {"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}
    if names is None:
        return list(table.values())
    unknown = [name for name in names if name not in table]
    if unknown:
        raise ValueError(f"ProfileKwargs.activities takes 'cpu' and 'cuda', got {unknown}")
    return [table[name] for name in names]


class ProfileContext:
    """The profiling region of a ``ProfileKwargs`` (``kwargs``).
    ``trace_dir`` is where the trace goes, ``trace_path`` the file
    written at exit (None under a schedule), ``profiler`` the
    ``torch.profiler.profile`` once entered."""

    def __init__(self, kwargs, suffix: str = "0"):
        self.kwargs = kwargs
        self.suffix = suffix
        self.trace_dir = kwargs.output_trace_dir
        self.trace_path = None
        self.profiler = None

    def _export_cycle(self, prof):
        prof.export_chrome_trace(
            os.path.join(self.trace_dir, f"trace_{self.suffix}_{prof.step_num}.json"))

    def __enter__(self):
        import torch.profiler

        if self.trace_dir is None:
            self.trace_dir = tempfile.mkdtemp(prefix="accelerate_tpu_torch_profile_")
        os.makedirs(self.trace_dir, exist_ok=True)
        k = self.kwargs
        scheduled = k.schedule_option is not None
        self.profiler = torch.profiler.profile(
            activities=_activities(k.activities),
            schedule=torch.profiler.schedule(**k.schedule_option) if scheduled else None,
            on_trace_ready=self._export_cycle if scheduled else None,
            record_shapes=k.record_shapes, profile_memory=k.profile_memory,
            with_stack=k.with_stack, with_flops=k.with_flops)
        self.profiler.__enter__()
        return self

    def step(self):
        """Advance the profiler's schedule by one step."""
        self.profiler.step()

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        if self.kwargs.schedule_option is None:
            self.trace_path = os.path.join(self.trace_dir, f"trace_{self.suffix}.json")
            self.profiler.export_chrome_trace(self.trace_path)
        callback = self.kwargs.on_trace_ready
        if callback is not None:
            callback(self)
        return False


def annotate(name: str):
    """A named range on the trace (``torch.profiler.record_function``)."""
    import torch.profiler

    return torch.profiler.record_function(name)
