"""Memory helpers and the batch-size finder.

Counterpart of ``accelerate_tpu/utils/memory.py``.
``find_executable_batch_size`` calls the decorated function with a batch
size, and on an out-of-memory error halves it and calls again. The
reference detects XLA's ``RESOURCE_EXHAUSTED`` by its message; here the
card's own errors are recognised too: ``torch.cuda.OutOfMemoryError``
(the caching allocator's, a hand kernel's workspace included, since the
wrappers allocate through it), the CUDA runtime's
``cudaErrorMemoryAllocation`` and cuBLAS's and cuDNN's allocation
failures as their messages word them.

An out-of-memory error raised in the decorated function holds that
call's activations through its traceback's frames. The finder lets the
exception go (it leaves the ``except`` block) before it collects garbage
and empties the CUDA cache, so the next try starts from the memory the
failed one started from.
"""

from __future__ import annotations

import functools
import gc
import inspect

import torch


def release_memory(*objects):
    """Drop the references in ``objects`` (returned as Nones, for
    ``a, b = release_memory(a, b)``), collect garbage and empty the CUDA
    cache."""
    if not isinstance(objects, list):
        objects = list(objects)
    for i in range(len(objects)):
        objects[i] = None
    gc.collect()
    clear_device_cache()
    return objects


def clear_device_cache(garbage_collection: bool = False):
    """``gc.collect()`` when asked, then ``torch.cuda.empty_cache()`` when
    CUDA is up: the caching allocator returns its free blocks."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


# the reference's markers (XLA's and the host's), then the card's own
OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "OOM",
    "Attempting to reserve",
    "exceeds the limit",
    "Ran out of memory",
    "cudaErrorMemoryAllocation",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "CUDNN_STATUS_ALLOC_FAILED",
)


def should_reduce_batch_size(exception: Exception) -> bool:
    """Whether ``exception`` is an out-of-memory error, the card's or the
    host's: a ``MemoryError``, a ``torch.cuda.OutOfMemoryError``, or an
    error whose message carries one of :data:`OOM_MARKERS`."""
    if isinstance(exception, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exception)
    return any(m in msg for m in OOM_MARKERS)


class _BatchSizeFinder:
    """Calls the function with halving batch sizes until one runs
    without an out-of-memory error. The size that ran is remembered
    across calls: a function entered again (after a resume) starts
    there."""

    def __init__(self, fn, starting_batch_size: int):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.batch_size = starting_batch_size

    def _check_signature(self, args):
        # the finder fills the first positional slot; a caller that fills
        # it too would shift every other argument
        accepted = list(inspect.signature(self._fn).parameters)
        if len(args) + 1 > len(accepted):
            shown = ", ".join(f"{name}={value!r}" for name, value in zip(accepted[1:], args[1:]))
            raise TypeError(
                f"`{self._fn.__name__}` receives its batch size from the decorator — "
                f"call it without one: `{self._fn.__name__}({shown})`"
            )

    def __call__(self, *args, **kwargs):
        self._check_signature(args)
        clear_device_cache(garbage_collection=True)
        while self.batch_size > 0:
            try:
                return self._fn(self.batch_size, *args, **kwargs)
            except Exception as err:
                if not should_reduce_batch_size(err):
                    raise
            # out of the except block: the error, its traceback and the
            # frames that hold the failed try's tensors are gone, so the
            # collection below frees them
            clear_device_cache(garbage_collection=True)
            self.batch_size //= 2
        raise RuntimeError("No executable batch size found, reached zero.")


def find_executable_batch_size(function=None, starting_batch_size: int = 128):
    """Decorator: call ``function(batch_size, ...)`` from
    ``starting_batch_size``, halving it after every out-of-memory error
    (:func:`should_reduce_batch_size`). The function takes the batch size
    as its first argument and is called without it."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)
    return _BatchSizeFinder(function, starting_batch_size)


def get_hbm_stats(device=None) -> dict:
    """The card's memory: ``bytes_in_use`` and ``peak_bytes_in_use`` of
    the caching allocator (``torch.cuda.memory_stats``) and
    ``bytes_limit``, the card's total; ``{}`` without CUDA."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def convert_bytes(size: float) -> str:
    """``size`` bytes in the largest unit under 1024 of it."""
    for unit in ["bytes", "KB", "MB", "GB", "TB"]:
        if size < 1024.0:
            return f"{round(size, 2)} {unit}"
        size /= 1024.0
    return f"{round(size, 2)} PB"
