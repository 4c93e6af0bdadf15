"""The port's ``utils/memory.py`` against the JAX package's, on the CPU.

- ``find_executable_batch_size``: the port's and the reference's finders
  try the same sequence of sizes and return the same survivor under the
  same scripted failures (each failing set of sizes, from each start),
  remember the survivor across calls, pass other arguments through,
  refuse a batch size passed by the caller (``TypeError``), let a
  non-memory error through and raise at zero.
- ``should_reduce_batch_size`` gives the reference's answer on every
  exception of a table built from the reference's ``OOM_MARKERS``, and
  True on the card's own errors (``torch.cuda.OutOfMemoryError``, cuBLAS'
  and cuDNN's allocation failures) and False on other CUDA errors.
- The finder lets a failed try's exception go before it collects: an
  object that only the failed frame held is gone when the next try
  starts; a control that keeps the exception keeps the object, so the
  check sees a leak (the CPU's form of the chip phase's memory gate).
- ``release_memory``, ``clear_device_cache``, ``convert_bytes`` and
  ``get_hbm_stats`` without CUDA.
"""

import gc
import itertools
import weakref

import pytest
import torch

from accelerate_tpu.utils import memory as ref
from accelerate_tpu_torch.utils import memory

FINDERS = {"port": memory.find_executable_batch_size, "ref": ref.find_executable_batch_size}


def _run(which, start, fails, error, calls=2):
    """Sizes tried and results of ``calls`` calls of one decorated
    function that raises ``error`` at every size in ``fails``."""
    tried = []

    @FINDERS[which](starting_batch_size=start)
    def train(batch_size, scale=1):
        tried.append(batch_size)
        if batch_size in fails:
            raise error
        return batch_size * scale

    results = []
    for _ in range(calls):
        try:
            results.append(train(scale=2))
        except RuntimeError as e:
            results.append(str(e))
    return tried, results


OOM = RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1.5G")


def _failing_sets(start):
    """The largest 0, 1, 3 or all sizes fail; then sets that are not a
    prefix (a size that fails while a larger one ran)."""
    sizes = [start >> i for i in range(8) if start >> i]
    sets = [set(sizes[:n]) for n in sorted({0, 1, min(3, len(sizes)), len(sizes)})]
    return sets + [set(sizes[1:2]), set(sizes[::2])]


@pytest.mark.parametrize("start,fails", [(start, fails) for start in (1, 7, 128)
                                         for fails in _failing_sets(start)])
def test_finders_try_the_same_sizes(start, fails):
    assert _run("port", start, fails, OOM) == _run("ref", start, fails, OOM)


def test_finder_signature_and_errors_match_the_reference():
    for which in ("port", "ref"):
        @FINDERS[which](starting_batch_size=8)
        def run(batch_size, a, b=2):
            return (batch_size, a, b)

        assert run(1, b=3) == (8, 1, 3)
        with pytest.raises(TypeError, match="receives its batch size"):
            run(8, 1, 3)

        @FINDERS[which](starting_batch_size=8)
        def unrelated(batch_size):
            raise ValueError("unrelated")

        with pytest.raises(ValueError, match="unrelated"):
            unrelated()

        @FINDERS[which]
        def never(batch_size):
            raise MemoryError()

        with pytest.raises(RuntimeError, match="reached zero"):
            never()
        assert never.batch_size == 0


def _exceptions():
    """A table of exceptions: every reference marker, in and out of
    context, each in two exception types; messages near them that are
    not out-of-memory errors; MemoryError."""
    table = [MemoryError(), MemoryError("host"), ValueError("shape mismatch"),
             RuntimeError("CUDA error: an illegal memory access was encountered"),
             RuntimeError("memory"), KeyError("out"), RuntimeError("")]
    for marker, cls in itertools.product(ref.OOM_MARKERS, (RuntimeError, ValueError)):
        table.append(cls(marker))
        table.append(cls(f"XLA failed: {marker} while allocating 3.2 GiB"))
        table.append(cls(marker.swapcase()))
    return table


def test_should_reduce_batch_size_matches_the_reference_on_its_markers():
    for exc in _exceptions():
        assert memory.should_reduce_batch_size(exc) == ref.should_reduce_batch_size(exc), exc


def test_should_reduce_batch_size_on_the_cards_errors():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total capacity of "
        "79.19 GiB of which 3.12 GiB is free.")
    assert memory.should_reduce_batch_size(oom)
    assert memory.should_reduce_batch_size(torch.cuda.OutOfMemoryError("no message"))
    for msg in ("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`",
                "cuDNN error: CUDNN_STATUS_ALLOC_FAILED",
                "CUDA error: out of memory",
                "cudaErrorMemoryAllocation: out of memory"):
        assert memory.should_reduce_batch_size(RuntimeError(msg)), msg
    for msg in ("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasGemmEx`",
                "CUDA error: device-side assert triggered",
                "cuDNN error: CUDNN_STATUS_BAD_PARAM"):
        assert not memory.should_reduce_batch_size(RuntimeError(msg)), msg


class _Activations:
    """Stands for a failed try's tensors: only its frame holds it."""


def _probe_finder(keep_errors: bool):
    """Per try: whether the previous failed try's activations were still
    alive when this try started."""
    refs, alive_at_start, kept = [], [], []

    @memory.find_executable_batch_size(starting_batch_size=8)
    def train(batch_size):
        alive_at_start.append([r() is not None for r in refs])
        acts = _Activations()
        acts.self_ref = acts  # a cycle: only a collection frees it
        refs.append(weakref.ref(acts))
        if batch_size > 2:
            try:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
            except torch.cuda.OutOfMemoryError as err:
                if keep_errors:
                    kept.append(err)
                raise
        return batch_size

    gc.collect()
    assert train() == 2
    return alive_at_start


def test_finder_frees_the_failed_try_before_the_next():
    alive = _probe_finder(keep_errors=False)
    assert alive == [[], [False], [False, False]]
    # the control keeps each error: its traceback holds the frame, and the
    # check sees every failed try's activations still alive
    alive = _probe_finder(keep_errors=True)
    assert alive == [[], [True], [True, True]]


def test_memory_helpers_match_the_reference():
    a, b = object(), [1]
    assert memory.release_memory(a, b) == ref.release_memory(a, b) == [None, None]
    for size in (0, 1, 1023, 1024, 1536, 10 ** 6, 3 * 2 ** 30, 5 * 2 ** 40, 2 ** 60):
        assert memory.convert_bytes(size) == ref.convert_bytes(size)
    memory.clear_device_cache(garbage_collection=True)  # no CUDA here: collects only
    if not torch.cuda.is_available():
        assert memory.get_hbm_stats() == {}
    assert set(memory.OOM_MARKERS) >= set(ref.OOM_MARKERS)
