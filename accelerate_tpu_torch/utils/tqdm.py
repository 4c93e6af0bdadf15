"""A progress bar on the main process only.

Counterpart of ``accelerate_tpu/utils/tqdm.py``: ``tqdm.auto.tqdm`` that
is disabled off the main process (off each node's main process with
``local=True``), and a plain pass-through of the iterable where ``tqdm``
is not installed. The process's place comes from
``state.current_topology``, so it works before any state exists and
without CUDA.
"""

from __future__ import annotations


def tqdm(*args, main_process_only: bool = True, local: bool = False, **kwargs):
    """``tqdm.auto.tqdm(*args, **kwargs)``, silent off the main process."""
    from ..state import current_topology

    try:
        from tqdm.auto import tqdm as _tqdm
    except ImportError:
        iterable = args[0] if args else kwargs.get("iterable")
        return iter(iterable) if iterable is not None else iter(())
    if main_process_only:
        index, local_index, _ = current_topology()
        kwargs.setdefault("disable", (local_index if local else index) != 0)
    return _tqdm(*args, **kwargs)
