"""Collectives over a tree of tensors, on one process.

Counterpart of the part of ``accelerate_tpu/utils/operations.py`` the
``Accelerator``'s methods call (``gather``, ``gather_object``, ``reduce``,
``pad_across_processes``, ``recursively_apply``), with the semantics the
reference gives them at one process: ``gather`` returns every tensor as it
is, ``gather_object`` a list of the one object (a list as it is),
``reduce`` multiplies by ``scale`` (the sum or mean over one process is
the value itself), and ``pad_across_processes`` pads nothing (every
process's size along ``dim`` is this one's). Their multi-process forms
are the multi-device slice (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(func, data, *args, test_type=None, error_on_other_type=False, **kwargs):
    """``func`` applied to every tensor or numpy array leaf of ``data``
    (dicts, lists and tuples keep their structure); another leaf passes
    through, or raises ``TypeError`` with ``error_on_other_type``."""
    test = test_type or _is_array
    if isinstance(data, dict):
        return type(data)((k, recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs)) for k, v in data.items())
    if isinstance(data, (list, tuple)):
        items = [recursively_apply(func, v, *args, test_type=test_type,
                                   error_on_other_type=error_on_other_type, **kwargs)
                 for v in data]
        if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
            return type(data)(*items)
        return type(data)(items)
    if test(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to {func.__name__}.")
    return data


def num_processes() -> int:
    """The processes of the run: torch.distributed's world when it is up,
    else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _one_process(what: str):
    if num_processes() > 1:
        raise NotImplementedError(
            f"{what} across processes is the multi-device slice of the port "
            "(ROADMAP queue 1 item 10)")


def gather(tensor):
    """Every tensor of ``tensor`` concatenated over the processes along
    dim 0: on one process, the tensors themselves."""
    _one_process("gather")
    return recursively_apply(lambda t: t, tensor)


def gather_object(obj: Any) -> list:
    """Every process's ``obj`` in a list (a list's items are spliced in):
    on one process ``[obj]``, or ``obj`` when it is a list."""
    _one_process("gather_object")
    return obj if isinstance(obj, list) else [obj]


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum (or mean) of every tensor over the processes, times
    ``scale``: on one process, each tensor times ``scale``."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be 'sum', 'mean' or 'none', got {reduction!r}")
    _one_process("reduce")
    return recursively_apply(lambda t: t * scale, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Every tensor padded with ``pad_index`` along ``dim`` to the largest
    size any process holds there: on one process, unpadded."""
    _one_process("pad_across_processes")
    return recursively_apply(lambda t: t, tensor)
