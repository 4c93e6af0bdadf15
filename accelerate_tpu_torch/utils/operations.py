"""Operations over a tree of tensors, and collectives on one process.

Counterpart of ``accelerate_tpu/utils/operations.py`` (its lines 56-501)
on torch tensors and numpy arrays: the tree helpers (``honor_type``,
``recursively_apply``, ``get_data_structure`` / ``initialize_tensors``,
``get_shape``, ``find_batch_size``, ``listify``, ``send_to_device``,
``pad_input_tensors``, ``slice_tensors``, ``concatenate``,
``drop_padding``, ``convert_to_fp32``, ``find_device``) and the
collectives with the semantics the reference gives them at one process:
``gather`` returns every tensor as it is, ``gather_object`` a list of the
one object (a list as it is), ``reduce`` multiplies by ``scale`` (the sum
or mean over one process is the value itself), ``pad_across_processes``
pads nothing (every process's size along ``dim`` is this one's),
``broadcast`` and ``broadcast_object_list`` return their input. Their
multi-process forms, and the sharding helpers (``make_global_batch``,
``psum``, ``pmean``, ``all_gather_axis``), are the multi-device slice
(ROADMAP queue 1 item 10).

Where the reference walks a tree in JAX's order, so does this module: a
dict's values in sorted key order (``find_batch_size``, ``find_device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import wraps
from typing import Any, Mapping

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def is_array_like(x) -> bool:
    """A torch tensor or a numpy array."""
    return _is_array(x)


@dataclass(frozen=True)
class TensorInformation:
    """An array's shape and dtype (torch's for a tensor, numpy's for an
    array): the skeleton ``get_data_structure`` gives."""

    shape: tuple
    dtype: Any


def is_tensor_information(x) -> bool:
    return isinstance(x, TensorInformation)


def honor_type(obj, generator):
    """``generator``'s items in ``obj``'s container type (a namedtuple
    takes them as its fields)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*list(generator))
    return type(obj)(generator)


def _leaves(data):
    """The leaves of ``data`` in JAX's tree order: a dict's values by
    sorted key (insertion order where the keys do not sort), lists and
    tuples in order; None is no leaf."""
    if isinstance(data, Mapping):
        try:
            keys = sorted(data)
        except TypeError:
            keys = list(data)
        for k in keys:
            yield from _leaves(data[k])
    elif isinstance(data, (list, tuple)):
        for v in data:
            yield from _leaves(v)
    elif data is not None:
        yield data


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


def broadcast(tensor, from_process: int = 0):
    """Every tensor of ``tensor`` as ``from_process`` holds it: on one
    process, ``tensor`` itself."""
    _one_process("broadcast")
    return tensor


def broadcast_object_list(object_list, from_process: int = 0):
    """``object_list`` filled with ``from_process``'s items: on one
    process, the list itself."""
    _one_process("broadcast_object_list")
    return object_list


def _to_tensor_leaf(x):
    """``send_to_device``'s leaves: numpy arrays and lists of numbers
    become tensors (numpy's dtypes kept), tensors stay."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x) if x.dtype != object else x
    if (isinstance(x, list) and x
            and all(isinstance(i, (int, float, bool)) for i in x)):
        return torch.from_numpy(np.asarray(x))
    return x


def send_to_device(tensor, device, non_blocking: bool = False, skip_keys=None):
    """``tensor`` (a tree) with every tensor on ``device``: numpy arrays
    and lists of numbers become tensors first, as the reference makes
    them arrays; other leaves pass through. The values under a top-level
    key in ``skip_keys`` stay where they are."""
    device = torch.device(device)

    def put(x):
        x = _to_tensor_leaf(x)
        return x.to(device, non_blocking=non_blocking) if isinstance(x, torch.Tensor) else x

    def walk(x):
        if isinstance(x, Mapping):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, list) and _to_tensor_leaf(x) is not x:
            return put(x)
        if isinstance(x, (list, tuple)):
            return honor_type(x, (walk(v) for v in x))
        return put(x)

    if skip_keys and isinstance(tensor, Mapping):
        if isinstance(skip_keys, str):
            skip_keys = [skip_keys]
        return type(tensor)((k, v if k in skip_keys else walk(v)) for k, v in tensor.items())
    return walk(tensor)


def get_data_structure(data):
    """``data`` with every array replaced by its :class:`TensorInformation`."""
    return recursively_apply(lambda t: TensorInformation(tuple(t.shape), t.dtype), data)


def initialize_tensors(data_structure):
    """The reverse of :func:`get_data_structure`: zeros of each shape and
    dtype (a tensor for a torch dtype, an array for a numpy one)."""
    def zeros(info):
        if isinstance(info.dtype, torch.dtype):
            return torch.zeros(info.shape, dtype=info.dtype)
        return np.zeros(info.shape, info.dtype)

    return recursively_apply(zeros, data_structure, test_type=is_tensor_information)


def get_shape(data):
    """``data`` with every array replaced by its shape as a list."""
    return recursively_apply(lambda t: list(t.shape), data)


def find_batch_size(data):
    """Dim 0 of the first array in ``data`` (JAX's tree order), or None."""
    for leaf in _leaves(data):
        if _is_array(leaf):
            return leaf.shape[0]
    return None


def listify(data):
    """``data`` with every array replaced by nested Python lists."""
    return recursively_apply(
        lambda t: t.detach().cpu().tolist() if isinstance(t, torch.Tensor) else t.tolist(),
        data)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Every array whose dim 0 is ``batch_size`` padded by repeating its
    last row until dim 0 divides by ``num_processes``."""
    remainder = batch_size % num_processes
    if remainder == 0:
        return tensor
    missing = num_processes - remainder

    def pad(t):
        if t.shape[0] != batch_size:
            return t
        if isinstance(t, torch.Tensor):
            return torch.cat([t] + [t[-1:]] * missing, dim=0)
        return np.concatenate([t] + [t[-1:]] * missing, axis=0)

    return recursively_apply(pad, tensor)


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):
    """Every array of ``data`` indexed with ``tensor_slice``."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data, dim: int = 0):
    """A list of trees of one structure concatenated leaf by leaf along
    ``dim``."""
    if isinstance(data[0], (tuple, list)):
        return honor_type(data[0], (concatenate([d[i] for d in data], dim=dim)
                                    for i in range(len(data[0]))))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim)
                              for k in data[0].keys()})
    if not _is_array(data[0]):
        raise TypeError(f"Can only concatenate arrays but got {type(data[0])}")
    if isinstance(data[0], torch.Tensor):
        return torch.cat(data, dim=dim)
    return np.concatenate(data, axis=dim)


def drop_padding(tensor, num_real: int):
    """Every array cut to its first ``num_real`` rows."""
    return recursively_apply(lambda t: t[:num_real], tensor)


def _is_half(t) -> bool:
    if isinstance(t, torch.Tensor):
        return t.dtype in (torch.float16, torch.bfloat16)
    return isinstance(t, np.ndarray) and t.dtype == np.float16


def convert_to_fp32(tensor):
    """Every fp16 / bf16 array of ``tensor`` as fp32."""
    return recursively_apply(
        lambda t: t.float() if isinstance(t, torch.Tensor) else t.astype(np.float32),
        tensor, test_type=_is_half)


def convert_outputs_to_fp32(function):
    """``function`` with its fp16 / bf16 outputs made fp32."""
    @wraps(function)
    def wrapper(*args, **kwargs):
        return convert_to_fp32(function(*args, **kwargs))

    return wrapper


def find_device(data):
    """The device of the first tensor in ``data`` (JAX's tree order), or
    None."""
    for leaf in _leaves(data):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None
