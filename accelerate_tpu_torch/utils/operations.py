"""Operations over a tree of tensors, and collectives over the processes.

Counterpart of ``accelerate_tpu/utils/operations.py`` (its lines 56-501)
on torch tensors and numpy arrays: the tree helpers (``honor_type``,
``recursively_apply``, ``get_data_structure`` / ``initialize_tensors``,
``get_shape``, ``find_batch_size``, ``listify``, ``send_to_device``,
``pad_input_tensors``, ``slice_tensors``, ``concatenate``,
``drop_padding``, ``convert_to_fp32``, ``find_device``) and the
collectives, over ``torch.distributed``'s group (gloo on the CPU, NCCL on
cards: a tensor goes to the process's device for the call and comes back
where it was): ``gather`` concatenates every process's tensors along dim
0, ``gather_object`` lists every process's object (splicing lists),
``reduce`` sums (or averages) over the processes and multiplies by
``scale``, ``pad_across_processes`` pads to the largest size along
``dim``, ``broadcast`` and ``broadcast_object_list`` give
``from_process``'s. On one process each is the reference's one-process
answer (the input, ``[obj]``, ``t * scale``, unpadded). Over the mesh's
axes (``parallel/mesh.py``): ``make_global_batch`` places this process's
shard of the global batch, ``psum`` / ``pmean`` reduce over the data
axes, ``all_gather_axis`` gathers along one axis.

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


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def num_processes() -> int:
    """The processes of the run: torch.distributed's world when it is up,
    else 1."""
    dist = _dist()
    return dist.get_world_size() if dist else 1


def _comm_device():
    """Where collectives run: the process's card under NCCL, else the CPU."""
    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_tensor(t) -> tuple:
    """(a tensor of ``t`` on the communication device, a function back to
    ``t``'s kind and place)."""
    dev = _comm_device()
    if isinstance(t, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(t)).to(dev), lambda x: x.cpu().numpy()
    home = t.device
    return t.detach().contiguous().to(dev), lambda x: x.to(home)


def gather(tensor):
    """Every tensor of ``tensor`` concatenated over the processes along
    dim 0 (every process's must have one shape: pad them first with
    :func:`pad_across_processes`); on one process, the tensors
    themselves."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return recursively_apply(lambda t: t, tensor)

    def one(t):
        x, back = _as_tensor(t)
        if x.dim() == 0:
            x = x[None]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return back(torch.cat(parts, dim=0))

    return recursively_apply(one, tensor)


def gather_object(obj: Any) -> list:
    """Every process's ``obj`` in a list, in process order (a list's items
    are spliced in): on one process ``[obj]``, or ``obj`` when it is a
    list."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return obj if isinstance(obj, list) else [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    if isinstance(obj, list):
        return [item for part in out for item in part]
    return out


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum (or mean) of every tensor over the processes, times
    ``scale`` (``"none"``: each process's own, times ``scale``)."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be 'sum', 'mean' or 'none', got {reduction!r}")
    dist = _dist()
    n = dist.get_world_size() if dist else 1

    def one(t):
        if n == 1 or reduction == "none":
            return t * scale
        x, back = _as_tensor(t)
        x = x.clone()
        dist.all_reduce(x)
        if reduction == "mean":
            x = x / n
        return back(x * scale)

    return recursively_apply(one, tensor)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Every tensor padded with ``pad_index`` along ``dim`` to the largest
    size any process holds there (at the start with ``pad_first``); a
    tensor with fewer dims passes through."""
    dist = _dist()

    def one(t):
        if dim >= t.ndim:
            return t
        size = int(t.shape[dim])
        if dist is not None and dist.get_world_size() > 1:
            x = torch.tensor([size], device=_comm_device())
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            size = int(x.item())
        missing = size - int(t.shape[dim])
        if missing == 0:
            return t
        shape = list(t.shape)
        shape[dim] = missing
        if isinstance(t, torch.Tensor):
            pad = torch.full(shape, pad_index, dtype=t.dtype, device=t.device)
            return torch.cat([pad, t] if pad_first else [t, pad], dim=dim)
        pad = np.full(shape, pad_index, dtype=t.dtype)
        return np.concatenate([pad, t] if pad_first else [t, pad], axis=dim)

    return recursively_apply(one, tensor)


def broadcast(tensor, from_process: int = 0):
    """Every tensor of ``tensor`` as ``from_process`` holds it (every
    process passes tensors of the same shapes)."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return tensor

    def one(t):
        x, back = _as_tensor(t)
        x = x.clone()
        dist.broadcast(x, src=from_process)
        return back(x)

    return recursively_apply(one, tensor)


def broadcast_object_list(object_list, from_process: int = 0):
    """``object_list`` filled in place with ``from_process``'s items (any
    picklable objects), and returned."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return object_list
    dist.broadcast_object_list(object_list, src=from_process)
    return object_list


def axis_group(mesh, axis_names):
    """The process group of this rank's fellows along ``axis_names`` of
    ``mesh`` taken together (one group per combination of the other axes'
    coordinates; built once per mesh and kept on it, by every rank); None
    for the whole world when ``mesh`` is None."""
    if mesh is None:
        return None
    names = tuple(a for a in mesh.mesh_dim_names if a in axis_names)
    groups = mesh.__dict__.setdefault("_att_axis_groups", {})
    if names not in groups:
        import torch.distributed as dist

        dims = [mesh.mesh_dim_names.index(a) for a in names]
        rest = [d for d in range(mesh.mesh.dim()) if d not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(-1, max(1, int(np.prod(
            [mesh.mesh.shape[d] for d in dims]))))
        groups[names], _ = dist.new_subgroups_by_enumeration([r.tolist() for r in ranks])
    return groups[names]


DATA_AXES = ("replica", "data", "fsdp")


def make_global_batch(data, mesh=None, batch_axes=DATA_AXES, batch_dim: int = 0):
    """This process's shard of the global batch, on its device (one
    process per device: the process's batch IS the device's shard of the
    reference's global array). Checks that the global batch (this
    process's rows x the ranks of ``batch_axes``) divides over them."""
    from ..parallel.mesh import axis_index

    _, degree = axis_index(mesh, batch_axes)
    rows = find_batch_size(data) if batch_dim == 0 else None
    if batch_dim and isinstance(data, dict):
        rows = next((v.shape[batch_dim] for v in data.values()
                     if _is_array(v) and v.ndim > batch_dim), None)
    if rows is not None and (rows * degree) % degree:
        raise ValueError(f"global batch {rows * degree} does not divide over {degree} ranks")
    device = mesh.device_type if mesh is not None else "cpu"
    if mesh is not None and device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return send_to_device(data, device, non_blocking=True)


def psum(x, axis_names=DATA_AXES, mesh=None):
    """``x`` summed over the ranks of ``axis_names`` (the whole world when
    ``mesh`` is None); ``x`` itself on one process."""
    if _dist() is None:
        return x
    y = x.clone()
    _dist().all_reduce(y, group=axis_group(mesh, axis_names))
    return y


def pmean(x, axis_names=DATA_AXES, mesh=None):
    """``x`` averaged over the ranks of ``axis_names``."""
    if _dist() is None:
        return x
    group = axis_group(mesh, axis_names)
    return psum(x, axis_names, mesh) / _dist().get_world_size(group)


def all_gather_axis(x, axis_name, *, axis: int = 0, tiled: bool = True, mesh=None):
    """Every rank's ``x`` along mesh axis ``axis_name``, concatenated along
    ``axis`` (``tiled``) or stacked in a new one; ``x`` on one process."""
    if _dist() is None:
        return x
    group = axis_group(mesh, (axis_name,) if isinstance(axis_name, str) else axis_name)
    parts = [torch.empty_like(x) for _ in range(_dist().get_world_size(group))]
    _dist().all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


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
