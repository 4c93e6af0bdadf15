"""The process, the accelerator and gradient-accumulation state.

Counterpart of ``accelerate_tpu/state.py`` (``PartialState``,
``AcceleratorState``, ``GradientState``). ``PartialState`` is the
reference's process singleton: every instance shares one dict, which
holds who this process is (``process_index``, ``num_processes``,
``local_process_index``: ``torch.distributed``'s rank and world when it
is initialized, else 0 and 1, and ``ACCELERATE_TPU_LOCAL_PROCESS_ID`` or
``LOCAL_RANK``), its device (one card a process: ``cuda:<local index>``)
and the coordination primitives. It knows nothing of precision.

The process group starts here, once (:func:`init_process_group`, the
reference's ``_maybe_init_jax_distributed``): when the launch
environment names a world, through the reference's contract
(``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``, each also
with its ``ACCELERATE_TPU_`` prefix) or torch's (``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``), on NCCL for a
process on a card and on gloo on the CPU. One process per device: rank
``r`` owns ``cuda:<local rank>`` (NCCL refuses two ranks on one card).

The reference's ``AcceleratorState`` is a singleton too, which refuses a
second, conflicting precision. Here each ``Accelerator`` owns its own
(and its own ``GradientState``): a process may hold accelerators of
different precisions at once. Its topology is the ``PartialState``'s;
its ``mesh`` is a ``DeviceMesh`` over the process group in
``MESH_AXIS_ORDER`` (``parallel/mesh.py``), None where no group is up.
"""

from __future__ import annotations

import builtins
import os
import time
from contextlib import contextmanager
from functools import wraps
from typing import Callable, Optional, Union

import numpy as np
import torch

from .models.decoder import resolve_device
from .utils.dataclasses import (DistributedType, GradientAccumulationPlugin,
                                InitProcessGroupKwargs, MixedPrecisionConfig, ShardingConfig)

LOCAL_PROCESS_ID_ENV = "ACCELERATE_TPU_LOCAL_PROCESS_ID"


def _env(name: str):
    """``ACCELERATE_TPU_<name>``, else ``<name>``, else None."""
    return os.environ.get(f"ACCELERATE_TPU_{name}") or os.environ.get(name) or None


def launch_world() -> Optional[dict]:
    """The world the launch environment names, or None: ``{"rank",
    "world_size", "init_method"}`` from torch's ``RANK`` / ``WORLD_SIZE``
    / ``MASTER_ADDR`` / ``MASTER_PORT`` (a world of one too, as a torch
    launcher writes it), else from the reference's
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` when
    they name more than one process."""
    if all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return {"rank": int(os.environ["RANK"]), "world_size": int(os.environ["WORLD_SIZE"]),
                "init_method": "env://"}
    coord, nproc = _env("COORDINATOR_ADDRESS"), _env("NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        return {"rank": int(_env("PROCESS_ID") or 0), "world_size": int(nproc),
                "init_method": f"tcp://{coord}"}
    return None


def init_process_group(cpu: bool = False,
                       kwargs: Optional[InitProcessGroupKwargs] = None) -> bool:
    """Start ``torch.distributed`` once, when :func:`launch_world` names a
    world: NCCL for a process on a card (bound to ``cuda:<local rank>``),
    gloo on the CPU, unless ``kwargs.backend`` says otherwise; never one
    in place of the other. Returns whether a group is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    world = launch_world()
    if world is None:
        return False
    kwargs = kwargs or InitProcessGroupKwargs()
    options = {}
    if cpu:
        backend = kwargs.backend or "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass cpu=True to run on the CPU")
        backend = kwargs.backend or "nccl"
        device = torch.device("cuda", _local_process_index() % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            options["device_id"] = device
    if kwargs.timeout is not None:
        options["timeout"] = kwargs.timeout
    dist.init_process_group(backend, init_method=kwargs.init_method or world["init_method"],
                            rank=world["rank"], world_size=world["world_size"], **options)
    return True


def _distributed():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def current_topology() -> tuple:
    """``(process_index, local_process_index, num_processes)``: the
    ``PartialState``'s when one exists, else read from
    ``torch.distributed`` and the environment without creating a state
    (which raises where there is no CUDA). For the callers that must work
    before any state exists: ``get_logger``, ``tqdm``."""
    shared = PartialState._shared_state
    if "distributed_type" in shared:
        return shared["process_index"], shared["local_process_index"], shared["num_processes"]
    dist = _distributed()
    index, count = (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)
    return index, _local_process_index(), count


def _local_process_index() -> int:
    return int(os.environ.get(LOCAL_PROCESS_ID_ENV, os.environ.get("LOCAL_RANK", 0)))


class PartialState:
    """The process singleton (the reference's ``PartialState``). Without
    CUDA it raises unless built with ``cpu=True``; once built, every
    ``PartialState()`` is that one, whatever its arguments."""

    _shared_state: dict = {}

    def __init__(self, cpu: bool = False,
                 process_group_kwargs: Optional[InitProcessGroupKwargs] = None, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        init_process_group(cpu, process_group_kwargs)
        dist = _distributed()
        num_processes = dist.get_world_size() if dist else 1
        process_index = dist.get_rank() if dist else 0
        local = _local_process_index()
        if cpu:
            device = torch.device("cpu")
        elif not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass cpu=True to run on the CPU")
        else:
            device = torch.device("cuda", local % torch.cuda.device_count())
        # set as one update: a state that raised above leaves nothing behind
        self.__dict__.update(
            num_processes=num_processes, process_index=process_index,
            local_process_index=local, device=device,
            backend=dist.get_backend() if dist else None,
            distributed_type=(DistributedType.MULTI_HOST if num_processes > 1
                              else DistributedType.NO))

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return "distributed_type" in self.__dict__

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()

    # -- topology ----------------------------------------------------------

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    # -- coordination ------------------------------------------------------

    def wait_for_everyone(self):
        """Every process waits here for the others: a
        ``torch.distributed`` barrier, or nothing on one process."""
        if self.num_processes > 1:
            _distributed().barrier()

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, the others after it."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self):
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    def _only_if(self, test: Callable[[], bool], function: Callable):
        @wraps(function)
        def wrapper(*args, **kwargs):
            if test():
                return function(*args, **kwargs)

        return wrapper

    def on_main_process(self, function: Callable = None):
        """Decorator: ``function`` runs on the main process only."""
        return self._only_if(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable = None):
        return self._only_if(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable):
        return self._only_if(lambda: self.is_last_process, function)

    def on_process(self, function: Callable = None, process_index: int = None):
        if function is None:
            return lambda f: self.on_process(f, process_index)
        return self._only_if(lambda: self.process_index == process_index, function)

    def on_local_process(self, function: Callable = None, local_process_index: int = None):
        if function is None:
            return lambda f: self.on_local_process(f, local_process_index)
        return self._only_if(lambda: self.local_process_index == local_process_index,
                             function)

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of a list, tuple, dict (of equal
        length values), numpy array or tensor; the first ``len % n``
        processes take one item more. With ``apply_padding`` a shorter
        share repeats its last item up to the longest's length, so every
        share has one length (before a gather)."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs)
        if isinstance(inputs, dict):
            length = len(inputs[list(inputs.keys())[0]])
            if not all(len(v) == length for v in inputs.values()):
                raise ValueError("All dict values must have the same length")
        per_process, extras = divmod(length, self.num_processes)
        start = self.process_index * per_process + min(self.process_index, extras)
        end = start + per_process + (1 if self.process_index < extras else 0)
        whole = per_process + (1 if extras > 0 else 0)

        def split(obj):
            if isinstance(obj, dict):
                return {k: split(v) for k, v in obj.items()}
            result = obj[start:end]
            if not apply_padding:
                return result
            if isinstance(result, (torch.Tensor, np.ndarray)):
                missing = whole - result.shape[0]
                if missing > 0:
                    if result.shape[0] == 0:
                        raise IndexError("an empty share has no last item to pad with")
                    last = result[-1:]
                    result = (torch.cat([result] + [last] * missing)
                              if isinstance(result, torch.Tensor)
                              else np.concatenate([result] + [last] * missing, axis=0))
                return result
            return list(result) + [result[-1]] * (whole - len(result))

        yield split(inputs)

    # -- telemetry heartbeat ----------------------------------------------

    def publish_heartbeat(self, step: int):
        """Record this process's training progress in the shared dict:
        ``(step, time.monotonic())``, read through any ``PartialState()``."""
        self.__dict__["telemetry_heartbeat"] = (int(step), time.monotonic())

    @property
    def heartbeat(self):
        """``(step, monotonic time)`` of the last heartbeat, or None."""
        return self.__dict__.get("telemetry_heartbeat")

    def print(self, *args, **kwargs):
        """``print`` on the local main process only."""
        if self.is_local_main_process:
            builtins.print(*args, **kwargs)

    def __repr__(self):
        return (f"Distributed environment: {self.distributed_type}\n"
                f"Num processes: {self.num_processes}\n"
                f"Process index: {self.process_index}\n"
                f"Local process index: {self.local_process_index}\n"
                f"Device: {self.device}\n"
                f"Backend: {self.backend}\n")


class AcceleratorState:
    """The device and the precision policy, over the process's
    ``PartialState`` (whose topology and coordination it hands on:
    ``process_index``, ``wait_for_everyone``, ...). ``device=None`` means
    the process's card and raises without CUDA; ``device="cpu"`` (or
    ``cpu=True``) runs the plain versions of the kernels."""

    def __init__(self, mixed_precision: Union[str, MixedPrecisionConfig] = "no",
                 device=None, cpu: bool = False,
                 sharding_config: Optional[ShardingConfig] = None,
                 process_group_kwargs: Optional[InitProcessGroupKwargs] = None):
        self.device: torch.device = resolve_device("cpu" if cpu else device)
        # a world the environment names starts here too, where the process's
        # PartialState was made before it was named
        init_process_group(self.device.type == "cpu", process_group_kwargs)
        self._partial = PartialState(cpu=self.device.type == "cpu",
                                     process_group_kwargs=process_group_kwargs)
        if device is None and not cpu and self._partial.device.type == "cuda":
            self.device = self._partial.device  # the card with its index
        self.precision = (mixed_precision if isinstance(mixed_precision, MixedPrecisionConfig)
                          else MixedPrecisionConfig(mode=mixed_precision))
        self.sharding_config = sharding_config or _sharding_config_from_env()
        axes = self.sharding_config.resolve(self._partial.num_processes)
        self.mesh = None
        if _distributed() is not None:
            from .parallel.mesh import build_mesh

            self.mesh = build_mesh(axes, device_type=self.device.type)
        self._axes = axes

    @property
    def mesh_shape(self) -> dict:
        """``{axis: size}`` in ``MESH_AXIS_ORDER``, size-1 axes kept (the
        resolved degrees where no process group, and so no mesh, is up)."""
        if self.mesh is None:
            return dict(self._axes)
        from .parallel.mesh import mesh_shape_dict

        return mesh_shape_dict(self.mesh)

    @property
    def mixed_precision(self) -> str:
        return self.precision.mode.value

    def __getattr__(self, name):
        # topology and coordination are the PartialState's
        if name == "_partial" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self._partial, name)

    def __repr__(self):
        return (f"AcceleratorState(device={self.device}, "
                f"mixed_precision={self.mixed_precision!r}, "
                f"distributed_type={self.distributed_type}, "
                f"num_processes={self.num_processes}, mesh={self.mesh_shape})")


def _sharding_config_from_env() -> ShardingConfig:
    """A ``ShardingConfig`` from the launcher's ``ACCELERATE_TPU_*``
    variables (the reference's cascade: ``STRATEGY``, ``DATA_PARALLEL``,
    ``FSDP``, ``TENSOR_PARALLEL``, ``SEQUENCE_PARALLEL``,
    ``EXPERT_PARALLEL``, ``PIPELINE_PARALLEL``, ``REPLICA``,
    ``GRAD_COMPRESSION``); unset or empty means not configured."""
    mapping = {"STRATEGY": ("strategy", str), "DATA_PARALLEL": ("data_parallel", int),
               "FSDP": ("fsdp", int), "TENSOR_PARALLEL": ("tensor_parallel", int),
               "SEQUENCE_PARALLEL": ("sequence_parallel", int),
               "EXPERT_PARALLEL": ("expert_parallel", int),
               "PIPELINE_PARALLEL": ("pipeline_parallel", int),
               "REPLICA": ("replica", int), "GRAD_COMPRESSION": ("grad_compression_dtype", str)}
    kwargs = {}
    for env_name, (field_name, cast) in mapping.items():
        v = os.environ.get(f"ACCELERATE_TPU_{env_name}")
        if v:
            kwargs[field_name] = cast(v)
    return ShardingConfig(**kwargs)


class GradientState:
    """Whether this micro-step ends an accumulation window
    (``sync_gradients``) and whether the active prepared dataloader has
    yielded its last batch (``end_of_dataloader``)."""

    def __init__(self, plugin: Optional[GradientAccumulationPlugin] = None):
        self.plugin = plugin or GradientAccumulationPlugin()
        self.sync_gradients = True
        self.active_dataloader = None
        self._dataloaders = []

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin.sync_with_dataloader

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin.sync_each_batch

    @property
    def end_of_dataloader(self) -> bool:
        return bool(self.active_dataloader is not None
                    and self.active_dataloader.end_of_dataloader)

    @property
    def remainder(self) -> int:
        """The real samples of the active loader's last global batch when
        ``even_batches`` squared it up, else -1."""
        return int(getattr(self.active_dataloader, "remainder", -1))

    def _add_dataloader(self, dataloader):
        self._dataloaders.append(dataloader)
        self.active_dataloader = dataloader

    def _remove_dataloader(self, dataloader):
        self._dataloaders.remove(dataloader)
        self.active_dataloader = self._dataloaders[-1] if self._dataloaders else None

    def _set_sync_gradients(self, value: bool):
        self.sync_gradients = bool(value)

    def __repr__(self):
        return (f"GradientState(num_steps={self.num_steps}, "
                f"sync_gradients={self.sync_gradients}, "
                f"end_of_dataloader={self.end_of_dataloader})")
