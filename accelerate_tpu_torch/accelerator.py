"""The training contract on one device.

Counterpart of ``accelerate_tpu/accelerator.py`` for the single-device
training slice. The user's loop is the reference's:

    accelerator = Accelerator(mixed_precision="bf16", gradient_accumulation_steps=2)
    model, optimizer, scheduler, loader = accelerator.prepare(model, optimizer,
                                                              scheduler, loader)
    for batch in loader:
        with accelerator.accumulate(model):
            loss = model(**batch)["loss"]
            accelerator.backward(loss)
            accelerator.clip_grad_norm_(max_norm=1.0)
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad()

or the fused step, ``step = accelerator.build_train_step()`` then
``metrics = step(batch)`` per update.

fp16 (``mixed_precision="fp16"``, a ``GradScalerKwargs`` among
``kwargs_handlers`` to tune it) trains with the reference's dynamic loss
scale (:class:`LossScale`): each micro-batch's backward starts from loss
x scale, its gradients are divided by the scale (and by the accumulation
count) as soon as they exist and checked for inf / nan; at the update the
flag is read on the host once, an update with a non-finite gradient is
skipped (``optimizer_step_was_skipped``; the parameters, the optimizer's
moments and the LR schedule stay where they were, the update counter
advances, as the reference's engine counts it) and the scale follows the
reference's rule.

Telemetry and trackers are the reference's: ``Accelerator(log_with=
"jsonl", telemetry=TelemetryConfig(...))``, ``init_trackers``, ``log``,
``log_system_metrics`` after an update (the session's rollup through
every tracker), ``prometheus_metrics`` and ``end_training``.

A run resumes as the reference's does: ``Accelerator(project_config=
ProjectConfiguration(project_dir, automatic_checkpoint_naming=True))``,
``save_state()`` every so often and ``load_state()`` in the new process
(``checkpointing.py``: the reference's checkpoint format, so either side
resumes the other's run); ``save_model`` exports the weights.

Where the reference computes gradients inside one jit, the port runs
PyTorch's autograd: ``backward`` sums each micro-batch's gradient, divided
by the accumulation count, into the parameters' ``.grad``; the wrapped
optimizer skips its update until the window closes. Mixed precision
follows the reference's ``_cast_params``: master weights stay fp32 (the
optimizer updates them) and the model rounds every floating parameter to
the compute dtype where it reads it (``DecoderLM.set_param_cast``).
``clip_grad_norm_`` records the threshold and returns the current global
norm, and the clip ``min(1, max_norm / (norm + 1e-6))`` is applied to the
whole accumulated gradient just before the update, as the reference's
update function does.

fp8 (``mixed_precision="fp8"``) is the reference's: bf16 compute over
fp32 masters, and ``prepare`` turns on the model config's ``use_fp8``, so
every projection runs the fp8 recipe (``ops/fp8.py``: ``torch._scaled_mm``
on the card). A model built with ``fp8_recipe="delayed"`` holds amax
histories (``fp8_histories()``); they advance once per optimizer update,
after the eager loop's ``optimizer.step()`` and in ``build_train_step``'s
update without a ``loss_fn``: a user ``loss_fn``'s forwards read the
histories and record nothing, as the reference's discard their writes.

The process API is the reference's (accelerator.py:1746-1843), over the
process's ``PartialState``: ``is_main_process``, ``process_index``,
``wait_for_everyone``, ``main_process_first``, the ``on_*process``
decorators, ``split_between_processes``, ``print``; ``profile()`` opens
a ``torch.profiler`` region (``utils/profiler.py``).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import shutil
import time
import uuid
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from .data import prepare_data_loader
from .ops import fp8
from .data import skip_first_batches as _skip_first_batches
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils import operations
from .utils.operations import send_to_device
from .utils.dataclasses import (NEXT_PART, AutocastKwargs, DataLoaderConfiguration,
                                GradientAccumulationPlugin, GradScalerKwargs,
                                InitProcessGroupKwargs, ProfileKwargs, ProjectConfiguration,
                                ShardingConfig, ShardingStrategy)

logger = logging.getLogger(__name__)


def global_grad_norm(params: Iterable[torch.Tensor], stage=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squared entries, fp32 (optax's
    ``global_norm``), the same on every rank: a sharded gradient's shards
    (``parallel/sharding``) count once, their squared norm summed over
    the ``shard`` group in one all-reduce; parameters without a gradient
    count as zero. ``stage`` (``(ids, group)``, on a ``stage`` axis) names
    the parameters of this rank's pipeline stages: their squared norm is
    summed over the stage group, where every other parameter (replicated
    over the stages, its gradient already summed) counts once."""
    import torch.distributed as dist

    if stage is not None:
        ids, group = stage
        params = list(params)
        own = global_grad_norm([p for p in params if id(p) in ids])
        rest = global_grad_norm([p for p in params if id(p) not in ids])
        sq = (own.float() ** 2).reshape(1).to(rest.device)
        dist.all_reduce(sq, group=group)
        return torch.sqrt(sq[0] + rest.float() ** 2)

    from .parallel.sharding import is_sharded, local_grad

    norms, shards, group = [], [], None
    for p in params:
        g = local_grad(p)
        if g is None:
            continue
        norm = torch.linalg.vector_norm(g.float())
        if is_sharded(p.grad):
            shards.append(norm)
            group = p.grad.device_mesh.get_group("shard")
        else:
            norms.append(norm)
    if shards:
        sq = torch.linalg.vector_norm(torch.stack(shards)) ** 2
        dist.all_reduce(sq, group=group)
        norms.append(torch.sqrt(sq))
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_grads(params, max_norm: float, norm: torch.Tensor):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))`` (a
    sharded one shard by shard)."""
    from .parallel.sharding import local_grad

    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for p in params:
        g = local_grad(p)
        if g is not None:
            g.mul_(scale.to(g.dtype))


def _agree(finite: bool, device) -> bool:
    """Every rank's finite flag AND-ed: one all-reduce of the flag, so no
    rank skips an update alone (the flag itself on one process)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return finite
    flag = torch.tensor([0.0 if finite else 1.0], device=device)
    dist.all_reduce(flag)
    return bool(flag.item() == 0.0)


class LossScale:
    """The reference's dynamic loss scale (``_make_scale_state``,
    ``_scale_state_update``): ``scale`` (fp32) and ``growth_tracker``, the
    finite updates in a row. After a finite update the tracker advances
    and, reaching ``growth_interval``, resets while the scale grows by
    ``growth_factor``; after a non-finite one the scale backs off by
    ``backoff_factor`` but never below 1.0 (torch's ``GradScaler`` has no
    floor) and the tracker resets."""

    def __init__(self, kwargs: GradScalerKwargs):
        self.kwargs = kwargs
        self.scale = float(np.float32(kwargs.init_scale))
        self.growth_tracker = 0

    def update(self, finite: bool):
        k = self.kwargs
        if finite:
            if self.growth_tracker + 1 >= k.growth_interval:
                self.scale = float(np.float32(self.scale) * np.float32(k.growth_factor))
                self.growth_tracker = 0
            else:
                self.growth_tracker += 1
        else:
            self.scale = max(float(np.float32(self.scale) * np.float32(k.backoff_factor)), 1.0)
            self.growth_tracker = 0

    def state_dict(self) -> dict:
        return {"scale": self.scale, "growth_tracker": self.growth_tracker}

    def load_state_dict(self, state: dict):
        self.scale = float(np.float32(state["scale"]))
        self.growth_tracker = int(state["growth_tracker"])


def _unscale(grads, scale: float, inv: float = 1.0) -> torch.Tensor:
    """Divide every gradient by ``scale`` (then multiply by ``inv``) in
    place, as the reference's ``g / scale`` (``* inv_steps``); returns a
    bool [1] device tensor, all of them finite."""
    if not grads:
        return torch.ones(1, dtype=torch.bool)
    torch._foreach_div_(grads, scale)
    if inv != 1.0:
        torch._foreach_mul_(grads, inv)
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.ones(1, device=grads[0].device))
    return found == 0


def _scaled_backward(loss: Optional[torch.Tensor], params, scale: float, post,
                     run: Optional[Callable] = None):
    """One micro-batch's backward from ``loss * scale`` (or ``run()``, a
    backward of its own: the 1F1B schedule's) into fresh gradients,
    ``post(grads)`` applied to them (the unscale), then added to what
    ``params`` had accumulated: the reference's per-micro-batch ``acc +
    g``. Returns ``(what post returns, what run returns)``."""
    from .parallel.sharding import local_grad

    stash = [p.grad for p in params]
    for p in params:
        p.grad = None
    ran = run() if run is not None else (loss.float() * scale).backward()
    out = post([local_grad(p) for p in params if p.grad is not None])
    for p, acc in zip(params, stash):
        if acc is not None and p.grad is not None:
            p.grad = acc.add_(p.grad)
        elif acc is not None:
            p.grad = acc
    return out, ran


def _lm_batch(model, vag, batch) -> tuple:
    """(the keyword arguments of the 1F1B value-and-grad ``vag`` for
    ``batch``, or None; the reason it falls back, or None): an
    ``(input_ids, labels)`` batch (a dict, or a tuple bound by the model
    call's signature), plus any other keyword ``vag`` takes (a seq2seq
    model's ``attention_mask``)."""
    import inspect

    if isinstance(batch, dict):
        named = dict(batch)
    elif isinstance(batch, (list, tuple)):
        names = [n for n, p in inspect.signature(model.forward).parameters.items()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        if len(batch) > len(names):
            return None, f"{len(batch) - len(names)} extra positional arg(s) forced the fallback"
        named = dict(zip(names, batch))
    else:
        return None, "the batch is not a dict or a tuple"
    if "labels" not in named or "input_ids" not in named:
        return None, "the batch carries no labels" if "labels" not in named else \
            "the batch carries no input_ids"
    takes = set(inspect.signature(vag).parameters) - {"scale"}
    extra = sorted(k for k in named if k not in takes)
    if extra:
        return None, f"batch key(s) {', '.join(extra)} forced the fallback"
    return named, None


def _call(model, batch):
    if isinstance(batch, dict):
        return model(**batch)
    if isinstance(batch, (list, tuple)):
        return model(*batch)
    return model(batch)


def _loss_of(out) -> torch.Tensor:
    return (out["loss"] if isinstance(out, dict) else out).float()


def _index(batches, i: int, k: int):
    """Update ``i``'s batch of a ``steps_per_call=k`` window: entry ``i``
    along the leading [k] axis of every tensor and array."""
    if isinstance(batches, (torch.Tensor, np.ndarray)):
        if batches.shape[0] != k:
            raise ValueError(
                f"a steps_per_call={k} batch needs a leading [{k}] axis, got "
                f"{tuple(batches.shape)}"
            )
        return batches[i]
    if isinstance(batches, dict):
        return type(batches)((key, _index(v, i, k)) for key, v in batches.items())
    if isinstance(batches, (list, tuple)):
        return type(batches)(_index(v, i, k) for v in batches)
    return batches


def _split(batch, micro: int):
    """``micro`` contiguous micro-batches along dim 0 of every tensor."""
    if micro == 1:
        return [batch]

    def part(x, i):
        if isinstance(x, torch.Tensor):
            if x.shape[0] % micro:
                raise ValueError(
                    f"batch dimension {x.shape[0]} is not divisible by {micro} micro-steps"
                )
            n = x.shape[0] // micro
            return x[i * n:(i + 1) * n]
        if isinstance(x, dict):
            return type(x)((k, part(v, i)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(part(v, i) for v in x)
        return x

    return [part(batch, i) for i in range(micro)]


def _checkpoint_index(folder: str) -> int:
    """The integer suffix of ``checkpoint_<i>``, -1 without one."""
    tail = folder.rsplit("_", 1)[-1]
    return int(tail) if tail.isdigit() else -1


_fp8_tensor_cores_warned = False


def _device_has_fp8_tensor_cores(device) -> bool:
    """fp8 tensor cores arrive with compute capability 8.9 (Ada) and 9.0
    (Hopper)."""
    device = torch.device(device)
    return device.type == "cuda" and torch.cuda.get_device_capability(device) >= (8, 9)


def _warn_fp8_without_tensor_cores_once(device) -> None:
    """One notice when mixed_precision='fp8' lands where no fp8 tensor core
    is (the reference's ``_warn_fp8_without_mxu_once``): the recipe stays
    numerically the same, but the products run their plain version on the
    CPU and raise on an older card."""
    global _fp8_tensor_cores_warned
    if _fp8_tensor_cores_warned or _device_has_fp8_tensor_cores(device):
        return
    _fp8_tensor_cores_warned = True
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    warnings.warn(
        f"mixed_precision='fp8' on {kind!r}: it has no fp8 tensor cores (compute "
        "capability 8.9 or later), so the fp8 products run their plain version "
        "(fp32 matmuls over fp8-rounded operands, slower than bf16) on the CPU and "
        "raise in torch._scaled_mm on an older card. Use mixed_precision='bf16' "
        "here if you want throughput.",
        stacklevel=3,
    )


def _enable_fp8(model) -> None:
    """Turn on ``config.use_fp8`` of a model whose config has the knob (a
    copy of the config, set on every module that shares it, as the
    reference's ``_enable_fp8`` copies the definition); other models pass
    through. A model built without the delayed recipe's histories then
    runs current scaling."""
    import dataclasses

    cfg = getattr(model, "config", None)
    if cfg is None or not hasattr(cfg, "use_fp8") or cfg.use_fp8:
        return
    new = dataclasses.replace(cfg, use_fp8=True)
    for m in model.modules():
        if getattr(m, "config", None) is cfg:
            m.config = new


class _RemovableHandle:
    def __init__(self, registry: dict, key):
        self.registry = registry
        self.key = key

    def remove(self):
        self.registry.pop(self.key, None)


class Accelerator:
    """``mixed_precision`` "no", "bf16", "fp16" or "fp8";
    ``gradient_accumulation_steps`` (or a
    ``GradientAccumulationPlugin``); ``project_dir`` / ``project_config``
    (a ``ProjectConfiguration``): where ``save_state`` writes;
    ``kwargs_handlers``: a ``GradScalerKwargs`` (the fp16 loss scale's
    rule), an ``AutocastKwargs`` and a ``ProfileKwargs`` (what
    ``profile()`` records); ``dataloader_config``: a
    ``DataLoaderConfiguration`` (its ``prefetch_depth`` is what one
    process reads; ``split_batches`` sets its field); ``log_with``:
    trackers (``tracking.py``); ``telemetry``: a ``TelemetryConfig``,
    True, or None to read ``ATT_TELEMETRY``; ``device=None`` means the
    process's card and raises without CUDA, ``device="cpu"`` (or the
    reference's ``cpu=True``) runs the plain versions of the kernels."""

    def __init__(self, mixed_precision="no", gradient_accumulation_steps: int = 1,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 kwargs_handlers: Optional[list] = None, log_with=None, telemetry=None,
                 device=None, cpu: bool = False,
                 dataloader_config: Optional[DataLoaderConfiguration] = None,
                 split_batches: bool = False,
                 sharding_config: Optional[ShardingConfig] = None):
        if gradient_accumulation_plugin is not None and gradient_accumulation_steps != 1:
            raise ValueError(
                "pass gradient_accumulation_steps or gradient_accumulation_plugin, not both"
            )
        plugin = gradient_accumulation_plugin or GradientAccumulationPlugin(
            num_steps=gradient_accumulation_steps)
        self.scaler_handler: Optional[GradScalerKwargs] = None
        self.autocast_handler: Optional[AutocastKwargs] = None
        self.profile_handler: Optional[ProfileKwargs] = None
        self.init_handler: Optional[InitProcessGroupKwargs] = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, ProfileKwargs):
                self.profile_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            else:
                raise TypeError(f"kwargs_handlers takes GradScalerKwargs, AutocastKwargs, "
                                f"ProfileKwargs and InitProcessGroupKwargs, got {handler!r}")
        if cpu and device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"cpu=True and device={device!r} disagree")
        if sharding_config is not None and sharding_config.unsupported():
            raise NotImplementedError(
                f"ShardingConfig {', '.join(sharding_config.unsupported())}: {NEXT_PART}")
        self.state = AcceleratorState(mixed_precision, device, cpu=cpu,
                                      sharding_config=sharding_config,
                                      process_group_kwargs=self.init_handler)
        from .parallel.sharding import resolve_strategy

        self.sharding_strategy = resolve_strategy(self.state.sharding_config, self.state.mesh)
        if self.state.mesh is None and self.sharding_strategy != ShardingStrategy.DP:
            raise RuntimeError(
                f"strategy {self.sharding_strategy} shards over a device mesh, which needs a "
                "process group: launch with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT "
                "(a world of one too) or with launchers.debug_launcher")
        if self.state.mixed_precision == "fp8" and self.state.num_processes > 1:
            raise NotImplementedError(
                "mixed_precision='fp8' on more than one process: the delayed recipe's amax "
                f"is a max over every rank's, a max-all-reduce of each history ({NEXT_PART})")
        if self.state.mixed_precision == "fp8":
            _warn_fp8_without_tensor_cores_once(self.state.device)
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        if self.scaler_handler is not None:
            self.state.precision.grad_scaler = self.scaler_handler
        self.loss_scale: Optional[LossScale] = (
            LossScale(self.state.precision.grad_scaler)
            if self.state.precision.needs_loss_scaling else None)
        self._finite: Optional[torch.Tensor] = None  # this window's gradients all finite
        self._update_finite = True   # the decision of the window's first update
        self.gradient_state = GradientState(plugin)
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.step = 0  # micro-steps since the last sync (accumulate())
        self._clip_max_norm: Optional[float] = None
        self._models, self._optimizers, self._schedulers, self._dataloaders = [], [], [], []
        self._custom_objects: list = []
        self._save_model_state_pre_hook: dict = {}
        self._load_model_state_pre_hook: dict = {}
        self.flag_tensor = None
        from .tracking import filter_trackers

        self.log_with = filter_trackers(log_with, self.logging_dir)
        self.trackers: list = []
        from .telemetry import TelemetrySession, resolve_config

        tcfg = resolve_config(telemetry)
        self.telemetry = TelemetrySession(tcfg, accelerator=self) if tcfg else None
        self._pending_loss = None  # the last micro-batch's loss, for the step record
        self._fused = False        # inside build_train_step's step: no per-call counting
        self._fused_update = False  # inside build_train_step's update: it rolls the histories
        # id(parameter before sharding) -> the parameter prepare_model left in
        # its place (FSDP2 replaces each with a sharded one)
        self._param_map: dict = {}
        # ids of the replicated parameters clip_grad_norm_ reduced in this
        # window: the update does not reduce them again
        self._reduced: set = set()

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mesh(self):
        """The ``DeviceMesh`` over the process group (``parallel/mesh.py``),
        or None on one process without a group."""
        return self.state.mesh

    @property
    def sharding_config(self) -> ShardingConfig:
        return self.state.sharding_config

    # -- the process API (the reference's accelerator.py:1746-1843) ------

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    def on_main_process(self, function):
        return self.state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.on_process(function, process_index)

    def on_last_process(self, function):
        return self.state.on_last_process(function)

    def wait_for_everyone(self):
        self.state.wait_for_everyone()

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.split_between_processes(inputs, apply_padding=apply_padding)

    def print(self, *args, **kwargs):
        self.state.print(*args, **kwargs)

    def profile(self, profile_handler: Optional[ProfileKwargs] = None):
        """A ``torch.profiler`` region (``utils/profiler.ProfileContext``)
        from ``profile_handler``, the accelerator's ``ProfileKwargs`` or
        the defaults; its trace is named for this process's index."""
        handler = profile_handler or self.profile_handler or ProfileKwargs()
        return handler.build(suffix=str(self.process_index))

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> Optional[str]:
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        """The index of the next automatically named checkpoint."""
        return self.project_configuration.iteration

    @property
    def optimizer_step_was_skipped(self) -> bool:
        """True when the last update of a prepared optimizer was skipped
        for non-finite fp16 gradients."""
        return any(opt.step_was_skipped for opt in self._optimizers)

    # what the telemetry session reads of its training owner (the
    # reference TrainEngine's names)

    @property
    def step_count(self) -> int:
        """Updates of the last prepared optimizer (skipped ones counted)."""
        return self._optimizers[-1].step_count if self._optimizers else 0

    @property
    def scale_state(self) -> Optional[dict]:
        """``{"scale", "growth_tracker"}`` of the fp16 loss scale, or None."""
        return None if self.loss_scale is None else self.loss_scale.state_dict()

    def last_step_skipped(self) -> bool:
        return self.optimizer_step_was_skipped

    @property
    def extra_state(self) -> dict:
        """The reference TrainEngine's mutable collections: ``{"fp8_stats":
        {buffer name: [2, H]}}`` of the last prepared model's amax
        histories (what telemetry's ``fp8_amax_health`` reads), or {}."""
        model = self._models[-1] if self._models else None
        hists = model.fp8_histories() if hasattr(model, "fp8_histories") else {}
        return {"fp8_stats": hists} if hists else {}

    @property
    def model_config(self):
        """The last prepared model's config (FLOPs per token), or None."""
        return getattr(self._models[-1], "config", None) if self._models else None

    # -- prepare ---------------------------------------------------------

    def prepare(self, *args):
        """Prepare models first, then optimizers, then LR schedulers (which
        need the prepared optimizers), then data loaders (any other
        iterable). Returns the objects in the order given."""
        result = list(args)
        kinds = (
            (nn.Module, self.prepare_model),
            (torch.optim.Optimizer, self.prepare_optimizer),
            (torch.optim.lr_scheduler.LRScheduler, self.prepare_scheduler),
        )
        done = [False] * len(result)
        for cls, fn in kinds:
            for i, obj in enumerate(result):
                if not done[i] and isinstance(obj, cls):
                    result[i], done[i] = fn(obj), True
        for i, obj in enumerate(result):
            if done[i]:
                continue
            if not hasattr(obj, "__iter__") or isinstance(obj, (torch.Tensor, str, dict)):
                raise TypeError(f"prepare() does not know what to do with {obj!r}")
            result[i] = self.prepare_data_loader(obj)
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module) -> nn.Module:
        """Move the model to the device, make its parameters train and set
        its mixed-precision cast. Floating parameters must already be the
        master dtype (fp32)."""
        model.to(self.device)
        model.requires_grad_(True)
        if self.mixed_precision == "fp8":
            _enable_fp8(model)
        want = self.state.precision.param_dtype
        bad = sorted({str(p.dtype) for p in model.parameters()
                      if p.is_floating_point() and p.dtype != want})
        if bad:
            raise ValueError(
                f"the model holds {bad} parameters; training keeps {want} master "
                "weights (build the model with param_dtype=torch.float32)"
            )
        cast = self.state.precision.compute_dtype
        cast = None if cast == want else cast
        if hasattr(model, "set_param_cast"):
            model.set_param_cast(cast)
        elif cast is not None:
            raise TypeError(
                f"mixed_precision={self.mixed_precision!r} rounds parameters at use, "
                "which needs a model with set_param_cast() (the port's models)"
            )
        if self.mesh is not None:
            self._shard(model)
        self._models.append(model)
        if self.telemetry is not None:
            import inspect

            self.telemetry.attach_engine(self)
            names = tuple(n for n, p in inspect.signature(model.forward).parameters.items()
                          if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))

            def note_batch(module, args, kwargs):
                # a training call's tokens go to the next step record (the
                # fused step counts its own batches)
                if (self.telemetry is not None and module.training
                        and torch.is_grad_enabled() and not self._fused):
                    self.telemetry.note_batch(args, kwargs, names)

            model.register_forward_pre_hook(note_batch, with_kwargs=True)
        return model

    def _shard(self, model: nn.Module):
        """Give a port model the mesh (its loss then averages over the
        global batch; a decoder rings over a ``sequence`` axis) and lay its
        parameters out by the strategy (``parallel/sharding.py``), noting
        which new parameter replaces which for the optimizers prepared
        next."""
        from .parallel.sharding import apply_sharding

        if hasattr(model, "set_mesh") and getattr(model, "mesh", None) is None:
            model.set_mesh(self.mesh)
        before = dict(model.named_parameters())
        apply_sharding(model, self.mesh, self.sharding_config)
        after = dict(model.named_parameters())
        for name, p in before.items():
            # None: a block another rank of the stage group holds
            self._param_map[id(p)] = after.get(name)

    def _rebind(self, optimizer: torch.optim.Optimizer):
        """Point ``optimizer``'s groups (and any state) at the parameters
        that sharding put in place of the ones it was built over, dropping
        those of blocks another stage's rank holds."""
        if not self._param_map:
            return
        pm = self._param_map
        for group in optimizer.param_groups:
            group["params"] = [pm.get(id(p), p) for p in group["params"]
                               if pm.get(id(p), p) is not None]
        state = optimizer.state
        for old in list(state):
            new = pm.get(id(old), old)
            if new is None:
                state.pop(old)
            elif new is not old:
                state[new] = state.pop(old)

    def _sync_fsdp(self, sync: bool):
        """Whether the sharded models reduce their gradients in the coming
        backward (FSDP2's ``set_requires_gradient_sync``): off inside
        ``no_sync`` and between an accumulation window's micro-batches."""
        for model in self._models:
            if hasattr(model, "set_requires_gradient_sync"):
                model.set_requires_gradient_sync(sync)

    def _reduce_replicated(self, params, window_ends: bool = True):
        """Average the replicated parameters' gradients over the ranks, once
        a window (DP's all-reduce; FSDP's parameters below
        ``min_weight_size_to_shard``). ``clip_grad_norm_`` reduces them
        early (``window_ends`` False) for the global norm; the update then
        reduces only those it did not."""
        if self.mesh is None or self.num_processes == 1:
            return
        from .parallel.sharding import reduce_replicated

        params = list(params)
        stage = self._stage()
        if stage is not None:
            todo = [p for p in params if id(p) not in self._reduced]
            reduce_replicated(todo, self.mesh, stage)
        else:
            todo = [p for p in params if p.grad is not None and id(p) not in self._reduced]
            reduce_replicated(todo)
        if window_ends:
            self._reduced.difference_update(map(id, params))
        else:
            self._reduced.update(map(id, todo))

    def _stage(self):
        """``(ids of this rank's pipeline-stage parameters, the stage
        group)`` on a mesh whose ``stage`` axis is > 1, else None."""
        from .parallel.mesh import axis_size

        if axis_size(self.mesh, "stage") <= 1:
            return None
        ids, group = set(), None
        for model in self._models:
            if getattr(model, "num_stages", 1) > 1:
                ids |= model.stage_param_ids()
                group = model.stage_plan().group
        return None if group is None else (ids, group)

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        self._rebind(optimizer)
        wrapped = AcceleratedOptimizer(optimizer, self.gradient_state,
                                       pre_step=self._before_update,
                                       post_step=self._after_update)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        wrapped = AcceleratedScheduler(scheduler, self._optimizers, self.gradient_state)
        self._schedulers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, loader):
        prepared = prepare_data_loader(loader, self.device, self.gradient_state,
                                       prefetch_depth=self.dataloader_config.prefetch_depth,
                                       mesh=self.mesh, config=self.dataloader_config)
        self._dataloaders.append(prepared)
        return prepared

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The model itself: prepare() does not wrap modules."""
        return model

    # -- the eager loop --------------------------------------------------

    def backward(self, loss: torch.Tensor, **kwargs):
        """Add this micro-batch's gradient, divided by the accumulation
        count, to the parameters' ``.grad``. Under fp16 the backward
        starts from ``loss * scale`` into fresh gradients, which are
        divided by the scale and the count, checked for inf / nan and
        added to the accumulated ones."""
        if self.telemetry is not None:
            self._pending_loss = loss.detach()
        self._reduced.clear()  # new local gradients join the reduced ones
        n = self.gradient_state.num_steps
        if self.loss_scale is None:
            (loss / n).backward(**kwargs)
            return
        if kwargs:
            raise TypeError(f"backward() under fp16 loss scaling takes no {sorted(kwargs)}")
        params = [p for p in self._model_params() if p.requires_grad]
        scale = self.loss_scale.scale
        finite, _ = _scaled_backward(loss, params, scale, lambda g: _unscale(g, scale, 1.0 / n))
        self._finite = finite if self._finite is None else self._finite & finite

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Mark this micro-step as closing an accumulation window (every
        ``num_steps``-th step, or the end of a prepared dataloader) or not."""
        gs = self.gradient_state
        if gs.sync_with_dataloader and gs.end_of_dataloader:
            self.step = 0
            gs._set_sync_gradients(True)
        else:
            self.step += 1
            gs._set_sync_gradients(self.step % gs.num_steps == 0 or gs.sync_each_batch)
        self._sync_fsdp(gs.sync_gradients or self.loss_scale is not None)
        yield

    def _model_params(self):
        return [p for m in self._models for p in m.parameters()]

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: int = 2):
        """Record ``max_norm`` for the coming updates and return the global
        norm of the gradients accumulated so far."""
        if norm_type != 2:
            raise ValueError("only L2 gradient clipping is supported")
        self._clip_max_norm = float(max_norm)
        params = list(parameters) if parameters is not None else self._model_params()
        if self.sync_gradients:
            # the window's gradients are whole: reduce the replicated ones
            # now, so the norm is the global one (the update skips them)
            self._reduce_replicated(params, window_ends=False)
        return global_grad_norm(params, self._stage())

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0):
        """Clamp every gradient entry to [-clip_value, clip_value] now, in
        place (``torch.nn.utils.clip_grad_value_``; fp16 gradients are
        already unscaled here). The reference raises: its update fuses the
        gradient into one sharded program (ROADMAP queue 3)."""
        params = list(parameters) if parameters is not None else self._model_params()
        torch.nn.utils.clip_grad_value_(params, clip_value)

    def _before_update(self, optimizer: AcceleratedOptimizer) -> bool:
        """At a window's update: under fp16 read the finite flag (one host
        read a window; every optimizer of the window shares it) and move
        the loss scale; then the clip. Returns whether to apply."""
        self._reduce_replicated(optimizer.parameters())
        if self.loss_scale is not None and self._finite is not None:
            self._update_finite = _agree(bool(self._finite.item()), self.device)
            self._finite = None
            self.loss_scale.update(self._update_finite)
        finite = self._update_finite if self.loss_scale is not None else True
        if finite and self._clip_max_norm is not None:
            params = optimizer.parameters()
            _clip_grads(params, self._clip_max_norm, global_grad_norm(params, self._stage()))
        return finite

    def _after_update(self, optimizer: AcceleratedOptimizer):
        if not self._fused_update:
            self._roll_fp8(optimizer)
        if self.telemetry is not None and not self._fused:
            self.telemetry.on_optimizer_step(self)

    def _roll_fp8(self, optimizer: AcceleratedOptimizer):
        """Advance the amax histories of the models ``optimizer`` updates one
        step (the reference's ``_roll_fp8_stats``): micro-steps between two
        updates shared the current slot."""
        ids = {id(p) for p in optimizer.parameters()}
        for model in self._models:
            if hasattr(model, "fp8_histories") and any(id(p) in ids for p in model.parameters()):
                fp8.roll_amax_histories(model)

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """Hold ``sync_gradients`` False inside: the optimizer steps and
        zero_grads there are skipped and the gradients keep summing, each
        rank's own: a sharded model's backward reduces nothing there (the
        first backward after it reduces what was summed), and replicated
        gradients are reduced once, at the update."""
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        self._sync_fsdp(self.loss_scale is not None)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)
            self._sync_fsdp(True)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches=None):
        """One process has no uneven inputs to join: a context that does
        nothing, as the reference's on one device."""
        yield

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastKwargs] = None):
        """The precision policy is applied where the model reads its
        parameters (``set_param_cast``), so there is nothing to switch: a
        context that does nothing, as the reference's."""
        yield

    # -- the fused step --------------------------------------------------

    def build_train_step(self, loss_fn: Optional[Callable] = None,
                         micro_steps: Optional[int] = None,
                         steps_per_call: Optional[int] = None):
        """``step(batch) -> {"loss", "grad_norm"}``: one optimizer update.
        The batch (this rank's part of the global one) is cut into
        ``micro_steps`` (default: the accumulation count) contiguous
        micro-batches along dim 0; their gradients and losses are averaged
        (a sharded model reduces its gradients once, in the last
        micro-batch's backward; replicated ones are reduced after it);
        ``grad_norm`` is the averaged gradient's global norm before the
        clip, over every shard; the clip (if ``clip_grad_norm_`` set one), the
        optimizer update and the LR schedulers follow. ``loss_fn(model,
        micro_batch)`` replaces the model call when given; its forwards
        read the delayed fp8 recipe's amax histories and record nothing, and
        the update does not roll them (the reference's user-loss path has
        no handle on the collection).

        ``steps_per_call=K`` (the reference's fused window): every batch
        leaf carries a leading [K] axis, and one call runs K full updates,
        update i on batch i with its own micro-batch split, clip and
        scheduler step. It returns the last update's metrics plus
        ``loss_mean`` over the K. The reference scans the K updates inside
        one program to save host dispatches; here they are a loop of the
        eager step, with no CUDA graph, since the training step keeps the
        card busy (5.0% idle on small_1b at B 8 x 2048 on an NVIDIA H100
        80GB HBM3 at 700.00 W, PERF.md)."""
        k = int(steps_per_call or 1)
        if k < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        if not self._models or not self._optimizers:
            raise RuntimeError("prepare(model, optimizer) before build_train_step")
        model, opt = self._models[-1], self._optimizers[-1]
        schedulers = list(self._schedulers)
        micro = micro_steps or self.gradient_state.num_steps
        params = opt.parameters()
        # a 1F1B-scheduled pipelined model trains (input_ids, labels)
        # batches through its own value-and-grad; any other batch falls
        # back to autograd through the GPipe forward, with one warning
        vag = None
        if loss_fn is None and hasattr(model, "pipeline_value_and_grad"):
            vag = model.pipeline_value_and_grad()

        def step(batch):
            try:
                return update(batch)
            except BaseException:
                # a step that raised (out of memory, say) leaves no copy of
                # the weights behind: the next step starts where this one did
                if hasattr(model, "release_casts"):
                    model.release_casts()
                raise

        def update(batch):
            batch = send_to_device(batch, self.device, non_blocking=True)
            opt.optimizer.zero_grad(set_to_none=True)
            self._reduced.clear()
            loss = torch.zeros((), device=self.device)
            scale = None if self.loss_scale is None else self.loss_scale.scale
            record = getattr(model, "fp8_record", None)
            if loss_fn is not None and record is not None:
                model.fp8_record = False
            parts = _split(batch, micro)
            try:
                for i, mb in enumerate(parts):
                    # a sharded model reduces once, in the last micro-batch's
                    # backward (every one under fp16: its unscale reads each
                    # micro-batch's reduced gradient)
                    self._sync_fsdp(i == len(parts) - 1 or scale is not None)
                    kw = None
                    if vag is not None:
                        kw, why = _lm_batch(model, vag, mb)
                        if kw is None:
                            self._warn_pipeline_fallback(why)
                    div = (lambda g: torch._foreach_div_(g, micro) if g else None)
                    if kw is not None:  # the 1F1B schedule's own backward
                        if scale is None:
                            out = vag(**kw, scale=1.0 / micro)
                        else:
                            _, out = _scaled_backward(None, params, scale, div,
                                                      run=lambda: vag(**kw, scale=scale))
                        mb_loss = _loss_of(out)
                    else:
                        out = loss_fn(model, mb) if loss_fn is not None else _call(model, mb)
                        mb_loss = _loss_of(out)
                        if scale is None:
                            (mb_loss / micro).backward()
                        else:  # the reference's acc + g / micro over scaled gradients
                            _scaled_backward(mb_loss, params, scale, div)
                    loss = loss + mb_loss.detach() / micro
            finally:
                if record is not None:
                    model.fp8_record = record
                self._sync_fsdp(True)
            self._reduce_replicated(params)
            finite = True
            if scale is not None:
                from .parallel.sharding import local_grad

                grads = [local_grad(p) for p in params if p.grad is not None]
                # one host read an update, agreed across the ranks
                finite = _agree(bool(_unscale(grads, scale).item()), self.device)
                self.loss_scale.update(finite)
            norm = global_grad_norm(params, self._stage())
            if finite and self._clip_max_norm is not None:
                _clip_grads(params, self._clip_max_norm, norm)
            self._fused_update = True
            try:
                opt.update(skip=not finite)
            finally:
                self._fused_update = False
            if loss_fn is None:
                self._roll_fp8(opt)
            if finite:
                for sched in schedulers:
                    sched.scheduler.step()
            return {"loss": loss, "grad_norm": norm}

        def window(batches):
            losses, metrics, skipped = [], None, False
            for i in range(k):
                metrics = step(_index(batches, i, k))
                losses.append(metrics["loss"])
                skipped |= opt.step_was_skipped
            # a skip anywhere in the window shows, as the reference's
            opt.step_was_skipped = skipped
            return {**metrics, "loss_mean": torch.stack(losses).mean()}

        run = step if k == 1 else window

        def timed(batch):
            tm = self.telemetry
            if tm is None:
                return run(batch)
            from .telemetry.metrics import batch_token_count

            t0 = time.perf_counter()
            self._fused = True
            try:
                metrics = run(batch)
            finally:
                self._fused = False
            tokens, samples, seq_len = batch_token_count(batch)
            tm.on_step(self, time.perf_counter() - t0, tokens=tokens, samples=samples,
                       seq_len=seq_len, steps=k, metrics=metrics)
            return metrics

        return timed

    def _warn_pipeline_fallback(self, reason: str):
        """One notice that a 1F1B-scheduled model trains a batch through the
        GPipe fallback (the reference's ``_warn_pipeline_fallback``): the
        gradients are the same, but its activations for ALL microbatches
        are kept (O(M) where the schedule keeps O(S))."""
        if getattr(self, "_pipeline_fallback_warned", False):
            return
        self._pipeline_fallback_warned = True
        logger.warning(
            "model exposes pipeline_value_and_grad (1f1b schedule) but this training step "
            "runs through the autograd/GPipe fallback: %s. The fallback computes the same "
            "gradients but keeps activations for ALL microbatches (O(M) memory instead of "
            "the schedule's O(S)): a model sized for 1F1B can run out of memory here. Feed "
            "plain (input_ids, labels) batches to use the configured schedule.", reason)

    # -- one-process collectives (the reference's accelerator.py:2049-2097)

    def gather(self, tensor):
        return operations.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """``gather`` of tensors (``gather_object`` of anything else, or
        with ``use_gather_object``), then, at the end of a prepared loader
        whose last global batch ``even_batches`` squared up, only its
        ``remainder`` real samples (the reference's accelerator.py:2052)."""
        try:
            operations.recursively_apply(lambda x: x, input_data, error_on_other_type=True)
            all_tensors = True
        except TypeError:
            all_tensors = False
        if use_gather_object or not all_tensors:
            data = operations.gather_object(input_data)
        else:
            data = self.gather(input_data)
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            def trim(t):
                return t if getattr(t, "ndim", 1) == 0 else t[:gs.remainder]

            if isinstance(data, list) and (use_gather_object or not all_tensors):
                return data[:gs.remainder]
            return operations.recursively_apply(trim, data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return operations.reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return operations.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                               pad_first=pad_first)

    def prepare_for_eval(self, batch, batch_dim: int = 0):
        """An eval batch placed as the prepared loaders place theirs: on
        the device. ``batch_dim`` is kept for the reference's signature
        (one process shards nothing)."""
        return send_to_device(batch, self.device, non_blocking=True)

    def set_trigger(self):
        """Raise the breakpoint flag that :meth:`check_trigger` reads."""
        self.flag_tensor = True

    def check_trigger(self) -> bool:
        """True once after :meth:`set_trigger` (on any process: one here)."""
        flags = operations.gather_object([1 if self.flag_tensor else 0])
        if any(flags):
            self.flag_tensor = False
            return True
        return False

    # -- trackers and telemetry (the reference's accelerator.py:2113-2175)

    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None):
        from .tracking import resolve_trackers

        self.trackers = resolve_trackers(self.log_with, project_name, self.logging_dir,
                                         init_kwargs or {})
        if config is not None:
            for tracker in self.trackers:
                tracker.store_init_configuration(config)

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        from .tracking import GeneralTracker

        return GeneralTracker(_blank=True)

    def log(self, values: dict, step: Optional[int] = None,
            log_kwargs: Optional[dict] = None):
        log_kwargs = log_kwargs or {}
        for tracker in self.trackers:
            tracker.log(values, step=step, **log_kwargs.get(tracker.name, {}))

    def _session(self):
        if self.telemetry is None:
            raise RuntimeError(
                "telemetry is not enabled; pass telemetry=TelemetryConfig(...) "
                "(or True) to Accelerator, or set ATT_TELEMETRY=1.")
        return self.telemetry

    def log_system_metrics(self, step: Optional[int] = None, extra: Optional[dict] = None,
                           log_kwargs: Optional[dict] = None) -> dict:
        """The telemetry rollup (step time, tokens/s, MFU, data wait,
        memory, loss, grad norm, loss scale, ...) logged through every
        tracker, and returned. Needs ``telemetry=``."""
        values = self._session().rollup()
        if extra:
            values = {**values, **extra}
        if values:
            self.log(values, step=values.get("sys/step") if step is None else step,
                     log_kwargs=log_kwargs)
        return values

    def prometheus_metrics(self) -> str:
        """The live rollup and SLO histograms as Prometheus text
        exposition, as the scrape thread serves them. Needs
        ``telemetry=``."""
        from .telemetry.exporter import prometheus_text

        return prometheus_text(self._session())

    def end_training(self):
        """Close the telemetry session and finish every tracker."""
        if self.telemetry is not None:
            self.telemetry.close()
        for tracker in self.trackers:
            tracker.finish()

    # -- checkpoints (the reference's accelerator.py:2178-2300) ---------

    def save(self, obj, f, safe_serialization: bool = True):
        """Write a tree of tensors to ``f`` (``utils/other.save``)."""
        from .utils.other import save

        save(obj, f, save_on_each_node=self.project_configuration.save_on_each_node,
             safe_serialization=safe_serialization)

    def save_model(self, model, save_directory, max_shard_size="10GB",
                   safe_serialization: bool = True):
        """Export ``model``'s weights as the reference's ``save_model`` does
        (``checkpointing.save_model_weights``)."""
        from .checkpointing import save_model_weights

        save_model_weights(model, save_directory, max_shard_size=max_shard_size,
                           safe_serialization=safe_serialization)

    def register_for_checkpointing(self, *objects):
        """Save and load ``objects`` (each with ``state_dict`` and
        ``load_state_dict``) with the accelerator's state."""
        invalid = [obj for obj in objects
                   if not (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict"))]
        if invalid:
            raise ValueError(
                "All `objects` must include a `state_dict` and `load_state_dict` function "
                f"to be stored: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook):
        """``hook(models, weights, output_dir)`` runs before every
        ``save_state``; ``weights`` is an empty list, as the reference's.
        Returns a handle whose ``remove()`` unregisters it."""
        key = uuid.uuid4()
        self._save_model_state_pre_hook[key] = hook
        return _RemovableHandle(self._save_model_state_pre_hook, key)

    def register_load_state_pre_hook(self, hook):
        """``hook(models, [], input_dir)`` runs before every ``load_state``,
        as the reference calls it; see :meth:`register_save_state_pre_hook`."""
        key = uuid.uuid4()
        self._load_model_state_pre_hook[key] = hook
        return _RemovableHandle(self._load_model_state_pre_hook, key)

    def save_state(self, output_dir: Optional[str] = None, safe_serialization: bool = True,
                   **save_model_func_kwargs):
        """Save the prepared models, optimizers, schedulers and data
        loaders, the registered objects, the random states and ``step``
        into ``output_dir``. With ``automatic_checkpoint_naming`` the
        directory is ``{project_dir}/checkpoints/checkpoint_<save_iteration>``;
        past ``total_limit`` checkpoints the oldest (by index) are deleted
        first, and an existing directory of that name raises. Returns the
        directory."""
        from .checkpointing import save_accelerator_state

        config = self.project_configuration
        if config.automatic_checkpoint_naming:
            output_dir = os.path.join(self.project_dir, "checkpoints")
        elif output_dir is None:
            raise ValueError("save_state() needs output_dir without automatic_checkpoint_naming")
        os.makedirs(output_dir, exist_ok=True)
        if config.automatic_checkpoint_naming:
            folders = [os.path.join(output_dir, f) for f in os.listdir(output_dir)]
            if config.total_limit is not None and len(folders) + 1 > config.total_limit:
                folders.sort(key=_checkpoint_index)
                for folder in folders[: len(folders) + 1 - config.total_limit]:
                    shutil.rmtree(folder, ignore_errors=True)
            output_dir = os.path.join(output_dir, f"checkpoint_{self.save_iteration}")
            if os.path.exists(output_dir):
                raise ValueError(
                    f"Checkpoint directory {output_dir} ({self.save_iteration}) already "
                    "exists. Please manually override `self.save_iteration` with what "
                    "iteration to start with.")
        os.makedirs(output_dir, exist_ok=True)
        logger.info("Saving current state to %s", output_dir)
        for hook in self._save_model_state_pre_hook.values():
            hook(self._models, [], output_dir)
        path = save_accelerator_state(
            output_dir, models=self._models, optimizers=self._optimizers,
            schedulers=self._schedulers, dataloaders=self._dataloaders,
            custom_objects=self._custom_objects, step=self.step,
            safe_serialization=safe_serialization, loss_scale=self.loss_scale)
        config.iteration += 1
        return path

    def load_state(self, input_dir: Optional[str] = None, **load_model_func_kwargs):
        """Load what :meth:`save_state` wrote (or the reference's
        ``save_state``) into the prepared objects; ``None`` with
        ``automatic_checkpoint_naming`` takes the newest checkpoint. The
        saved ``step`` replaces the accelerator's. Every tensor lands on
        the device of the parameter or state it replaces."""
        from .checkpointing import load_accelerator_state

        if input_dir is None:
            if not self.project_configuration.automatic_checkpoint_naming:
                raise ValueError("load_state() needs input_dir without "
                                 "automatic_checkpoint_naming")
            base = os.path.join(self.project_dir, "checkpoints")
            input_dir = os.path.join(base, sorted(os.listdir(base), key=_checkpoint_index)[-1])
        logger.info("Loading states from %s", input_dir)
        for hook in self._load_model_state_pre_hook.values():
            hook(self._models, [], input_dir)
        override_step = load_accelerator_state(
            input_dir, models=self._models, optimizers=self._optimizers,
            schedulers=self._schedulers, dataloaders=self._dataloaders,
            custom_objects=self._custom_objects, loss_scale=self.loss_scale)
        if override_step is not None:
            self.step = override_step

    def get_state_dict(self, model, unwrap: bool = True) -> dict:
        """The model's ``state_dict()`` on the host (the reference returns
        its host-replicated variables)."""
        return {k: v.detach().to("cpu") for k, v in model.state_dict().items()}

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """``data.skip_first_batches``: resume an epoch past its first
        ``num_batches`` batches."""
        return _skip_first_batches(dataloader, num_batches)

    def free_memory(self, *objects):
        """Drop every prepared object, reset ``step``, collect garbage and
        return the card's cached blocks. Returns ``objects`` as Nones, for
        ``a, b = accelerator.free_memory(a, b)``."""
        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self.step = 0
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        return [None] * len(objects)

    def clear(self, *objects):
        return self.free_memory(*objects)
