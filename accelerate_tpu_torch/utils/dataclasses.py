"""The training step's configuration: mixed precision, loss scaling,
gradient accumulation, the data loader, the profiler and the project's
checkpoint layout.

Counterpart of the parts of ``accelerate_tpu/utils/dataclasses.py`` that
the single-process slice reads (``DistributedType``, ``PrecisionType``,
``MixedPrecisionConfig``, ``GradScalerKwargs``, ``AutocastKwargs``,
``ProfileKwargs``, ``GradientAccumulationPlugin``,
``DataLoaderConfiguration``, ``ProjectConfiguration``), with torch dtypes
and ``torch.profiler``. fp8 is the reference's policy: bf16 compute over
fp32 masters, with the projections through ``ops/fp8.py``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional

import torch


class KwargsHandler:
    """Base of the kwargs dataclasses: ``to_kwargs()`` is what differs
    from the defaults."""

    def to_dict(self):
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self):
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k) != v}


@dataclass
class AutocastKwargs(KwargsHandler):
    """The reference's autocast knobs. The precision policy is applied
    where the model reads its parameters (``DecoderLM.set_param_cast``),
    so there is no autocast region to switch: both are kept for the
    reference's signature."""

    enabled: bool = True
    cache_enabled: bool = True


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss scaling for fp16, the reference's rule: the loss is
    multiplied by ``scale`` before the backward and the gradients divided
    by it after; an update whose gradients are not all finite is skipped
    and the scale multiplied by ``backoff_factor`` (never below 1.0);
    after ``growth_interval`` finite updates in a row it is multiplied by
    ``growth_factor``. ``enabled=False`` trains fp16 without a scale."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


class DistributedType(str, Enum):
    """The run's topology, the reference's members: ``NO`` is one process
    on one card (or on the CPU), ``MULTI_HOST`` several processes under
    ``torch.distributed``. ``TPU`` and ``CPU_SIM`` (one process driving
    several devices) have no counterpart in a one-process-per-card port
    and are never set."""

    NO = "NO"
    TPU = "TPU"
    MULTI_HOST = "MULTI_HOST"
    CPU_SIM = "CPU_SIM"

    def __str__(self):
        return self.value


class PrecisionType(str, Enum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


@dataclass
class MixedPrecisionConfig:
    """The precision policy of a training step.

    ``compute_dtype``: what every floating parameter is rounded to at use
    (activations follow the model config's dtype); ``param_dtype``: the
    master weights the optimizer updates; ``grad_scaler``: the loss
    scale's rule, used under fp16 (``needs_loss_scaling``). fp8 computes
    in bf16 (the projections' fp8 operands are the models' ``use_fp8``,
    which ``Accelerator.prepare`` turns on)."""

    mode: PrecisionType = PrecisionType.NO
    compute_dtype: Optional[torch.dtype] = None
    param_dtype: Optional[torch.dtype] = None
    grad_scaler: GradScalerKwargs = field(default_factory=GradScalerKwargs)

    def __post_init__(self):
        self.mode = PrecisionType(self.mode)
        c = {PrecisionType.BF16: torch.bfloat16, PrecisionType.FP16: torch.float16,
             PrecisionType.FP8: torch.bfloat16}.get(self.mode, torch.float32)
        self.compute_dtype = self.compute_dtype or c
        self.param_dtype = self.param_dtype or torch.float32

    @property
    def needs_loss_scaling(self) -> bool:
        return self.mode == PrecisionType.FP16 and self.grad_scaler.enabled


@dataclass
class ProfileKwargs(KwargsHandler):
    """``torch.profiler`` around a region (``Accelerator.profile``).
    ``activities``: a list of "cpu" and "cuda" (both when None);
    ``schedule_option``: the keywords of ``torch.profiler.schedule``
    (``wait``, ``warmup``, ``active``, ``repeat``, ``skip_first``; the
    region then calls ``step()`` each step); ``on_trace_ready(ctx)`` runs
    once the region ends and its trace is written; ``record_shapes``,
    ``profile_memory``, ``with_stack`` and ``with_flops`` are
    ``torch.profiler.profile``'s; the Chrome trace goes to
    ``output_trace_dir`` (a fresh temporary directory when None)."""

    activities: Optional[list] = None
    schedule_option: Optional[dict] = None
    on_trace_ready: Optional[Callable] = None
    record_shapes: bool = False
    profile_memory: bool = False
    with_stack: bool = False
    with_flops: bool = False
    output_trace_dir: Optional[str] = None

    def build(self, suffix: str = "0"):
        from .profiler import ProfileContext

        return ProfileContext(self, suffix=suffix)


@dataclass
class DataLoaderConfiguration:
    """How ``Accelerator.prepare`` wraps a data loader. ``prefetch_depth``
    > 1 runs a producer thread that assembles that many batches ahead
    into the native host ring (``runtime/prefetch.py``).
    ``split_batches``, ``dispatch_batches`` and ``even_batches`` shard a
    loader across processes; on one process they change nothing, as in
    the reference. ``use_seedable_sampler``, ``non_blocking`` and
    ``use_stateful_dataloader`` are kept for the reference's signature:
    ``prepare`` always rebuilds a shuffled torch loader's sampler so its
    order depends only on (seed, epoch), the loader's copies to the card
    are issued non-blocking, and every prepared loader has
    ``state_dict``."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    prefetch_depth: int = 0


@dataclass
class GradientAccumulationPlugin:
    """``num_steps`` micro-batches per optimizer update;
    ``sync_with_dataloader`` forces an update at the end of each pass over
    a prepared dataloader; ``sync_each_batch`` updates after every batch."""

    num_steps: int = 1
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {self.num_steps}")


@dataclass
class ProjectConfiguration:
    """Where ``Accelerator.save_state`` writes. With
    ``automatic_checkpoint_naming`` checkpoints go to
    ``{project_dir}/checkpoints/checkpoint_{iteration}``, and at most
    ``total_limit`` of them are kept (the oldest go first).
    ``logging_dir`` defaults to ``project_dir``. ``save_on_each_node``
    is kept for the reference's signature: one process writes here."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)
