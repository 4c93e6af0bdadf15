"""The training step's configuration: mixed precision, loss scaling,
gradient accumulation and the project's checkpoint layout.

Counterpart of the parts of ``accelerate_tpu/utils/dataclasses.py`` that
the single-device training slice reads (``PrecisionType``,
``MixedPrecisionConfig``, ``GradScalerKwargs``, ``AutocastKwargs``,
``GradientAccumulationPlugin``, ``ProjectConfiguration``), with torch
dtypes. fp8 is a later slice and raises.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

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
    scale's rule, used under fp16 (``needs_loss_scaling``)."""

    mode: PrecisionType = PrecisionType.NO
    compute_dtype: Optional[torch.dtype] = None
    param_dtype: Optional[torch.dtype] = None
    grad_scaler: GradScalerKwargs = field(default_factory=GradScalerKwargs)

    def __post_init__(self):
        self.mode = PrecisionType(self.mode)
        if self.mode == PrecisionType.FP8:
            raise NotImplementedError(
                "mixed_precision='fp8' is a later slice of the port (ROADMAP queue 1, fp8)"
            )
        c = {PrecisionType.BF16: torch.bfloat16,
             PrecisionType.FP16: torch.float16}.get(self.mode, torch.float32)
        self.compute_dtype = self.compute_dtype or c
        self.param_dtype = self.param_dtype or torch.float32

    @property
    def needs_loss_scaling(self) -> bool:
        return self.mode == PrecisionType.FP16 and self.grad_scaler.enabled


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
