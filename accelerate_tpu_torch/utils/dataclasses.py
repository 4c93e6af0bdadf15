"""The training step's configuration: mixed precision, gradient
accumulation and the project's checkpoint layout.

Counterpart of the parts of ``accelerate_tpu/utils/dataclasses.py`` that
the single-device training slice reads (``PrecisionType``,
``MixedPrecisionConfig``, ``GradientAccumulationPlugin``,
``ProjectConfiguration``), with torch dtypes. fp16 (loss scaling) and fp8 are later slices and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import torch


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
    master weights the optimizer updates."""

    mode: PrecisionType = PrecisionType.NO
    compute_dtype: Optional[torch.dtype] = None
    param_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        self.mode = PrecisionType(self.mode)
        if self.mode == PrecisionType.FP16:
            raise NotImplementedError(
                "mixed_precision='fp16' needs dynamic loss scaling, a later slice "
                "of the port (ROADMAP queue 1, training options)"
            )
        if self.mode == PrecisionType.FP8:
            raise NotImplementedError(
                "mixed_precision='fp8' is a later slice of the port (ROADMAP queue 1, fp8)"
            )
        c = torch.bfloat16 if self.mode == PrecisionType.BF16 else torch.float32
        self.compute_dtype = self.compute_dtype or c
        self.param_dtype = self.param_dtype or torch.float32


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
