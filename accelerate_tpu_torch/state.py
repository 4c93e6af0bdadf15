"""Accelerator and gradient-accumulation state on one device.

Counterpart of ``accelerate_tpu/state.py`` (``AcceleratorState``,
``GradientState``) for the single-device training slice. The reference
keeps both as process-wide singletons; here the ``Accelerator`` owns one
of each and hands them to the objects it prepares.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .models.decoder import resolve_device
from .utils.dataclasses import GradientAccumulationPlugin, MixedPrecisionConfig


class AcceleratorState:
    """The device (``None`` means CUDA and raises without it; pass
    ``device="cpu"`` for the plain versions) and the precision policy."""

    def __init__(self, mixed_precision: Union[str, MixedPrecisionConfig] = "no",
                 device=None):
        self.device: torch.device = resolve_device(device)
        self.precision = (mixed_precision if isinstance(mixed_precision, MixedPrecisionConfig)
                          else MixedPrecisionConfig(mode=mixed_precision))

    @property
    def mixed_precision(self) -> str:
        return self.precision.mode.value

    def __repr__(self):
        return (f"AcceleratorState(device={self.device}, "
                f"mixed_precision={self.mixed_precision!r})")


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
