"""Device placement of training batches.

Counterpart of ``accelerate_tpu/data.py``'s ``prepare_data_loader`` for
one device: every batch of a torch ``DataLoader`` (or any iterable of
dicts, tuples or tensors) is moved to the accelerator's device, numpy
arrays becoming tensors, and the loader tells the ``GradientState`` when
it yields its last batch, so an accumulation window closes at the end of
an epoch. Sharding across processes and dispatch from one process belong
to the multi-device slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .state import GradientState


def send_to_device(batch, device: torch.device):
    """``batch`` with every tensor (and numpy array) on ``device``; dicts,
    lists and tuples keep their structure, other values pass through."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device, non_blocking=True)
    if isinstance(batch, dict):
        return type(batch)((k, send_to_device(v, device)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(send_to_device(v, device) for v in batch)
    return batch


class DataLoaderShard:
    """Iterates the wrapped loader with one batch of lookahead, so
    ``end_of_dataloader`` is True while the last batch is in use."""

    def __init__(self, loader, device: torch.device,
                 gradient_state: Optional[GradientState] = None):
        self.loader = loader
        self.device = device
        self.gradient_state = gradient_state
        self.end_of_dataloader = False

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self.gradient_state is not None:
            self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        try:
            it = iter(self.loader)
            try:
                nxt = next(it)
            except StopIteration:
                return
            while True:
                cur = nxt
                try:
                    nxt = next(it)
                except StopIteration:
                    self.end_of_dataloader = True
                    yield send_to_device(cur, self.device)
                    return
                yield send_to_device(cur, self.device)
        finally:
            if self.gradient_state is not None:
                self.gradient_state._remove_dataloader(self)


def prepare_data_loader(loader, device: torch.device,
                        gradient_state: Optional[GradientState] = None) -> DataLoaderShard:
    return DataLoaderShard(loader, device, gradient_state)
