"""Optimizer wrapper.

Counterpart of ``accelerate_tpu/optimizer.py`` (``AcceleratedOptimizer``),
around a ``torch.optim.Optimizer``. It keeps the reference's call-site
contract: while gradients accumulate (``GradientState.sync_gradients``
False) ``step()`` is skipped and ``zero_grad()`` is a no-op, so the
``.grad`` buffers keep summing the micro-batches; at a sync step the
Accelerator's ``pre_step`` runs (the fp16 finite check and the gradient
clip), then the wrapped optimizer updates, unless the gradients were not
all finite: then the update is skipped (``step_was_skipped``).
``step_count`` counts the updates (not the micro-steps), skipped ones
too, as the reference's engine does; its checkpoint records it. A group
that holds sharded parameters (DTensors, ``parallel/sharding.py``) beside
replicated ones steps as two groups of the same settings, one of each
kind: torch's multi-tensor update takes one kind at a time.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .state import GradientState


def _by_kind(groups: list) -> list:
    """``groups`` with each group that mixes sharded and whole parameters
    split in two of the same settings (``groups`` itself when none does)."""
    from torch.distributed.tensor import DTensor

    out, split = [], False
    for group in groups:
        kinds = {}
        for p in group["params"]:
            kinds.setdefault(isinstance(p, DTensor), []).append(p)
        split |= len(kinds) > 1
        out.extend(dict(group, params=params) for params in kinds.values())
    return out if split else groups


class AcceleratedOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` (so LR schedulers accept it) whose
    parameter groups are the wrapped optimizer's. ``pre_step`` (the
    Accelerator's) runs just before each update and returns whether to
    apply it; ``post_step`` runs after it."""

    def __init__(self, optimizer: torch.optim.Optimizer, gradient_state: GradientState,
                 pre_step: Optional[Callable[["AcceleratedOptimizer"], bool]] = None,
                 post_step: Optional[Callable[["AcceleratedOptimizer"], None]] = None):
        # no super().__init__: the parameter groups are the wrapped
        # optimizer's own
        self.optimizer = optimizer
        self.gradient_state = gradient_state
        self._pre_step = pre_step
        self._post_step = post_step
        # True when the last update was skipped for non-finite fp16 gradients
        self.step_was_skipped = False
        self.step_count = 0  # updates, skipped ones counted

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @param_groups.setter
    def param_groups(self, groups):
        self.optimizer.param_groups = groups

    def parameters(self):
        """Every parameter the wrapped optimizer updates."""
        return [p for group in self.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True):
        """Clear the gradients, except while accumulating."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        """Update, except while accumulating (the micro-step returns with
        the gradients left to sum)."""
        if not self.gradient_state.sync_gradients:
            return None
        apply = True if self._pre_step is None else self._pre_step(self)
        return self.update(closure, skip=not apply)

    def update(self, closure=None, skip: bool = False):
        """One update of the wrapped optimizer, or none with ``skip`` (the
        parameters and the optimizer's state stay as they are); counted
        in ``step_count`` either way."""
        self.step_was_skipped = bool(skip)
        out = None
        if not skip:
            groups = self.optimizer.param_groups
            self.optimizer.param_groups = _by_kind(groups)
            try:
                out = self.optimizer.step(closure)
            finally:
                self.optimizer.param_groups = groups
        self.step_count += 1
        if self._post_step is not None:
            self._post_step(self)
        return out

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict):
        self.optimizer.load_state_dict(state_dict)

    def __repr__(self):
        return f"AcceleratedOptimizer({self.optimizer!r})"
