"""Learning-rate scheduling.

Counterpart of ``accelerate_tpu/scheduler.py``. The reference bakes an
optax schedule into the optimizer, where it advances with the update
count. The port steps a torch LR scheduler instead, and
``AcceleratedScheduler`` keeps the same semantics: the schedule advances
only when the optimizer really updated (not while gradients accumulate,
not after a skipped update).

:func:`warmup_cosine_decay_schedule` reproduces
``optax.warmup_cosine_decay_schedule`` as a multiplier for
``torch.optim.lr_scheduler.LambdaLR``. optax evaluates a schedule at the
update count *before* the update, so the first update uses ``schedule(0)``;
a ``LambdaLR`` sets ``lr = base_lr * f(0)`` when it is built and
``f(k)`` after its k-th ``step()``, which lines up when the scheduler
steps once after every update.
"""

from __future__ import annotations

import math
from typing import Callable

from .state import GradientState


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """``f(step) = schedule(step) / peak_value``, where ``schedule`` is
    optax's: a linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` reached at
    ``decay_steps`` (which counts the warmup). Give the optimizer
    ``lr=peak_value`` and ``LambdaLR(optimizer, f)`` sets the optax value."""
    if peak_value <= 0.0:
        raise ValueError(f"peak_value must be > 0 (the multiplier's base), got {peak_value}")
    if decay_steps - warmup_steps <= 0:
        raise ValueError(
            f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})"
        )
    alpha = end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax.linear_schedule (polynomial, power 1)
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return lambda step: schedule(step) / peak_value


class AcceleratedScheduler:
    """Wraps a torch LR scheduler; :meth:`step` advances it only when every
    prepared optimizer really updated in this step."""

    def __init__(self, scheduler, optimizers, gradient_state: GradientState):
        self.scheduler = scheduler
        self.optimizers = optimizers  # the Accelerator's list of prepared optimizers
        self.gradient_state = gradient_state

    def step(self, *args, **kwargs):
        if not self.gradient_state.sync_gradients:
            return
        if any(opt.step_was_skipped for opt in self.optimizers):
            return
        self.scheduler.step(*args, **kwargs)

    def get_last_lr(self):
        return self.scheduler.get_last_lr()

    def state_dict(self) -> dict:
        """The reference's ``{"manual_steps": n}``, which counts steps only
        of a scheduler detached from its optimizer: the port's always
        steps with it, for which the reference records 0. The torch
        scheduler's own state goes beside it under ``"torch"``."""
        return {"manual_steps": 0, "torch": self.scheduler.state_dict()}

    def load_state_dict(self, state_dict: dict):
        """Load the torch scheduler's state when the file has it. The
        reference's file has none: its schedule's position is the
        optimizer state's update count, which loading that state set."""
        if "torch" in state_dict:
            self.scheduler.load_state_dict(state_dict["torch"])
            # the optimizer's state holds no learning rate: it is the one
            # the schedule set at its last step
            for group, lr in zip(self.scheduler.optimizer.param_groups,
                                 self.scheduler.get_last_lr()):
                group["lr"] = lr

    def __repr__(self):
        return f"AcceleratedScheduler({self.scheduler!r})"
