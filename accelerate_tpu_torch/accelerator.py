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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from .data import prepare_data_loader, send_to_device
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import GradientAccumulationPlugin


def global_grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squared entries, fp32 (optax's
    ``global_norm``); parameters without a gradient count as zero."""
    norms = [torch.linalg.vector_norm(p.grad.float()) for p in params if p.grad is not None]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


def _clip_grads(params, max_norm: float, norm: torch.Tensor):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))``."""
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))


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


class Accelerator:
    """``mixed_precision`` "no" or "bf16" ("fp16"/"fp8" are later slices);
    ``gradient_accumulation_steps`` (or a ``GradientAccumulationPlugin``);
    ``device=None`` means CUDA and raises without it, ``device="cpu"``
    runs the plain versions of the kernels."""

    def __init__(self, mixed_precision="no", gradient_accumulation_steps: int = 1,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 device=None):
        if gradient_accumulation_plugin is not None and gradient_accumulation_steps != 1:
            raise ValueError(
                "pass gradient_accumulation_steps or gradient_accumulation_plugin, not both"
            )
        plugin = gradient_accumulation_plugin or GradientAccumulationPlugin(
            num_steps=gradient_accumulation_steps)
        self.state = AcceleratorState(mixed_precision, device)
        self.gradient_state = GradientState(plugin)
        self.step = 0  # micro-steps since the last sync (accumulate())
        self._clip_max_norm: Optional[float] = None
        self._models, self._optimizers, self._schedulers, self._dataloaders = [], [], [], []

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

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
        want = self.state.precision.param_dtype
        bad = sorted({str(p.dtype) for p in model.parameters()
                      if p.is_floating_point() and p.dtype != want})
        if bad:
            raise ValueError(
                f"the model holds {bad} parameters; training keeps {want} master "
                "weights (build DecoderLM with param_dtype=torch.float32)"
            )
        cast = self.state.precision.compute_dtype
        cast = None if cast == want else cast
        if hasattr(model, "set_param_cast"):
            model.set_param_cast(cast)
        elif cast is not None:
            raise TypeError(
                f"mixed_precision={self.mixed_precision!r} rounds parameters at use, "
                "which needs a model with set_param_cast() (DecoderLM)"
            )
        self._models.append(model)
        return model

    def prepare_optimizer(self, optimizer: torch.optim.Optimizer) -> AcceleratedOptimizer:
        wrapped = AcceleratedOptimizer(optimizer, self.gradient_state,
                                       pre_step=self._clip_before_update)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        wrapped = AcceleratedScheduler(scheduler, self._optimizers, self.gradient_state)
        self._schedulers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, loader):
        prepared = prepare_data_loader(loader, self.device, self.gradient_state)
        self._dataloaders.append(prepared)
        return prepared

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The model itself: prepare() does not wrap modules."""
        return model

    # -- the eager loop --------------------------------------------------

    def backward(self, loss: torch.Tensor, **kwargs):
        """Add this micro-batch's gradient, divided by the accumulation
        count, to the parameters' ``.grad``."""
        (loss / self.gradient_state.num_steps).backward(**kwargs)

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
        return global_grad_norm(params)

    def _clip_before_update(self, optimizer: AcceleratedOptimizer):
        if self._clip_max_norm is not None:
            params = optimizer.parameters()
            _clip_grads(params, self._clip_max_norm, global_grad_norm(params))

    # -- the fused step --------------------------------------------------

    def build_train_step(self, loss_fn: Optional[Callable] = None,
                         micro_steps: Optional[int] = None,
                         steps_per_call: Optional[int] = None):
        """``step(batch) -> {"loss", "grad_norm"}``: one optimizer update.
        The batch is cut into ``micro_steps`` (default: the accumulation
        count) contiguous micro-batches along dim 0; their gradients and
        losses are averaged; ``grad_norm`` is the averaged gradient's global
        norm before the clip; the clip (if ``clip_grad_norm_`` set one), the
        optimizer update and the LR schedulers follow. ``loss_fn(model,
        micro_batch)`` replaces the model call when given.

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

        def step(batch):
            batch = send_to_device(batch, self.device)
            opt.optimizer.zero_grad(set_to_none=True)
            loss = torch.zeros((), device=self.device)
            for mb in _split(batch, micro):
                out = loss_fn(model, mb) if loss_fn is not None else _call(model, mb)
                mb_loss = _loss_of(out)
                (mb_loss / micro).backward()
                loss = loss + mb_loss.detach() / micro
            norm = global_grad_norm(params)
            if self._clip_max_norm is not None:
                _clip_grads(params, self._clip_max_norm, norm)
            opt.optimizer.step()
            for sched in schedulers:
                sched.scheduler.step()
            return {"loss": loss, "grad_norm": norm}

        if k == 1:
            return step

        def window(batches):
            losses, metrics = [], None
            for i in range(k):
                metrics = step(_index(batches, i, k))
                losses.append(metrics["loss"])
            return {**metrics, "loss_mean": torch.stack(losses).mean()}

        return window
