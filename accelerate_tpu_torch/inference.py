"""Pipeline-parallel inference: ``prepare_pippy``.

Counterpart of ``accelerate_tpu/inference.py`` (the reference library's
``prepare_pippy``, which splits a torch model with
``torch.distributed.pipelining``). Here the split points are the
decoder's blocks: :func:`prepare_pippy` gives a ``DecoderLM`` (trained
pipelined or not) the GPipe schedule over ``num_stages`` stages
(``parallel/pipeline.py``), holding the model's own tensors, and
:class:`PipelinedModel` runs it: the batch padded to a multiple of the
microbatch count with copies of row 0, the padding sliced off the logits.
On a ``stage`` axis each rank holds only its stages' blocks and every
rank returns the logits (the last stage's, broadcast over the stage
group), as the reference's GSPMD outputs are global.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class PipelinedModel:
    """``__call__(input_ids, **kwargs) -> logits`` through the pipelined
    model, inference only: the batch (and every keyword tensor whose
    leading dimension is the batch's) padded up to a multiple of
    ``num_microbatches`` with copies of its row 0, then sliced back."""

    def __init__(self, model, num_microbatches: int):
        self.model = model
        self.num_microbatches = num_microbatches

    def _pad(self, x: torch.Tensor, target: int) -> torch.Tensor:
        extra = target - x.shape[0]
        return torch.cat([x, x[:1].expand(extra, *x.shape[1:])], dim=0)

    @torch.no_grad()
    def __call__(self, input_ids, **kwargs) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, device=self.model.device)
        batch = ids.shape[0]
        target = -(-batch // self.num_microbatches) * self.num_microbatches
        if target != batch:
            ids = self._pad(ids, target)
            kwargs = {k: self._pad(v, target) if isinstance(v, torch.Tensor) and v.dim() >= 1
                      and v.shape[0] == batch else v for k, v in kwargs.items()}
        return self.model(ids, **kwargs)[:batch]

    def eval(self):
        return self

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError("prepare_pippy wraps the model for inference only")
        return self


def prepare_pippy(model, num_stages: Optional[int] = None,
                  num_microbatches: Optional[int] = None, mesh=None,
                  example_args: tuple = ()) -> PipelinedModel:
    """Split a ``DecoderLM`` over pipeline stages for inference (the
    reference's ``prepare_pippy``). ``num_stages`` defaults to the
    ``stage`` axis of ``mesh`` (the model's own mesh when None), and an
    error says how to get one when there is none; ``num_microbatches``
    defaults to ``num_stages``. The pipelined model holds ``model``'s
    tensors (on a stage axis, only its stages' blocks). ``example_args``
    is accepted for the reference's signature: the split needs no trace."""
    from .models.decoder import DecoderLM
    from .parallel.mesh import axis_size

    if not isinstance(model, DecoderLM):
        raise TypeError(
            "prepare_pippy supports DecoderLM-family models (its blocks define the stage "
            f"split); got {type(model).__name__}")
    cfg = model.config
    mesh = mesh if mesh is not None else model.mesh
    if num_stages is None:
        num_stages = axis_size(mesh, "stage")
        if num_stages <= 1:
            raise ValueError(
                "prepare_pippy found no 'stage' axis in the mesh: configure "
                "ShardingConfig(pipeline_parallel=k) (or pass num_stages explicitly for "
                "schedule testing without a stage axis); a forced schedule on an unsplit "
                "mesh only adds bubble overhead")
    if num_microbatches is None:
        num_microbatches = num_stages
    if cfg.num_layers % num_stages != 0:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by num_stages={num_stages}")
    pipe_cfg = dataclasses.replace(cfg, pipeline_stages=num_stages,
                                   pipeline_microbatches=num_microbatches)
    from .generation import depipeline

    source = depipeline(model)
    pipe = source.rebuilt(pipe_cfg, mesh=mesh if axis_size(mesh, "stage") > 1 else None)
    pipe.eval()
    logger.info("prepare_pippy: %d stages x %d layers/stage, %d microbatches", num_stages,
                cfg.num_layers // num_stages, num_microbatches)
    return PipelinedModel(pipe, num_microbatches)
