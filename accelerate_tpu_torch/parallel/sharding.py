"""Parameter layouts of the sharding strategies, on FSDP2.

Counterpart of ``accelerate_tpu/parallel/sharding.py``. The reference
gives each parameter a ``NamedSharding`` and lets GSPMD place the
collectives; here the strategy decides the wrapping and the axis degrees
only the mesh, so one code path runs on one card and on N ranks:

- ``FSDP``: ``fully_shard`` of every block (each element of the model's
  ``ModuleList`` s), then of the root, on a 2-D mesh (replicate, shard):
  ``shard`` is the ``fsdp`` axis, ``replicate`` every other axis that
  sees other tokens (``replica``, ``data``, ``sequence``); parameters are
  resharded after the forward.
- ``GRAD_OP``: the same with ``reshard_after_forward=False`` (gradients
  and optimizer state sharded, parameters kept gathered from the forward
  to the backward).
- ``HYBRID``: the same 2-D mesh, ``replica`` on its replicate side.
- ``DP``: parameters stay replicated; the Accelerator all-reduces their
  gradients once an update (:func:`reduce_replicated`).
- ``AUTO``: FSDP where the ``fsdp`` axis is > 1, else DP (the
  reference's inference from the axis sizes).

As the reference's heuristic, a parameter smaller than
``min_weight_size_to_shard``, or with no dimension the ``fsdp`` degree
divides, stays replicated (FSDP2's ``ignored_params``; its gradient is
all-reduced with DP's); a sharded one is cut along its largest dimension
the degree divides (``shard_placement_fn``). Every gradient ends as the
mean over all ranks: the port's models scale their loss so that this
mean is the gradient of the loss over the global batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from ..utils.dataclasses import ShardingConfig, ShardingStrategy
from .mesh import axis_size


def resolve_strategy(config: ShardingConfig, mesh) -> ShardingStrategy:
    """``AUTO`` made concrete from the axis sizes; the others as given."""
    if config.strategy != ShardingStrategy.AUTO:
        return config.strategy
    return ShardingStrategy.FSDP if axis_size(mesh, "fsdp") > 1 else ShardingStrategy.DP


def shard_dim(shape, degree: int, min_size: int) -> Optional[int]:
    """The dimension the reference shards a parameter of ``shape`` along
    (its largest one that ``degree`` divides; the last such on a tie), or
    None where it stays replicated."""
    size = 1
    for d in shape:
        size *= int(d)
    if size < min_size:
        return None
    candidates = [(int(d), i) for i, d in enumerate(shape) if int(d) % degree == 0]
    return max(candidates)[1] if candidates else None


def fsdp_mesh(mesh):
    """The 2-D (replicate, shard) ``DeviceMesh`` of FSDP2 over the ranks of
    ``mesh``: ``shard`` the ``fsdp`` axis, ``replicate`` every other axis
    flattened in the mesh's order. On a ``stage`` axis > 1 it spans this
    rank's stage only (each stage shards its own blocks): the slice of a
    (stage, replicate, shard) mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    f = names.index("fsdp")
    if axis_size(mesh, "stage") > 1:
        st = names.index("stage")
        order = [st] + [d for d in range(len(names)) if d not in (st, f)] + [f]
        ranks = mesh.mesh.permute(order).reshape(int(mesh.mesh.shape[st]), -1,
                                                 int(mesh.mesh.shape[f]))
        full = DeviceMesh(mesh.device_type, ranks,
                          mesh_dim_names=("stage", "replicate", "shard"))
        return full["replicate", "shard"]
    order = [d for d in range(len(names)) if d != f] + [f]
    ranks = mesh.mesh.permute(order).reshape(-1, int(mesh.mesh.shape[f]))
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("replicate", "shard"))


def data_group(mesh) -> tuple:
    """(the process group of the ranks that share this rank's ``stage``
    coordinate, its size D): the ranks among which a stage's gradients are
    averaged, the whole world without a stage axis. Made once per mesh and
    kept on it (every rank makes every stage's group, in order, as
    ``new_group`` asks: a cache keyed by anything a rank sees alone could
    make some ranks skip that collective)."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    if axis_size(mesh, "stage") <= 1:
        return dist.group.WORLD, mesh.size()
    made = getattr(mesh, "_stage_data_group", None)
    if made is None:
        st = names.index("stage")
        ranks = mesh.mesh.movedim(st, 0).reshape(int(mesh.mesh.shape[st]), -1)
        mine, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in ranks])
        made = mesh._stage_data_group = (mine, int(ranks.shape[1]))
    return made


def _blocks(model: nn.Module) -> list:
    """The model's blocks: the elements of its outermost ``ModuleList`` s."""
    out = []

    def walk(module):
        for child in module.children():
            if isinstance(child, nn.ModuleList):
                out.extend(child)
            else:
                walk(child)

    walk(model)
    # a stage mesh's model keeps no parameters where another stage's blocks are
    return [b for b in out if any(True for _ in b.parameters())]


def apply_sharding(model: nn.Module, mesh, config: ShardingConfig) -> ShardingStrategy:
    """Lay ``model`` (already on its device, fp32 master weights) out as
    ``config``'s strategy says over ``mesh``; returns the strategy made
    concrete. Its replicated parameters' gradients are
    :func:`reduce_replicated`'s."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    strategy = resolve_strategy(config, mesh)
    if strategy == ShardingStrategy.DP:
        return strategy
    degree = axis_size(mesh, "fsdp")
    dims = {p: shard_dim(tuple(p.shape), degree, config.min_weight_size_to_shard)
            for p in model.parameters()}
    kw = {"mesh": fsdp_mesh(mesh),
          "reshard_after_forward": strategy != ShardingStrategy.GRAD_OP}
    kw["ignored_params"] = {p for p, d in dims.items() if d is None}
    kw["shard_placement_fn"] = lambda p: Shard(dims[p]) if dims.get(p) is not None else None
    for block in _blocks(model):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    return strategy


def is_sharded(p: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def _all_reduce_mean(grads: list, group, divisor: int):
    """Sum ``grads`` over ``group`` in one all-reduce of their
    concatenation, then divide by ``divisor``."""
    import torch.distributed as dist

    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def reduce_replicated(params: Iterable[torch.Tensor], mesh=None, stage=None):
    """Average the gradients of the parameters of ``params`` every rank
    holds whole (all of them under DP; under FSDP those left replicated)
    over all ranks, in one all-reduce of their concatenation.

    On a ``stage`` axis (``stage``: ``(ids of this rank's pipeline-stage
    parameters, the stage group)``) a stage's blocks are averaged over the
    D ranks of their stage only (``data_group``); every other parameter
    (the embedding, the final norm, the head, an encoder: replicated over
    the stages, where only some stages add to its gradient) is summed over
    the stage group, then averaged over the D ranks, in one all-reduce
    over every rank (/ D); a sharded one, which FSDP averaged within its
    stage, is summed over the stage group. A parameter with no gradient
    here gives zeros."""
    import torch.distributed as dist

    if stage is None:
        grads = [p.grad for p in params if p.grad is not None and not is_sharded(p)]
        if dist.get_world_size() > 1:
            _all_reduce_mean(grads, None, dist.get_world_size())
        return
    ids, stage_group = stage
    group, d = data_group(mesh)
    own, rest, sharded = [], [], []
    for p in params:
        if id(p) in ids:
            if p.grad is not None and not is_sharded(p):
                own.append(p.grad)
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        (sharded if is_sharded(p) else rest).append(local_grad(p) if is_sharded(p) else p.grad)
    _all_reduce_mean(own, group, d)
    _all_reduce_mean(rest, None, d)
    _all_reduce_mean(sharded, stage_group, 1)


def local_grad(p: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's part of ``p``'s gradient: the shard of a sharded one,
    the whole of a replicated one."""
    g = p.grad
    if g is None:
        return None
    return g.to_local() if is_sharded(g) else g
