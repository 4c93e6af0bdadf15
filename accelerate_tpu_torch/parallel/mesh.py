"""The device mesh over the process group.

Counterpart of ``accelerate_tpu/parallel/mesh.py``. One process drives
one device, so the mesh's points are the group's ranks: a
``torch.distributed.device_mesh.DeviceMesh`` with every axis of
``MESH_AXIS_ORDER`` (size-1 axes kept, so any axis can be named whatever
its degree), ``replica`` outermost and ``tensor`` innermost, as the
reference lays them out. Rank ``r`` sits at the row-major position ``r``
of the axis sizes.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from ..utils.constants import MESH_AXIS_ORDER


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs a process group: launch the processes with RANK / "
            "WORLD_SIZE / MASTER_ADDR / MASTER_PORT (or the reference's "
            "COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), or with "
            "launchers.debug_launcher")
    return dist.get_world_size()


def build_mesh(axis_sizes: Mapping[str, int], device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the process group with the axes
    of ``axis_sizes`` in ``MESH_AXIS_ORDER`` (others innermost, in their
    given order). The sizes must multiply to the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    names = [n for n in MESH_AXIS_ORDER if n in axis_sizes]
    names += [n for n in axis_sizes if n not in MESH_AXIS_ORDER]
    sizes = [int(axis_sizes[n]) for n in names]
    total = 1
    for s in sizes:
        total *= s
    world = _world()
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} processes")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))


def single_device_mesh(device_type: str = "cuda"):
    """Every axis of ``MESH_AXIS_ORDER`` at size 1: a world of one."""
    return build_mesh({n: 1 for n in MESH_AXIS_ORDER}, device_type)


def mesh_shape_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``, 1 where the mesh is None or lacks it (a
    ``{axis: size}`` mapping is read as the reference's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(name, 1))
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_index(mesh, names: Sequence[str]) -> tuple:
    """(this rank's index along ``names`` taken together, row-major in the
    mesh's order, and their size product): which batch shard (the data
    axes) or which sequence chunk this rank holds."""
    if mesh is None:
        return 0, 1
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for dim, name in enumerate(mesh.mesh_dim_names):
        if name in names:
            size = int(mesh.mesh.shape[dim])
            index, count = index * size + int(coord[dim]), count * size
    return index, count

