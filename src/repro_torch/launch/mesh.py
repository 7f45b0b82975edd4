"""Meshes (counterpart of `repro/launch/mesh.py`): a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialized process group, one rank per device.

A mesh is named by its shape, "DxT" (data, model) or "PxDxT" (pod,
data, model; the pod axis folds into data parallelism, as
`shardings.RULES["batch"]` folds it). "16x16" and "2x16x16" are the
reference's production shapes under the same rule. The product of the
dimensions must be the world size.

A mesh's process groups (NCCL communicators, with their buffers) live
as long as the process group they are made in, so one mesh of a shape
is made once per process group and handed to every later caller: a
process that trains several runs on one mesh holds one set of them.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# (shape, axes, device type) -> (the process group it was made in, mesh)
_MESHES: dict = {}


def parse_mesh(name: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of a mesh named "DxT" or "PxDxT"."""
    try:
        shape = tuple(int(d) for d in name.split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in AXES or min(shape) < 1:
        raise ValueError(f"mesh {name!r} is not DxT or PxDxT")
    return shape, AXES[len(shape)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` with axis names `axes` over the world's
    ranks (row-major, the last axis the fastest); the process group must
    be initialized and its size the product of `shape`. The same mesh
    object for every call in one process group."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} has {math.prod(shape)} "
                         f"devices, the world {world}")
    key = (tuple(shape), tuple(axes), device_type)
    made_in, mesh = _MESHES.get(key, (None, None))
    if made_in is not dist.group.WORLD:
        mesh = init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
        _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def make_production_mesh(name: str, device_type: str = "cuda"):
    """The mesh named `name` ("DxT" or "PxDxT") over the cards there
    are: one rank per device, the product the world size."""
    return make_mesh(*parse_mesh(name), device_type=device_type)
