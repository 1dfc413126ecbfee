"""Production and host meshes (counterpart of ``repro/launch/mesh.py``).

Single pod: (16, 16) = ("data", "model"), 256 ranks.
Multi-pod: (2, 16, 16) = ("pod", "data", "model"), 512 ranks.

A mesh is a ``torch.distributed.DeviceMesh`` over the default process
group, or, for the sharding rules alone, a ``MeshShape``: axis names
and sizes with no process group behind them, the counterpart of the
reference's ``jax.sharding.AbstractMesh``.  The functions are built on
call, so importing this module starts no process group.  The dry run
(``launch/dryrun.py``) starts a ``"fake"`` group of 256 or 512 ranks
first, the counterpart of the reference's host device count flag.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

#: (shape, axis names) of the production meshes, by ``multi_pod``
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, with no process group."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


Mesh = Union["torch.distributed.device_mesh.DeviceMesh", MeshShape]


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    shape, axes = PRODUCTION[multi_pod]
    return MeshShape(axes, shape)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def make_mesh(shape: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the default
    process group; raises when the world is smaller."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < shape.size:
        raise RuntimeError(
            f"mesh {shape.sizes} needs {shape.size} ranks, found {world}: "
            f"start a process group of {shape.size} ranks first (python -m "
            "repro_torch.launch.dryrun starts a 'fake' one)")
    return DeviceMesh(device_type,
                      torch.arange(shape.size).reshape(shape.sizes),
                      mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the first 256 (512) ranks of the default
    process group; raises when the world is smaller."""
    return make_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device: DeviceLike = None):
    """A (data, model) mesh over the visible devices: ``cuda`` unless the
    caller asks for the CPU (``device="cpu"``), as every entry point of
    the port.  With no process group it starts a one-rank group (nccl on
    the card, gloo on the CPU) over an in-process store."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh(MeshShape(("data", "model"), (data, model)), dev.type)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes: ("pod", "data") multi-pod, else ("data",)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_size(mesh: Mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def model_size(mesh: Mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
