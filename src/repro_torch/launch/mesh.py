"""Production and local device meshes (the reference's ``launch/mesh.py``).

Functions, not module constants: importing this module initialises no
process group and builds no mesh.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller initialises (backend, address, rank and
world size are the caller's), with one exception: :func:`make_local_mesh`
with no group initialised makes a one-rank group itself.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

PROD_SHAPE = (16, 16)
PROD_AXES = ("data", "model")
PROD2_SHAPE = (2, 16, 16)
PROD2_AXES = ("pod", "data", "model")


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """Single pod: (16, 16) ``("data", "model")`` over 256 ranks; two pods:
    (2, 16, 16) ``("pod", "data", "model")`` over 512.  Raises unless the
    default process group exists and has exactly that many ranks."""
    shape, axes = ((PROD2_SHAPE, PROD2_AXES) if multi_pod
                   else (PROD_SHAPE, PROD_AXES))
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        name = "x".join(map(str, shape))
        raise ValueError(
            f"the {name} production mesh needs {need} ranks in the default "
            f"process group; it has {have}"
            + ("" if dist.is_initialized() else " (none initialised)"))
    return _mesh(_device_type(device_type), shape, axes)


def make_local_mesh(model_parallel: int = 1, device_type=None):
    """A ``("data", "model")`` mesh over the ranks of the default group,
    ``model_parallel`` wide on the model axis (1 when it does not divide
    the rank count, as the reference does).

    With no group initialised, this makes a one-rank group on the
    caller's device first: gloo for the CPU, nccl for a card, its store a
    file in a fresh temporary directory.  One rank gives a (1, 1) mesh, on
    which every placement is trivial."""
    dev = _device_type(device_type)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="mesh_"), "store")
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                init_method="file://" + store, rank=0,
                                world_size=1)
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return _mesh(dev, (n // mp, mp), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: ``("pod", "data")`` on multi-pod,
    ``("data",)``."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (a ``DeviceMesh``, or anything with
    ``mesh_dim_names`` and ``shape``: placements need no devices)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class MeshShape:
    """Names and sizes of a mesh with no devices behind it: enough for every
    spec function of ``launch.sharding`` and ``models.shardctx`` (the
    reference's tests fake ``mesh.devices.shape`` for the same purpose)."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)

    def __repr__(self):
        return f"MeshShape({self.shape}, {self.mesh_dim_names})"
