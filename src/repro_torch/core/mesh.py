"""The data mesh of the sharded paths: one ``torch.distributed`` process
group, one rank per row shard.

The reference's mesh is single-controller: one process drives S devices
through ``shard_map`` and ``lax.psum``.  Here the mesh is SPMD: S processes of
one process group that the CALLER initialised (backend, ranks and devices are
the caller's choice; nothing here initialises a group or picks a backend).
Each rank holds its own row block and buffer segment and runs the same
replicated host schedule.

The one collective a sharded tick crosses is :meth:`DataMesh.all_gather_fold`:
an all-gather of the S partials followed by a fold IN SHARD ORDER,
``((p0 + p1) + p2) + p3``.  An all-reduce would not do: its reduction order is
the backend's, so it can differ from the sequential fold of the single-device
run in the last bit, while a fold of gathered partials adds in exactly that
order, which is what makes a mesh pool drain bit-equal to its ``mesh=False``
twin.

Row sharding follows the reference (``DATA_AXIS``, :func:`shard_dataset`):
rows padded to a multiple of the shard count, ``gid == -1`` marking padding.
``host_device_flag``, ``data_sharding``, ``put_sharded`` and
``put_replicated`` place XLA arrays on a device mesh and have no counterpart:
a rank places its own block on its own device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .sampling import default_device

# The one data-parallel axis name every sharded component agrees on.
DATA_AXIS = "data"


class DataMesh:
    """This process's view of the data mesh: ``rank`` of ``size`` shards,
    its tensors on ``device``.

    ``group`` is an initialised process group (None: the default group).
    With the gloo backend the collectives move host tensors, so a tensor on
    a CUDA device is staged through host memory for the transport only; with
    NCCL it stays on its device.  ``gathers``, ``broadcasts`` and
    ``reduces`` count the collectives this object issued.
    """

    def __init__(self, group=None, device=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                "a DataMesh needs an initialised torch.distributed process "
                "group: call torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = (torch.device(device) if device is not None
                       else default_device())
        self._host_transport = dist.get_backend(group) == "gloo"
        self.gathers = 0
        self.broadcasts = 0
        self.reduces = 0

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self._host_transport else x

    def all_gather_fold(self, x: torch.Tensor,
                        fold: Optional[Callable] = None) -> torch.Tensor:
        """One collective: gather the S ranks' partials ``x`` (same shape and
        dtype everywhere) and fold them left to right in shard order,
        ``fold(fold(p0, p1), p2) ...`` (default: addition), on ``x``'s
        device."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        self.gathers += 1
        out = parts[0].to(x.device)
        for p in parts[1:]:
            p = p.to(x.device)
            out = out + p if fold is None else fold(out, p)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks (``op`` "sum" or "max"), on ``x``'s
        device.  The backend picks the order of a sum: exact for integers,
        not bit-stable for floats (use :meth:`all_gather_fold` there)."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        w = self._wire(x).clone()
        dist.all_reduce(w, op=ops[op], group=self.group)
        self.reduces += 1
        return w.to(x.device)

    def broadcast_from0(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (on ``x``'s device): the value every
        rank acts on where each would otherwise read its own (a clock)."""
        w = self._wire(x).clone()
        dist.broadcast(w, src=dist.get_global_rank(self.group, 0)
                       if self.group is not None else 0, group=self.group)
        self.broadcasts += 1
        return w.to(x.device)

    def broadcast_float(self, v: float) -> float:
        """Rank 0's float ``v`` on every rank."""
        t = torch.tensor([float(v)], dtype=torch.float64)
        if not self._host_transport:
            t = t.to(self.device)
        return float(self.broadcast_from0(t)[0])


def make_data_mesh(num_devices: Optional[int] = None,
                   device=None) -> DataMesh:
    """The :class:`DataMesh` of the default process group, whose size must
    be ``num_devices`` when given."""
    mesh = DataMesh(device=device)
    if num_devices is not None and int(num_devices) != mesh.size:
        raise ValueError(
            f"requested a {int(num_devices)}-shard data mesh but the process "
            f"group has {mesh.size} ranks")
    return mesh


def shard_dataset(mesh: Optional[DataMesh], gid, x, device=None):
    """This rank's ``(gid (n_l,) int32, x (n_l,) f32)`` row block of a
    row-sharded dataset.

    Rows are padded to a multiple of the shard count with ``gid == -1``
    marking padding, and block s holds rows ``[s * n_l, (s + 1) * n_l)``.
    ``mesh=None`` is one shard: the whole padded table.  The block lands on
    ``device`` (default: the mesh's device, else the card).
    """
    gid = np.asarray(gid)
    x = np.asarray(x)
    S = 1 if mesh is None else mesh.size
    s = 0 if mesh is None else mesh.rank
    n = len(gid)
    per = -(-n // S)
    pad = per * S - n
    gid_p = np.pad(gid, (0, pad), constant_values=-1)   # -1 = invalid row
    x_p = np.pad(x, (0, pad))
    dev = torch.device(device) if device is not None else (
        mesh.device if mesh is not None else default_device())
    blk = slice(s * per, (s + 1) * per)
    return (torch.as_tensor(gid_p[blk].astype(np.int32), device=dev),
            torch.as_tensor(x_p[blk].astype(np.float32), device=dev))
