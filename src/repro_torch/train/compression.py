"""Gradient compression for a slow cross-node axis: int8 quantization with
error feedback (the reference's ``train/compression.py``).

int8 + a per-tensor scale cuts all-reduce traffic 4x against f32; the
residual (error feedback) makes the compression unbiased over time
(Karimireddy et al. 2019).

    g_sum, new_resid = compressed_psum(g_local, resid, mesh)

``mesh`` is a :class:`~repro_torch.core.mesh.DataMesh`: one rank per
process of an initialised ``torch.distributed`` group (for the pod sync,
also the ``"pod"`` axis of a ``DeviceMesh``).  The scales are
max-reduced so every rank dequantizes alike, and the codes are summed as
int32, which is exact in any order: the result is bit-equal whatever the
backend's reduction order.  Divisions take their divisor as a tensor on
the operand's device: CUDA turns a division by a host scalar into a
product with its reciprocal, which rounds differently from the
reference's ``x / 127.0``, and the card must give the CPU's bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.mesh import DataMesh
from . import pytree


def _div(x: torch.Tensor, d) -> torch.Tensor:
    return x / torch.as_tensor(d, dtype=torch.float32, device=x.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(_div(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(_div(xf, scale)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(x: torch.Tensor, resid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: q(x + resid), new resid = input - deq(q)."""
    target = x.float() + resid
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def compressed_psum(x: torch.Tensor, resid: torch.Tensor, mesh: DataMesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback all-reduce over the mesh's ranks: (the f32 sum
    of every rank's dequantized codes, this rank's new residual)."""
    _, scale, _ = ef_quantize(x, resid)
    # One shared scale across the ranks keeps dequantization consistent.
    scale_max = mesh.all_reduce(scale, "max")
    # Requantize against the shared scale (keeps |q| <= 127).
    target = x.float() + resid
    q = torch.clamp(torch.round(target / scale_max), -127, 127).to(
        torch.int8)
    new_resid = target - q.float() * scale_max
    total = mesh.all_reduce(q.to(torch.int32), "sum")
    return total.float() * scale_max, new_resid


def make_pod_gradient_sync(pod_mesh, *, enabled: bool = True):
    """grad_sync(grads, resids) -> (grads, resids): each leaf summed over
    the pod ranks with int8 error feedback and divided by their count.

    ``pod_mesh`` is a :class:`DataMesh` over the pod ranks, or a
    ``DeviceMesh`` (``launch.mesh``) whose ``"pod"`` axis gives them: each
    rank reduces over the sub-group of ranks that share its other
    coordinates.  The identity when disabled, when there is no mesh, or
    when the mesh has no ``"pod"`` axis (the reference's case)."""
    if not enabled or pod_mesh is None:
        return lambda g, r: (g, r)
    if not isinstance(pod_mesh, DataMesh):
        if "pod" not in (pod_mesh.mesh_dim_names or ()):
            return lambda g, r: (g, r)
        pod_mesh = DataMesh(group=pod_mesh.get_group("pod"),
                            device=pod_mesh.device_type)

    def grad_sync(grads, resids):
        flat_g, skel = pytree.flatten(grads)
        flat_r = pytree.leaves(resids)
        out = [compressed_psum(g, r, pod_mesh) for g, r in zip(flat_g,
                                                               flat_r)]
        n = float(pod_mesh.size)
        return (pytree.unflatten(skel, [_div(s, n) for s, _ in out]),
                pytree.unflatten(skel, [r for _, r in out]))

    return grad_sync
