"""Kernel layer: hand-written Hopper kernels, their plain PyTorch versions,
and the switch that picks between them."""
from __future__ import annotations

import torch


def kernel_backend_available() -> bool:
    """Whether the hand-written kernels are the right default: a CUDA card
    is present."""
    return torch.cuda.is_available()


def resolve_use_kernel(mode: "bool | str", device) -> bool:
    """Resolve a tri-state kernel switch for tensors on ``device``.

    ``"auto"`` selects the CUDA kernels for a CUDA device and the plain
    PyTorch versions for the CPU.  ``False`` always runs the plain versions;
    ``True`` demands the kernels and raises on a CPU device -- there is no
    fallback.
    """
    dev = torch.device(device)
    if isinstance(mode, str):
        if mode == "auto":
            return dev.type == "cuda"
        raise ValueError(f"use_kernel must be True, False or 'auto'; got {mode!r}")
    if mode and dev.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {dev}")
    return bool(mode)
