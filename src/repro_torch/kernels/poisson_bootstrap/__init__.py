"""Poisson-bootstrap moment kernel (CUDA, ``csrc/poisson_bootstrap.cu``) and
its plain PyTorch version."""
from . import ops, ref

__all__ = ["ops", "ref"]
