"""Segment kernels (CUDA, ``csrc/segment_agg.cu``): the grouped block's
segment bootstrap and the exact GROUP BY aggregate, with their plain
PyTorch versions."""
from . import ops, ref

__all__ = ["ops", "ref"]
