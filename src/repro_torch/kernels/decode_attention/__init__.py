"""Decode attention (CUDA, ``csrc/decode_attention.cu``): single-token GQA
flash decoding over a KV cache with a length per row, with its plain
PyTorch version."""
from . import ops, ref

__all__ = ["ops", "ref"]
