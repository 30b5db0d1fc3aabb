"""The benchmark of the PyTorch and CUDA port of MISS (``repro_torch``):
TPC-H lineitem served through ``AQPSession`` on one H100."""
