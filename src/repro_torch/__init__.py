"""PyTorch/CUDA port of the MISS system (the JAX package ``repro`` is the
reference).  Entry points run on the card unless the caller passes
``device="cpu"``."""
