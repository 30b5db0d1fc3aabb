"""Kernel row 1 (``csrc/poisson_bootstrap.cu``, ``pb_kernel``): the least
time the card could take for the traced calls' work
(``roofline/work.py``) over their device time, in %."""
from aqpbench.metrics_common import roofline


def read(run):
    return roofline(run, "poisson_bootstrap", ("pb_kernel",))
