"""Kernel row 2 (``csrc/segment_agg.cu``, ``seg_boot_kernel`` with its
``seg_plan_kernel``): the least time the card could take for the traced
calls' work (``roofline/work.py``) over their device time, in %."""
from aqpbench.metrics_common import roofline


def read(run):
    return roofline(run, "segment_boot", ("seg_boot_kernel",
                                          "seg_plan_kernel"))
