"""Session: median of ``SessionResponse.queue_wait_s`` over the window's
answers (the program's own submit -> lane splice wait), in ms."""
import numpy as np


def read(run):
    waits = [r["resp"].queue_wait_s for r in run["answered"]]
    return float(np.median(waits)) * 1e3 if waits else None
