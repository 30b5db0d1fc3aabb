"""Session, in a closed loop: the median latency of every request sent in
the window, from its send, in ms."""
import numpy as np


def read(run):
    lat = run["latency_s"]
    return float(np.percentile(lat, 50)) * 1e3 if len(lat) else None
