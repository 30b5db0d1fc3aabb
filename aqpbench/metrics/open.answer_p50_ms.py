"""Session, in an open loop: the median latency of every request sent in
the window, from its due time, in ms (per-layer where the tail swings with
the planner's pool resizes)."""
import numpy as np


def read(run):
    lat = run["latency_s"]
    return float(np.percentile(lat, 50)) * 1e3 if len(lat) else None
