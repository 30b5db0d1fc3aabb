"""Session, in an open loop: the 95th percentile of the latencies of every
request sent in the window, from its due time, in ms."""
import numpy as np


def read(run):
    lat = run["latency_s"]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
