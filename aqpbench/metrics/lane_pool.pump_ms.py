"""Lane pool and fused step: mean host ms of an ``AQPSession.pump()``
round in the window (the benchmark's span around each call)."""
import numpy as np


def read(run):
    return float(np.mean(run["pump_s"])) * 1e3 if run["pump_s"] else None
