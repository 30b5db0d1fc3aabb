"""Lane pool: mean ``SessionResponse.ticks`` (pool ticks from splice to
harvest) over the POOL and WARM answers of the requests sent in the window;
None where the responses carry no such count."""
import numpy as np


def read(run):
    vals = [getattr(r["resp"], "ticks", None) for r in run["answered"]
            if r["resp"].route.name in ("POOL", "WARM")]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else None
