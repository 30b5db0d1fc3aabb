"""Device: 1 - (union of device-busy intervals / traced window), in %."""
from aqpbench.metrics_common import idle_share


def read(run):
    return idle_share(run)
