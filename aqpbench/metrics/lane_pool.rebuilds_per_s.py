"""Lane pool: the planner's pool rebuilds (a new lane count, applied only
while the pool is idle) per second of the window, from the session's
``stats()["pool_rebuilds"]``."""


def read(run):
    d = run["stats1"]["pool_rebuilds"] - run["stats0"]["pool_rebuilds"]
    return d / run["seconds"] if d > 0 else None
