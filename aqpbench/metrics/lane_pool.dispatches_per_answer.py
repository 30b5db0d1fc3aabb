"""Lane pool: fused dispatches (one a busy tier and one a resident GROUP BY
block per round, plus synchronous LOOP/BATCHED dispatches) from the
session's ``stats()["fused_dispatches"]``, which survives pool rebuilds,
over the answers of the requests sent in the window."""


def read(run):
    n = len(run["answered"])
    d = run["stats1"]["fused_dispatches"] - run["stats0"]["fused_dispatches"]
    return d / n if n and d > 0 else None
