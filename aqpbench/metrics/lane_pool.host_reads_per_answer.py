"""Lane pool and fused step: the program's device-to-host reads (its spans
named ``*.read``: each tick's read of every busy tier and block, the
harvest's reads, a shed pilot's) starting inside the traced sub-window,
over the answers polled in it; None where the program names no read."""


def read(run):
    tr, tracer = run.get("trace"), run["tracer"]
    if tr is None or tracer.span is None:
        return None
    lo, hi = tracer.span
    n = sum(1 for r in run["traced"] if lo <= r["t_done"] <= hi)
    w0, w1 = tr.window
    k = sum(1 for name, s, _ in tr.spans
            if name.endswith(".read") and w0 <= s < w1)
    return k / n if n and k else None
