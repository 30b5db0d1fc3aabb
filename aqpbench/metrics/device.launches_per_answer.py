"""Device: kernels the profiler saw in the traced sub-window over the
answers polled in it."""


def read(run):
    tr, tracer = run.get("trace"), run["tracer"]
    if tr is None or tracer.span is None:
        return None
    lo, hi = tracer.span
    n = sum(1 for r in run["traced"] if lo <= r["t_done"] <= hi)
    k = tr.count_in_window()
    return k / n if n and k else None
