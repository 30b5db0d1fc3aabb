"""Device: idle seconds of the traced window whose innermost host span is a
phase of the fused tick (``lane_pool.step.*``), over the window, in %; None
where the program has no such span."""

STEP = "lane_pool.step."


def read(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    idle = sum(t for name, t in tr.idle_gaps(len(tr.spans) + 1)
               if name.startswith(STEP))
    return 100.0 * idle / tr.window_s if idle > 0 else None
