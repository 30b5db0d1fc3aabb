"""Session, in a closed loop: answers polled inside the window over its
seconds (per-layer there: with the clients always waiting, it swings with
the host's load run to run more than the tail does)."""


def read(run):
    n = len(run["in_window"])
    return n / run["seconds"] if n else None
