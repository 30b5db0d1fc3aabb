"""Lane pool and fused step: the share of the pool's finish-and-test phases
(each ``lane_pool.step.test`` span inside a ``lane_pool.tier_step`` or
``lane_pool.block_step``) starting inside the traced sub-window that
replayed a CUDA graph (held a ``lane_pool.step.finish_replay`` span), in %.
A program with the finish graph path (``FinishGraphs`` in
``repro_torch.core.graphs``) whose phases all ran eagerly reads 0; None
where there is no trace, no such phase, or no such path in the program.

The session counts the same over a whole run (``stats()``'s
``finish_replays`` over ``finish_replays + eager_finish``); the harness
hands a reader none of those counters, so this reads the spans."""
import importlib
import importlib.util

import numpy as np

STEPS = ("lane_pool.tier_step", "lane_pool.block_step")
PHASE = "lane_pool.step.test"
REPLAY = "lane_pool.step.finish_replay"
GRAPHS = "repro_torch.core.graphs"


def _inside(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """Mask of the ``inner`` (k, 2) intervals that lie inside one of the
    disjoint ``outer`` (j, 2) intervals."""
    if outer.size == 0 or inner.size == 0:
        return np.zeros(inner.shape[0], bool)
    outer = outer[np.argsort(outer[:, 0], kind="stable")]
    i = np.searchsorted(outer[:, 0], inner[:, 0], side="right") - 1
    return (i >= 0) & (outer[np.maximum(i, 0), 1] >= inner[:, 1])


def _has_path() -> bool:
    """The program's graph module holds the finish phase's cache."""
    return (importlib.util.find_spec(GRAPHS) is not None
            and hasattr(importlib.import_module(GRAPHS), "FinishGraphs"))


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    w0, w1 = tr.window

    def spans(names, in_window=False):
        return np.asarray([(s, e) for n, s, e in tr.spans if n in names
                           and (not in_window or w0 <= s < w1)],
                          np.int64).reshape(-1, 2)

    phases = spans((PHASE,), in_window=True)
    phases = phases[_inside(spans(STEPS), phases)]
    if phases.shape[0] == 0 or not _has_path():
        return None
    replays = int(_inside(phases, spans((REPLAY,))).sum())
    return 100.0 * replays / phases.shape[0]
