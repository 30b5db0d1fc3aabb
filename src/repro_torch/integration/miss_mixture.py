"""MISS-driven corpus mixture statistics for the LM data pipeline.

Per-domain corpus statistics (mean document length, mean quality score,
fraction passing a filter) drive mixture weighting decisions.  At corpus
scale these are GROUP BY queries over billions of documents; MISS answers
them from minimal samples with certified error -- this module is the thin
adapter from pipeline metadata to the AQP engine, on the table's device
(the card by default, where the ESTIMATE is the Poisson-bootstrap kernel's
moments entry).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..aqp.engine import AQPEngine
from ..aqp.query import Query
from ..core.sampling import GroupedData


def mixture_statistics(
    doc_lengths: Sequence[np.ndarray],
    *,
    epsilon_rel: float = 0.01,
    delta: float = 0.05,
    seed: int = 0,
    device=None,
) -> Dict[str, object]:
    """Certified per-domain mean document length + suggested mixture weights.

    ``doc_lengths``: one array of per-document token counts per domain.
    Returns {"mean_len", "weights", "trace", "docs_scanned", "docs_total"};
    weights are token-mass proportional (len_mean * n_docs, normalized).
    """
    data = GroupedData.from_group_arrays(
        [np.asarray(d, np.float32) for d in doc_lengths], device=device)
    eng = AQPEngine(data, seed=seed)
    trace = eng.execute(Query(func="avg", epsilon_rel=epsilon_rel,
                              delta=delta))
    mean_len = trace.theta[:, 0]
    mass = mean_len * data.sizes
    weights = mass / mass.sum()
    return {
        "mean_len": mean_len,
        "weights": weights,
        "trace": trace,
        "docs_scanned": trace.total_sampled,
        "docs_total": int(data.sizes.sum()),
    }
