"""Distributed AQP over a row-sharded dataset: shard-local work, one
collective.

The Poisson bootstrap composes over row shards: replicate b's moment sums
``M_b = sum_j w_bj * feats_j`` split as ``M_b = sum_s M_b^s`` with independent
Poisson weights per shard.  So the whole distributed ESTIMATE is shard-local
(sample -> weight -> moment sums), one :meth:`~repro_torch.core.mesh.DataMesh.
all_gather_fold` of the ``(m, B + 1, 3)`` partials, and the finish on the
small combined result: only ``m * (B + 1) * 3`` floats a rank cross the
interconnect, whatever the data size.  The exact distributed GROUP BY is each
rank's segment-aggregate partials folded the same way.

Every function takes this rank's row block (:func:`shard_dataset`) and a
:class:`~repro_torch.core.mesh.DataMesh` (SPMD: every rank calls it), or
``mesh=None``: one shard holding the whole padded table.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import estimators
from ..core.bootstrap import _quantile
from ..core.mesh import DataMesh, make_data_mesh, shard_dataset  # noqa: F401
from ..kernels import prng
from ..kernels.segment_agg import ops as seg_ops

_STAT_KEYS = ("count", "sum", "sumsq", "min", "max")
_ROWS_AT_ONCE = 1 << 14     # sampled rows whose (rows, B) weights exist at once


def _fold(mesh: Optional[DataMesh], x: torch.Tensor, fold=None) -> torch.Tensor:
    """The combined partials: one collective on a mesh, ``x`` itself for one
    shard."""
    return x if mesh is None else mesh.all_gather_fold(x, fold)


def _stats_fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fold two ``(5, m)`` [count, sum, sumsq, min, max] partials."""
    return torch.cat([a[:3] + b[:3], torch.minimum(a[3:4], b[3:4]),
                      torch.maximum(a[4:], b[4:])])


def sharded_group_stats(mesh: Optional[DataMesh], gid: torch.Tensor,
                        x: torch.Tensor, m: int) -> Dict[str, torch.Tensor]:
    """Exact distributed GROUP BY count/sum/sumsq/min/max, each ``(m,)``.

    Each rank's partials come from one segment-aggregate launch over its
    block (its plain version on a CPU tensor), padding rows (``gid < 0``)
    masked out; the S partials fold in shard order, min/max by
    ``minimum``/``maximum``.  An empty group reads min ``3e38``, max
    ``-3e38``.
    """
    mask = (gid >= 0).to(torch.float32)
    agg = seg_ops.segment_aggregate(gid, x.to(torch.float32), mask, m)
    part = torch.stack([agg[k] for k in _STAT_KEYS])            # (5, m)
    out = _fold(mesh, part, _stats_fold)
    return {k: out[i] for i, k in enumerate(_STAT_KEYS)}


def _bootstrap_partials(gid: torch.Tensor, x: torch.Tensor, m: int,
                        rate: torch.Tensor, boot_seed: int, samp_seed: int,
                        shard: int, B: int) -> torch.Tensor:
    """(m, B + 1, 3) moment sums of one shard's Bernoulli sample: replicate
    0 the plain sample, replicate b weight ``poisson1(hash3(boot_seed, row +
    shard * n_l, b))``."""
    dev = x.device
    n_l = gid.shape[0]
    valid = gid >= 0
    g = torch.clamp(gid.to(torch.int64), min=0)
    rows = torch.arange(n_l, dtype=torch.int64, device=dev)
    # Shard-local Bernoulli(rate_g): each row's keep-threshold is a pure
    # function of (sample seed, row, shard), so a larger rate keeps a
    # superset of rows.
    u = prng.uniform01(prng.hash3(samp_seed, rows, shard))
    sampled = valid & (u < rate.to(device=dev, dtype=torch.float32)[g])
    idx = torch.nonzero(sampled)[:, 0]
    xs = x.to(torch.float32)[idx]
    feats = torch.stack([torch.ones_like(xs), xs, xs * xs], dim=1)  # (k, 3)
    cols = torch.arange(1, B + 1, dtype=torch.int64, device=dev)
    M = torch.zeros((m, B + 1, 3), dtype=torch.float32, device=dev)
    for c0 in range(0, idx.shape[0], _ROWS_AT_ONCE):
        sl = slice(c0, c0 + _ROWS_AT_ONCE)
        w = prng.poisson1_weights_at(
            boot_seed, (idx[sl] + shard * n_l)[:, None], cols[None, :])
        w_all = torch.cat([torch.ones_like(w[:, :1]), w], dim=1)  # (k, B+1)
        onehot = torch.nn.functional.one_hot(g[idx[sl]], m).to(torch.float32)
        M += torch.einsum("ng,nb,np->gbp", onehot, w_all, feats[sl])
    return M


def sharded_bootstrap_estimate(
    mesh: Optional[DataMesh], gid: torch.Tensor, x: torch.Tensor, m: int,
    rate, seed: int, *, B: int = 200, delta: float = 0.05,
    est_name: str = "avg", sample_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed (sample -> Poisson bootstrap -> L2 error, theta-hat).

    ``rate (m,)`` is each group's Bernoulli sampling rate.  Rows are sampled
    shard-locally, every replicate's moment sums are shard-local, and one
    fold of the ``(m, B + 1, 3)`` partials crosses the mesh.  ``sample_seed``
    (default ``seed``) fixes the sample: a larger ``rate`` under the same
    sample seed keeps a superset of rows, so MISS iterations refine the
    sample while ``seed`` re-randomizes the bootstrap.  Returns ``(e,
    theta (m,))``.
    """
    est = estimators.get(est_name)
    if est.moments_finish is None:
        raise ValueError(f"{est_name} is not a moment estimator")
    if sample_seed is None:
        sample_seed = seed
    boot_seed = (int(seed) ^ 0x5BD1E995) & 0xFFFFFFFF
    shard = 0 if mesh is None else mesh.rank
    if not isinstance(rate, torch.Tensor):
        rate = torch.as_tensor(np.asarray(rate, np.float32))
    M = _fold(mesh, _bootstrap_partials(
        gid, x, m, rate, boot_seed, int(sample_seed) & 0xFFFFFFFF, shard, B))
    theta = est.moments_finish(M[:, 0])                         # (m, 1)
    reps = est.moments_finish(M[:, 1:])                         # (m, B, 1)
    err = torch.sqrt(torch.sum((reps - theta[:, None]) ** 2, dim=-1))
    joint = torch.sqrt(torch.sum(err * err, dim=0))             # (B,)
    return _quantile(joint, float(np.float32(1.0 - delta))), theta[:, 0]
