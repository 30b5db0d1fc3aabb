"""Sampling substrate of the fused loop: the grouped dataset and the
counter-PRNG slot->row binding.

The dataset lives sorted by group with an offset table (the dense inverted
index of paper SS4.1), resident on the card; a sample of group i is a run of
slots whose rows :func:`counter_slot_table` binds once per sample key, so
samples are nested across iterations and shared across queries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import prng
from . import keys as keylib

# Domain-separation salt of the slot->row stream (same value as the
# reference, so one sample key names one binding in both packages).
SLOT_SALT = 0x5A17


def default_device() -> torch.device:
    """Entry points run on the card unless the caller names a device."""
    return torch.device("cuda")


@dataclasses.dataclass
class GroupedData:
    """A dataset pre-partitioned by the GROUP BY attribute.

    values:  (N, c) f32 rows on ``device``, sorted so each group occupies a
             contiguous extent.
    offsets: (m + 1,) int64 group boundaries (host numpy).
    scale:   (m,) per-group population scale |D|_i used by SUM/COUNT
             (paper SS2.2.1); defaults to the group sizes.
    """

    values: torch.Tensor
    offsets: np.ndarray
    scale: Optional[np.ndarray] = None
    device: Optional[torch.device] = None

    def __post_init__(self):
        dev = torch.device(self.device) if self.device is not None else (
            self.values.device if isinstance(self.values, torch.Tensor)
            else default_device())
        self.device = dev
        self.values = torch.as_tensor(self.values, device=dev)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        self.offsets = np.asarray(self.offsets, dtype=np.int64)
        if self.scale is None:
            self.scale = self.sizes.astype(np.float64)

    @property
    def num_groups(self) -> int:
        return len(self.offsets) - 1

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def num_columns(self) -> int:
        return self.values.shape[1]

    @staticmethod
    def from_columns(group_ids, values, device=None) -> "GroupedData":
        """Build from unsorted (group_id, value) columns -- the index build."""
        group_ids = np.asarray(group_ids)
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        order = np.argsort(group_ids, kind="stable")
        gid_sorted = group_ids[order]
        m = int(gid_sorted[-1]) + 1 if len(gid_sorted) else 0
        offsets = np.searchsorted(gid_sorted, np.arange(m + 1))
        return GroupedData(torch.from_numpy(values[order]), offsets,
                           device=device)

    @staticmethod
    def from_group_arrays(groups, device=None) -> "GroupedData":
        arrs = [np.asarray(g) for g in groups]
        arrs = [a[:, None] if a.ndim == 1 else a for a in arrs]
        offsets = np.concatenate([[0], np.cumsum([len(a) for a in arrs])])
        return GroupedData(torch.from_numpy(np.concatenate(arrs, axis=0)),
                           offsets, device=device)


def counter_slot_table(sample_key, starts, sizes, n_cap: int,
                       device=None) -> torch.Tensor:
    """(m, n_cap) int32 slot->row binding: slot j of group i reads row
    ``start_i + floor(u * size_i)``, ``u`` the counter hash of ``(seed, i,
    j)`` -- a pure function of the key, so samples nest across iterations
    and two programs given the same key gather the same rows."""
    dev = torch.device(device) if device is not None else default_device()
    starts = torch.as_tensor(np.asarray(starts, np.int32), device=dev)
    sizes = torch.as_tensor(np.asarray(sizes, np.int32), device=dev)
    m = sizes.shape[0]
    seed = keylib.bits(keylib.fold_in(sample_key, SLOT_SALT))
    rows_i = torch.arange(m, dtype=torch.int64, device=dev)[:, None]
    cols_j = torch.arange(n_cap, dtype=torch.int64, device=dev)[None, :]
    u = prng.uniform01(prng.hash3(seed, rows_i, cols_j))       # (m, n_cap)
    idx = (u * sizes[:, None]).to(torch.int32)
    return starts[:, None] + torch.minimum(idx, sizes[:, None] - 1)


def stratum_key(sample_key, g: int) -> np.ndarray:
    """The per-stratum sample key of group ``g`` under a shared binding.

    A grouped lane block gives every group its own slot->row stream by
    folding the group index into the shared key, so a block lane bound to
    group g draws exactly the rows a solo run over group g's slice draws
    when seeded with ``stratum_key(sample_key, g)`` (shifted by the group's
    start)."""
    return keylib.fold_in(sample_key, g)


def stratified_slot_tables(sample_key, offsets, n_cap: int,
                           device=None) -> torch.Tensor:
    """(G, 1, n_cap) int32 per-stratum slot->row bindings: table g is
    :func:`counter_slot_table` of group g alone under ``stratum_key(
    sample_key, g)``, in global rows.  The middle axis is the lane-local
    group axis (m = 1), so the result is a grouped block's per-lane
    ``LaneParams.slot_idx``."""
    off = np.asarray(offsets, np.int64)
    starts, sizes = off[:-1], np.diff(off)
    return torch.stack([
        counter_slot_table(stratum_key(sample_key, g), starts[g:g + 1],
                           sizes[g:g + 1], n_cap, device=device)
        for g in range(len(sizes))])


def bucket_cap(n: int, *, base: int = 256) -> int:
    """Round ``n`` up to the next power-of-two bucket >= base."""
    cap = base
    while cap < n:
        cap *= 2
    return cap
