"""Carry state over from the reference package, as numpy arrays.

Data takes the place of weights in this system: the same table, keys and
mid-run lane state fed to both packages must give the same trajectories.
Each function takes plain numpy arrays (``np.asarray`` of the reference's
arrays), so this module needs nothing of the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core import keys as keylib
from .core.fused import LaneParams, LaneState
from .core.sampling import GroupedData


def grouped_data_from_numpy(values: np.ndarray, offsets: np.ndarray,
                            scale: Optional[np.ndarray] = None,
                            device=None) -> GroupedData:
    """A :class:`GroupedData` on ``device`` from the reference's
    ``(values, offsets, scale)``."""
    return GroupedData(torch.from_numpy(np.array(values, np.float32)),
                       np.asarray(offsets, np.int64),
                       None if scale is None else np.asarray(scale),
                       device=device)


def key_from_numpy(key_data: np.ndarray) -> np.ndarray:
    """A ``(2,)`` uint32 key from the reference's raw key data."""
    return keylib.as_key(key_data)


def _leaves(leaves: Mapping[str, np.ndarray], fields) -> dict:
    missing = [f for f in fields if f not in leaves]
    if missing:
        raise ValueError(f"missing leaves: {missing}")
    return {f: np.asarray(leaves[f]) for f in fields}


def lane_state_from_numpy(leaves: Mapping[str, np.ndarray],
                          device=None) -> LaneState:
    """A :class:`LaneState` from the reference ``LaneState``'s leaves
    (``{name: np.asarray(leaf)}``), with the port's dtypes."""
    a = _leaves(leaves, LaneState._fields)
    dt = dict(keys=np.int64, k=np.int32, iters=np.int32, n_cur=np.int32,
              filled=np.int32, done=np.bool_, failed=np.bool_)
    return LaneState(**{
        f: torch.as_tensor(np.asarray(v, dt.get(f, np.float32)).copy(),
                           device=device)
        for f, v in a.items()})


def lane_params_from_numpy(leaves: Mapping[str, np.ndarray],
                           device=None) -> LaneParams:
    """A :class:`LaneParams` from the reference ``LaneParams``'s leaves.
    Warm-started lanes are a later slice: a warm lane raises."""
    if "warm" in leaves and np.any(np.asarray(leaves["warm"])):
        raise NotImplementedError(
            "warm-started lanes are not ported yet (ROADMAP Queue 1 item 11)")
    a = _leaves(leaves, LaneParams._fields)
    dt = dict(est_fids=np.int32, boot_base=np.int64, slot_idx=np.int32,
              group_sizes=np.int32)
    return LaneParams(**{
        f: torch.as_tensor(np.asarray(v, dt.get(f, np.float32)).copy(),
                           device=device)
        for f, v in a.items()})
