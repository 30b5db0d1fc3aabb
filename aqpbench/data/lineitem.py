"""TPC-H ``lineitem`` made on the device from a seed (TPC-H Standard
Specification, section 4.2.3).

Only the columns the served table needs are drawn:

* ``L_QUANTITY``   uniform on [1, 50];
* ``L_PARTKEY``    uniform on [1, SF * 200 000];
* ``P_RETAILPRICE = (90000 + ((P_PARTKEY / 10) mod 20001)
                     + 100 * (P_PARTKEY mod 1000)) / 100``  (integer /10);
* ``L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE``, exact in cents and
  rounded once to float32 (the resident measure);
* the clustering attribute (``L_SHIPINSTRUCT``: 4 values, ``L_TAX``: 9
  values 0.00-0.08) uniform over its values: it only sets the group sizes,
  one multinomial draw from the seed.

Rows are made in group order, each group's rows contiguous, in chunks on the
device, so the served table needs no sort.  The same seed on the same device
gives the same values, chunk by chunk, which is how the reference reads the
table again after the measured window.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

CHUNK_ROWS = 1 << 24
SIZING_ROWS = 1 << 21
SIZING_SEED = 20_180_731        # fixed: the traffic's sizing never moves


def seed_words(seed: int) -> list:
    """A non-negative entropy list for numpy's SeedSequence from any int."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def num_rows(cfg: dict) -> int:
    return int(round(cfg["scale_factor"] * cfg["rows_per_sf"]))


def num_parts(cfg: dict) -> int:
    return int(round(cfg["scale_factor"] * cfg["parts_per_sf"]))


def group_sizes(cfg: dict, seed: int) -> np.ndarray:
    """(groups,) row counts: the clustering attribute uniform over its
    ``groups`` values, drawn once from the seed."""
    m = int(cfg["groups"])
    rng = np.random.default_rng(seed_words(seed) + [1])
    return rng.multinomial(num_rows(cfg), np.full(m, 1.0 / m)).astype(np.int64)


def offsets_of(sizes: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def retail_cents(partkey):
    """P_RETAILPRICE in cents of an integer partkey array (torch or numpy)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def chunks(cfg: dict, seed: int, device, chunk_rows: int = CHUNK_ROWS
           ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """Yield ``(group, first_row, extendedprice f32 chunk)`` in row order."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    parts = num_parts(cfg)
    row = 0
    for g, size in enumerate(group_sizes(cfg, seed)):
        done = 0
        while done < size:
            k = int(min(chunk_rows, size - done))
            qty = torch.randint(1, 51, (k,), generator=gen, device=device,
                                dtype=torch.int32)
            pk = torch.randint(1, parts + 1, (k,), generator=gen,
                               device=device, dtype=torch.int32)
            cents = qty * retail_cents(pk)          # < 2**24: exact in f32
            yield g, row, cents.to(torch.float32) / 100.0
            row += k
            done += k


def make_table(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, np.ndarray]:
    """``(values (N,) f32 on device, offsets (groups + 1,) int64)``."""
    sizes = group_sizes(cfg, seed)
    values = torch.empty((int(sizes.sum()),), dtype=torch.float32,
                         device=device)
    for _, row, x in chunks(cfg, seed, device):
        values[row:row + x.shape[0]] = x
    return values, offsets_of(sizes)


def sizing_values(cfg: dict) -> np.ndarray:
    """A fixed host sample of EXTENDEDPRICE from the same formulas, which
    sizes the traffic's bounds: the population's per-group answers are the
    same in every group, so a request's bound does not depend on the seed's
    table."""
    rng = np.random.default_rng(SIZING_SEED)
    qty = rng.integers(1, 51, SIZING_ROWS, dtype=np.int64)
    pk = rng.integers(1, num_parts(cfg) + 1, SIZING_ROWS, dtype=np.int64)
    return ((qty * retail_cents(pk)).astype(np.float32)
            / np.float32(100.0)).astype(np.float32)
