"""Sampling substrate: the grouped dataset, the counter-PRNG slot->row
binding of the fused loop, stratified sampling, the two-point init design
and the incremental ``SampleStore`` of the host route.

The dataset lives sorted by group with an offset table (the dense inverted
index of paper SS4.1), resident on the card.  In the fused loop a sample of
group i is a run of slots whose rows :func:`counter_slot_table` binds once
per sample key, so samples are nested across iterations and shared across
queries.  A sharded table (:class:`ShardLayout`) splits the rows into S
blocks and each lane buffer into S slot segments; :func:`sharded_slot_tables`
is the same binding cut per segment, into each shard's own rows.

On the host route, :class:`SampleStore` makes sampling incremental: each
group holds a lazily materialized uniform random permutation of its extent
(numpy's generator, the reference's draws), and "a sample of size n" is the
first n entries of it.  Growing n gathers only the new rows, on the device,
into a device-resident buffer; the same prefixes serve every query of a
store.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Sharded slot binding: the counter-PRNG binding split over row shards
# ---------------------------------------------------------------------------

# Domain-separation salt folding the shard index into the per-segment
# bootstrap seed stream (core/fused.py ``_sharded_step_body``).
SHARD_SALT = 0x5DA7


def _shard_alloc_tables(lsizes: np.ndarray, n_cap: int,
                        cap_s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative slot-ownership tables of a sharded group layout.

    ``lsizes[s, i]`` rows of group i live on shard s.  Shard s emits
    candidate times ``k * (Z_i / z_si)`` for ``k = 1..cap_s`` (``Z_i`` the
    group's rows), the candidates are merged by ``(time, shard)`` and the
    first ``n_cap`` are the group's logical slot order; ``alloc[s, i, n]``
    counts the slots shard s owns among the first ``n``.  The table is the
    identity at S = 1, 1-Lipschitz in ``n`` (so one tick's growth clamp
    always grants at least the per-segment window) and proportional (shard
    s owns ~``z_si / Z_i`` of the slots).  Host numpy, the reference's
    arithmetic step for step, so the tables are equal to its.
    """
    S, m = lsizes.shape
    alloc = np.zeros((S, m, n_cap + 1), np.int64)
    cap_groups = np.zeros((m,), np.int64)
    for i in range(m):
        z = lsizes[:, i].astype(np.float64)
        total = z.sum()
        if total <= 0:
            continue
        times: List[np.ndarray] = []
        sids: List[np.ndarray] = []
        k = np.arange(1, cap_s + 1, dtype=np.float64)
        for s in range(S):
            if z[s] <= 0:
                continue
            times.append(k * (total / z[s]))
            sids.append(np.full(cap_s, s, np.int64))
        t = np.concatenate(times)
        sid = np.concatenate(sids)
        order = np.lexsort((sid, t))          # stable: ties break by shard id
        sid = sid[order][:n_cap]
        cap_groups[i] = len(sid)
        for s in range(S):
            owned = np.cumsum(sid == s)
            alloc[s, i, 1:1 + len(sid)] = owned
            alloc[s, i, 1 + len(sid):] = owned[-1] if len(sid) else 0
    return alloc, cap_groups


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Host-side description of a grouped table split into S row blocks.

    Shard s owns rows ``[s * R, (s + 1) * R)`` of the zero-padded table, ``R
    = rows_per_shard``; each group's extent meets each block in at most one
    sub-extent (``lstarts``/``lsizes``, shard-local).  A lane buffer's slot
    axis is cut into S segments of ``seg_cap = n_cap // S`` slots, and
    ``alloc`` maps a logical sample-prefix length to each segment's fill
    (:func:`_shard_alloc_tables`).  ``cap_groups[i]`` is group i's logical
    slot capacity, clamped to the group's size and to at least 1.
    """
    num_shards: int
    rows_per_shard: int
    n_cap: int
    lstarts: np.ndarray     # (S, m) int32, shard-local row starts
    lsizes: np.ndarray      # (S, m) int32
    alloc: np.ndarray       # (S, m, n_cap + 1) int32, cumulative ownership
    cap_groups: np.ndarray  # (m,) int32

    @property
    def seg_cap(self) -> int:
        return self.n_cap // self.num_shards

    @staticmethod
    def build(offsets, *, n_cap: int, num_shards: int) -> "ShardLayout":
        offsets = np.asarray(offsets, np.int64)
        S = int(num_shards)
        if S < 1:
            raise ValueError(f"num_shards must be >= 1; got {S}")
        if n_cap % S:
            raise ValueError(f"n_cap={n_cap} must divide by num_shards={S}")
        n_rows = int(offsets[-1])
        rows_per_shard = -(-max(n_rows, 1) // S)
        m = len(offsets) - 1
        lstarts = np.zeros((S, m), np.int64)
        lsizes = np.zeros((S, m), np.int64)
        for s in range(S):
            blo = s * rows_per_shard
            bhi = blo + rows_per_shard
            lo = np.clip(offsets[:-1], blo, bhi)
            hi = np.clip(offsets[1:], blo, bhi)
            lsizes[s] = np.maximum(hi - lo, 0)
            # Empty sub-extents point at a valid local row; alloc owns none
            # of their slots, so they are never gathered.
            lstarts[s] = np.where(lsizes[s] > 0, lo - blo, 0)
        alloc, cap_groups = _shard_alloc_tables(lsizes, n_cap, n_cap // S)
        cap_groups = np.minimum(cap_groups, np.diff(offsets))
        cap_groups = np.maximum(cap_groups, 1)      # keep n >= 1 clips valid
        return ShardLayout(
            num_shards=S, rows_per_shard=int(rows_per_shard), n_cap=int(n_cap),
            lstarts=lstarts.astype(np.int32), lsizes=lsizes.astype(np.int32),
            alloc=alloc.astype(np.int32), cap_groups=cap_groups.astype(np.int32))

    def pad_values(self, values):
        """Values padded with zero rows to ``S * rows_per_shard`` (2-D): a
        numpy array on the host, a tensor on its own device."""
        total = self.num_shards * self.rows_per_shard
        if isinstance(values, torch.Tensor):
            v = values if values.dim() == 2 else values[:, None]
            if v.shape[0] < total:
                v = torch.cat([v, v.new_zeros((total - v.shape[0],)
                                              + tuple(v.shape[1:]))])
            return v
        v = np.asarray(values)
        if v.ndim == 1:
            v = v[:, None]
        if len(v) < total:
            v = np.pad(v, ((0, total - len(v)), (0, 0)))
        return v

    def block_values(self, values: torch.Tensor, s: int) -> torch.Tensor:
        """Shard s's ``(rows_per_shard, c)`` row block of the padded table,
        cut from ``values`` without padding the rest."""
        R = self.rows_per_shard
        v = values if values.dim() == 2 else values[:, None]
        blk = v[s * R:(s + 1) * R]
        if blk.shape[0] < R:
            blk = torch.cat([blk, blk.new_zeros((R - blk.shape[0],)
                                                + tuple(blk.shape[1:]))])
        return blk

    def shard_rows(self, filled) -> np.ndarray:
        """(S,) resident slots per shard at per-group watermarks ``filled``
        (m,): the per-shard dispatch accounting of the pool's stats."""
        f = np.minimum(np.asarray(filled, np.int64).reshape(-1), self.n_cap)
        gi = np.arange(self.alloc.shape[1])
        return np.stack([self.alloc[s, gi, f].sum()
                         for s in range(self.num_shards)])

    def max_shard_frac(self) -> float:
        """Largest per-shard share of any group's rows: translates a global
        watermark into a worst-case segment fill (the pool's cost model)."""
        z = self.lsizes.astype(np.float64)
        tot = np.maximum(z.sum(axis=0), 1.0)
        return float((z / tot[None, :]).max()) if z.size else 1.0


def sharded_slot_tables(sample_key, layout: ShardLayout, *,
                        local_rows: bool, device=None) -> torch.Tensor:
    """(S, m, seg_cap) int32 stacked slot->row tables of the sharded step.

    Segment slot j of shard s for group i draws ``u = uniform01(hash3(seed,
    i, s * seg_cap + j))`` -- the stream of :func:`counter_slot_table`
    indexed by the buffer-global slot -- into shard s's sub-extent of group
    i.  ``local_rows=True`` gives rows of the shard's own block (the mesh);
    ``False`` adds the block offset, giving rows of the whole (padded)
    table: the single-device view of the same binding.
    """
    dev = torch.device(device) if device is not None else default_device()
    S, m = layout.lsizes.shape
    seg_cap = layout.seg_cap
    seed = keylib.bits(keylib.fold_in(sample_key, SLOT_SALT))
    lstarts = torch.as_tensor(layout.lstarts, device=dev)
    lsizes = torch.as_tensor(layout.lsizes, device=dev)
    gids = torch.arange(m, dtype=torch.int64, device=dev)[None, :, None]
    slots = (torch.arange(S, dtype=torch.int64, device=dev)[:, None, None]
             * seg_cap
             + torch.arange(seg_cap, dtype=torch.int64, device=dev)[None, None, :])
    u = prng.uniform01(prng.hash3(seed, gids, slots))         # (S, m, seg_cap)
    draw = torch.minimum((u * lsizes[..., None]).to(torch.int32),
                         torch.clamp(lsizes[..., None] - 1, min=0))
    rows = lstarts[..., None] + draw
    if not local_rows:
        rows = rows + (torch.arange(S, dtype=torch.int32, device=dev)
                       * layout.rows_per_shard)[:, None, None]
    return rows


# ---------------------------------------------------------------------------
# PRNG root, stratified sampling and the two-point init design
# ---------------------------------------------------------------------------

def root_key(seed: int) -> np.ndarray:
    """The constructor of a fresh key stream root: ``PRNGKey(seed)``."""
    return keylib.prng_key(seed)


def stratified_sample(key, values: torch.Tensor, offsets, n_vec,
                      n_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n_vec[i]`` uniform rows (with replacement) from each group's
    extent: ``(sample (m, n_cap, c), mask (m, n_cap))`` on the values'
    device, row ``start_i + floor(u * size_i)`` for the reference's
    ``uniform(key, (m, n_cap))``."""
    dev = values.device
    off = torch.as_tensor(np.asarray(offsets, np.int32), device=dev)
    m = off.shape[0] - 1
    starts, sizes = off[:-1], off[1:] - off[:-1]
    u = keylib.uniform(key, (m, n_cap), device=dev)
    idx = starts[:, None] + torch.minimum(
        (u * sizes[:, None]).to(torch.int32), sizes[:, None] - 1)
    sample = values[idx.to(torch.int64)]
    n = torch.as_tensor(np.asarray(n_vec, np.int64), device=dev)
    mask = (torch.arange(n_cap, device=dev)[None, :] < n[:, None]).to(
        torch.float32)
    return sample, mask


def stratified_sample_host(rng: np.random.Generator, data: GroupedData,
                           n_vec: np.ndarray, n_cap: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-index variant (numpy RNG) of :func:`stratified_sample`; the
    gather runs on the data's device."""
    m = data.num_groups
    idx = np.zeros((m, n_cap), dtype=np.int64)
    mask = np.zeros((m, n_cap), dtype=np.float32)
    sizes = data.sizes
    for i in range(m):
        k = int(min(n_vec[i], n_cap))
        idx[i, :k] = data.offsets[i] + rng.integers(0, sizes[i], size=k)
        mask[i, :k] = 1.0
    dev = data.device
    return (data.values[torch.as_tensor(idx, device=dev)],
            torch.as_tensor(mask, device=dev))


def gap_sample_indices(rng: np.random.Generator, n_rows: int,
                       p: float) -> np.ndarray:
    """Bernoulli(p) row subset without a coin per row (paper SS4.1, gap
    sampling): gaps between kept rows are Geometric(p), drawn on the host
    with numpy (the reference's draws for the same generator)."""
    if p <= 0.0:
        return np.empty((0,), dtype=np.int64)
    if p >= 1.0:
        return np.arange(n_rows, dtype=np.int64)
    # E[#kept] = n p; oversample the geometric draws and trim.
    est = int(n_rows * p + 10 * np.sqrt(n_rows * p + 1)) + 16
    pos = np.cumsum(rng.geometric(p, size=est)) - 1
    return pos[pos < n_rows].astype(np.int64)


def two_point_init_sizes(key, m: int, l: int, n_min: int,
                         n_max: int) -> np.ndarray:
    """Initial ``(l, m)`` sample-size matrix from the Bhatia-Davis optimal
    design (paper Eq. 15/16): a fraction n_max/(n_min + n_max) of the probes
    at n_min, the rest at n_max, both at least once, each column shuffled by
    numpy seeded from the key's last word (the reference's draws)."""
    l_min = int(round(l * n_max / (n_min + n_max)))
    l_min = min(max(l_min, 1), l - 1)
    col = np.concatenate([
        np.full((l_min,), n_min, np.int64),
        np.full((l - l_min,), n_max, np.int64),
    ])
    sizes = np.tile(col[:, None], (1, m))
    rng = np.random.default_rng(keylib.as_key(key)[-1])
    for j in range(m):
        rng.shuffle(sizes[:, j])
    return sizes


# ---------------------------------------------------------------------------
# SampleStore: incremental permuted-prefix sampling
# ---------------------------------------------------------------------------

class _PrefixPermutation:
    """Lazily materialized uniform random permutation of ``[0, size)``.

    Incremental Fisher-Yates with a sparse swap map: materializing positions
    ``[t, upto)`` costs O(upto - t) time and O(upto) memory whatever
    ``size`` is, in ``page``-sized chunks.  It touches no data rows.
    """

    __slots__ = ("size", "page", "_rng", "_perm", "_len", "_swaps")

    def __init__(self, size: int, rng: np.random.Generator, *,
                 page: int = 512):
        self.size = int(size)
        self.page = int(page)
        self._rng = rng
        self._perm = np.empty((0,), np.int64)
        self._len = 0
        self._swaps: Dict[int, int] = {}

    def prefix(self, n: int) -> np.ndarray:
        """First ``n`` entries of the permutation (local offsets)."""
        n = min(int(n), self.size)
        if n > self._len:
            upto = min(-(-n // self.page) * self.page, self.size)
            if upto > len(self._perm):
                cap = max(2 * len(self._perm), upto)
                new = np.empty((min(cap, self.size),), np.int64)
                new[: self._len] = self._perm[: self._len]
                self._perm = new
            sw = self._swaps
            # r = j + floor(u * (size - j)) is uniform on [j, size).
            u = self._rng.random(upto - self._len)
            for j in range(self._len, upto):
                r = j + int(u[j - self._len] * (self.size - j))
                vj = sw.get(j, j)
                vr = sw.get(r, r)
                self._perm[j] = vr
                sw[r] = vj
            self._len = upto
        return self._perm[:n]


class SampleStoreBinding:
    """One value-column binding of a :class:`SampleStore`.

    The store owns the per-group permutations (which rows); a binding owns a
    device-resident buffer of gathered rows of one values tensor (their
    contents).  Predicate queries bind their indicator column to the same
    permutations, so every binding sees the same nested prefixes.
    """

    def __init__(self, store: "SampleStore", values: torch.Tensor):
        self.store = store
        self.values = torch.as_tensor(values, device=store.device)
        if self.values.dim() == 1:
            self.values = self.values[:, None]
        self._buf: Optional[torch.Tensor] = None    # (m, capacity, c)
        self._gathered = np.zeros((store.num_groups,), np.int64)
        self._epoch = store.epoch
        self.rows_touched = 0                       # cumulative gathered rows

    def _sync_epoch(self) -> None:
        if self._epoch != self.store.epoch:
            # Permutations were refreshed or reshuffled under us.
            self._buf = None
            self._gathered[:] = 0
            self._epoch = self.store.epoch

    def _ensure_capacity(self, cap: int) -> None:
        c = self.values.shape[1]
        m = self.store.num_groups
        if self._buf is None:
            self._buf = torch.zeros((m, cap, c), dtype=self.values.dtype,
                                    device=self.values.device)
        elif self._buf.shape[1] < cap:
            buf = torch.zeros((m, cap, c), dtype=self._buf.dtype,
                              device=self._buf.device)
            buf[:, :self._buf.shape[1]] = self._buf
            self._buf = buf

    def _window(self, n_vec, base) -> Tuple[np.ndarray, np.ndarray]:
        """Clamp a (base, n) permutation window to the group extents.

        ``base=None`` is the prefix ``[0, n)``; a base reads slots ``[base,
        base + n)`` (MISS's stacked init windows).  A window overrunning a
        group's extent is shifted back, so the sample never shrinks.
        """
        sizes = self.store.sizes
        n = np.minimum(np.asarray(n_vec, np.int64), sizes)
        if base is None:
            b = np.zeros_like(n)
        else:
            b = np.minimum(np.asarray(base, np.int64),
                           np.maximum(sizes - n, 0))
        return b, n

    def sample_cost(self, n_vec: np.ndarray, base=None) -> int:
        """Rows a ``sample(n_vec, base)`` call would gather."""
        self._sync_epoch()
        b, n = self._window(n_vec, base)
        return int(np.maximum(b + n - self._gathered, 0).sum())

    def sample(self, n_vec: np.ndarray,
               base=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Permuted-prefix sample of ``n_vec[i]`` rows a group:
        ``(sample (m, n_cap, c), mask (m, n_cap))`` with ``n_cap`` the
        power-of-two bucket of the requested max size.  Only rows not yet
        resident are gathered (one device gather); with ``base``, row i holds
        slots ``[base[i], base[i] + n[i])`` left-aligned."""
        self._sync_epoch()
        store = self.store
        dev = self.values.device
        b, n = self._window(n_vec, base)
        need = b + n
        store.reserve(int(need.max(initial=1)))
        out_cap = bucket_cap(int(n.max(initial=1)))
        self._ensure_capacity(bucket_cap(int(need.max(initial=1))))
        grow = np.flatnonzero(need > self._gathered)
        if grow.size:
            g_pos: List[np.ndarray] = []
            s_pos: List[np.ndarray] = []
            idx: List[np.ndarray] = []
            for i in grow:
                lo, hi = int(self._gathered[i]), int(need[i])
                loc = store.perm(i).prefix(hi)[lo:hi]
                idx.append(store.offsets[i] + loc)
                s_pos.append(np.arange(lo, hi, dtype=np.int64))
                g_pos.append(np.full((hi - lo,), i, np.int64))
            flat_idx = np.concatenate(idx)
            pos = torch.as_tensor(
                np.stack([np.concatenate(g_pos), np.concatenate(s_pos),
                          flat_idx]), device=dev)
            self._buf[pos[0], pos[1]] = self.values[pos[2]]
            self._gathered[grow] = need[grow]
            self.rows_touched += int(flat_idx.shape[0])
            store._note_rows(int(flat_idx.shape[0]))
        n_dev = torch.as_tensor(n, device=dev)
        mask = (torch.arange(out_cap, device=dev)[None, :]
                < n_dev[:, None]).to(torch.float32)
        if base is None or not b.any():
            return self._buf[:, :out_cap], mask
        # Left-align the windows: column j of row i reads slot b[i] + j.
        slots = (torch.as_tensor(b, device=dev)[:, None]
                 + torch.arange(out_cap, device=dev)[None, :])
        slots = torch.clamp(slots, max=self._buf.shape[1] - 1)
        window = torch.gather(
            self._buf, 1, slots[:, :, None].expand(-1, -1,
                                                   self._buf.shape[2]))
        return window, mask

    def sample_host(self, n_vec: np.ndarray,
                    base=None) -> Tuple[np.ndarray, np.ndarray]:
        """The same windows gathered with numpy (the parity reference of
        :meth:`sample`)."""
        store = self.store
        b, n = self._window(n_vec, base)
        store.reserve(int((b + n).max(initial=1)))
        out_cap = bucket_cap(int(n.max(initial=1)))
        vals = self.values.cpu().numpy()
        m = store.num_groups
        out = np.zeros((m, out_cap, vals.shape[1]), vals.dtype)
        mask = np.zeros((m, out_cap), np.float32)
        for i in range(m):
            lo, k = int(b[i]), int(n[i])
            loc = store.perm(i).prefix(lo + k)[lo:lo + k]
            out[i, :k] = vals[store.offsets[i] + loc]
            mask[i, :k] = 1.0
        return out, mask

    def prefix_indices(self, n_vec: np.ndarray,
                       base=None) -> Tuple[np.ndarray, np.ndarray]:
        """Global row indices of the current windows (idx (m, cap), mask)."""
        store = self.store
        b, n = self._window(n_vec, base)
        store.reserve(int((b + n).max(initial=1)))
        out_cap = bucket_cap(int(n.max(initial=1)))
        idx = np.zeros((store.num_groups, out_cap), np.int64)
        mask = np.zeros((store.num_groups, out_cap), np.float32)
        for i in range(store.num_groups):
            lo, k = int(b[i]), int(n[i])
            idx[i, :k] = store.offsets[i] + store.perm(i).prefix(
                lo + k)[lo:lo + k]
            mask[i, :k] = 1.0
        return idx, mask


class SampleStore:
    """Device-resident incremental sample store over one :class:`GroupedData`.

    * ``sample(n)`` is the first ``n`` entries of a per-group uniform random
      permutation: samples are nested within an epoch (without
      replacement, so ``sample(|group|)`` is the whole extent);
    * growing ``n -> n + delta`` gathers exactly ``delta`` new rows;
      ``rows_touched`` counts them and ``sample_cost`` predicts them;
    * ``refresh()`` invalidates after a data update, ``reshuffle()`` redraws
      the permutations over the same data;
    * ``bind(values)`` attaches a derived column to the same permutations.
    """

    def __init__(self, data: GroupedData, *, seed: int = 0, page: int = 512):
        self.data = data
        self.seed = int(seed)
        self.page = int(page)
        self.epoch = 0
        self.rows_touched = 0       # over all bindings
        self._capacity = 0
        self._perms: List[Optional[_PrefixPermutation]] = []
        self._reset_perms()
        self._primary = self.bind(data.values)

    def _reset_perms(self) -> None:
        root = np.random.default_rng((self.seed, self.epoch))
        self._seeds = root.integers(0, 2**63 - 1, size=self.num_groups)
        self._perms = [None] * self.num_groups

    def perm(self, i: int) -> _PrefixPermutation:
        p = self._perms[i]
        if p is None:
            p = _PrefixPermutation(
                int(self.sizes[i]),
                np.random.default_rng(int(self._seeds[i])), page=self.page)
            self._perms[i] = p
        return p

    def _note_rows(self, k: int) -> None:
        self.rows_touched += k

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def num_groups(self) -> int:
        return self.data.num_groups

    @property
    def sizes(self) -> np.ndarray:
        return self.data.sizes

    @property
    def offsets(self) -> np.ndarray:
        return self.data.offsets

    @property
    def capacity(self) -> int:
        """Current padded sample capacity (a power-of-two bucket)."""
        return self._capacity

    def reserve(self, n: int) -> int:
        """Grow the capacity bucket to cover ``n``; returns the capacity."""
        cap = bucket_cap(max(int(n), 1))
        if cap > self._capacity:
            self._capacity = cap
        return self._capacity

    def sample(self, n_vec: np.ndarray,
               base=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._primary.sample(n_vec, base)

    def sample_host(self, n_vec: np.ndarray,
                    base=None) -> Tuple[np.ndarray, np.ndarray]:
        return self._primary.sample_host(n_vec, base)

    def sample_cost(self, n_vec: np.ndarray, base=None) -> int:
        return self._primary.sample_cost(n_vec, base)

    def prefix_indices(self, n_vec: np.ndarray, base=None):
        return self._primary.prefix_indices(n_vec, base)

    def bind(self, values: torch.Tensor) -> SampleStoreBinding:
        """Attach a derived values column to this store's permutations
        (untracked; invalidated lazily through the epoch counter)."""
        return SampleStoreBinding(self, values)

    def refresh(self, data: Optional[GroupedData] = None) -> None:
        """Invalidate after a data update (or rebind to ``data``): new
        permutations, every binding's buffer dropped; ``rows_touched``
        keeps counting."""
        if data is not None:
            self.data = data
            v = data.values
            self._primary.values = v if v.dim() == 2 else v[:, None]
            self._primary._gathered = np.zeros((self.num_groups,), np.int64)
        self.epoch += 1
        self._reset_perms()

    def reshuffle(self, seed: Optional[int] = None) -> None:
        """Redraw the permutations over the same data, so a long-lived
        store does not answer repeats from the same prefixes forever."""
        if seed is not None:
            self.seed = int(seed)
        self.epoch += 1
        self._reset_perms()
