"""Collective byte counts and roofline terms of a sharded step (the
reference's ``launch/hlo_analysis.py``, which parses compiled HLO text).

An eager port has no HLO: the collectives are the functional collectives
that DTensor issues on each rank's local tensors.  :class:`CollectiveRecord`
is a ``CommDebugMode`` that also keeps each collective's result bytes;
:func:`collective_bytes` maps its funcol ops onto the reference's five
kinds (result bytes ~ wire bytes per rank; an all-reduce counts once,
although a ring moves ~2x).  :func:`roofline_terms` keeps the reference's
three-term formula with an H100's constants in place of a TPU's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# funcol / c10d op name (the overload packet's last part) -> kind.
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "send_": "collective-permute",
}


def kind_of(op_name: str) -> str:
    """The reference's kind of a collective op (``"other"`` if unknown)."""
    return _KIND_OF.get(op_name.split(".")[-1], "other")


def _nbytes(out) -> int:
    import torch
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def CollectiveRecord():
    """A ``CommDebugMode`` that also records ``(op name, result bytes)`` of
    every collective run on a rank's local tensors, in ``.collectives``, and
    their bytes by the DTensor op that issued them, in ``.by_op``.
    Built on call, so importing this module imports no distributed code."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils import _pytree

    class _Record(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.collectives: List[Tuple[str, int]] = []
            self.by_op: Dict[str, int] = {}
            self._op = "-"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self._op = str(func)        # the op whose collectives follow
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or any(
                    isinstance(x, FakeTensor) for x in
                    _pytree.tree_leaves((args, kwargs))):
                # DTensor's own shape propagation runs the op on fake
                # tensors of the global shape: no rank runs it.
                return out
            name = str(func._overloadpacket).split(".")[-1]
            packet = func._overloadpacket
            if packet in self.comm_registry or kind_of(name) != "other":
                self.collectives.append((name, _nbytes(out)))
                self.by_op[self._op] = (self.by_op.get(self._op, 0)
                                        + _nbytes(out))
            self.local_op(func, args, kwargs or {}, out)
            return out

        def local_op(self, func, args, kwargs, out):
            """Called with every op run on local tensors (a hook for
            subclasses)."""

    return _Record()


def collective_bytes(record) -> Dict:
    """Per-kind result bytes and counts of the collectives in ``record``
    (a :func:`CollectiveRecord`, or any iterable of ``(op name, bytes)``),
    with their total: the reference's dict."""
    pairs = getattr(record, "collectives", record)
    out = {k: 0 for k in KINDS}
    count = {k: 0 for k in KINDS}
    for name, nbytes in pairs:
        kind = kind_of(name)
        if kind == "other":
            continue
        out[kind] += int(nbytes)
        count[kind] += 1
    return {"total": sum(out.values()), "counts": count, **out}


# NVIDIA H100 SXM constants (NVIDIA's data sheet; per GPU, dense, at the
# 700 W limit) -- the roofline denominators.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 450e9                 # B/s per direction per GPU (NVLink 4)


def roofline_terms(*, flops: float, bytes_: float, coll_bytes: float,
                   chips: int) -> Dict[str, float]:
    """The three roofline times in seconds of one step, per rank (all three
    inputs are one rank's): compute, memory and collective.

    NVLink joins the 8 GPUs of one node; a 256- or 512-GPU mesh crosses
    nodes over slower links (InfiniBand, ~50 GB/s per GPU each way), so
    the collective term here is a lower bound."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_ / HBM_BW
    t_coll = coll_bytes / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "chips": chips,
    }
