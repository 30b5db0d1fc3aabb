"""Activation-sharding constraint context (the reference's
``models/shardctx.py``).

Placement propagates greedily from the weights; without anchors it can
replicate whole activation paths across the model axis (the reference
measured per-partition FLOPs ~10x the ideal share without them).  The fix
-- standard in MaxText/AXLearn -- is explicit anchors at block boundaries.

The model code stays mesh-agnostic: it calls ``constrain(x, kind)`` with a
semantic kind; the launcher installs concrete rules (mesh + partition spec
per kind) via ``use_rules``/``make_rules``.  With no rules installed, or on
a plain (non-DTensor) tensor, the call returns its input object, so
single-device runs and every unsharded path are unaffected.  Under rules a
DTensor is redistributed to the kind's spec, trimmed by :func:`_fits` to
the dims the mesh axes divide.

Kinds:
  resid    (B, S, d)      residual stream      -> (dp, seq?, None)
  heads    (B, S, H, dh)  post-QKV projections -> (dp, seq?, model, None)
  scores   (B, kv, G, S, T) attention scores   -> heads or context parallel
  ffn      (B, S, f)      MLP hidden           -> (dp, seq?, model)
  logits   (B, S, V)      unembedded           -> (dp, None, model)
  experts  (E, C, d)      MoE expert buffers   -> unconstrained

A spec is a :class:`P`: one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of names (several mesh axes on one dim, the first
major).  :func:`to_placements` turns it into DTensor placements.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch

_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding_rules", default=None)


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that the spec names at tensor dim ``d``, ``Replicate()`` on every
    other.  Mesh dims sharing one tensor dim split it in mesh order, which
    must be the spec's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axs = _axes(entry)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axs} at dim {d} are not in "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def make_rules(mesh, *, batch_shardable: bool = True,
               seq_axis: Optional[str] = None,
               n_heads: Optional[int] = None) -> Dict:
    """Concrete spec table.  batch_shardable=False (long_500k, batch=1)
    shards the sequence axis over the data axes instead.  ``n_heads``
    decides the attention-score strategy: heads-sharded (divisible by the
    model axis) or context-parallel (query-seq over model)."""
    from ..launch.mesh import axis_sizes, dp_axes

    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    if batch_shardable:
        b, s = dp, seq_axis
    else:
        b, s = None, dp
    model_size = axis_sizes(mesh)["model"]
    heads_shardable = n_heads is not None and n_heads % model_size == 0
    return {
        "mesh": mesh,
        "specs": {
            "resid": P(b, s, None),
            "heads": P(b, s, "model", None),
            # Attention scores (B, kv, G, S, T): when the head dims don't
            # divide the model axis (qwen2: 12 heads vs 16) the "heads"
            # anchor is dropped and the whole O(S^2) attention path would
            # replicate across model; shard the QUERY sequence dim instead
            # (context-parallel attention -- softmax reduces over T, which
            # stays local).  Heads-shardable archs keep propagation from the
            # "heads" anchor (no conflicting reshard).
            "scores": (None if heads_shardable
                       else P(b, None, None, "model", None)),
            "ffn": P(b, s, "model"),
            "logits": P(b, s, "model"),
            # NOTE "experts" deliberately unconstrained: the reference
            # measured that anchoring the (E, C, d) buffers to P(model, ...)
            # lowers the token->expert scatter by replication and doubles
            # all-reduce traffic (jamba train_4k: 67.6 -> 142.2 GB).  Left
            # to propagation the scatter stays token-sharded and the
            # expert weights gather per layer -- cheaper at these shapes.
            "experts": None,
        },
    }


@contextlib.contextmanager
def use_rules(rules: Optional[Dict]):
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def is_dtensor(x) -> bool:
    """True for a DTensor: the sharded path."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mixed(sharded: bool = True):
    """A region in which plain tensors meet DTensors as replicated ones
    (RoPE tables, masks, positions): DTensor's ``implicit_replication`` on
    the sharded path, nothing otherwise.  Not to be nested: leaving the
    inner region ends the outer one too (one-element tensors, such as
    scalars, need no region)."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _gather_unsplittable(x, heads: int):
    """``x`` with its last dim's shards gathered when their count does not
    divide ``heads`` (nothing to do for a plain tensor)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    sizes = x.device_mesh.shape
    n = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == last:
            n *= sizes[i]
    if heads % n == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
        for pl in x.placements])


def split_heads(x, heads: int, head_dim: int):
    """``x`` (..., heads * head_dim) reshaped to (..., heads, head_dim).  A
    DTensor whose last dim is sharded over more ranks than ``heads``
    divides is first gathered on those mesh dims (DTensor cannot split a
    dim whose shards straddle the new leading dim; the reference's
    "heads" anchor drops the model axis in that case too)."""
    x = _gather_unsplittable(x, heads)
    return x.reshape(tuple(x.shape[:-1]) + (heads, head_dim))


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads, ctx.head_dim = x.shape[-2], x.shape[-1]
        return x.reshape(tuple(x.shape[:-2]) + (-1,))

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads, ctx.head_dim)


def merge_heads(x):
    """``x`` (..., heads, head_dim) reshaped to (..., heads * head_dim).  On
    a DTensor the gradient is split back by :func:`split_heads`, so a
    gradient whose last dim arrives sharded over more ranks than ``heads``
    divides is gathered first (DTensor refuses that reshape)."""
    if not is_dtensor(x):
        return x.reshape(tuple(x.shape[:-2]) + (-1,))
    return _MergeHeads.apply(x)


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_placed(x):
    """``x`` itself, whose gradient is redistributed to ``x``'s placements
    as it leaves this use.  A leaf used twice (the tied embedding: lookup
    and head) then sums two gradients of one placement, where DTensor
    would otherwise have to turn one placement into the other's pending
    sum (which some versions cannot do).  A plain tensor passes through."""
    return _GradPlaced.apply(x) if is_dtensor(x) else x


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.placements = table.device_mesh, table.placements
        ctx.shape, ctx.tok_placements = table.shape, tokens.placements
        ctx.save_for_backward(tokens.to_local())
        out = table.full_tensor()[tokens.to_local()]
        return DTensor.from_local(out, tokens.device_mesh, tokens.placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        (tok,) = ctx.saved_tensors
        g = g.redistribute(ctx.mesh, ctx.tok_placements).to_local()
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad.index_put_((tok,), g, accumulate=True)
        pending = [Partial() if pl.is_shard() else Replicate()
                   for pl in ctx.tok_placements]
        grad = DTensor.from_local(grad, ctx.mesh, pending, run_check=False)
        return grad.redistribute(ctx.mesh, ctx.placements), None


def embed_lookup(table, tokens):
    """``table[tokens]``.  On DTensors: the table gathered whole, each rank
    looking up its own tokens (the output placed as the tokens are), and
    in the backward each rank's rows summed over the ranks that hold
    tokens and scattered to the table's placements -- the lookup's sharding
    strategy done by hand, the same gather on every version."""
    if not is_dtensor(table):
        return table[tokens]
    return _Lookup.apply(table, tokens)


def replicated(fn):
    """``fn`` run on whole tensors when a DTensor is among its arguments
    (the sharded path): every DTensor argument is redistributed to
    ``Replicate()`` and unwrapped, ``fn`` runs on the local (full) tensors,
    and its tensor outputs come back as replicated DTensors.  The
    counterpart of letting a compiler replicate an operation it cannot
    partition, for the ops that have no DTensor sharding strategy (each is
    listed in PERF.md); without a DTensor argument ``fn`` is called as it
    is."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from torch.utils import _pytree
        dts = [x for x in _pytree.tree_leaves((args, kwargs))
               if is_dtensor(x)]
        if not dts:
            return fn(*args, **kwargs)
        from torch.distributed.tensor import DTensor, Replicate
        mesh = dts[0].device_mesh
        rep = [Replicate()] * len(mesh.mesh_dim_names)

        def down(x):
            return (x.redistribute(mesh, rep).to_local() if is_dtensor(x)
                    else x)

        def up(x):
            import torch
            return (DTensor.from_local(x, mesh, rep, run_check=False)
                    if isinstance(x, torch.Tensor) else x)

        a, k = _pytree.tree_map(down, (args, kwargs))
        return _pytree.tree_map(up, fn(*a, **k))
    return wrapper


def _fits(spec: P, shape, mesh) -> P:
    """``spec`` with each axis assignment dropped where the mesh axes'
    product does not divide the dim or exceeds it."""
    from ..launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    out = []
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, padded):
        if ax is None:
            out.append(None)
            continue
        tot = 1
        for a in _axes(ax):
            tot *= sizes[a]
        out.append(ax if dim % tot == 0 and dim >= tot else None)
    return P(*out)


def constrain(x, kind: str):
    """``x`` redistributed to the installed rules' spec for ``kind``; ``x``
    itself with no rules, no spec for the kind, or a plain tensor."""
    rules = _RULES.get()
    if rules is None:
        return x
    spec = rules["specs"].get(kind)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = rules["mesh"]
    spec = _fits(spec, x.shape, mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))
