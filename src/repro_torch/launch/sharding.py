"""Sharding rules: parameter/optimizer/batch/cache partition specs (the
reference's ``launch/sharding.py``), and :func:`place`, which puts a tree
on a mesh by them.

Strategy: FSDP x TP --
  * every weight is sharded on BOTH the data axis (outer/reduction dim,
    ZeRO-3 style) and the model axis (TP dim: heads / ffn / experts / vocab);
  * optimizer moments mirror their parameter's spec;
  * activations: batch over (pod, data), TP dims over model (the
    ``models.shardctx`` anchors place the rest);
  * MoE expert stacks shard the expert axis over model (expert parallelism);
  * KV caches shard batch over data-parallel axes and sequence over model
    (flash-decoding style partial attention); long_500k (batch=1) shards
    sequence over ALL axes.

Rules are name-pattern based over the flattened parameter tree.  The port
keeps one dict per layer (``layers/<i>/...``) where the reference stacks
each pattern position over repeats (``blocks/<j>/...`` with a leading
``n_repeats`` axis, which its specs pad with ``None``): a port leaf's spec
is the reference's without that leading ``None``.  Every function returns
a tree of :class:`~repro_torch.models.shardctx.P` shaped like its input,
in ``train.pytree`` order; ``place`` turns a tree and its specs into
DTensors, the counterpart of ``jit(in_shardings=...)``.  On a one-rank
mesh every spec is trivial and ``place`` returns the tree as it is.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from ..models.attention import KVCache
from ..models.shardctx import P, to_placements
from ..models.ssm import MambaState, RWKVState
from ..train import pytree
from .mesh import axis_sizes, dp_axes

PyTree = Any

# (regex over path, spec WITHOUT the stacked-repeat axis).  First match wins.
# "D" is replaced by the data axis name, "M" by the model axis name.
_RULES: Tuple[Tuple[str, Optional[Tuple[Optional[str], ...]]], ...] = (
    # --- embeddings (the tied head is the embedding, scaled) ---
    (r"embed$|tied_head$", ("M", "D")),
    (r"unembed$", ("D", "M")),
    # --- attention ---
    (r"(wq|wk|wv)$", ("D", "M")),
    (r"mixer/wo$|xattn/wo$", ("M", "D")),
    (r"(bq|bk|bv)$", ("M",)),
    (r"(q_norm|k_norm)$", (None,)),
    # --- MoE (leading E axis -> expert parallelism over model) ---
    (r"router$", ("D", None)),
    (r"we_(gate|up)$", ("M", "D", None)),
    (r"we_down$", ("M", None, "D")),
    (r"shared/(wi_gate|wi_up)$", ("D", "M")),
    (r"shared/wo$", ("M", "D")),
    # --- dense MLP ---
    (r"(wi_gate|wi_up)$", ("D", "M")),
    (r"ff/wo$", ("M", "D")),
    # --- Mamba ---
    (r"in_proj$", ("D", "M")),
    (r"out_proj$", ("M", "D")),
    (r"conv_w$", (None, "M")),
    (r"bc_proj$", ("M", None)),
    (r"dt_proj$", ("M", None)),
    (r"(dt_bias|A_log|D)$", (None,)),
    # --- RWKV ---
    (r"tmix/(wr|wk|wv|wg)$", ("D", "M")),
    (r"tmix/wo$", ("M", "D")),
    (r"wA$", ("D", None)),
    (r"wB$", (None, "D")),
    (r"(mu|w0|u|ln_out)$", None),          # small: replicate
    (r"cmix/wk$", ("D", "M")),
    (r"cmix/wv$", ("M", "D")),
    # --- norms, gates, scalars ---
    (r"(ln1|ln2|ln_x|xgate|final_norm|enc_norm)$", None),
)


def paths(tree) -> list:
    """``[(path, leaf)]`` in ``pytree`` order; a path joins the dict keys
    and list indices from the root with ``/`` (the reference's
    ``_path_str``)."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            out.append(("/".join(prefix), node))
    walk(tree, ())
    return out


def _spec_for(path_s: str, ndim: int, mesh) -> P:
    conv = {"D": "data", "M": "model", None: None}
    for pat, axes in _RULES:
        if re.search(pat, path_s):
            if axes is None:
                return P()
            axes = [conv[a] for a in axes]
            while len(axes) < ndim:
                axes = [None] + axes
            if len(axes) != ndim:
                axes = axes[-ndim:] if ndim else []
            return P(*axes)
    return P()                                # default: replicate


def _shardable(spec: P, shape, mesh) -> P:
    """Drop axis assignments that do not divide the dimension."""
    sizes = axis_sizes(mesh)
    out = []
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, padded):
        if ax is None:
            out.append(None)
            continue
        tot = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            tot *= sizes[a]
        out.append(ax if dim % tot == 0 else None)
    return P(*out)


def _tree_of(tree, fn):
    """The tree of ``fn(path, leaf)`` over ``tree``'s leaves."""
    _, skel = pytree.flatten(tree)
    return pytree.unflatten(skel, [fn(p, x) for p, x in paths(tree)])


def param_shardings(params: PyTree, mesh, prefix: str = "") -> PyTree:
    """Spec tree for a params (or grads/moments) tree; ``prefix`` is the
    path of ``params`` in its whole tree (a subtree's leaves are matched by
    their full path)."""
    return _tree_of(params, lambda path, x: _shardable(
        _spec_for("/".join(p for p in (prefix, path) if p), x.ndim, mesh),
        tuple(x.shape), mesh))


def placer(mesh):
    """``init_model``'s ``place`` hook: each part placed by
    :func:`param_shardings` as it is drawn."""
    return lambda prefix, sub: place(sub, param_shardings(sub, mesh, prefix),
                                     mesh)


def opt_shardings(opt_state: PyTree, params_sh: PyTree, mesh) -> PyTree:
    """Moments mirror their parameter; step scalar replicated."""
    out = {"step": P()}
    for key in ("mu", "nu", "master"):
        if key in opt_state:
            out[key] = params_sh
    return out


def _dp(mesh):
    """(dp entry of a spec, product of the dp axes' sizes)."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]
    return (dp if len(dp) > 1 else dp[0]), total


def batch_shardings(batch_like: PyTree, mesh, *, shard_batch: bool = True
                    ) -> PyTree:
    """tokens/labels (B, S): batch over DP axes; stub embeds likewise."""
    dp, dp_total = _dp(mesh)

    def leaf(_, x):
        nd = x.ndim
        if not shard_batch or x.shape[0] % dp_total:
            # batch=1 (long_500k): shard the sequence axis over data instead.
            if nd >= 2 and x.shape[1] % dp_total == 0:
                return P(None, dp)
            return P()
        return P(dp, *([None] * (nd - 1)))

    return _tree_of(batch_like, leaf)


def cache_shardings(caches: PyTree, mesh, *, batch: int) -> PyTree:
    """Decode caches (or prefill's raw caches), keyed on the cache type: the
    K/V of a ``KVCache``, of an ``xkv`` pair or of a raw prefill pair (B,
    S, Hkv, dh), and the 4-D recurrent states
    (``MambaState.ssm``, ``RWKVState.wkv``, which the reference's
    rank-keyed rule treats alike) -> B over DP, dim 1 over model; batch=1
    -> dim 1 over all axes.  The 3-D tails (Mamba conv, RWKV shifts) ->
    B over DP, dim 1 over model when it divides (batch=1: model only).
    Lengths (B,) -> B over DP."""
    dp, dp_total = _dp(mesh)
    all_axes = tuple(mesh.mesh_dim_names)
    by_batch = batch % dp_total == 0

    def kv(x):
        spec = (P(dp, "model", None, None) if by_batch
                else P(None, all_axes, None, None))
        return _shardable(spec, tuple(x.shape), mesh)

    def tail(x):
        spec = P(dp, "model", None) if by_batch else P(None, "model", None)
        return _shardable(spec, tuple(x.shape), mesh)

    def length(x):
        return _shardable(P(dp) if by_batch else P(), tuple(x.shape), mesh)

    def node(c):
        if isinstance(c, KVCache):
            return KVCache(kv(c.k), kv(c.v), length(c.length))
        if isinstance(c, MambaState):
            return MambaState(kv(c.ssm), tail(c.conv))
        if isinstance(c, RWKVState):
            return RWKVState(kv(c.wkv), tail(c.shift))
        if isinstance(c, dict):
            return {k: tail(v) if k == "cmix" else node(v)
                    for k, v in c.items()}
        if isinstance(c, tuple):            # an xkv or a raw prefill (k, v)
            return tuple(kv(t) for t in c)
        if isinstance(c, list):
            return [node(v) for v in c]
        raise TypeError(f"not a decode cache entry: {type(c).__name__}")

    return node(caches)


def logits_sharding(mesh, *, shard_batch: bool = True) -> P:
    dp, _ = _dp(mesh)
    return P(dp if shard_batch else None, None, "model")


def place(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` with its spec
    (``distribute_tensor``: every rank passes the same full leaf and keeps
    its shard).  On a one-rank mesh the tree is returned as it is: every
    placement there is trivial."""
    if ranks(mesh) == 1:
        return tree
    from torch.distributed.tensor import distribute_tensor

    flat, skel = pytree.flatten(tree)
    flat_s = spec_list(specs)
    if len(flat_s) != len(flat):
        raise ValueError(f"{len(flat)} leaves against {len(flat_s)} specs")
    # src_data_rank=None: each rank cuts its shard from its own copy, no
    # scatter or broadcast (every rank drew the same seeded leaf).
    return pytree.unflatten(skel, [
        distribute_tensor(x, mesh, to_placements(s, mesh),
                          src_data_rank=None)
        for x, s in zip(flat, flat_s)])


def ranks(mesh) -> int:
    """The number of ranks of a mesh."""
    n = 1
    for s in mesh.shape:
        n *= s
    return n


class _Spec:
    """A spec as one ``pytree`` leaf (``P`` is a tuple, which ``pytree``
    would walk)."""

    def __init__(self, spec):
        self.spec = spec


def _spec_leaves(specs):
    if isinstance(specs, P):
        return _Spec(specs)
    if specs is None or isinstance(specs, str):
        raise TypeError(f"not a spec tree: {specs!r}")
    if isinstance(specs, dict):
        return {k: _spec_leaves(v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        parts = [_spec_leaves(v) for v in specs]
        return (type(specs)(*parts) if hasattr(specs, "_fields")
                else type(specs)(parts))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def spec_list(specs) -> list:
    """The specs of a spec tree in ``pytree`` order."""
    return [s.spec for s in pytree.leaves(_spec_leaves(specs))]


def full(tree: PyTree) -> PyTree:
    """Each DTensor leaf gathered to its full tensor (a collective on every
    rank); plain tensors pass through."""
    from torch.distributed.tensor import DTensor
    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
