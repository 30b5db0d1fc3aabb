"""Train-step factory: loss -> grads -> AdamW, with activation remat and
microbatch gradient accumulation (the reference's ``train/train_step.py``).

``build_train_step(cfg, tcfg)`` returns

    init_fn(seed, device)               -> (params, opt_state)
    step_fn(params, opt_state, batch)   -> (params, opt_state, metrics)

``step_fn`` is functional, as the reference's: it returns new params and
state and leaves its arguments as they were.  The optimizer sees the
trainable tree (``model.trainable``: no tied head); the returned params
carry a tied head formed anew from the updated embedding, so ``prefill``
and ``decode_step`` serve the trained weights.  Microbatching splits the
batch axis into ``k`` parts and accumulates the loss and the gradients in
f32 before scaling by ``1/k``, as the reference's ``lax.scan`` does.

On DTensor parameters (a mesh of several ranks, ``launch.sharding``) the
same code runs sharded: plain tensors meet DTensors as replicated ones
(``shardctx.mixed``), each gradient is reduce-scattered to its parameter's
placements before the update, and the metrics come back whole.  The
caller installs the activation rules (``shardctx.use_rules``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..models import model as M
from ..models import shardctx
from ..models.config import ModelConfig
from . import pytree
from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: Optional[str] = "dots"          # None | "full" | "dots" | "dots_no_batch"
    microbatches: int = 1
    z_loss: float = 0.0                    # the reference's field; unused there too
    unroll: bool = False                   # the reference's scan analysis mode; the port loops over layers


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig
                     ) -> Tuple[Callable, Callable]:
    """Returns (init_fn, step_fn); see the module docstring."""

    def init_fn(seed: int = 0, device="cuda", place=None):
        params = M.init_model(cfg, seed, device=device, place=place)
        return params, adamw_init(tcfg.optimizer, M.trainable(params))

    def value_and_grad(flat, skel, batch):
        leaves = [t.detach().requires_grad_(True) for t in flat]
        loss = M.loss_fn(cfg, pytree.unflatten(skel, leaves), batch,
                         remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), [_placed_like(g, t) for g, t in
                               zip(grads, flat)]

    def grads_of(flat, skel, batch):
        k = tcfg.microbatches
        if k <= 1:
            return value_and_grad(flat, skel, batch)
        b = batch["tokens"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} "
                             f"microbatches")
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        g_acc = [torch.zeros_like(t, dtype=torch.float32) for t in flat]
        for i in range(k):
            mb = {key: v[i * (b // k):(i + 1) * (b // k)]
                  for key, v in batch.items()}
            loss, g = value_and_grad(flat, skel, mb)
            loss_acc = loss_acc + loss
            for acc, gi in zip(g_acc, g):
                acc.add_(gi.float())
            del g
        inv = 1.0 / k
        return loss_acc * inv, [a * inv for a in g_acc]

    def step_fn(params, opt_state, batch):
        flat, skel = pytree.flatten(M.trainable(params))
        sharded = shardctx.is_dtensor(flat[0])
        with shardctx.mixed(sharded):
            loss, grads = grads_of(flat, skel, batch)
            new, opt_state, metrics = adamw_update(
                tcfg.optimizer, pytree.unflatten(skel, grads), opt_state,
                pytree.unflatten(skel, flat))
            del grads
            if cfg.tie_embeddings:
                M.attach_tied_head(cfg, new)
        metrics = dict(metrics, loss=loss)
        if sharded:
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return new, opt_state, metrics

    return init_fn, step_fn


def _placed_like(g, t):
    """A gradient on its parameter's placements: the sum over the data
    axes that DTensor leaves pending (``Partial``) is reduced and scattered
    to the parameter's shards.  A plain gradient passes through."""
    if shardctx.is_dtensor(g) and g.placements != t.placements:
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _whole(x):
    return x.full_tensor() if shardctx.is_dtensor(x) else x
