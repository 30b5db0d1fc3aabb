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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..models import model as M
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

    def init_fn(seed: int = 0, device="cuda"):
        params = M.init_model(cfg, seed, device=device)
        return params, adamw_init(tcfg.optimizer, M.trainable(params))

    def value_and_grad(flat, skel, batch):
        leaves = [t.detach().requires_grad_(True) for t in flat]
        loss = M.loss_fn(cfg, pytree.unflatten(skel, leaves), batch,
                         remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

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
        loss, grads = grads_of(flat, skel, batch)
        new, opt_state, metrics = adamw_update(
            tcfg.optimizer, pytree.unflatten(skel, grads), opt_state,
            pytree.unflatten(skel, flat))
        del grads
        if cfg.tie_embeddings:
            M.attach_tied_head(cfg, new)
        return new, opt_state, dict(metrics, loss=loss)

    return init_fn, step_fn
