"""The port's loss and gradients against ``jax.value_and_grad`` of the
reference's ``loss_fn``, for every arch of the registry at
``reduced_for_smoke`` size (f32): the mirror of
``tests/test_archs.py::test_reduced_smoke_train_step``, held to the
reference's numbers and not only to finiteness.

Each arch runs twice, on the reference's own initial weights
(``init_model``, whose zero cross gate leaves the cross-attention branch
without gradient) and on ``lm_tree_from_seed``'s (biases, gains and the
cross gate drawn too), both carried by ``lm_params_from_numpy``; the
reference's gradient tree is mapped to the port's layout the same way.
Batches are random tokens and labels (and frames / image embeddings) from
a numpy seed.

Tolerance: the loss at rtol 1e-5; each gradient leaf within 2e-4 of that
leaf's largest reference magnitude (f32 sums in other orders: measured
up to 5e-5 for Jamba's eight layers, ~2e-6 elsewhere).  A leaf the forward
does not reach (an ``xonly`` layer's ``ln1``) has zero gradient in both.
The port's gradients under ``remat="dots"`` equal those without remat bit
for bit.

The tied head: the embedding's gradient carries the head's contribution
(rows of tokens absent from the batch get one), ``tied_head`` is no
trainable leaf, and after a step it equals the new embedding times
``d_model**-0.5``, so ``prefill`` serves the trained weights.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainConfig, build_train_step

GRAD_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro.models.config import reduced_for_smoke as jreduced
    return dict(jax=jax, jnp=jnp, M=JM, get_config=jget_config,
                reduced=jreduced)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S + 1))
    b = {"tokens": t[:, :-1].astype(np.int32),
         "labels": t[:, 1:].astype(np.int32)}
    shape = (B, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.is_encdec:
        b["frames"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if cfg.family == "vision":
        b["image_embeds"] = (rng.standard_normal(shape) * 0.1).astype(
            np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def value_and_grad(cfg, params, batch, remat=None):
    """The port's loss and its gradient leaves (``pytree`` order of the
    trainable tree; an unreached leaf gets zeros)."""
    flat, skel = pytree.flatten(M.trainable(params))
    leaves = [t.detach().requires_grad_(True) for t in flat]
    logits, aux = M.train_logits(cfg, pytree.unflatten(skel, leaves), batch,
                                 remat=remat)
    B, S = batch["tokens"].shape
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    loss = M.loss_fn(cfg, pytree.unflatten(skel, leaves), batch,
                     remat=remat)
    assert loss.requires_grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), [g.numpy() for g in grads]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_grads_match_reference(jx, arch):
    jax, jnp = jx["jax"], jx["jnp"]
    cfg = reduced_for_smoke(get_config(arch))
    jcfg = jx["reduced"](jx["get_config"](arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    b = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, b)
    vg = jax.jit(jax.value_and_grad(lambda p: jx["M"].loss_fn(jcfg, p, jb)))
    ref_tree = jax.tree.map(
        np.asarray, jx["M"].init_model(jcfg, jax.random.PRNGKey(0)))
    for tree in (ref_tree, lm_tree_from_seed(cfg, 0)):
        jloss, jgrads = vg(jax.tree.map(jnp.asarray, tree))
        params = lm_params_from_numpy(cfg, tree, device="cpu")
        loss, grads = value_and_grad(cfg, params, _tb(b))
        assert np.isfinite(float(loss)), arch
        assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = pytree.leaves(M.trainable(lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, jgrads), device="cpu")))
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            w = w.numpy()
            assert g.shape == w.shape
            assert np.all(np.isfinite(g)), arch
            scale = float(np.abs(w).max())
            assert np.abs(g - w).max() <= GRAD_TOL * scale, arch
    _, dots = value_and_grad(cfg, params, _tb(b), remat="dots")
    for g, d in zip(grads, dots):
        assert g.tobytes() == d.tobytes(), arch


def test_train_logits_records_a_graph_only_for_trainable_leaves():
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 0),
                                  device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    logits, _ = M.train_logits(cfg, params, {"tokens": tokens})
    assert logits.grad_fn is None            # served weights: no graph
    params["embed"].requires_grad_(True)
    logits, _ = M.train_logits(cfg, params, {"tokens": tokens})
    assert logits.grad_fn is not None


def test_tied_head_gradient_and_reattach():
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    assert cfg.tie_embeddings
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 0),
                                  device="cpu")
    b = _batch(cfg, S=16)
    _, grads = value_and_grad(cfg, params, _tb(b))
    names = sorted(M.trainable(params))
    assert "tied_head" in params and "tied_head" not in names
    g_embed = grads[names.index("embed")]
    absent = np.setdiff1d(np.arange(cfg.vocab_size), b["tokens"])
    assert absent.size > 0
    # Rows no token looks up get their gradient from the head alone.
    assert np.all(np.abs(g_embed[absent]).max(axis=1) > 0)

    ocfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1)
    _, step = build_train_step(cfg, TrainConfig(optimizer=ocfg, remat=None))
    opt = adamw_init(ocfg, M.trainable(params))
    assert "tied_head" not in opt["mu"]
    new, opt, _ = step(params, opt, _tb(b))
    assert not torch.equal(new["embed"], params["embed"])
    scale = torch.tensor(cfg.d_model ** -0.5, dtype=new["embed"].dtype)
    assert torch.equal(new["tied_head"], new["embed"] * scale)
    assert not new["tied_head"].requires_grad
    # prefill serves the trained weights (f32 products over 1 and S rows:
    # rounding apart); a stale head would be far off.
    tokens = torch.from_numpy(b["tokens"])
    last, _, _ = M.prefill(cfg, new, {"tokens": tokens})
    full, _ = M.train_logits(cfg, new, {"tokens": tokens})
    assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=1e-5,
                    atol=1e-5)
    stale = dict(new, tied_head=params["tied_head"])
    old, _, _ = M.prefill(cfg, stale, {"tokens": tokens})
    assert float((old - last).abs().max()) > 1e-2
