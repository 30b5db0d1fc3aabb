"""The port's training substrate (``repro_torch.train``) against the JAX
reference: mirrors of the 14 tests of ``tests/test_train.py`` on the port,
then the two packages on the same numpy inputs.

* ``lr_schedule`` at steps 0-120: rtol 1e-6 (XLA's and torch's f32 ``cos``
  may differ in the last bit);
* ``clip_by_global_norm`` and one ``adamw_update`` from the same params,
  grads and state (f32 moments, bf16 moments, bf16 params with f32
  masters): f32 leaves at rtol 1e-5 / atol 1e-7 (the global norm sums the
  same squares in the same order, but the two libraries' f32 reductions
  inside a leaf add in different orders), bf16 leaves within one bf16 ulp
  (an f32 difference in the last bit can round either way);
* one ``build_train_step`` step of the reference's ``tiny_cfg`` from the
  reference's own weights and optimizer state (carried by
  ``lm_params_from_numpy`` / ``adamw_state_from_numpy``): loss rtol 1e-5,
  params and moments rtol 2e-4 / atol 2e-5 (the reference's microbatch
  tolerance: f32 gradients summed in other orders);
* checkpoints: a bf16 leaf bit for bit through save and restore, and a
  plain tree the reference's ``ckpt.save`` wrote (f32, int32, bf16) read
  back bit for bit;
* compression: ``quantize_int8`` / ``ef_quantize`` bit-equal to the
  reference (both round half to even), and ``compressed_psum`` over four
  gloo ranks bit-equal to a numpy transcription of the reference's
  ``compressed_psum`` (``src/repro/train/compression.py:47-64``).

The remat test also counts the matmuls the backward pass runs: ``"dots"``
recomputes none of the forward's (the same count as no remat), ``"full"``
recomputes every one the backward needs, ``"dots_no_batch"`` the batched
ones (the attention einsums).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import pytree
from repro_torch.train.elastic import StepWatchdog, degrade_ladder, plan_mesh
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         lr_schedule)
from repro_torch.train.train_step import TrainConfig, build_train_step

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7


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
    from repro.models.config import ModelConfig as JModelConfig
    from repro.train import checkpoint as jckpt
    from repro.train import compression as jcomp
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    return dict(jax=jax, jnp=jnp, opt=jopt, ts=jts, ckpt=jckpt, comp=jcomp,
                ModelConfig=JModelConfig)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_train.py
# ---------------------------------------------------------------------------

def test_lr_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, torch.tensor(s))) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(1e-3)
    assert lrs[-1] == pytest.approx(1e-4, rel=0.05)
    assert all(a >= b for a, b in zip(lrs[1:], lrs[2:]))  # monotone decay


def test_clip_by_global_norm():
    g = {"a": torch.ones((4,)) * 3.0, "b": torch.ones((3,)) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(9 * 4 + 16 * 3))
    total = np.sqrt(sum(float(torch.sum(x ** 2))
                        for x in pytree.leaves(clipped)))
    assert total == pytest.approx(1.0, rel=1e-5)


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=1, total_steps=200,
                      weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(cfg, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, grads, state, params)
    assert float(torch.max(torch.abs(params["w"]))) < 0.1


def test_adamw_bf16_moments():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = adamw_init(cfg, params)
    assert state["mu"]["w"].dtype == torch.bfloat16
    params2, state2, _ = adamw_update(
        cfg, {"w": torch.ones((8,), dtype=torch.bfloat16)}, state, params)
    assert params2["w"].dtype == torch.bfloat16
    assert int(state2["step"]) == 1
    assert state2["step"].dtype == torch.int32


def tiny_cfg():
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
                       dtype="float32").validate()


def _batch(B=4, S=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S + 1))
    return {"tokens": t[:, :-1].astype(np.int32),
            "labels": t[:, 1:].astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_microbatch_matches_full_batch():
    """Accumulated microbatch gradients == single big-batch gradients."""
    cfg = tiny_cfg()
    init_f, step_f = build_train_step(cfg, TrainConfig(microbatches=1,
                                                       remat=None))
    _, step_m = build_train_step(cfg, TrainConfig(microbatches=4,
                                                  remat=None))
    params, opt = init_f(0, "cpu")
    batch = _tb(_batch(B=8))
    p1, _, m1 = step_f(params, opt, batch)
    p2, _, m2 = step_m(params, opt, batch)
    assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(pytree.leaves(p1), pytree.leaves(p2)):
        assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)


def test_remat_matches_no_remat():
    cfg = tiny_cfg()
    init_f, step_p = build_train_step(cfg, TrainConfig(remat=None))
    params, opt = init_f(0, "cpu")
    batch = _tb(_batch())
    p1, _, m1 = step_p(params, opt, batch)
    for remat in ("full", "dots", "dots_no_batch"):
        _, step_r = build_train_step(cfg, TrainConfig(remat=remat))
        p2, _, m2 = step_r(params, opt, batch)
        assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
        for a, b in zip(pytree.leaves(p1), pytree.leaves(p2)):
            assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, tree)
    for a, b in zip(pytree.leaves(tree), pytree.leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_crc_detects_corruption(tmp_path):
    tree = {"a": torch.ones((16,))}
    path = ckpt.save(str(tmp_path), 1, tree)
    fn = os.path.join(path, "arr_00000.npy")
    raw = bytearray(open(fn, "rb").read())
    raw[-1] ^= 0xFF
    open(fn, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(str(tmp_path), 1, tree)


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"a": torch.ones((2,))}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    steps = sorted(os.listdir(str(tmp_path)))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_checkpointer(tmp_path):
    tree = {"a": torch.arange(8.0)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(3, tree)
    tree["a"].add_(1.0)           # the snapshot was taken at save()
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), 3, tree)
    assert torch.equal(out["a"], torch.arange(8.0))


def test_async_checkpointer_reraises_writer_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ac = ckpt.AsyncCheckpointer(str(blocker))
    ac.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                     # the error is raised once


def test_quantize_roundtrip_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = comp.quantize_int8(x)
    assert q.dtype == torch.int8
    err = np.abs(comp.dequantize_int8(q, s).numpy() - x.numpy())
    assert err.max() <= float(s) * 0.5 + 1e-7


def test_error_feedback_corrects_bias():
    """Sum over steps of EF-compressed values converges to sum of inputs."""
    rng = np.random.default_rng(1)
    resid = torch.zeros((256,))
    total_sent = np.zeros((256,))
    total_true = np.zeros((256,))
    for _ in range(50):
        x = torch.from_numpy(rng.standard_normal(256).astype(np.float32)
                             * 0.01)
        q, s, resid = comp.ef_quantize(x, resid)
        total_sent += comp.dequantize_int8(q, s).numpy()
        total_true += x.numpy()
    # Residual bounds the cumulative discrepancy (unbiased over time).
    assert np.abs(total_sent - total_true).max() <= \
        np.abs(resid.numpy()).max() + 1e-6


def test_plan_mesh_and_ladder():
    p = plan_mesh(512, model_parallel=16, pods=2)
    assert p.shape == (2, 16, 16) and p.axes == ("pod", "data", "model")
    p = plan_mesh(256, model_parallel=16)
    assert p.shape == (16, 16)
    p = plan_mesh(24, model_parallel=16)   # 24 % 16 != 0 -> fall back
    assert p.n_devices == 24
    ladder = degrade_ladder(512, model_parallel=16, pods=2)
    assert ladder[0].n_devices == 512
    assert ladder[-1].n_devices >= 16


def test_watchdog_flags_straggler():
    dog = StepWatchdog(factor=5.0)
    for _ in range(3):
        dog.start(); time.sleep(0.01); assert not dog.stop()
    dog.start(); time.sleep(0.2)
    assert dog.stop()
    assert dog.last >= 0.2 and dog.slow_steps == 1


# ---------------------------------------------------------------------------
# Remat: what "dots" saves
# ---------------------------------------------------------------------------

class _CountMatmuls(TorchDispatchMode):
    OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(cfg, params, batch, remat):
    flat, skel = pytree.flatten(M.trainable(params))
    leaves = [t.detach().requires_grad_(True) for t in flat]
    loss = M.loss_fn(cfg, pytree.unflatten(skel, leaves), batch, remat=remat)
    with _CountMatmuls() as c:
        torch.autograd.grad(loss, leaves)
    return c.n


def test_remat_dots_saves_the_matmuls():
    cfg = tiny_cfg()
    params = M.init_model(cfg, 0, device="cpu")
    batch = _tb(_batch())
    plain = _backward_matmuls(cfg, params, batch, None)
    assert _backward_matmuls(cfg, params, batch, "dots") == plain
    # Per layer the forward runs 7 projections (mm) and the two attention
    # einsums (bmm).  "full" recomputes 8 of them: the recomputation stops
    # once the backward's saved tensors are rebuilt, and the MLP's output
    # product feeds only the residual addition.  "dots_no_batch"
    # recomputes the two bmms.
    assert _backward_matmuls(cfg, params, batch, "full") == plain + 8 * 2
    assert _backward_matmuls(cfg, params, batch,
                             "dots_no_batch") == plain + 2 * 2
    with pytest.raises(ValueError, match="remat"):
        M.loss_fn(cfg, {k: v.requires_grad_(True) if k == "embed" else v
                        for k, v in M.trainable(params).items()},
                  batch, remat="dots_saveable")


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference(jx):
    cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jx["opt"].AdamWConfig(lr_peak=3e-4, warmup_steps=10,
                                 total_steps=100)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jx["opt"].lr_schedule(jcfg, jx["jnp"].asarray(steps)))
    got = lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_tree(rng):
    """A params-like tree: nested dicts and a list, mixed shapes."""
    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": arr(6, 4), "final_norm": arr(4),
            "layers": [{"ln1": arr(4), "mixer": {"wq": arr(4, 4),
                                                 "wo": arr(4, 4)}}
                       for _ in range(2)]}


def _as_jax(jx, tree, dtype):
    return jx["jax"].tree.map(lambda a: jx["jnp"].asarray(a, dtype), tree)


def _as_torch(tree, dtype):
    return pytree.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _close(got, want, dtype):
    got, want = _np(got), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)
    else:
        assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("moments,params_dtype,master", [
    ("float32", "float32", False), ("bfloat16", "float32", False),
    ("float32", "bfloat16", True)])
def test_clip_and_adamw_update_match_reference(jx, moments, params_dtype,
                                               master):
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    p_np = _opt_tree(rng)
    g_np = pytree.tree_map(lambda a: a * 2.0, _opt_tree(rng))
    mu_np = pytree.tree_map(lambda a: a * 0.1, _opt_tree(rng))
    nu_np = pytree.tree_map(lambda a: a * a * 0.01,
                            _opt_tree(rng))
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=20,
              moment_dtype=moments, master_fp32=master)
    cfg, jcfg = AdamWConfig(**kw), jx["opt"].AdamWConfig(**kw)
    tdt = dict(float32=torch.float32, bfloat16=torch.bfloat16)
    jdt = dict(float32=jnp.float32, bfloat16=jnp.bfloat16)

    jclip, jn = jx["opt"].clip_by_global_norm(
        _as_jax(jx, g_np, jnp.float32), 1.0)
    tclip, tn = clip_by_global_norm(_as_torch(g_np, torch.float32), 1.0)
    assert float(jn) > 1.0                     # the clip is active
    assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(pytree.leaves(tclip), jx["jax"].tree.leaves(jclip)):
        _close(a, b, "float32")

    jstate = {"step": jnp.asarray(3, jnp.int32),
              "mu": _as_jax(jx, mu_np, jdt[moments]),
              "nu": _as_jax(jx, nu_np, jdt[moments])}
    state = {"step": torch.tensor(3, dtype=torch.int32),
             "mu": _as_torch(mu_np, tdt[moments]),
             "nu": _as_torch(nu_np, tdt[moments])}
    if master:
        jstate["master"] = _as_jax(jx, p_np, jnp.float32)
        state["master"] = _as_torch(p_np, torch.float32)
    jp, js, jm = jx["opt"].adamw_update(
        jcfg, _as_jax(jx, g_np, jdt[params_dtype]), jstate,
        _as_jax(jx, p_np, jdt[params_dtype]))
    tp, ts, tm = adamw_update(cfg, _as_torch(g_np, tdt[params_dtype]), state,
                              _as_torch(p_np, tdt[params_dtype]))
    assert int(ts["step"]) == int(js["step"]) == 4
    assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                    rtol=1e-5)
    assert sorted(ts) == sorted(js)
    for a, b in zip(pytree.leaves(tp), jx["jax"].tree.leaves(jp)):
        assert a.dtype == tdt[params_dtype]
        _close(a, b, params_dtype)
    for key in ("mu", "nu"):
        for a, b in zip(pytree.leaves(ts[key]),
                        jx["jax"].tree.leaves(js[key])):
            assert a.dtype == tdt[moments]
            _close(a, b, moments)
    if master:
        for a, b in zip(pytree.leaves(ts["master"]),
                        jx["jax"].tree.leaves(js["master"])):
            _close(a, b, "float32")


def _jtiny(jx):
    return jx["ModelConfig"](name="t", family="dense", n_layers=2,
                             d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                             vocab_size=64, dtype="float32").validate()


@pytest.mark.parametrize("tie", [False, True])
def test_train_step_matches_reference(jx, tie):
    """One step of both packages from the reference's own init and AdamW
    state, the port's params and moments mapped to its layout, then the
    next step's loss.  At lr 1e-3 Adam's first update is about lr *
    sign(g): the f32 gradients agree to ~1e-6 of their leaf's scale, far
    from flipping a sign.  (At a larger lr over several steps a gradient
    within its noise of zero can flip an element's update.)"""
    import dataclasses
    jax = jx["jax"]
    jcfg = dataclasses.replace(_jtiny(jx), tie_embeddings=tie)
    cfg = dataclasses.replace(tiny_cfg(), tie_embeddings=tie)
    opt = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    jinit, jstep = jx["ts"].build_train_step(
        jcfg, jx["ts"].TrainConfig(
            optimizer=jx["opt"].AdamWConfig(**opt), remat=None))
    _, step = build_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(**opt), remat="dots"))
    jparams, jopt = jinit(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    opt_state = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, jopt),
                                       device="cpu")
    b = _batch(seed=0)
    jparams, jopt, jm = jstep(jparams, jopt,
                              jax.tree.map(jx["jnp"].asarray, b))
    params, opt_state, m = step(params, opt_state, _tb(b))
    assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                    rtol=1e-5)
    assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    want = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    assert sorted(params) == sorted(want)
    for a, b_ in zip(pytree.leaves(params), pytree.leaves(want)):
        assert_allclose(_np(a), _np(b_), rtol=2e-4, atol=2e-5)
    wopt = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, jopt),
                                  device="cpu")
    assert int(opt_state["step"]) == int(wopt["step"]) == 1
    for key in ("mu", "nu"):
        assert "tied_head" not in opt_state[key]
        for a, b_ in zip(pytree.leaves(opt_state[key]),
                         pytree.leaves(wopt[key])):
            assert_allclose(_np(a), _np(b_), rtol=2e-4, atol=2e-5)
    b = _batch(seed=1)
    _, _, jm = jstep(jparams, jopt, jax.tree.map(jx["jnp"].asarray, b))
    _, _, m = step(params, opt_state, _tb(b))
    assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)


def test_bf16_leaf_checkpoint_bits(tmp_path):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32)).to(
        torch.bfloat16)
    tree = {"w": x, "n": [torch.arange(3, dtype=torch.int32),
                          torch.tensor(1.5)]}
    path = ckpt.save(str(tmp_path), 2, tree)
    import json
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert [m["dtype"] for m in man["leaves"]] == ["int32", "float32",
                                                   "bfloat16"]
    out = ckpt.restore(str(tmp_path), 2, tree)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["n"][0], tree["n"][0])


def test_reference_checkpoint_restores_bit_for_bit(jx, tmp_path):
    jnp = jx["jnp"]
    rng = np.random.default_rng(6)
    f = rng.standard_normal((4, 5)).astype(np.float32)
    bf = rng.standard_normal((3, 2)).astype(np.float32)
    ints = rng.integers(-1000, 1000, (6,)).astype(np.int32)
    jtree = {"z": {"f": jnp.asarray(f), "i": jnp.asarray(ints)},
             "a": [jnp.asarray(bf, jnp.bfloat16), jnp.asarray(np.float32(2))]}
    jx["ckpt"].save(str(tmp_path), 11, jtree)
    like = {"z": {"f": torch.zeros(4, 5), "i": torch.zeros(6,
                                                           dtype=torch.int32)},
            "a": [torch.zeros(3, 2, dtype=torch.bfloat16), torch.zeros(())]}
    assert ckpt.latest_step(str(tmp_path)) == 11
    out = ckpt.restore(str(tmp_path), 11, like)
    assert out["z"]["f"].numpy().tobytes() == f.tobytes()
    assert out["z"]["i"].dtype == torch.int32
    assert np.array_equal(out["z"]["i"].numpy(), ints)
    want16 = np.asarray(jtree["a"][0]).view(np.int16)
    assert out["a"][0].dtype == torch.bfloat16
    assert np.array_equal(out["a"][0].view(torch.int16).numpy(), want16)
    assert float(out["a"][1]) == 2.0


def test_quantize_bit_equal_to_reference(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 3, 4096)
         ).astype(np.float32)
    r = (rng.standard_normal(4096) * 0.01).astype(np.float32)
    jq, js = jx["comp"].quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    jq, js, jr = jx["comp"].ef_quantize(jnp.asarray(x), jnp.asarray(r))
    q, s, res = comp.ef_quantize(torch.from_numpy(x), torch.from_numpy(r))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert res.numpy().tobytes() == np.asarray(jr).tobytes()
    d = comp.dequantize_int8(q, s).numpy()
    assert d.tobytes() == np.asarray(
        jx["comp"].dequantize_int8(jq, js)).tobytes()


# ---------------------------------------------------------------------------
# compressed_psum over four gloo ranks
# ---------------------------------------------------------------------------

WORLD = 4
RANK_CODE = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.core.mesh import make_data_mesh
from repro_torch.train import compression as comp
mesh = make_data_mesh(world, device="cpu")
sys.path.insert(0, sys.argv[5])
from test_torch_train import rank_inputs
x, r = rank_inputs(rank)
s, nr = comp.compressed_psum(torch.from_numpy(x), torch.from_numpy(r), mesh)
sync = comp.make_pod_gradient_sync(mesh)
g, gr = sync({"b": [torch.from_numpy(x)], "a": torch.from_numpy(x[:7])},
             {"b": [torch.from_numpy(r)], "a": torch.from_numpy(r[:7])})
np.savez(out, sum=s.numpy(), resid=nr.numpy(), g_b=g["b"][0].numpy(),
         g_a=g["a"].numpy(), r_b=gr["b"][0].numpy(), reduces=mesh.reduces)
dist.destroy_process_group()
"""


def rank_inputs(rank: int):
    """Rank ``rank``'s gradient and residual: mixed magnitudes, so the
    shared scale is another rank's."""
    g = np.random.default_rng(200 + rank)
    x = (g.standard_normal(1024) * 10.0 ** (rank - 2)).astype(np.float32)
    r = (g.standard_normal(1024) * 10.0 ** (rank - 4)).astype(np.float32)
    return x, r


def _numpy_compressed_psum(xs, rs):
    """The reference's compressed_psum, transcribed to numpy for all ranks
    at once (np.round rounds half to even, as jnp.round does)."""
    f32 = np.float32
    scales = [np.maximum(np.max(np.abs(x + r)) / f32(127.0), f32(1e-12))
              for x, r in zip(xs, rs)]
    scale_max = np.max(np.asarray(scales, f32))
    qs = [np.clip(np.round((x + r) / scale_max), -127, 127).astype(np.int8)
          for x, r in zip(xs, rs)]
    resids = [(x + r) - q.astype(f32) * scale_max
              for x, r, q in zip(xs, rs, qs)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    return total.astype(f32) * scale_max, resids


def test_compressed_psum_four_gloo_ranks_bit_equal(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), str(WORLD), str(store),
         str(tmp_path / f"rank{r}.npz"), str(ROOT / "tests")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    xs, rs = zip(*(rank_inputs(r) for r in range(WORLD)))
    want_sum, want_resid = _numpy_compressed_psum(xs, rs)
    assert np.abs(want_sum).max() > 0
    for r in range(WORLD):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["sum"].tobytes() == want_sum.tobytes(), r
        assert got["resid"].tobytes() == want_resid[r].tobytes(), r
        # The pod sync: the same sum over 4, leaf by leaf.
        want_g = want_sum / np.float32(WORLD)
        assert got["g_b"].tobytes() == want_g.tobytes(), r
        assert got["r_b"].tobytes() == want_resid[r].tobytes(), r
        sub, _ = _numpy_compressed_psum([x[:7] for x in xs],
                                        [x[:7] for x in rs])
        assert got["g_a"].tobytes() == (sub / np.float32(WORLD)).tobytes()
        assert int(got["reduces"]) == 2 * 3      # 3 psums, 2 reduces each


def test_pod_gradient_sync_identity_without_mesh():
    g, r = {"a": torch.ones(3)}, {"a": torch.zeros(3)}
    sync = comp.make_pod_gradient_sync(None)
    assert sync(g, r) == (g, r)
