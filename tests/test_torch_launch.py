"""The port's launch layer: the shape registry against the reference's,
abstract input specs on the ``meta`` device for every (arch x shape) cell
(mirrors of ``tests/test_launch.py``'s ``test_input_specs_cover_grid`` and
``test_reduced_smoke_all_cells_eval_shape``: no memory is allocated), and
``launch.train`` on the CPU: a finite falling loss, a checkpointed run
resumed where it stopped with the losses of an uninterrupted run (bit for
bit: the CPU runs the same operations in the same order), and the
refusals (``--mesh prod``, no card)."""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, list_archs
from repro_torch.configs.registry import SUBQUADRATIC, shape_applicable
from repro_torch.launch import specs
from repro_torch.launch import train as T
from repro_torch.models import Model, init_model
from repro_torch.models.config import reduced_for_smoke
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import pytree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jreg():
    pytest.importorskip("jax")
    from repro.configs import registry
    return registry


def test_registry_matches_reference(jreg):
    assert ARCHS == jreg.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}
    assert SUBQUADRATIC == jreg.SUBQUADRATIC
    for arch in ARCHS:
        for shape in SHAPES:
            assert shape_applicable(arch, shape) == jreg.shape_applicable(
                arch, shape)
    assert [a for a, _ in list_archs()] == list(ARCHS)
    assert get_shape("train_4k") == SHAPES["train_4k"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_cover_grid(arch, shape):
    if shape_applicable(arch, shape):
        with pytest.raises(ValueError):
            specs.input_specs(arch, shape)
        return
    kind, abstract = specs.input_specs(arch, shape)
    shp = SHAPES[shape]
    assert kind == shp.kind
    leaves = pytree.leaves(abstract)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    if kind in ("train", "prefill"):
        t = abstract["batch"]["tokens"]
        assert t.shape == (shp.global_batch, shp.seq_len)
        assert t.dtype == torch.int32
        assert ("labels" in abstract["batch"]) == (kind == "train")
    else:
        assert abstract["token"].shape == (shp.global_batch, 1)
        caches = pytree.leaves(abstract["caches"])
        assert caches, "decode cell must carry caches"
        assert all(hasattr(c, "shape") for c in caches)


def test_reduced_smoke_all_cells_eval_shape():
    """decode cache specs materialize abstractly for every decode cell."""
    for arch in ARCHS:
        for shape in ("decode_32k", "long_500k"):
            if shape_applicable(arch, shape):
                continue
            kind, abstract = specs.input_specs(arch, shape)
            total = sum(c.numel() * c.element_size()
                        for c in pytree.leaves(abstract["caches"]))
            assert total > 0


def test_model_veneer():
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    m = Model(cfg)
    params = m.init(0, device="cpu")
    same = init_model(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(params),
                                                 pytree.leaves(same)))
    tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    batch = {"tokens": tokens, "labels": (tokens + 1) % cfg.vocab_size}
    loss = m.loss(params, batch)
    assert math.isfinite(float(loss))
    last, raw, _ = m.prefill(params, batch)
    assert last.shape == (2, 1, cfg.vocab_size)
    caches = m.init_caches(2, 16, device="cpu")
    logits, _ = m.decode(params, tokens[:, :1], caches)
    assert logits.shape == (2, 1, cfg.vocab_size)


SMOKE = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--lr", "3e-3"]


def test_train_main_resumes_from_checkpoint(tmp_path):
    full = T.run(SMOKE + ["--steps", "5"])
    assert all(math.isfinite(x) for x in full["losses"])
    assert full["losses"][-1] < full["losses"][0]
    d = str(tmp_path / "ck")
    first = T.main(SMOKE + ["--steps", "3", "--ckpt", d, "--ckpt-every",
                            "2", "--remat", "dots"])
    assert first == full["losses"][2]
    assert ckpt.latest_step(d) == 1
    again = T.run(SMOKE + ["--steps", "5", "--ckpt", d])
    assert again["start_step"] == 2
    assert again["losses"] == full["losses"][2:]
    for a, b in zip(pytree.leaves(again["params"]),
                    pytree.leaves(full["params"])):
        assert torch.equal(a, b)


def test_train_main_eval_and_microbatches(capsys):
    out = T.run(SMOKE + ["--steps", "2", "--eval-every", "2",
                         "--microbatches", "2"])
    (tr,) = out["evals"]
    assert tr.info["model_forwards"] <= tr.info["full_eval_forwards"] == 768
    assert "[miss-eval]" in capsys.readouterr().out


def test_train_main_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="item 20"):
        T.main(SMOKE + ["--mesh", "prod"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        T.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])
