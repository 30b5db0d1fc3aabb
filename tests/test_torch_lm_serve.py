"""The port's continuous batcher against the JAX reference's on the same
weights and prompts (reduced ``qwen2-1.5b``, f32): 6 requests through 2
slots, one retired at ``s_max - 1``, one at EOS, and an idle slot decoding
on past ``s_max`` -- the token sequences must be equal.  And the port's
serve entry point runs on the CPU.

Prompts take two lengths only: the reference's batcher compiles its prefill
once per prompt length.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.launch import serve
from repro_torch.models.config import reduced_for_smoke
from repro_torch.serve.batching import ContinuousBatcher, Request

S_MAX = 24
SLOTS = 2
# (prompt length, max_new_tokens): request 4 reaches s_max - 1 after 7
# steps while request 5 decodes on beside its idle slot.
SPECS = [(6, 8), (6, 12), (6, 8), (6, 8), (16, 16), (6, 16)]
EOS_RID = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    tree = lm_tree_from_seed(cfg, 2)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in SPECS]
    return cfg, tree, prompts


def _serve(batcher_cls, request_cls, cfg, params, prompts, eos):
    b = batcher_cls(cfg, params, slots=SLOTS, s_max=S_MAX)
    for rid, (p, (_, new)) in enumerate(zip(prompts, SPECS)):
        b.submit(request_cls(rid=rid, prompt=p, max_new_tokens=new,
                             eos_id=eos if rid == EOS_RID else None))
    done = b.run()
    return b, {r.rid: list(map(int, r.out_tokens)) for r in done}


def test_batcher_tokens_equal_reference(setup):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.serve import batching as jb

    cfg, tree, prompts = setup
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    # The EOS request's 4th token, from a run without EOS, cuts it short.
    _, free = _serve(ContinuousBatcher, Request, cfg, params, prompts, None)
    eos = free[EOS_RID][3]
    cut = free[EOS_RID].index(eos, 1) + 1
    assert cut < SPECS[EOS_RID][1]

    batcher, got = _serve(ContinuousBatcher, Request, cfg, params, prompts,
                          eos)
    _, want = _serve(jb.ContinuousBatcher, jb.Request, cfg,
                     jax.tree.map(jnp.asarray, tree), prompts, eos)
    assert got == want
    assert len(got[EOS_RID]) == cut and got[EOS_RID][-1] == eos
    n4 = S_MAX - 1 - SPECS[4][0] + 1            # retired at s_max - 1
    assert len(got[4]) == n4 < SPECS[4][1]
    for rid in (0, 2, 3, 5):
        assert len(got[rid]) == SPECS[rid][1]
    # An idle slot decoded on past s_max (its cache writes dropped).
    assert int(batcher.caches[0].length.max()) > S_MAX


def test_serve_entry_point_runs_on_cpu(capsys):
    n = da_ops.counter.launches
    done = serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    assert da_ops.counter.launches == n          # the CPU runs the plain op
    assert "3 requests" in capsys.readouterr().out
