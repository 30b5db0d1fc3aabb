"""Carry state over from the reference package, as numpy arrays.

Data takes the place of weights in this system: the same table, keys and
mid-run lane state fed to both packages must give the same trajectories.
On the LM side, the same parameter tree fed to both packages must give the
same logits and tokens.
Each function takes plain numpy arrays (``np.asarray`` of the reference's
arrays), so this module needs nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .core import keys as keylib
from .core.fused import LaneParams, LaneState
from .core.sampling import GroupedData
from .models import model as lm
from .models import ssm
from .models.config import ModelConfig


def grouped_data_from_numpy(values: np.ndarray, offsets: np.ndarray,
                            scale: Optional[np.ndarray] = None,
                            device=None) -> GroupedData:
    """A :class:`GroupedData` on ``device`` from the reference's
    ``(values, offsets, scale)``."""
    return GroupedData(torch.from_numpy(np.array(values, np.float32)),
                       np.asarray(offsets, np.int64),
                       None if scale is None else np.asarray(scale),
                       device=device)


def key_from_numpy(key_data: np.ndarray) -> np.ndarray:
    """A ``(2,)`` uint32 key from the reference's raw key data."""
    return keylib.as_key(key_data)


def _leaves(leaves: Mapping[str, np.ndarray], fields) -> dict:
    missing = [f for f in fields if f not in leaves]
    if missing:
        raise ValueError(f"missing leaves: {missing}")
    return {f: np.asarray(leaves[f]) for f in fields}


def lane_state_from_numpy(leaves: Mapping[str, np.ndarray],
                          device=None) -> LaneState:
    """A :class:`LaneState` from the reference ``LaneState``'s leaves
    (``{name: np.asarray(leaf)}``), with the port's dtypes."""
    a = _leaves(leaves, LaneState._fields)
    dt = dict(keys=np.int64, k=np.int32, iters=np.int32, n_cur=np.int32,
              filled=np.int32, done=np.bool_, failed=np.bool_)
    return LaneState(**{
        f: torch.as_tensor(np.asarray(v, dt.get(f, np.float32)).copy(),
                           device=device)
        for f, v in a.items()})


def lane_params_from_numpy(leaves: Mapping[str, np.ndarray],
                           device=None) -> LaneParams:
    """A :class:`LaneParams` from the reference ``LaneParams``'s leaves,
    warm-start rows included."""
    a = _leaves(leaves, LaneParams._fields)
    dt = dict(est_fids=np.int32, boot_base=np.int64, slot_idx=np.int32,
              warm=np.bool_, warm_n0=np.int32, group_sizes=np.int32)
    return LaneParams(**{
        f: torch.as_tensor(np.asarray(v, dt.get(f, np.float32)).copy(),
                           device=device)
        for f, v in a.items()})


OUT_GAIN = 8.0              # lm_tree_from_seed's output-projection gain

# Leaves the reference keeps in f32 whatever the model's dtype: norm gains,
# the MoE router, the Mamba per-head scalars, RWKV's mix, decay and bonus.
_F32_LEAVES = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "router",
               "dt_bias", "A_log", "D", "mu", "w0", "u", "ln_out")


def _lm_leaf(name: str, a, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(device=device,
                dtype=torch.float32 if name in _F32_LEAVES else dtype)


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                         device="cuda") -> Dict[str, Any]:
    """The port's LM params from the reference's parameter tree as numpy
    (``jax.tree.map(np.asarray, params)``).

    ``tree["blocks"]`` holds one dict per pattern position whose leaves
    carry a leading ``n_pattern_repeats`` axis (the reference's scan
    stack); layer ``r * len(pattern) + j`` is repeat ``r`` of position
    ``j``, so each pattern position of a hybrid keeps its own leaf set.
    Weights take the config's dtype; norm gains and the MoE/SSM leaves of
    ``_F32_LEAVES`` stay f32, as the reference initialises them.  A tied
    head is formed from the embedding, an untied one is the tree's
    ``unembed``."""
    lm.check_supported(cfg)
    dtype = lm._dtype(cfg)

    def conv(node, name=""):
        if isinstance(node, Mapping):
            return {k: conv(v, k) for k, v in node.items()}
        return _lm_leaf(name, node, dtype, device)

    params: Dict[str, Any] = {k: conv(v, k) for k, v in tree.items()
                              if k != "blocks"}
    layers = [conv(_take(blk, r)) for r in range(cfg.n_pattern_repeats)
              for blk in tree["blocks"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    params["layers"] = layers
    if cfg.tie_embeddings:
        lm.attach_tied_head(cfg, params)
    return params


def _take(node, r: int):
    if isinstance(node, Mapping):
        return {k: _take(v, r) for k, v in node.items()}
    return np.asarray(node)[r]


def lm_tree_from_seed(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """A parameter tree in the reference's layout (blocks stacked over
    repeats, one per pattern position) with f32 numpy values drawn from
    ``seed``: the same weights for both packages, or for the card and the
    CPU.  Unlike the reference's initialiser, biases, norm gains and the
    SSM scalars are random too, so they are exercised, and the output
    projections are drawn at ``OUT_GAIN`` times their fan-in scale: under a
    tied head, random layers that small leave each token's own embedding to
    pick the next token, and greedy decoding would repeat the prompt's last
    token whatever the attention does.  The MoE router is drawn at its
    fan-in scale (the reference's is 0.02), so routing is far from uniform
    and capacity drops occur.  ``A_log`` stays increasing (every head
    decays), RWKV's ``mu`` in [0, 1] and ``w0`` near -0.6, so the clamps and
    the f32 range argument of ``models/ssm.py`` hold.  Attention weights
    are drawn first, QK norm gains and an untied head (at its fan-in scale)
    after every other leaf, so a dense config without them keeps its
    weights."""
    lm.check_supported(cfg)
    rng = np.random.default_rng(seed)
    d, dh, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    nr = cfg.n_pattern_repeats
    kinds = [lm.parse_kind(k) for k in cfg.layer_pattern]

    def w(*shape, scale):
        return (np.clip(rng.standard_normal(shape), -2, 2)
                * scale).astype(np.float32)

    def gain(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    def swiglu(d_ff):
        return {"wi_gate": w(nr, d, d_ff, scale=d ** -0.5),
                "wi_up": w(nr, d, d_ff, scale=d ** -0.5),
                "wo": w(nr, d_ff, d, scale=OUT_GAIN * d_ff ** -0.5)}

    def moe():
        mo = cfg.moe
        E, dff = mo.num_experts, mo.d_expert
        p = {"router": w(nr, d, E, scale=d ** -0.5),
             "we_gate": w(nr, E, d, dff, scale=d ** -0.5),
             "we_up": w(nr, E, d, dff, scale=d ** -0.5),
             "we_down": w(nr, E, dff, d, scale=OUT_GAIN * dff ** -0.5)}
        if mo.num_shared:
            p["shared"] = swiglu(dff * mo.num_shared)
        return p

    def mamba():
        s = cfg.ssm
        di = s.expand * d
        Hm = di // s.head_dim
        a_log = np.log(np.linspace(1.0, 16.0, Hm)) + 0.1 * rng.standard_normal(
            (nr, Hm))
        return {"in_proj": w(nr, d, 2 * di, scale=d ** -0.5),
                "conv_w": w(nr, s.conv_width, di, scale=0.5),
                "bc_proj": w(nr, di, 2 * s.d_state, scale=di ** -0.5),
                "dt_proj": w(nr, di, Hm, scale=di ** -0.5),
                "dt_bias": w(nr, Hm, scale=0.5) - 1.0,
                "A_log": np.sort(a_log, axis=-1).astype(np.float32),
                "D": gain(nr, Hm),
                "out_proj": w(nr, di, d, scale=OUT_GAIN * di ** -0.5)}

    def rwkv():
        K = cfg.ssm.head_dim
        lora = ssm.rwkv_lora(d)
        return {"mu": rng.uniform(0.0, 1.0, (nr, 5, d)).astype(np.float32),
                "wr": w(nr, d, d, scale=d ** -0.5),
                "wk": w(nr, d, d, scale=d ** -0.5),
                "wv": w(nr, d, d, scale=d ** -0.5),
                "wg": w(nr, d, d, scale=d ** -0.5),
                "wo": w(nr, d, d, scale=OUT_GAIN * d ** -0.5),
                "w0": -0.6 + w(nr, d, scale=0.1),
                "wA": w(nr, d, lora, scale=d ** -0.5),
                "wB": w(nr, lora, d, scale=0.1),
                "u": w(nr, d // K, K, scale=0.5),
                "ln_out": gain(nr, d)}

    def cmix():
        return {"mu": rng.uniform(0.0, 1.0, (nr, d)).astype(np.float32),
                "wk": w(nr, d, cfg.d_ff, scale=d ** -0.5),
                "wv": w(nr, cfg.d_ff, d, scale=OUT_GAIN * cfg.d_ff ** -0.5)}

    attn_mixers = {}
    for j, (mixer, _) in enumerate(kinds):
        if mixer != "attn":
            continue
        m = {"wq": w(nr, d, H * dh, scale=d ** -0.5),
             "wk": w(nr, d, Hkv * dh, scale=d ** -0.5),
             "wv": w(nr, d, Hkv * dh, scale=d ** -0.5),
             "wo": w(nr, H * dh, d, scale=OUT_GAIN * (H * dh) ** -0.5)}
        if cfg.qkv_bias:
            m.update(bq=w(nr, H * dh, scale=0.1),
                     bk=w(nr, Hkv * dh, scale=0.1),
                     bv=w(nr, Hkv * dh, scale=0.1))
        attn_mixers[j] = m
    tree: Dict[str, Any] = {"embed": w(cfg.vocab_size, d, scale=1.0),
                            "final_norm": gain(d), "blocks": []}
    for j, (mixer, ff) in enumerate(kinds):
        blk: Dict[str, Any] = {"ln1": gain(nr, d)}
        if mixer == "rwkv":
            blk["tmix"] = rwkv()
            blk["ln2"] = gain(nr, d)
            blk["cmix"] = cmix()
        else:
            blk["mixer"] = attn_mixers[j] if mixer == "attn" else mamba()
            blk["ln2"] = gain(nr, d)
            blk["ff"] = moe() if ff == "moe" else swiglu(cfg.d_ff)
        tree["blocks"].append(blk)
    if cfg.qk_norm:
        for m in attn_mixers.values():
            m.update(q_norm=gain(nr, dh), k_norm=gain(nr, dh))
    if not cfg.tie_embeddings:
        tree["unembed"] = w(d, cfg.vocab_size, scale=d ** -0.5)
    return tree
