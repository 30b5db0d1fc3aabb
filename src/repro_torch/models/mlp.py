"""Feed-forward blocks: the dense SwiGLU MLP and token-choice top-k MoE with
optional shared experts (DeepSeekMoE-style fine-grained routing).

MoE dispatch is the reference's sort-based fixed-shape scheme: flatten the
(token, choice) pairs, stable-sort them by expert, find each expert's
segment start with a left ``searchsorted``, drop the entries past capacity
``C`` into a pad row, run every expert as one stacked product over ``(E, C,
d)``, and add the weighted outputs back to their tokens in f32.  The
reference computes all of it in ``jnp`` outside any Pallas kernel, and so
does this module.

The combine is deterministic: ``index_add_`` on the card adds a token's
``k`` contributions with atomics, in an order that changes from run to run.
Each token's contributions are gathered through the inverse permutation
instead and added one after another in ascending-expert order, the order in
which the reference's scatter-add on the CPU meets them in the sorted list.

Capacity drops couple the tokens of a call: a full expert drops the later
entries in sorted order, so a token's output depends on which other tokens
share the call.  Decode with at most 8 rows never drops: ``C >= 8 >= T``
and an expert receives at most one entry per token.
"""
from __future__ import annotations

import torch

from . import nn
from .config import ModelConfig, MoEConfig
from .shardctx import constrain, replicated


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             device):
    return {
        "wi_gate": nn.dense_init(generator, d_model, d_ff, dtype, device),
        "wi_up": nn.dense_init(generator, d_model, d_ff, dtype, device),
        "wo": nn.dense_init(generator, d_ff, d_model, dtype, device,
                            scale=d_ff ** -0.5),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(nn.dense(p["wi_gate"], x)) * nn.dense(
        p["wi_up"], x)
    h = constrain(h, "ffn")
    return constrain(nn.dense(p["wo"], h), "resid")


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    """The reference's initialisers: an f32 router at scale 0.02, each
    expert's matrices at their fan-in scale, stacked over the E axis."""
    mo = cfg.moe
    d, E, dff = cfg.d_model, mo.num_experts, mo.d_expert

    def stack(d_in, d_out):
        return nn.dense_init(generator, d_in, d_out, dtype, device,
                             stack=E)

    p = {
        "router": nn.dense_init(generator, d, E, torch.float32, device,
                                scale=0.02),
        "we_gate": stack(d, dff),
        "we_up": stack(d, dff),
        "we_down": stack(dff, d),
    }
    if mo.num_shared:
        p["shared"] = init_mlp(generator, d, dff * mo.num_shared, dtype,
                               device)
    return p


def capacity(T: int, mo: MoEConfig) -> int:
    """Rows each expert holds in a call of ``T`` tokens (the reference's
    ``_capacity``)."""
    cap = int(T * mo.top_k * mo.capacity_factor / mo.num_experts) + 1
    return max(8, ((cap + 7) // 8) * 8)


def top_k(x: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (the first k columns of a stable sort; ``torch.topk``
    leaves ties in no stated order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, cfg: ModelConfig, xt: torch.Tensor):
    """The router on ``xt`` (T, d): softmax probabilities (T, E) in f32 and
    the top-k gates, renormalised to sum to 1, with their experts (T, k)
    (:func:`top_k`)."""
    logits = nn.dense(p["router"], xt.float())
    probs = torch.softmax(logits, dim=-1)
    gate, choice = top_k(probs, cfg.moe.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, choice


@replicated
def moe(p, cfg: ModelConfig, x: torch.Tensor):
    """Token-choice top-k MoE.  x (B, S, d) -> (y, aux_loss).

    Under sharding rules the call runs replicated (``shardctx.replicated``):
    the dispatch's stable sort, scatter and gathers have no DTensor
    strategy, and the capacity couples every token of the call, so each
    rank routes the whole global batch as one device would."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mo.num_experts, mo.top_k
    C = capacity(T, mo)
    dev = x.device
    xt = x.reshape(T, d)
    probs, gate, choice = route(p, cfg, xt)

    # Aux load-balance loss (Switch-style): E * sum_e f_e * p_e.  The
    # counts are whole numbers in f32, exact in any order of addition;
    # ``bincount`` would read its input's maximum on the host.
    me = torch.mean(probs, dim=0)
    flat_expert = choice.reshape(-1)                             # (T*k,)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, flat_expert, torch.ones((T * k,), dtype=torch.float32,
                                   device=dev)) * (1.0 / (T * k))
    aux = mo.aux_loss_coef * E * torch.sum(me * ce)

    # ---- sort-based dispatch (fixed shapes) ----
    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order]
    t_sorted = order // k
    g_sorted = gate.reshape(-1)[order]
    idx = torch.arange(T * k, device=dev)
    seg_start = torch.searchsorted(e_sorted,
                                   torch.arange(E, device=dev))  # left
    pos_in_e = idx - seg_start[e_sorted]
    keep = pos_in_e < C
    slot = torch.where(keep, e_sorted * C + pos_in_e, E * C)     # drop -> pad

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xt[t_sorted], 0.0)
    h = constrain(buf[:E * C].reshape(E, C, d), "experts")

    # ---- stacked expert FFN (one product over E) ----
    hg = torch.nn.functional.silu(torch.bmm(h, p["we_gate"]))
    hu = torch.bmm(h, p["we_up"])
    ho = constrain(torch.bmm(hg * hu, p["we_down"]), "experts")  # (E, C, d)

    # ---- combine: each token's k weighted outputs, ascending expert ----
    contrib = ho.reshape(E * C, d)[torch.clamp(slot, max=E * C - 1)]
    contrib = torch.where(keep[:, None], contrib, 0.0)
    weighted = contrib.float() * g_sorted[:, None]
    inv = torch.empty_like(order)
    inv[order] = idx
    at = torch.sort(inv.reshape(T, k), dim=-1).values            # (T, k)
    y = weighted[at[:, 0]]
    for j in range(1, k):
        y = y + weighted[at[:, j]]

    if mo.num_shared:
        y = y + mlp(p["shared"], xt).float()
    return y.reshape(B, S, d).to(x.dtype), aux
