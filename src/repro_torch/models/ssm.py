"""State-space sequence mixers: Mamba (SSD chunked form) and RWKV6 (Finch).

The reference computes both scans in ``jnp`` outside any Pallas kernel, in
their chunked matmul forms (intra-chunk work as (L x L) contractions, only
chunk-boundary states carried over a loop of chunks), and so does this
module:

  * Mamba in the SSD (Mamba-2) head formulation: one scalar decay per head
    and token, so the intra-chunk decay matrix is (B, L, L, H).  The
    reference's three-operand intra-chunk einsum is written as two
    contractions (weights ``scores * decay``, then the product with the
    inputs), so no (B, L, L, H, P) tensor is formed.
  * RWKV6 with its per-channel data-dependent decay.  The chunked path uses
    the exp(+/-cumlog) factorisation; with chunks of at most 32 and the log
    decay clamped to [-2, -1e-4] every intermediate stays within f32 range
    (worst case e^64 ~ 6e27 << 3.4e38).  The ``sequential=True`` scan is the
    oracle the tests hold it against.

The chunk rule is the reference's: ``mamba_forward`` needs ``S % min(chunk,
S) == 0`` and ``rwkv_forward`` ``S % min(chunk, 32, S) == 0``; any other
length raises ``ValueError`` (the reference asserts).  Both mixers have a
one-token ``*_decode`` step that carries the recurrent state.

Numerics copied from the reference: softplus is ``logaddexp(x, 0)``
(``jax.nn.softplus``; torch's ``softplus`` switches to ``x`` above 20),
RWKV's token-shift mix forms ``1 - mu`` in the activation dtype, its output
norm is one RMS norm over all of d, and the Mamba conv tail is cast to the
activation dtype after a forward pass but not after a decode step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import nn
from .config import ModelConfig

silu = torch.nn.functional.silu


# ===========================================================================
# Mamba (SSD chunked)
# ===========================================================================

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.d_state


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, _, N = _mamba_dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": nn.dense_init(generator, d, 2 * d_in, dtype, device),
        "conv_w": (torch.randn((s.conv_width, d_in), generator=generator,
                               device=device) * 0.1).to(dtype),
        "bc_proj": nn.dense_init(generator, d_in, 2 * N, dtype, device),
        "dt_proj": nn.dense_init(generator, d_in, H, dtype, device,
                                 scale=0.02),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "out_proj": nn.dense_init(generator, d_in, d, dtype, device,
                                  scale=d_in ** -0.5),
    }


class MambaState(NamedTuple):
    ssm: torch.Tensor     # (B, H, P, N) f32 recurrent state
    conv: torch.Tensor    # (B, conv_width - 1, d_in) conv tail


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba_preproject(p, cfg: ModelConfig, x, conv_tail=None):
    """Shared projections: (xh, xraw, z, a, Bv, Cv, new conv tail)."""
    s = cfg.ssm
    B_, S, _ = x.shape
    d_in, H, P, N = _mamba_dims(cfg)
    xi, z = nn.dense(p["in_proj"], x).split(d_in, dim=-1)
    # Causal depthwise conv of width W over the sequence.
    W = s.conv_width
    if conv_tail is None:
        conv_tail = torch.zeros((B_, W - 1, d_in), dtype=xi.dtype,
                                device=x.device)
    xpad = torch.cat([conv_tail, xi], dim=1)
    xc = 0
    for i in range(W):
        xc = xc + xpad[:, i:i + S] * p["conv_w"][i][None, None, :]
    xc = silu(xc)
    new_tail = xpad[:, -(W - 1):] if W > 1 else conv_tail
    dt = softplus(nn.dense(p["dt_proj"], xc).float() + p["dt_bias"])
    a = torch.exp(-dt * torch.exp(p["A_log"]))       # (B,S,H) decay in (0,1)
    Bv, Cv = nn.dense(p["bc_proj"], xc).float().split(N, dim=-1)
    xraw = xc.reshape(B_, S, H, P).float()           # raw heads
    xh = xraw * dt[..., None]                        # dt-scaled input
    return xh, xraw, z, a, Bv, Cv, new_tail


def mamba_chunk(cfg: ModelConfig, S: int) -> int:
    """Chunk length of the SSD scan over ``S`` tokens; ``ValueError`` if
    ``S`` is not a multiple of it."""
    L = min(cfg.ssm.chunk, S)
    if S % L:
        raise ValueError(f"mamba_forward: {S} tokens are not a multiple of "
                         f"the chunk {L} (min(chunk={cfg.ssm.chunk}, S))")
    return L


def mamba_forward(p, cfg: ModelConfig, x, state: MambaState | None = None):
    """Chunked SSD scan.  x (B,S,d) -> (y (B,S,d), final MambaState)."""
    B_, S, _ = x.shape
    d_in, H, P, N = _mamba_dims(cfg)
    L = mamba_chunk(cfg, S)
    conv_tail = state.conv if state is not None else None
    xh, xraw, z, a, Bv, Cv, new_tail = _mamba_preproject(p, cfg, x,
                                                         conv_tail)
    st = (state.ssm if state is not None
          else torch.zeros((B_, H, P, N), dtype=torch.float32,
                           device=x.device))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c0 in range(0, S, L):
        xh_c, a_c = xh[:, c0:c0 + L], a[:, c0:c0 + L]
        B_c, C_c = Bv[:, c0:c0 + L], Cv[:, c0:c0 + L]
        logw = torch.log(torch.clamp(a_c, min=1e-20))            # (B,L,H)
        csum = torch.cumsum(logw, dim=1)                         # inclusive
        # Contribution of the incoming state: C_t . (exp(csum_t) * state).
        y_state = torch.einsum("bln,bhpn->blhp", C_c, st) * torch.exp(
            csum)[..., None]
        # Intra-chunk: scores (B,L,L) shared over heads; per-head decay.
        scores = torch.einsum("bln,bsn->bls", C_c, B_c)
        # Clamp the exponent at 0 BEFORE exp: entries with s > t overflow.
        expo = torch.clamp(csum[:, :, None, :] - csum[:, None, :, :],
                           max=0.0)
        dec = torch.where(causal[None, :, :, None], torch.exp(expo), 0.0)
        wts = scores[..., None] * dec                            # (B,t,s,H)
        y_intra = torch.einsum("btsh,bshp->bthp", wts, xh_c)
        # State update to the chunk end.
        decay_to_end = torch.exp(csum[:, -1:, :] - csum)         # (B,L,H)
        chunk_decay = torch.exp(csum[:, -1])[..., None, None]    # (B,H,1,1)
        st = chunk_decay * st + torch.einsum(
            "bshp,bsn->bhpn", decay_to_end[..., None] * xh_c, B_c)
        ys.append(y_state + y_intra)
    y = torch.cat(ys, dim=1)                                     # (B,S,H,P)
    y = y + xraw * p["D"][None, None, :, None]                   # D skip
    y = y.reshape(B_, S, d_in).to(x.dtype) * silu(z)
    out = nn.dense(p["out_proj"], y)
    return out, MambaState(ssm=st, conv=new_tail.to(x.dtype))


def mamba_decode(p, cfg: ModelConfig, x, state: MambaState):
    """Single-token recurrent step.  x (B,1,d)."""
    B_, S, _ = x.shape
    if S != 1:
        raise ValueError(f"mamba_decode takes one token per row, got {S}")
    d_in = _mamba_dims(cfg)[0]
    xh, xraw, z, a, Bv, Cv, new_tail = _mamba_preproject(p, cfg, x,
                                                         state.conv)
    st = state.ssm * a[:, 0, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh[:, 0], Bv[:, 0])
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0], st)
    y = y + xraw[:, 0] * p["D"][None, :, None]
    y = y.reshape(B_, 1, d_in).to(x.dtype) * silu(z)
    return nn.dense(p["out_proj"], y), MambaState(ssm=st, conv=new_tail)


def init_mamba_state(cfg: ModelConfig, B: int, dtype,
                     device) -> MambaState:
    s = cfg.ssm
    d_in, H, P, N = _mamba_dims(cfg)
    return MambaState(
        ssm=torch.zeros((B, H, P, N), dtype=torch.float32, device=device),
        conv=torch.zeros((B, s.conv_width - 1, d_in), dtype=dtype,
                         device=device))


# ===========================================================================
# RWKV6 (Finch) time mix
# ===========================================================================

LOGW_MIN, LOGW_MAX = -2.0, -1e-4   # clamp keeps the chunked path in f32 range
RWKV_MAX_CHUNK = 32


def rwkv_lora(d: int) -> int:
    """Rank of the data-dependent decay's LoRA."""
    return max(32, d // 64)


def init_rwkv(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    K = cfg.ssm.head_dim
    H = d // K
    lora = rwkv_lora(d)
    f32 = torch.float32

    def dense(d_in, d_out, scale=None):
        return nn.dense_init(generator, d_in, d_out, dtype, device, scale)

    p = {
        # token-shift mix coefficients per stream (r, k, v, w, g)
        "mu": torch.full((5, d), 0.5, dtype=f32, device=device),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d, d ** -0.5),
        # data-dependent decay LoRA: w_t = exp(clamp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -0.6, dtype=f32, device=device),
        "wA": dense(d, lora, 0.02),
        "wB": dense(lora, d, 0.02),
    }
    p["u"] = torch.randn((H, K), generator=generator, device=device) * 0.1
    p["ln_out"] = nn.rms_norm_init(d, device)
    return p


class RWKVState(NamedTuple):
    wkv: torch.Tensor     # (B, H, K, K) f32
    shift: torch.Tensor   # (B, 1, d) previous token's input


def _rwkv_project(p, cfg: ModelConfig, x, shift):
    xprev = torch.cat([shift, x[:, :-1]], dim=1)
    mixed = [x * m + xprev * (1.0 - m)
             for m in p["mu"][:, None, None, :].to(x.dtype)]
    xr, xk, xv, xw, xg = mixed
    r = nn.dense(p["wr"], xr)
    k = nn.dense(p["wk"], xk)
    v = nn.dense(p["wv"], xv)
    g = silu(nn.dense(p["wg"], xg))
    logw = p["w0"] + torch.tanh(nn.dense(p["wA"], xw).float()) @ \
        p["wB"].float()
    logw = torch.clamp(logw, LOGW_MIN, LOGW_MAX)     # (B,S,d)
    return r, k, v, g, logw, x[:, -1:]


def _heads(t, H, K):
    B_, S, _ = t.shape
    return t.reshape(B_, S, H, K).float()


def rwkv_chunk(cfg: ModelConfig, S: int) -> int:
    """Chunk length of the chunked scan over ``S`` tokens; ``ValueError``
    if ``S`` is not a multiple of it."""
    L = min(cfg.ssm.chunk, RWKV_MAX_CHUNK, S)
    if S % L:
        raise ValueError(f"rwkv_forward: {S} tokens are not a multiple of "
                         f"the chunk {L} (min(chunk={cfg.ssm.chunk}, "
                         f"{RWKV_MAX_CHUNK}, S))")
    return L


def rwkv_forward(p, cfg: ModelConfig, x, state: RWKVState | None = None,
                 *, sequential: bool = False):
    """RWKV6 time mix.  x (B,S,d) -> (y, final state)."""
    K = cfg.ssm.head_dim
    d = cfg.d_model
    H = d // K
    B_, S, _ = x.shape
    L = S if sequential else rwkv_chunk(cfg, S)
    shift = (state.shift if state is not None
             else torch.zeros((B_, 1, d), dtype=x.dtype, device=x.device))
    r, k, v, g, logw, new_shift = _rwkv_project(p, cfg, x, shift)
    rh, kh, vh = _heads(r, H, K), _heads(k, H, K), _heads(v, H, K)
    lw = logw.reshape(B_, S, H, K)
    u = p["u"]
    S_ = (state.wkv if state is not None
          else torch.zeros((B_, H, K, K), dtype=torch.float32,
                           device=x.device))

    ys = []
    if sequential:
        for t in range(S):
            r_t, k_t, v_t, lw_t = rh[:, t], kh[:, t], vh[:, t], lw[:, t]
            kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
            ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                   S_ + u[None, :, :, None] * kv))
            S_ = torch.exp(lw_t)[..., None] * S_ + kv
        y = torch.stack(ys, dim=1)                       # (B,S,H,K)
    else:
        strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=x.device), diagonal=-1)
        for c0 in range(0, S, L):
            r_c, k_c = rh[:, c0:c0 + L], kh[:, c0:c0 + L]
            v_c, lw_c = vh[:, c0:c0 + L], lw[:, c0:c0 + L]   # (B,L,H,K)
            csum = torch.cumsum(lw_c, dim=1)                 # inclusive
            cprev = csum - lw_c                              # csum_{t-1}
            r_tilde = r_c * torch.exp(cprev)                 # decays-to-t
            k_tilde = k_c * torch.exp(-csum)                 # bounded: clamp
            scores = torch.einsum("blhk,bshk->bhls", r_tilde, k_tilde)
            scores = scores * strict[None, None]
            # u-bonus diagonal: r_t . (u * k_t) v_t.
            diag = torch.einsum("blhk,blhk->blh", r_c, u[None, None] * k_c)
            y_intra = torch.einsum("bhls,bshv->blhv", scores, v_c)
            y_intra = y_intra + diag[..., None] * v_c
            y_state = torch.einsum("blhk,bhkv->blhv", r_tilde, S_)
            # State to the chunk end.
            dec_end = torch.exp(csum[:, -1:] - csum)         # (B,L,H,K)
            S_ = torch.exp(csum[:, -1])[..., None] * S_ + torch.einsum(
                "blhk,blhv->bhkv", k_c * dec_end, v_c)
            ys.append(y_state + y_intra)
        y = torch.cat(ys, dim=1)

    y = y.reshape(B_, S, d)
    y = nn.rms_norm(p["ln_out"], y.to(x.dtype), cfg.rms_eps) * g
    return nn.dense(p["wo"], y), RWKVState(wkv=S_, shift=new_shift)


def rwkv_decode(p, cfg: ModelConfig, x, state: RWKVState):
    """Single-token step (B,1,d)."""
    K = cfg.ssm.head_dim
    d = cfg.d_model
    H = d // K
    B_ = x.shape[0]
    r, k, v, g, logw, new_shift = _rwkv_project(p, cfg, x, state.shift)
    r_t = _heads(r, H, K)[:, 0]
    k_t = _heads(k, H, K)[:, 0]
    v_t = _heads(v, H, K)[:, 0]
    lw_t = logw.reshape(B_, 1, H, K)[:, 0]
    kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
    out = torch.einsum("bhk,bhkv->bhv", r_t,
                       state.wkv + p["u"][None, :, :, None] * kv)
    S_new = torch.exp(lw_t)[..., None] * state.wkv + kv
    y = out.reshape(B_, 1, d)
    y = nn.rms_norm(p["ln_out"], y.to(x.dtype), cfg.rms_eps) * g
    return nn.dense(p["wo"], y), RWKVState(wkv=S_new, shift=new_shift)


def init_rwkv_state(cfg: ModelConfig, B: int, dtype, device) -> RWKVState:
    K = cfg.ssm.head_dim
    H = cfg.d_model // K
    return RWKVState(
        wkv=torch.zeros((B, H, K, K), dtype=torch.float32, device=device),
        shift=torch.zeros((B, 1, cfg.d_model), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# RWKV channel mix (the FFN half of an RWKV block)
# ---------------------------------------------------------------------------

def init_rwkv_cmix(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device):
    return {
        "mu": torch.full((cfg.d_model,), 0.5, dtype=torch.float32,
                         device=device),
        "wk": nn.dense_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
        "wv": nn.dense_init(generator, cfg.d_ff, cfg.d_model, dtype, device,
                            scale=cfg.d_ff ** -0.5),
    }


def rwkv_cmix(p, cfg: ModelConfig, x, shift):
    """Channel mix of x (B,S,d) after ``shift`` (B,1,d); returns (y, the
    new shift)."""
    xprev = torch.cat([shift, x[:, :-1]], dim=1)
    mu = p["mu"].to(x.dtype)
    xk = x * mu + xprev * (1 - mu)
    h = torch.square(torch.relu(nn.dense(p["wk"], xk)))
    return nn.dense(p["wv"], h), x[:, -1:]
