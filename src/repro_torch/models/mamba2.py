"""Mamba2 (SSD) block: selective state-space recurrence (PyTorch port of
``repro.models.mamba2``).

Projections and the causal depthwise conv run over the full sequence;
the diagonal-decay rank-1 state update runs in a chunked time scan
(``recurrent.chunked_time_scan``). State per layer: h (B, nH, headD, N)
f32 and the conv context (B, K-1, conv_channels).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_batch, merge_last, split_last
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def block_init(cfg: ModelConfig, generator: torch.Generator, *, dtype, device):
    """One block's weights, with the JAX init's distributions and scales."""
    d, din, nh = cfg.d_model, d_inner(cfg), n_ssm_heads(cfg)
    conv_ch = din + 2 * cfg.ssm_state
    kw = dict(dtype=dtype, device=device)
    return dict(
        ln=torch.ones((d,), **kw),
        in_proj=L.dense_init(generator, d, 2 * din + 2 * cfg.ssm_state + nh, **kw),
        conv_w=L.normal_init(generator, (cfg.ssm_conv, conv_ch), 0.1, dtype, device),
        conv_b=torch.zeros((conv_ch,), **kw),
        a_log=torch.log(torch.linspace(1.0, 16.0, nh)).to(**kw),
        d_skip=torch.ones((nh,), **kw),
        dt_bias=torch.zeros((nh,), **kw),
        norm=torch.ones((din,), **kw),
        out_proj=L.dense_init(generator, din, d,
                              scale=1.0 / math.sqrt(2.0 * cfg.n_layers * din), **kw),
    )


def _ssm_step(hstate, inp):
    """h ← a_t h + dt_t x_t b_tᵀ; y = h c_t. hstate: (B, nh, hd, N)."""
    x_t, b_t, c_t, dt_t, a_t = inp
    dbx = (dt_t[..., None] * x_t)[..., None] * b_t[:, None, None, :]
    hstate = a_t[..., None, None] * hstate + dbx
    return hstate, torch.einsum("bhdn,bn->bhd", hstate, c_t)


def block_apply(cfg: ModelConfig, p, x, conv_prev, ssm_state):
    """x: (B, S, d). Returns (out, new_conv_prev, new_ssm_state)."""
    cd = x.dtype
    din, nh, hd, st = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state

    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"].to(cd)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * st, nh], dim=-1)
    xbc, conv_prev = R.causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"],
                                             prev=conv_prev)
    xbc = L.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [din, st, st], dim=-1)
    xs = split_last(xs, nh).float()
    bmat, cmat = bmat.float(), cmat.float()               # (B, S, N)
    dt = L.softplus(dt.float() + p["dt_bias"])             # (B, S, nh)
    decay = torch.exp(-torch.exp(p["a_log"].float())[None, None] * dt)

    inputs = tuple(a.movedim(1, 0) for a in (xs, bmat, cmat, dt, decay))
    ssm_state, ys = local_batch(   # each rank's batch rows (a no-op unsharded)
        lambda st, xs: R.chunked_time_scan(_ssm_step, st, xs, chunk=cfg.scan_chunk,
                                           remat=cfg.remat),
        (ssm_state, 0), (inputs, 1), out_dims=(0, 1))
    y = ys.movedim(0, 1)                                  # (B, S, nh, hd)
    y = y + p["d_skip"].float()[None, None, :, None] * xs
    y = merge_last(y).to(cd)
    y = L.rmsnorm(y * L.silu(z), p["norm"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(cd), conv_prev, ssm_state


def state_shapes(cfg: ModelConfig, batch: int):
    conv_ch = d_inner(cfg) + 2 * cfg.ssm_state
    return (
        (batch, cfg.ssm_conv - 1, conv_ch),
        (batch, n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state),
    )
