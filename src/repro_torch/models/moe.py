"""Mixture-of-Experts feed-forward: shared + routed top-k experts (PyTorch
port of ``repro.models.moe``).

Dispatch is sort-based with per-group capacity, as in the JAX package:
token→expert assignments are stably argsorted, ranked within their expert
segment and scattered into a dense ``(groups, E, capacity, d)`` buffer;
assignments ranked past the capacity are dropped, and a load-balance aux
loss is returned beside the output. The JAX package's sharding hints
(``lshard``) sit at the same three points: the groups split over the
dispatch (data) axes, the expert buffers over the expert (model) axis.
Under sharding rules ``dispatch`` and ``combine``, which have no
``DTensor`` sharding rule (``searchsorted``, ``scatter_``, ``gather``),
run on each rank's groups (``sharding.local_batch``); without rules, or
on plain tensors, every hint is a no-op.

``moe_apply`` is four steps, each a function of this module: ``route``
(router, softmax, top-k), ``dispatch`` (ranks, capacity, the buffer),
``expert_products`` (the three batched products) and ``combine`` (gather
back, weight, sum), then the ``shared_expert``. Every step runs on the
device from shapes alone: the capacity is a Python int and nothing syncs.

Ordering that decides results, kept from the JAX package:
- ties among router probabilities go to the lower expert index (what
  ``jax.lax.top_k`` does; ``torch.topk`` promises no order), so the
  top k come from a stable descending sort;
- ranks within an expert follow the flattened (token, k) order of a
  stable argsort, so the first ``cap`` assignments in token order stay;
- dropped assignments go to a sink row past the ``E * cap`` slots, which
  is cut off (JAX's ``mode="drop"`` scatter), and combine gives them 0;
- the combine rounds the weights to the compute dtype, then weights and
  sums the k expert outputs in f32 and rounds once: ``jnp.sum`` of a
  bf16 array accumulates in f32, and XLA keeps the weighted products in
  f32 too (its optimized HLO for the JAX combine); one bf16 rounding per
  product or per add differs from it in about a third of the outputs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import as_device
from repro_torch.distributed.sharding import local_batch, lshard, pin_grad
from repro_torch.models import layers as L


def moe_init(cfg: ModelConfig, generator: torch.Generator, *,
             dtype=L.PARAM_DTYPE, device="cuda"):
    """One MoE layer's weights with the JAX init's distributions and
    scales: ``router`` (d, E), ``e_gate``/``e_up`` (E, d, f), ``e_down``
    (E, f, d), and with shared experts ``shared`` (a gated MLP of width
    ``n_shared_experts * moe_d_ff``) and ``shared_gate`` (d, 1)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=as_device(device))
    p = dict(
        router=L.dense_init(generator, d, e, scale=0.02, **kw),
        e_gate=L.normal_init(generator, (e, d, f), 1.0 / math.sqrt(d), **kw),
        e_up=L.normal_init(generator, (e, d, f), 1.0 / math.sqrt(d), **kw),
        e_down=L.normal_init(generator, (e, f, d),
                         1.0 / math.sqrt(2.0 * cfg.n_layers * f), **kw),
    )
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        p["shared"] = L.mlp_init(generator, d, fs, gated=True,
                                 n_layers_scale=cfg.n_layers, **kw)
        p["shared_gate"] = L.dense_init(generator, d, 1, scale=0.02, **kw)
    return p


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Expert slots per group: ``tokens · k / E · capacity_factor``,
    rounded up to a multiple of 8, at least 8."""
    cap = int(tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def route(cfg: ModelConfig, p, xt):
    """xt: (g, tg, d) → ``probs`` (g, tg, E) f32, ``top_p`` (g, tg, k)
    renormalised f32 and ``top_i`` (g, tg, k) int64. The logits come out
    of the compute dtype's matmul and are cast to f32 after it."""
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., : cfg.top_k], top_i[..., : cfg.top_k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def aux_loss(probs, top_i, n_experts: int):
    """Switch-style load-balance loss: E · Σ_e (mean prob)·(share of the
    top-k assignments)."""
    k = top_i.shape[-1]
    pe = probs.mean(dim=(0, 1))
    fe = torch.nn.functional.one_hot(top_i, n_experts).float().sum(dim=2)
    fe = fe.mean(dim=(0, 1)) / k
    return n_experts * (pe * fe).sum()


def dispatch(xt, top_i, n_experts: int, cap: int):
    """Scatter each group's kept assignments into its expert slots.

    xt: (g, tg, d); top_i: (g, tg, k). Returns ``buf`` (g, E, cap, d), the
    tokens in their slots and zeros elsewhere, and ``slot`` (g, tg·k): each
    assignment's slot in (token, k) order, ``E · cap`` where it was
    dropped."""
    g, tg, d = xt.shape
    n = top_i.shape[-1] * tg
    sink = n_experts * cap
    flat_e = top_i.reshape(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n, device=xt.device) - first
    slot_sorted = torch.where(rank < cap, sorted_e * cap + rank, sink)
    tok_sorted = order // top_i.shape[-1]
    buf = xt.new_zeros((g, sink + 1, d))
    # dropped assignments all land in the sink row, which is cut off
    buf.scatter_(1, slot_sorted[..., None].expand(g, n, d),
                 xt.gather(1, tok_sorted[..., None].expand(g, n, d)))
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return buf[:, :sink].reshape(g, n_experts, cap, d), slot


def expert_products(p, buf):
    """Every expert's gated MLP over its slots, empty ones included:
    buf (g, E, cap, d) → (g, E, cap, d) in the compute dtype."""
    cd = buf.dtype
    h = torch.einsum("gecd,edf->gecf", buf, p["e_up"].to(cd))
    gate = torch.einsum("gecd,edf->gecf", buf, p["e_gate"].to(cd))
    h = L.activation_fn("silu")(gate) * h
    return torch.einsum("gecf,efd->gecd", h, p["e_down"].to(cd))


def combine(out_buf, slot, top_p):
    """Each token's k expert outputs weighted by ``top_p`` (rounded to the
    compute dtype) and summed in f32, dropped ones as zeros, rounded once:
    out_buf (g, E, cap, d), slot (g, tg·k), top_p (g, tg, k) → (g, tg, d)."""
    g, e, cap, d = out_buf.shape
    tg, k = top_p.shape[1:]
    flat = out_buf.reshape(g, e * cap, d)
    picked = flat.gather(1, slot.clamp(max=e * cap - 1)[..., None]
                         .expand(g, tg * k, d))
    picked = torch.where((slot < e * cap)[..., None], picked, 0.0)
    w = top_p[..., None].to(out_buf.dtype).float()
    return (picked.reshape(g, tg, k, d).float() * w).sum(dim=2).to(out_buf.dtype)


def shared_expert(p, x):
    """The shared experts' gated MLP times its f32 sigmoid gate (computed
    as XLA expands it, 1 / (1 + exp(-z))), in the compute dtype."""
    cd = x.dtype
    sh = L.mlp_apply(p["shared"], x, "silu")
    z = (x @ p["shared_gate"].to(cd)).float()
    return sh * (1 / (1 + torch.exp(-z))).to(cd)


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, S, d) → (out (B, S, d), aux_loss f32 scalar). The B·S tokens
    are split into ``cfg.dispatch_groups`` groups (the group axis is a
    batch axis), each with its own capacity; padded rows are routed like
    any other and take capacity, as in the JAX package."""
    b, s, d = x.shape
    g = cfg.dispatch_groups
    t = b * s
    if t % g:
        raise ValueError(f"dispatch_groups {g} must divide token count {t}")
    cap = capacity(t // g, cfg)
    # the batch split over the DP axes alone, then through (t, d): DTensor's
    # view rules take a flatten and a split one at a time
    x = lshard(x, "batch", "seq", "embed")
    xt = pin_grad(lshard(x.reshape(t, d).reshape(g, t // g, d), "dispatch", None,
                         "embed"))
    probs, top_p, top_i = route(cfg, p, xt)
    aux = aux_loss(probs, top_i, cfg.n_experts)
    buf, slot = local_batch(lambda xg, ig: dispatch(xg, ig, cfg.n_experts, cap),
                            (xt, 0), (top_i, 0), axis="dispatch")
    buf = lshard(buf, "dispatch", "expert", None, "embed")
    out_buf = lshard(expert_products(p, buf), "dispatch", "expert", None,
                     "embed")
    out = local_batch(combine, (out_buf, 0), (slot, 0), (top_p, 0),
                      axis="dispatch")
    out = pin_grad(out.reshape(t, d).reshape(b, s, d))
    if "shared" in p:
        out = out + shared_expert(p, x)
    return out, aux
