"""AdamW with fp32 state, cosine schedule, global-norm clipping (PyTorch
port of ``repro.optim.adamw``).

The state is ``dict(m=..., v=..., step=...)``: ``m`` and ``v`` f32 trees
shaped like the parameters and ``step`` an ``int32`` scalar tensor, as in
the JAX package, so a checkpoint of it has the JAX package's words.

``apply`` updates ``params``, ``m`` and ``v`` in place under
``torch.no_grad()`` (the port's ops work in place) and returns the same
``(params, state, diagnostics)`` triple as the JAX function, with a new
``step``. Its arithmetic is JAX's ``upd``, op for op: the clip scale, the
bias corrections, decay on matrices only (``ndim >= 2``). Each product
and sum is its own rounded op (no fused multiply-add), and the global
norm sums the leaves' squares in the JAX package's leaf order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: f32 on
    ``step``'s device."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


def init(params: Any):
    """Zero ``m`` and ``v`` (f32, on each parameter's device) and step 0 (on
    the first parameter's)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return dict(m=tree_map(zeros, params), v=tree_map(zeros, params),
                step=torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device))


def global_norm(grads: Any) -> torch.Tensor:
    """The f32 L2 norm of all gradient leaves, summed in leaf order."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Any, state: Any, params: Any):
    """One AdamW step. Returns (params, state, diagnostics); ``params``,
    ``state["m"]`` and ``state["v"]`` are the trees passed in, updated in
    place, and ``grads`` is left as it was."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        tmp = g.square().mul_(1 - cfg.b2)           # (1 - b2) * g²
        v.mul_(cfg.b2).add_(tmp)                    # v = b2 v + (1 - b2) g²
        m.mul_(cfg.b1).add_(g.mul_(1 - cfg.b1))     # m = b1 m + (1 - b1) g
        torch.div(v, bc2, out=tmp).sqrt_().add_(cfg.eps)
        upd = torch.div(m, bc1, out=g).div_(tmp)    # (m / bc1) / (√(v / bc2) + eps)
        pf = p.float()                              # p itself when f32
        if p.ndim >= 2:  # decay matrices only (standard practice)
            upd.add_(torch.mul(pf, cfg.weight_decay, out=tmp))
        pf.sub_(upd.mul_(lr))
        if pf is not p:
            p.copy_(pf)
    return params, dict(m=state["m"], v=state["v"], step=step), dict(
        grad_norm=gnorm, lr=lr)
