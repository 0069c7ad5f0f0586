"""The training step: loss → grads → AdamW, with optional grad accumulation
(PyTorch port of ``repro.train.train_step``)."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import lshard
from repro_torch.models.api import LM
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten


def value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss runs on
    detached leaves that require grad (the parameters themselves never
    do); returns the detached loss and a gradient tree shaped like
    ``params`` (zeros for a leaf the loss does not use)."""
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig, *,
                    accum_steps: int = 1, cast_bf16: bool = False,
                    grad_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    ``accum_steps > 1`` splits the batch along axis 0 into microbatches and
    accumulates grads in f32 (the memory knob for big train cells).
    ``cast_bf16`` casts matrix params (f32, ``ndim >= 2``) to bf16 before
    the loss; the gradients flow back to the f32 leaves.
    ``grad_shardings`` (a tree of ``distributed.sharding.NamedSharding``
    shaped like the parameters) pins each ``DTensor`` gradient, and the
    accumulation carry, to its parameter's placements, so the FSDP shards
    take reduce-scattered gradients instead of full-size all-reduced ones;
    plain-tensor gradients pass through unchanged.

    ``adamw.apply`` then updates ``params`` and ``opt_state`` in place and
    the step returns those same trees."""

    def pin(tree):
        if grad_shardings is None or not any(
                isinstance(g, DTensor) for g in leaves(tree)):
            return tree
        return tree_map(
            lambda g, s: g.redistribute(s.mesh, s.placements_for(g.shape))
            if isinstance(g, DTensor) else g, tree, grad_shardings)

    def loss_fn(params, batch):
        if cast_bf16:
            params = tree_map(
                lambda p: p.to(torch.bfloat16)
                if p.ndim >= 2 and p.dtype == torch.float32 else p,
                params)
        return model.loss(params, batch)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = pin(grads)
        else:
            def micro(i):
                # a sharded batch is gathered first, so microbatch i holds
                # rows i·B/accum.. as on one device, then split again
                rest = lambda x: (None,) * (x.ndim - 1)  # noqa: E731
                return {k: lshard(lshard(x, None, *rest(x)).reshape(
                    (accum_steps, -1) + tuple(x.shape[1:]))[i], "batch", *rest(x))
                        for k, x in batch.items()}

            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = pin(tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))
            for i in range(accum_steps):
                l, g = value_and_grad(loss_fn, params, micro(i))
                grads = pin(tree_map(lambda a, b: a + b.float(), grads, pin(g)))
                loss = loss + l
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, grads)
        params, opt_state, diag = adamw.apply(opt_cfg, grads, opt_state, params)
        return params, opt_state, dict(loss=loss, **diag)

    return train_step


def init_state(model: LM, generator: torch.Generator, device="cuda"):
    """Fresh parameters drawn from ``generator`` and their AdamW state."""
    params = model.init(generator, device=device)
    return params, adamw.init(params)
