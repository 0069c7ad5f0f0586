"""The training step: loss → grads → AdamW, with optional grad accumulation
(PyTorch port of ``repro.train.train_step``)."""

from __future__ import annotations

import torch

from repro_torch.models.api import LM
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig, *,
                    accum_steps: int = 1, cast_bf16: bool = False,
                    grad_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    ``accum_steps > 1`` splits the batch along axis 0 into microbatches and
    accumulates grads in f32 (the memory knob for big train cells).
    ``cast_bf16`` casts matrix params (f32, ``ndim >= 2``) to bf16 before
    the loss; the gradients flow back to the f32 leaves. ``grad_shardings``
    pins the gradient sharding in the JAX package; on one device there is
    nothing to shard, so it is accepted and ignored.

    Autograd takes the place of ``jax.value_and_grad``: the loss runs on
    detached leaves that require grad (the parameters themselves never do),
    so ``adamw.apply`` then updates ``params`` and ``opt_state`` in place
    and the step returns those same trees."""
    del grad_shardings

    def loss_fn(params, batch):
        if cast_bf16:
            params = tree_map(
                lambda p: p.to(torch.bfloat16)
                if p.ndim >= 2 and p.dtype == torch.float32 else p,
                params)
        return model.loss(params, batch)

    def value_and_grad(params, batch):
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            def micro(i):
                return {k: x.reshape((accum_steps, -1) + tuple(x.shape[1:]))[i]
                        for k, x in batch.items()}

            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(accum_steps):
                l, g = value_and_grad(params, micro(i))
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
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
