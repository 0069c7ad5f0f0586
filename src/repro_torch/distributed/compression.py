"""Gradient compression: int8 quantized all-reduce with error feedback
(PyTorch port of ``repro.distributed.compression``).

For pure-DP replicas the gradient sum can ship int8 + one f32 scale per
tensor, with the quantization residual carried to the next step (error
feedback), which keeps SGD convergence unaffected to first order.

``compressed_psum`` is the building block over the process group of one
mesh dim: each rank's int8 values and scale are all-gathered and every
rank dequantizes them and sums them in rank order, so the sum is the same
f32 number on every rank and equals the f32 sum of each rank's dequantized
values. An all-gather is not a reduction, so its traffic grows with the
rank count: over ``n`` ranks each rank sends and receives ``(n - 1)``
int8 copies of a leaf (plus their scales) and holds ``n`` of them at
once, where the f32 ring all-reduce it replaces moves ``2 (n - 1) / n``
f32 copies (``wire_bytes``). Compression ships 4x less on 2 ranks, 2x
less on 4, the same on 8 and more beyond, so it pays on a small axis
(``pod``, where links are scarcest), not on the 16-way ``data`` axis.
``make_dp_train_step`` wires it into a manual-collective DP training step
(parameters replicated, the batch split over the ranks). The FSDP/TP
paths keep ``DTensor``'s own collectives (compression there would sit on
the critical path of the matmuls).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.optim import adamw
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor):
    """(q int8, scale f32 scalar): ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round_half_even(x / scale), -127, 127)``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 sum over ``group``. Returns (summed, new_err).

    ``x + err`` is quantized; the residual is the new error state, and the
    result is the f32 sum, in rank order, of every rank's dequantized
    values."""
    y = x.float() + err
    q, scale = quantize_int8(y)
    deq = q.float() * scale
    new_err = torch.addcmul(y, q.float(), scale, value=-1.0)  # fused, as XLA
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(scales, scale, group=group)
    total = qs[0].float() * scales[0]
    for qi, si in zip(qs[1:], scales[1:]):
        total = total + qi.float() * si
    return total, new_err


def wire_bytes(tree: Any, *, compressed: bool, ranks: int) -> int:
    """Bytes one rank sends to sum ``tree`` over ``ranks`` ranks, on a
    ring: the f32 all-reduce sends ``2 (ranks - 1) / ranks`` of its 4
    bytes an element; the int8 all-gather sends each of its ``ranks - 1``
    hops the whole leaf, 1 byte an element and its f32 scale. On 2 ranks
    these are the JAX package's counts (4 bytes an element, or 1 and a
    scale a leaf)."""
    xs = leaves(tree)
    n = sum(x.numel() for x in xs)
    if compressed:
        return (ranks - 1) * (n + 4 * len(xs))
    return 2 * (ranks - 1) * 4 * n // ranks


def init_error_state(params: Any):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_dp_train_step(model, opt_cfg: adamw.AdamWConfig, mesh,
                       *, compress: bool = True, axis: str = "data"):
    """Manual-collective pure-DP train step (params replicated).

    Returns step(params, opt_state, err, batch) -> (params, opt, err, loss).
    ``batch`` is the global batch; each rank of the mesh dim ``axis``
    takes its slice of axis 0. The gradients are divided by the rank
    count, summed over the ranks (int8 with error feedback under
    ``compress``), the loss is averaged, and AdamW updates ``params`` and
    ``opt_state`` in place."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def step(params, opt_state, err, batch):
        local = {k: x.chunk(n)[rank] for k, x in batch.items()}
        loss, grads = value_and_grad(model.loss, params, local)
        if compress:
            out = [compressed_psum(g / n, e, group)
                   for g, e in zip(leaves(grads), leaves(err))]
            grads = unflatten(grads, [s for s, _ in out])
            err = unflatten(err, [e for _, e in out])
        else:
            def psum(g):
                g = g / n
                dist.all_reduce(g, group=group)
                return g

            grads = tree_map(psum, grads)
        params, opt_state, _ = adamw.apply(opt_cfg, grads, opt_state, params)
        dist.all_reduce(loss, group=group)
        return params, opt_state, err, loss / n

    return step
