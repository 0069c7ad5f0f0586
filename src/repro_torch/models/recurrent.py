"""Chunked, remat-friendly time scans for the recurrent families (RWKV6,
Mamba2): the PyTorch port of ``repro.models.recurrent``.

The projections run over the whole sequence outside the recurrence; the
scan body carries only the small recurrent state. The time axis goes in
chunks: with ``remat`` each chunk runs under a non-reentrant
``torch.utils.checkpoint``, so the backward keeps one carry a chunk and
recomputes the chunk's steps, and its memory is O(S / chunk × state)
instead of O(S × state). The per-step body is a Python loop over time:
a few small kernels a token, on the card as on the CPU.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.models import layers as L


def _loop(n: int, trip, carry, xs, remat=None):
    """``carry, y_t = trip(t, carry)`` for ``t < n``, each trip under
    ``remat(trip, t, carry)`` if given: the last carry and the ``y_t``.
    An active dispatch mode with a ``loop`` method may run the trips its
    own way and gets ``xs`` to tell whether it may (the dry-run's op
    counter, which on ``meta`` tensors counts a few trips for all)."""
    runner = getattr(_get_current_dispatch_mode(), "loop", None)
    out = runner(n, trip, carry, xs, remat) if runner is not None else None
    if out is not None:
        return out
    ys = []
    for t in range(n):
        carry, y = trip(t, carry) if remat is None else remat(trip, t, carry)
        ys.append(y)
    return carry, ys


def _scan(step_fn, carry, xs):
    """``lax.scan`` over axis 0 of each tensor of ``xs``."""
    carry, ys = _loop(xs[0].shape[0],
                      lambda t, c: step_fn(c, tuple(x[t] for x in xs)),
                      carry, xs)
    return carry, torch.stack(ys)


def chunked_time_scan(step_fn, carry, xs, *, chunk: int = 64, remat: bool = True):
    """Scan ``step_fn`` over the time axis (axis 0 of each tensor of the
    tuple ``xs``). step_fn: (carry, x_t) -> (carry, y_t). Returns (carry,
    ys) with ys stacked over time, like ``lax.scan``.

    A sequence longer than ``chunk`` is padded with zeros to whole chunks
    and the pad steps run, as in the JAX package: where the length is not
    a multiple of ``chunk`` the carry returned is the one after the pad
    steps (the outputs are cut back to the length)."""
    xs = tuple(xs)
    length = xs[0].shape[0]
    if length <= chunk:
        return _scan(step_fn, carry, xs)
    n_chunks = -(-length // chunk)
    pad = n_chunks * chunk - length
    if pad:
        xs = tuple(torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
                   for x in xs)

    def one_chunk(c, carry):
        return _scan(step_fn, carry,
                     tuple(x[c * chunk:(c + 1) * chunk] for x in xs))

    carry, ys = _loop(n_chunks, one_chunk, carry, xs,
                      functools.partial(L.remat_call, remat))
    return carry, torch.cat(ys)[:length]


def causal_depthwise_conv(x, w, b, *, prev=None):
    """Causal depthwise 1-D conv over time. x: (B, S, C); w: (K, C).

    ``prev``: (B, K-1, C) carried context for streaming decode (None:
    zero history). Returns (out (B, S, C), new_prev)."""
    k = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)          # (B, S+K-1, C)
    taps = [(xp[:, i:i + x.shape[1]], w[i].to(x.dtype)) for i in range(k)]
    bias = b.to(x.dtype)
    # the taps' products summed and the bias added with the fused
    # multiply-adds XLA contracts the JAX loop's ``out + xp * w`` into
    # (``addcmul``): one tap is one fma onto the bias; with more, tap 0
    # goes onto tap 1's rounded product, each later tap onto the sum
    if k == 1:
        return torch.addcmul(bias, *taps[0]), prev
    out = torch.addcmul(taps[1][0] * taps[1][1], *taps[0])
    for xi, wi in taps[2:]:                               # K is tiny (4)
        out = torch.addcmul(out, xi, wi)
    out = out + bias
    return out, xp[:, -(k - 1):]


def token_shift(x, prev):
    """RWKV token shift: x_{t-1} along time. x: (B, S, d); prev: (B, d)."""
    shifted = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return shifted, x[:, -1]
