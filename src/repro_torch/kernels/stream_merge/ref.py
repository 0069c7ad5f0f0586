"""Plain PyTorch version of the streaming-merge kernel.

Line for line the oracle of ``repro.kernels.stream_merge.ref``. The CPU
tests pin it against the JAX oracle and the Pallas kernel in interpret
mode; ``chip_smoke.py`` holds the CUDA kernel (K9) against it on the
card. Pointers are the ``int32`` carrier of ``core.format``.
"""

from __future__ import annotations

import torch


def merge_ref(alloc, ptrs, bfi=None):
    """Merge K snapshot layers into one (paper's streaming job).

    alloc/ptrs: (K, N); ``alloc`` bool or int (tested ``!= 0``), ``ptrs``
    int32. For each page, take the entry of the highest allocated layer.
    ``bfi`` is accepted for the JAX signature and unused, as there.
    Returns (found (N,) bool, ptr (N,) int32 — the JAX ``uint32``
    pointer's bits, 0 where absent, src_layer (N,) int32 [-1 if absent]).
    """
    k = alloc.shape[0]
    idx = torch.arange(k, dtype=torch.int32, device=alloc.device)[:, None]
    src = torch.where(alloc != 0, idx, -1).amax(dim=0)
    found = src >= 0
    ptr = torch.gather(ptrs, 0, src.clamp(min=0)[None].to(torch.int64))[0]
    return (found, torch.where(found, ptr, 0).to(torch.int32),
            src.to(torch.int32))
