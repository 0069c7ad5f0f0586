"""Bit-level layout of SnapStore L2 index entries (PyTorch port).

The same layout as ``repro.core.format`` (sQEMU §5.2): an entry is two
32-bit words.

``word0`` (data pointer + cluster flags)::

    bits [0, 28)   page_ptr   — row index into the global page pool
    bit  28        ENCRYPTED  — feature-preservation flag (carried, not used)
    bit  29        COLD       — tier-residency bit (host tier)
    bit  30        ZERO       — "reads as zeros" cluster (qcow2 v3 feature)
    bit  31        ALLOCATED  — entry describes an allocated page

``word1`` (sQEMU extension; all-zero in vanilla-format images)::

    bits [0, 16)   backing_file_index (bfi)
    bit  16        BFI_VALID — set iff written in scalable (sQEMU) format

The all-zeros entry means "unallocated", exactly as in Qcow2.

**Carrier type.** torch's ``uint32`` has no ``>>`` or ``max`` on the CPU,
so the port carries words as ``int32`` holding the same 32 bits. ALLOCATED
is bit 31, the sign bit of an ``int32``: test flags with ``!= 0``, never
``> 0``. The python-int constants below keep their unsigned values (what
numpy ``uint32`` arrays and the CUDA sources use); ``*_I32`` are the same
bits as ``int32`` scalars for tensor arithmetic. ``words`` converts any
host array of packed words to the ``int32`` carrier bit for bit.

This module is the one home of the bit layout: the CUDA kernels receive
it as ``-D`` macros generated by ``cuda_macros`` at build time.
"""

from __future__ import annotations

import numpy as np
import torch

ENTRY_WORDS = 2

PTR_BITS = 28
PTR_MASK = (1 << PTR_BITS) - 1

FLAG_ENCRYPTED = 1 << 28
FLAG_COLD = 1 << 29
FLAG_ZERO = 1 << 30
FLAG_ALLOCATED = 1 << 31

BFI_BITS = 16  # paper §5.2: "We use 16 bits to encode backing_file_index"
BFI_MASK = (1 << BFI_BITS) - 1
FLAG_BFI_VALID = 1 << BFI_BITS

MAX_CHAIN_REPRESENTABLE = 1 << BFI_BITS
MAX_POOL_ROWS = 1 << PTR_BITS

WORD_DTYPE = torch.int32


def to_i32(value: int) -> int:
    """The ``int32`` value holding the same 32 bits as unsigned ``value``."""
    value &= (1 << 32) - 1
    return value - (1 << 32) if value >= (1 << 31) else value


FLAG_ALLOCATED_I32 = to_i32(FLAG_ALLOCATED)
FLAG_ZERO_I32 = to_i32(FLAG_ZERO)
FLAG_COLD_I32 = to_i32(FLAG_COLD)


def words(x, device=None) -> torch.Tensor:
    """Packed words (numpy ``uint32``/``int32``, list, or tensor) as the
    ``int32`` carrier, bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=WORD_DTYPE)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    else:
        a = (a.astype(np.int64) & ((1 << 32) - 1)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.array(a)).to(device or "cpu")


def _flag(mask_like, value: int, like: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(mask_like, dtype=torch.bool, device=like.device)
    return torch.where(m, torch.tensor(value, dtype=WORD_DTYPE, device=like.device),
                       torch.tensor(0, dtype=WORD_DTYPE, device=like.device))


def pack_entry(ptr, bfi, *, allocated, bfi_valid, zero=False, cold=False):
    """Pack entry fields into a ``(..., 2) int32`` tensor.

    ``ptr``/``bfi`` are integer tensors (broadcastable); ``allocated``,
    ``bfi_valid``, ``zero``, ``cold`` are boolean tensors or python bools.
    """
    ptr = torch.as_tensor(ptr)
    dev = ptr.device
    ptr = ptr.to(torch.int64) & PTR_MASK
    bfi = torch.as_tensor(bfi, device=dev).to(torch.int64) & BFI_MASK
    ptr, bfi = torch.broadcast_tensors(ptr, bfi)
    ptr = ptr.to(WORD_DTYPE)
    bfi = bfi.to(WORD_DTYPE)
    alloc = torch.as_tensor(allocated, dtype=torch.bool, device=dev)
    w0 = ptr | _flag(alloc, FLAG_ALLOCATED_I32, ptr)
    w0 = w0 | _flag(zero, FLAG_ZERO_I32, ptr)
    w0 = w0 | _flag(cold, FLAG_COLD_I32, ptr)
    w1 = bfi | _flag(bfi_valid, FLAG_BFI_VALID, ptr)
    # An unallocated entry is all-zeros (Qcow2 convention).
    w0 = torch.where(alloc, w0, torch.zeros_like(w0))
    w1 = torch.where(alloc, w1, torch.zeros_like(w1))
    w0, w1 = torch.broadcast_tensors(w0, w1)
    return torch.stack([w0, w1], dim=-1)


def empty_entries(shape, device) -> torch.Tensor:
    """All-zero (unallocated) entries of the given leading shape."""
    return torch.zeros(tuple(shape) + (ENTRY_WORDS,), dtype=WORD_DTYPE,
                       device=device)


def entry_ptr(entries):
    return entries[..., 0] & PTR_MASK


def entry_allocated(entries):
    return (entries[..., 0] & FLAG_ALLOCATED_I32) != 0


def entry_zero(entries):
    return (entries[..., 0] & FLAG_ZERO_I32) != 0


def entry_cold(entries):
    """Tier-residency bit: True where ``ptr`` addresses the host tier."""
    return (entries[..., 0] & FLAG_COLD_I32) != 0


def entry_bfi(entries):
    return entries[..., 1] & BFI_MASK


def entry_bfi_valid(entries):
    return (entries[..., 1] & FLAG_BFI_VALID) != 0


def cuda_macros() -> list[str]:
    """``nvcc`` ``-D`` flags carrying this layout into ``csrc/*.cu``, as
    unsigned 32-bit literals (the kernels read words as ``uint32_t``)."""
    consts = dict(
        FMT_PTR_MASK=PTR_MASK,
        FMT_FLAG_ALLOCATED=FLAG_ALLOCATED,
        FMT_FLAG_ZERO=FLAG_ZERO,
        FMT_FLAG_COLD=FLAG_COLD,
        FMT_BFI_MASK=BFI_MASK,
        FMT_FLAG_BFI_VALID=FLAG_BFI_VALID,
    )
    return [f"-D{name}={value:#x}u" for name, value in consts.items()]
