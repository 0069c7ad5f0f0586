"""Device selection, and the dtype names of the blobs, shared by the port.

Every entry point (``Engine``, ``PagedKVCache``, ``fleet.create``, model
init) defaults to ``device="cuda"``. The CPU is used only when the caller
asks for it, as the tests do; with no card and no explicit CPU request the
entry point raises instead of falling back.
"""

from __future__ import annotations

import torch


def as_device(device) -> torch.device:
    """Normalize ``device``; raise if it names CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as numpy spells it (``torch.float32`` →
    ``"float32"``), the ``dtype`` field of the tenant and sequence blobs in
    both packages."""
    return str(dtype).removeprefix("torch.")
