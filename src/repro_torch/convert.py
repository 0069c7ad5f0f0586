"""Carry the JAX package's weights and fleet state into the port.

Both functions take plain numpy arrays (``np.asarray`` of each JAX leaf),
so the port never imports JAX: tests convert on their side and hand the
arrays over, and both packages then compute on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.fleet import ChainFleet, FleetSpec
from repro_torch.device import as_device


def params_from_jax(tree, device="cuda", dtype=None):
    """The JAX params pytree as numpy — ``embed``, ``ln_f``, ``w_out`` and
    ``layers`` stacked on a leading L axis with ``ln1``, ``ln2``,
    ``attn.{wq,wk,wv,wo,bq,bk,bv}``, ``ff.{w_up,w_gate,w_down}`` — as the
    port's params on ``device`` (leaves keep their dtype unless ``dtype``
    is given)."""
    dev = as_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


#: ChainFleet tensor fields, in declaration order.
FLEET_FIELDS = ("l1", "l2", "pool", "lease_owner", "lease_index",
                "lease_count", "alloc_count", "length", "scalable",
                "overflow", "snap_dropped", "cold_count")


def fleet_from_numpy(spec: FleetSpec, arrays: dict, device="cuda") -> ChainFleet:
    """A ``ChainFleet`` from numpy arrays keyed by ``FLEET_FIELDS`` (the
    JAX fleet's leaves). Packed ``uint32`` words (``l1``, ``l2``) become
    the ``int32`` carrier bit for bit."""
    dev = as_device(device)
    out = {}
    for name in FLEET_FIELDS:
        a = np.asarray(arrays[name])
        if name in ("l1", "l2"):
            out[name] = fmt.words(a, device=dev)
        elif name == "pool":
            out[name] = torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=dev, dtype=spec.dtype)
        elif a.dtype == bool:
            out[name] = torch.from_numpy(a.copy()).to(dev)
        else:
            out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)
    return ChainFleet(spec=spec, **out)
