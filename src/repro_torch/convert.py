"""Carry the JAX package's weights, chain, fleet and cold-tier state into
the port.

Every function takes plain numpy arrays (``np.asarray`` of each JAX leaf),
so the port never imports JAX: tests convert on their side and hand the
arrays over, and both packages then compute on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import format as fmt
from repro_torch.core.chain import Chain, ChainSpec
from repro_torch.core.fleet import ChainFleet, FleetSpec
from repro_torch.core.store import TieredStore
from repro_torch.device import as_device


def params_from_jax(tree, device="cuda", dtype=None):
    """The JAX params pytree as numpy — ``embed``, ``ln_f``, ``w_out`` and
    ``layers`` stacked on a leading L axis with ``ln1``, ``ln2``,
    ``attn.{wq,wk,wv,wo}`` (and ``bq,bk,bv`` with a QKV bias, ``q_norm,
    k_norm`` with qk-norm), and ``ff.{w_up,w_gate,w_down}`` (no
    ``w_gate`` in an ungated MLP) or, in a MoE layer, ``ff.{router,
    e_gate,e_up,e_down}`` (the experts (L, E, ...)) with
    ``ff.shared.{w_gate,w_up,w_down}`` and ``ff.shared_gate`` where the
    config has shared experts — as the port's params on ``device`` (leaves
    keep their dtype unless ``dtype`` is given)."""
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


#: Chain tensor fields, in declaration order.
CHAIN_FIELDS = ("l1", "l2", "pool", "pool_cursor", "length", "overflow",
                "snap_dropped")


def _pages(a, dtype, dev) -> torch.Tensor:
    """Page data: a float type (bf16 included) through float32, which holds
    every bf16 value exactly; an integer pool (a checkpoint's ``uint32``
    words) as the ``int32`` carrier by bit view, since float32 would round
    every word above 2^24."""
    if not dtype.is_floating_point:
        return fmt.words(a, device=dev).to(dtype)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev,
                                                               dtype=dtype)


def _tensors(names, arrays: dict, dtype, dev) -> dict:
    out = {}
    for name in names:
        a = np.asarray(arrays[name])
        if name in ("l1", "l2"):
            out[name] = fmt.words(a, device=dev)
        elif name == "pool":
            out[name] = _pages(a, dtype, dev)
        elif a.dtype == bool:
            out[name] = torch.from_numpy(a.copy()).to(dev)
        else:
            out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)
    return out


def fleet_from_numpy(spec: FleetSpec, arrays: dict, device="cuda") -> ChainFleet:
    """A ``ChainFleet`` from numpy arrays keyed by ``FLEET_FIELDS`` (the
    JAX fleet's leaves). Packed ``uint32`` words (``l1``, ``l2``) become
    the ``int32`` carrier bit for bit."""
    dev = as_device(device)
    return ChainFleet(spec=spec, **_tensors(FLEET_FIELDS, arrays, spec.dtype, dev))


def chain_from_numpy(spec: ChainSpec, arrays: dict, *, scalable: bool,
                     device="cuda") -> Chain:
    """A ``Chain`` from numpy arrays keyed by ``CHAIN_FIELDS`` (the JAX
    chain's leaves) and its format flag; words as in ``fleet_from_numpy``."""
    dev = as_device(device)
    return Chain(spec=spec, scalable=bool(scalable),
                 **_tensors(CHAIN_FIELDS, arrays, spec.dtype, dev))


def tiered_store_from_numpy(page_size: int, dtype, data, *, free=(), top: int,
                            demoted_rows: int = 0,
                            promoted_rows: int = 0) -> TieredStore:
    """A ``TieredStore`` holding the JAX store's state: its host array
    ``data`` (capacity and rows), free list, high-water mark ``top`` and
    lifetime counters. Built through the store's own allocator, so the
    free list keeps its order."""
    data = np.asarray(data)
    store = TieredStore(page_size, dtype, initial_rows=data.shape[0])
    rows = store.alloc(int(top))
    store.put(rows, _pages(data[:top], dtype, "cpu"))
    store.free(np.asarray(free, np.int64))
    store.demoted_rows = int(demoted_rows)
    store.promoted_rows = int(promoted_rows)
    return store
