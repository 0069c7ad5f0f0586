"""Carry the JAX package's weights, training state, chain, fleet and
cold-tier state into the port.

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
    """The JAX params pytree as numpy, any family's, as the port's params
    on ``device``: every leaf goes through float32 (which holds every bf16
    value exactly) and is stored in ``dtype``, float32 by default. The
    trees (layer leaves stacked on a leading L axis):

    - dense and MoE: ``embed``, ``ln_f``, ``w_out`` and ``layers`` with
      ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}`` (and ``bq,bk,bv`` with a
      QKV bias, ``q_norm,k_norm`` with qk-norm), and ``ff.{w_up,w_gate,
      w_down}`` (no ``w_gate`` in an ungated MLP) or, in a MoE layer,
      ``ff.{router,e_gate,e_up,e_down}`` (the experts (L, E, ...)) with
      ``ff.shared.{w_gate,w_up,w_down}`` and ``ff.shared_gate`` where the
      config has shared experts;
    - RWKV-6 (24 leaves): ``embed``, ``ln_f_g``, ``ln_f_b``, ``w_out`` and
      ``layers.{ln1_g,ln1_b,ln2_g,ln2_b,mu,w_r,w_k,w_v,w_g,wo,w0,
      w_lora_a,w_lora_b,u,lnx_g,lnx_b,mu_ff,wk_ff,wv_ff,wr_ff}``;
    - Zamba2: ``embed``, ``ln_f``, ``w_out``, the Mamba2 ``layers.{ln,
      in_proj,conv_w,conv_b,a_log,d_skip,dt_bias,norm,out_proj}`` and the
      one ``shared.{ln1,ln2,attn.{wq,wk,wv,wo},ff.{w_up,w_gate,w_down}}``
      (not stacked);
    - Whisper: ``embed`` (tied), ``ln_f``, ``ln_fb``, ``enc_ln``,
      ``enc_lnb``, ``enc_layers.{ln1,ln1b,ln2,ln2b,attn.*,ff.{w_up,
      w_down}}`` and ``dec_layers`` with those and ``lnx``, ``lnxb``,
      ``xattn.{wq,wk,wv,wo}``.

    Integer leaves would be rounded above 2^24 on the way: a training
    state, whose AdamW step is ``int32``, goes through
    ``train_state_from_jax``."""
    dev = as_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def train_state_from_jax(params, opt_state, device="cuda"):
    """The JAX trainer's ``(params, opt_state)`` as numpy — the params
    pytree of ``params_from_jax`` (any family's) and AdamW's ``dict(m=...,
    v=..., step=...)``, ``m`` and ``v`` trees of the params' shape — as the
    port's ``(params, opt_state)`` on ``device``:
    params, ``m`` and ``v`` float32, ``step`` an ``int32`` scalar taken
    as an integer, never through float32. With the same state both
    trainers' checkpoints hold the same words."""
    dev = as_device(device)
    state = dict(m=params_from_jax(opt_state["m"], dev),
                 v=params_from_jax(opt_state["v"], dev),
                 step=torch.tensor(int(np.asarray(opt_state["step"])),
                                   dtype=torch.int32, device=dev))
    return params_from_jax(params, dev), state


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
