"""Per-device cost of one call of a function, counted op by op as it runs
(the port's counterpart of ``repro.launch.hlo_analysis``, which it
replaces).

A PyTorch program has no partitioned HLO module to parse. Instead
``count`` runs the function under ``OpCounter``, a ``TorchDispatchMode``
that sees every op on *local* tensors: a ``DTensor`` op is handed back to
``DTensor`` (``NotImplemented``), which desugars it into its local op and
the collectives of its redistributions, and those reach the mode with
per-device shapes. It sums, as ``hlo_analysis`` reports them:

* ``flops``: ``FlopCounterMode``'s FLOP formulas (``torch.utils.
  flop_counter.flop_registry``: 2·M·N·K a matmul, the convolutions and
  attention ops) on the local shapes;
* ``hbm_bytes``: the bytes of every tensor an op reads and writes (its
  tensor arguments and results) for every op that is not a view (an op
  whose result aliases its input moves nothing). Eager PyTorch fuses
  nothing, so this is what a run would move, not what a fused program
  would;
* collective payload bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``point-to-point``) of every
  ``_c10d_functional`` op: the result's bytes, the (larger) operand's
  for a reduce-scatter.

A Python loop runs its body once a trip, so every trip is counted: what
``hlo_analysis``'s trip-count weighting of while loops restores. The
backward of an autograd graph and the recompute of a checkpointed layer
run under the mode too and are counted as they run.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "point-to-point")

# _c10d_functional op name -> collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "point-to-point",
    "broadcast_": "point-to-point",
    "send": "point-to-point",
    "recv": "point-to-point",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpCounter(TorchDispatchMode):
    """Sums FLOPs, memory bytes and collective bytes of the local ops that
    run while it is active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collective = dict.fromkeys(KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into local ops
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = _nbytes(out)
                if kind == "reduce-scatter":
                    n = max(n, _nbytes((args, kwargs)))
                self.collective[kind] += n
        elif not _is_view(func):
            self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def report(self) -> dict:
        coll = dict(self.collective)
        coll["total"] = sum(coll[k] for k in KINDS)
        return dict(flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
                    collective_bytes=coll)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), report)``: the report of ``OpCounter``
    over the one call."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.report()
