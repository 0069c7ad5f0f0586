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
* nothing for the ops ``DTensor``'s sharding propagation tries on fake
  tensors (once per op and shape, so a process's first cell would
  otherwise count them);
* collective payload bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``point-to-point``) of every
  ``_c10d_functional`` op: the result's bytes, the (larger) operand's
  for a reduce-scatter.

A Python loop runs its body once a trip, so every trip is counted: what
``hlo_analysis``'s trip-count weighting of while loops restores. The
backward of an autograd graph and the recompute of a checkpointed layer
run under the mode too and are counted as they run.

**Weighted trips.** A time loop of a recurrent model runs tens of
thousands of trips whose costs on ``meta`` tensors are all the same (no
values exist, so no trip can differ). ``models.recurrent`` hands its
loops to the active dispatch mode's ``loop`` method, where there is one;
``OpCounter.loop`` runs a few trips and weights them (``trips``), as
``hlo_analysis`` weights a while body by its trip count: a weighted
trip's ops count ``n`` times, and so do the backward ops of the autograd
nodes the trip created (a hook on each node sets the weight while it
runs; a node keeps the weight it was created with, and a checkpointed
chunk's recompute runs at its forward's weight). What the hooks cannot
see is added back: autograd adds the gradients that reach one node into
its buffer after the sender's hook, one ``add`` (two reads, a write) an
arrival past the first, and a weighted trip sends one gradient where the
trips it stands for send ``n``; the sender's hook counts the adds the
missing arrivals would make. Four trips stand for a loop
(``OpCounter.loop``): the first alone (its carry may
need no gradient), one weighted for the middle trips, the one before the
last alone (the last may leave part of its carry unused) and the last
alone (a recompute stops early inside it). FLOPs, bytes and collective
bytes then equal the every-trip count exactly
(``tests/test_torch_launch.py``). Peak memory does not: a weighted loop
saves one trip's activations where the loop saves ``n`` (the report's
``weighted_loops`` says whether one ran).
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.autograd.graph import get_gradient_edge
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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


# an AccumulateGrad node's sequence number: it belongs to no trip
_LEAF_SEQ = 2**64 - 1


def _seq_mark() -> int:
    """The sequence number of an autograd node made now: every node a
    later op creates has a larger one."""
    probe = torch.empty(0, device="meta", requires_grad=True).view(0)
    return probe.grad_fn._sequence_nr()


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
        self.weight = 1          # times the running op is counted
        self._node_weight = {}   # autograd node -> weight of its trip
        self._outer = []         # weights a running node's hook replaced
        self._arrived = set()    # (backward pass, edge) a gradient reached
        self.weighted_loops = 0  # loops that ran a few trips for all

    # -- weighted trips --------------------------------------------------------

    def loop(self, n: int, trip, carry, xs, remat=None):
        """``models.recurrent``'s loop hook: ``carry, y_t = trip(t, carry)``
        for ``t < n``, each trip under ``remat(trip, t, carry)`` if given.
        Where every tensor of ``xs`` is a ``meta`` tensor (or a ``DTensor``
        of meta shards) and ``n > 3``, four trips stand for ``n``: trip 0
        alone (its carry may need no gradient where later ones do), trip 1
        for trips 1 to n - 3, trip n - 2 alone (the trip whose carry the
        last one reads: the last trip may not use all of it), and the last
        trip alone (a checkpointed loop's recompute stops inside it). A
        trip's recompute runs at the weight its forward ran at. The
        outputs of the trips not run are trip 1's, detached: a stacked
        tensor reads them all, their gradients go nowhere. Returns
        ``(carry, ys)``, or ``None``: run every trip."""
        if n <= 3 or any(isinstance(t, torch.Tensor) and not _local(t).is_meta
                         for t in tree_leaves(xs)):
            return None
        self.weighted_loops += 1

        def one(t, c):
            if remat is None:
                return trip(t, c)
            return remat(functools.partial(self.run_at, self.weight, trip),
                         t, c)

        carry, first = self.trips(1, one, 0, carry, carry=carry)
        carry, mid = self.trips(n - 3, one, 1, carry, carry=carry)
        carry, before_last = self.trips(1, one, n - 2, carry, carry=carry)
        carry, last = self.trips(1, one, n - 1, carry, carry=carry)
        return carry, ([first, mid] + [mid.detach()] * (n - 4)
                       + [before_last, last])

    def run_at(self, weight: int, fn, *args):
        """``fn(*args)`` with every op counted ``weight`` times."""
        outer, self.weight = self.weight, weight
        try:
            return fn(*args)
        finally:
            self.weight = outer

    def trips(self, n: int, fn, *args, carry=()):
        """Run ``fn(*args)``, one trip of a loop, counted as ``n`` trips:
        its forward ops, the backward ops of the autograd nodes it creates,
        and the adds that accumulate the gradients it sends. ``carry``:
        the trip's inputs that one trip reads and the next writes (the
        loop carry): a gradient to them stands for one arrival at each
        trip the carry's maker stands for, not ``n``."""
        w = self.weight * n
        mark = _seq_mark() if torch.is_grad_enabled() else None
        out = self.run_at(w, fn, *args)
        if mark is not None:
            skip = {(e.node, e.output_nr) for e in
                    (get_gradient_edge(t) for t in tree_leaves(carry)
                     if isinstance(t, torch.Tensor) and t.requires_grad)}
            self._tag(out, mark, w, skip)
        return out

    def _tag(self, out, mark: int, w: int, skip: set) -> None:
        """Give weight ``w`` to the nodes made since ``mark`` that reach
        ``out`` (those of an inner trip keep theirs)."""
        todo = [t.grad_fn for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            seq = node._sequence_nr()
            if seq <= mark or seq == _LEAF_SEQ:
                continue
            if node not in self._node_weight:
                self._node_weight[node] = w
                self._hook(node, w, skip)
            todo.extend(nxt for nxt, _ in node.next_functions)

    def _hook(self, node, w: int, skip: set) -> None:
        def pre(grad_outputs):
            self._outer.append(self.weight)
            self.weight = w

        def post(grad_inputs, grad_outputs):
            self.weight = self._outer.pop()
            task = torch._C._current_graph_task_id()
            for edge, g in zip(node.next_functions, grad_inputs):
                if edge[0] is None or g is None:
                    continue
                # the engine adds this gradient into the target's buffer
                # after this hook, at weight 1; the full loop makes `eff`
                # arrivals where this one made one, and the `w_to` trips
                # the target stands for each take a first arrival with no
                # add
                w_to = self._node_weight.get(edge[0], 1)
                eff = w_to if edge in skip else max(w, w_to)
                key = (task, edge)
                extra = eff - 1 if key in self._arrived else eff - w_to
                self._arrived.add(key)
                self.hbm_bytes += extra * 3 * _nbytes(_local(g))

        node.register_prehook(pre)
        node.register_hook(post)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into local ops
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(t, FakeTensor) for t in tree_leaves(out))):
            # DTensor's sharding propagation trying an op on fake tensors
            # (once per op and shape): no op of the program
            return out
        w = self.weight
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += w * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = _nbytes(out)
                if kind == "reduce-scatter":
                    n = max(n, _nbytes((args, kwargs)))
                self.collective[kind] += w * n
        elif not _is_view(func):
            self.hbm_bytes += w * (_nbytes((args, kwargs)) + _nbytes(out))
        return out

    def report(self) -> dict:
        coll = dict(self.collective)
        coll["total"] = sum(coll[k] for k in KINDS)
        return dict(flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
                    collective_bytes=coll, weighted_loops=self.weighted_loops)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), report)``: the report of ``OpCounter``
    over the one call."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.report()
