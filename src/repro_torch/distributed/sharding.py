"""Logical-axis sharding: DP/FSDP/TP/EP/SP rules → partition specs and
``DTensor`` placements (PyTorch port of ``repro.distributed.sharding``).

Model code annotates activations with *logical* axis names
(``lshard(x, "batch", "seq", "embed")``); the launcher activates a rule
set mapping logical names to mesh axes. The rules return the JAX
package's ``PartitionSpec``s entry for entry (``P``: one entry per tensor
dim, a mesh-axis name, a tuple of names, or ``None``); ``placements``
turns a spec into one ``Shard(d)`` or ``Replicate()`` per mesh dim, the
form a ``DTensor`` takes.

Where the JAX package leaves the collectives to XLA's SPMD partitioner,
here a leaf placed by the rules is a ``DTensor``: its ops insert their
own collectives, and ``lshard`` redistributes a ``DTensor`` to the
placements the active rules give. With no active rules (unit tests,
single-device runs), or on a plain tensor, every annotation is a no-op,
and the model runs the plain path unchanged. Under ``use_rules`` plain
tensors that meet a ``DTensor`` (positions, masks, a batch not placed)
count as replicated.

Rules ship in two flavours keyed by the production meshes:

* single-pod ``(data=16, model=16)``: batch/fsdp → ``data``; tensor/expert/
  sequence parallel → ``model``.
* multi-pod ``(pod=2, data=16, model=16)``: batch additionally shards over
  ``pod`` (pure DP across pods; ZeRO stays within a pod so optimizer-state
  all-gathers never cross the inter-pod links).

Divisibility guard: a dimension that does not divide by the mapped mesh
axes is left unsharded (e.g. whisper's 8 heads on a 16-way model axis),
which keeps one rule set valid for all ten architectures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import mesh_shape

# the active rules: process-wide, not thread-local, because autograd runs
# a CUDA backward (and with it a checkpointed layer's recompute, which
# reaches ``lshard``) on its own device threads
_active: list = [None]


class P(tuple):
    """A partition spec: one entry per tensor dim (mesh-axis name, tuple
    of names, or ``None``), the shape of JAX's ``PartitionSpec``, which
    also writes a one-name tuple as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self):
        return "P" + super().__repr__()


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(sizes, a) for a in axis)
    return sizes[axis]


class Rules:
    """Mapping: logical axis name -> mesh axis (str | tuple | None)."""

    def __init__(self, mapping: dict, mesh):
        self.mapping = dict(mapping)
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)

    def axis_of(self, name: Optional[str], dim_size: Optional[int] = None):
        """The mesh axis (or axes) a logical name maps to on this mesh, or
        ``None``: unmapped, absent from the mesh, or a ``dim_size`` the
        axes do not divide."""
        if name is None:
            return None
        axis = self.mapping.get(name)
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            axis = tuple(a for a in axis if a in self.sizes)
            if not axis:
                return None
        elif axis not in self.sizes:
            return None
        if dim_size is not None:
            size = _axis_size(self.sizes, axis)
            if size == 0 or dim_size % size != 0:
                return None  # divisibility guard: leave unsharded
        return tuple(axis) if isinstance(axis, (tuple, list)) else axis

    def partition(self, names: Sequence[Optional[str]], shape=None) -> P:
        """The spec of a tensor whose dims carry ``names``: a mesh axis
        appears at most once, on the first dim that claims it."""
        dims = list(shape) if shape is not None else [None] * len(names)
        out, used = [], set()
        for n, d in zip(names, dims):
            axis = self.axis_of(n, d)
            axes = axis if isinstance(axis, tuple) else (axis,)
            if axis is None or any(a in used for a in axes):
                out.append(None)  # a mesh axis may appear at most once
                continue
            used.update(axes)
            out.append(axis)
        return P(*out)


def make_rules(mesh, *, seq_shard: bool = False) -> Rules:
    mapping = {
        "batch": ("pod", "data"),
        # SP: sharding the sequence dim of the residual stream over the
        # model axis divides saved-activation memory by |model| at the cost
        # of per-layer activation all-gathers around attention
        "seq": "model" if seq_shard else None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "fsdp": "data",          # ZeRO param/optimizer sharding (intra-pod)
        "expert": "model",       # EP shares the model axis
        "dispatch": ("pod", "data"),
        "kv_seq": "model",       # decode KV caches: sequence-sharded
        "frames": None,
        "ssm_heads": "model",
        "state": None,
    }
    return Rules(mapping, mesh)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Activate ``rules`` for ``lshard`` (and let plain tensors meet
    ``DTensor``s as replicated ones) inside the block."""
    prev = _active[0]
    _active[0] = rules
    try:
        if rules is None:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _active[0] = prev


def active_rules() -> Optional[Rules]:
    return _active[0]


def placements(spec: P, mesh, shape=None) -> list:
    """A spec as ``DTensor`` placements on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis and
    ``Replicate()`` elsewhere. A dim sharded over several axes (``("pod",
    "data")``) is split major to minor, as JAX lays it out, so its axes
    must come in the mesh's order. Given the tensor's ``shape``, a dim of
    size 1 stays whole: the divisibility guard lets it name only axes of
    size 1, where a shard is the whole dim, and ``DTensor``'s view rules
    refuse to reshape a sharded singleton."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if shape is not None and shape[d] == 1:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of {spec} lists its axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def lshard(x, *names: Optional[str]):
    """Redistribute a ``DTensor`` to the active logical sharding; a no-op
    without rules or on a plain tensor."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for rank-{x.ndim} array")
    want = placements(rules.partition(names, x.shape), x.device_mesh, x.shape)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def local_batch(fn, *args, out_dims=0, axis: str = "batch"):
    """``fn`` on each rank's slice of the batch: for loops over time (the
    recurrent scans) that would otherwise dispatch every step's ops through
    ``DTensor``, and for ops with no ``DTensor`` sharding rule that need
    none (the MoE's ``searchsorted`` and ``scatter_`` over its dispatch
    groups, ``axis="dispatch"``): each rank's rows are independent.

    ``args`` are ``(tree, dim)`` pairs: every ``DTensor`` leaf of ``tree``
    (and every plain tensor leaf, taken as replicated) is redistributed to
    its batch dim ``dim`` split over the DP axes (as the rule of ``axis``
    says) and every other dim whole, or wholly replicated where ``dim``
    is ``None`` (a parameter: its gradient is a
    partial sum over the ranks that split the batch). ``fn`` gets the
    trees of local tensors; each output tensor comes back as a ``DTensor``
    split on its dim of ``out_dims`` (one int for all, or one a tree of
    the output tuple). With no rules or no ``DTensor`` leaf it is
    ``fn(*trees)``."""
    from torch.distributed.tensor import Partial
    from torch.utils._pytree import tree_flatten, tree_unflatten

    rules = active_rules()
    flat = [(tree_flatten(t), d) for t, d in args]
    dts = [(x, d) for (xs, _), d in flat for x in xs if isinstance(x, DTensor)]
    if rules is None or not dts:
        return fn(*(t for t, _ in args))
    mesh = dts[0][0].device_mesh
    n = next((x.shape[d] for x, d in dts if d is not None), 1)
    spec = rules.partition((axis,), (n,))

    def where(dim):
        if dim is None:
            return [Replicate()] * mesh.ndim
        return [Shard(dim) if p == Shard(0) else p
                for p in placements(spec, mesh, (n,))]

    split = where(0)
    locals_ = []
    for (xs, treedef), d in flat:
        want = where(d)
        grad = want if d is not None else [
            Partial() if p == Shard(0) else Replicate() for p in split]
        if d is not None:   # a plain tensor counts as replicated
            xs = [DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
                  if isinstance(x, torch.Tensor) and not isinstance(x, DTensor)
                  else x for x in xs]
        locals_.append(tree_unflatten(
            [x.redistribute(mesh, want).to_local(grad_placements=grad)
             if isinstance(x, DTensor) else x for x in xs], treedef))
    out = fn(*locals_)
    outs, otree = tree_flatten(out)
    dims = tree_flatten(out_dims)[0] if not isinstance(out_dims, int) \
        else [out_dims] * len(outs)
    return tree_unflatten(
        [DTensor.from_local(o, mesh, where(d), run_check=False)
         if isinstance(o, torch.Tensor) else o for o, d in zip(outs, dims)],
        otree)


def split_last(x, n: int):
    """``x`` (..., n·k) → (..., n, k). A ``DTensor`` whose last dim is
    sharded over mesh dims that do not divide ``n`` (2 KV heads on a 16-way
    model axis) has that dim gathered first, which ``DTensor``'s view
    rules need; a plain tensor is reshaped as it is."""
    shape = tuple(x.shape[:-1]) + (n, x.shape[-1] // n)
    if isinstance(x, DTensor):
        mesh, last = x.device_mesh, x.ndim - 1
        ways = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if p == Shard(last))
        if n % ways:
            x = x.redistribute(mesh, [Replicate() if p == Shard(last) else p
                                      for p in x.placements])
    return x.reshape(shape)


def pin_grad(x):
    """``x`` whose gradient is brought back to ``x``'s own placements
    before it flows on: ``DTensor``'s backward view rules need the
    gradient of a flatten (heads into the model dim, groups into tokens)
    split as the forward was (a gradient split over a dim that does not
    divide it is refused, or given wrong local shapes). A plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False)


def merge_last(x):
    """``x`` (..., n, k) → (..., n·k), the heads of an attention or a
    recurrence back into the model dim, its gradient pinned (``pin_grad``)."""
    return pin_grad(x.reshape(tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],)))


def _coordinate(mesh, axes) -> int:
    """This rank's index along ``axes`` (mesh dim names, major to minor)."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    c = 0
    for a in axes:
        i = names.index(a)
        c = c * mesh.size(i) + coord[i]
    return c


def local_attention(fn, q, k, v):
    """``fn(q, k, v)``, an attention over q (B, Sq, H, D) and k/v (B, Sk,
    Hkv, D), on each rank's heads: the batch split over the DP axes as the
    rules say, each sequence whole, q's heads split over the model axis
    where the rules split them, and k/v cut to the KV heads those q heads
    read (grouped attention). The local ops are the plain path's, so on
    one rank the result is bitwise the plain one. With no rules or no
    ``DTensor`` argument it is ``fn(q, k, v)``.

    The sequence is gathered: a decode step over a ``kv_seq``-sharded cache
    all-gathers the cache (where XLA's partitioner would split the softmax
    over the shards instead)."""
    from torch.distributed.tensor import Partial

    rules = active_rules()
    dts = [a for a in (q, k, v) if isinstance(a, DTensor)]
    if rules is None or not dts:
        return fn(q, k, v)
    mesh = dts[0].device_mesh
    qs = rules.partition(("batch", None, "heads", None), q.shape)
    ks = rules.partition(("batch", None, "kv_heads", None), k.shape)
    if qs[2] is None or ks[2] != qs[2]:
        ks = P(ks[0], None, None, None)
    qp = placements(qs, mesh, q.shape)
    kp = placements(ks, mesh, k.shape)
    cut = qs[2] is not None and ks[2] is None   # k/v whole, q heads split
    # a rank that reads only some KV heads has a partial gradient of them
    kgrad = [Partial() if cut and qp[i] == Shard(2) else p
             for i, p in enumerate(kp)]

    def local(x, want, grad):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, want).to_local(grad_placements=grad)

    ql = local(q, qp, qp)
    kl, vl = local(k, kp, kgrad), local(v, kp, kgrad)
    if cut:
        h, hkv, hq = q.shape[2], k.shape[2], ql.shape[2]
        g = h // hkv
        axes = qs[2] if isinstance(qs[2], tuple) else (qs[2],)
        lo = _coordinate(mesh, axes) * hq
        if (hq % g if hq >= g else g % hq):
            raise ValueError(f"{hq} q heads a rank do not align with "
                             f"groups of {g}")
        n_kv = max(1, hq // g)
        kl = kl[:, :, lo // g: lo // g + n_kv]
        vl = vl[:, :, lo // g: lo // g + n_kv]
    return DTensor.from_local(fn(ql, kl, vl), mesh, qp, run_check=False)


# ---------------------------------------------------------------------------
# parameter sharding: name-based rules over the trailing dims of each leaf
# ---------------------------------------------------------------------------

# leaf-name -> logical names of the *trailing* dims. Leading (stacked-layer,
# expert, group) dims are padded with None unless matched by a 3-dim rule.
_PARAM_RULES: dict[str, tuple] = {
    # attention
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wo": ("heads", "fsdp"),
    # mlp
    "w_up": ("fsdp", "ff"),
    "w_gate": ("fsdp", "ff"),
    "w_down": ("ff", "fsdp"),
    # embeddings / head
    "embed": ("vocab", "fsdp"),
    "w_out": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    # moe (leading expert dim matched by rank-3 lookup below)
    "router": ("fsdp", None),
    "e_up": ("expert", "fsdp", None),
    "e_gate": ("expert", "fsdp", None),
    "e_down": ("expert", None, "fsdp"),
    # ssm / rwkv
    "in_proj": ("fsdp", "ff"),
    "out_proj": ("ff", "fsdp"),
    "w_r": ("fsdp", "ff"),
    "w_k": ("fsdp", "ff"),
    "w_v": ("fsdp", "ff"),
    "w_g": ("fsdp", "ff"),
    "wk_ff": ("fsdp", "ff"),
    "wv_ff": ("ff", "fsdp"),
    "wr_ff": ("fsdp", None),
}


# decode/prefill cache leaves, matched by name + rank (trailing dims rule)
_CACHE_RULES: dict[str, tuple] = {
    "k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    "xk": (None, "batch", None, "kv_heads", "head_dim"),
    "xv": (None, "batch", None, "kv_heads", "head_dim"),
    "conv": (None, "batch", None, None),
    "ssm": (None, "batch", "ssm_heads", None, None),
    "state": (None, "batch", "ssm_heads", None, None),
    "att_shift": (None, "batch", None),
    "ffn_shift": (None, "batch", None),
    "pos": (),
}


def _shape(leaf) -> tuple:
    """A leaf's shape; a Python number (a cache's ``pos``) is a scalar."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple tree, ``path`` the
    keys (list and tuple indices) from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(cache: Any, rules: Rules) -> Any:
    def visit(path, leaf):
        shape = _shape(leaf)
        rule = _CACHE_RULES.get(str(path[-1]))
        if rule is None or len(rule) != len(shape):
            rule = (None,) * len(shape)
        return rules.partition(rule, shape)

    return map_with_path(visit, cache)


def batch_spec(batch: Any, rules: Rules) -> Any:
    """Model inputs: shard axis 0 (global batch) over the DP axes."""
    def visit(_, leaf):
        shape = _shape(leaf)
        return rules.partition(("batch",) + (None,) * (len(shape) - 1), shape)

    return map_with_path(visit, batch)


def param_spec(path: str, shape: tuple, rules: Rules) -> P:
    leaf = path.split("/")[-1]
    rule = _PARAM_RULES.get(leaf)
    if rule is None or len(shape) < len(rule):
        return P(*([None] * len(shape)))
    pad = len(shape) - len(rule)
    names = (None,) * pad + tuple(rule)
    return rules.partition(names, shape)


def param_specs(params: Any, rules: Rules) -> Any:
    """The spec tree matching ``params`` (real or ``meta`` leaves), each
    leaf named by its ``/``-joined path."""
    return map_with_path(
        lambda path, leaf: param_spec("/".join(map(str, path)), _shape(leaf),
                                      rules),
        params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where a leaf goes (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P

    def placements_for(self, shape=None) -> list:
        return placements(self.spec, self.mesh, shape)


def shardings_of(specs: Any, mesh) -> Any:
    """A spec tree as a tree of ``NamedSharding``s on ``mesh``."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: shardings_of(v, mesh) for k, v in specs.items()}
    return type(specs)(shardings_of(v, mesh) for v in specs)


def param_shardings(params: Any, rules: Rules) -> Any:
    return shardings_of(param_specs(params, rules), rules.mesh)


def place(x, sharding: NamedSharding):
    """One tensor as a ``DTensor`` placed by ``sharding``; a Python
    number (a cache's ``pos``) stays as it is. Every rank holds the whole
    tensor (each process draws or restores the same state, as each JAX
    process hands ``device_put`` its own copy), so each takes its own
    shard of it and nothing is sent."""
    if not isinstance(x, torch.Tensor):
        return x
    return distribute_tensor(x, sharding.mesh,
                             sharding.placements_for(tuple(x.shape)),
                             src_data_rank=None)


def distribute(tree: Any, shardings: Any) -> Any:
    """Place every leaf of ``tree`` by the matching ``NamedSharding`` of
    ``shardings`` (a tree of the same structure)."""
    if isinstance(shardings, NamedSharding):
        return place(tree, shardings)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s) for v, s in zip(tree, shardings))
    raise TypeError(f"no sharding for leaf {type(tree).__name__}")
