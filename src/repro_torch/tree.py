"""Pytrees of tensors in JAX's leaf order.

The port's state trees (parameters, optimizer state, checkpointed state)
are nested dicts, lists and tuples of tensors. ``leaves`` walks them in
the order ``jax.tree.leaves`` does (dict keys sorted, lists and tuples in
order, ``None`` an empty subtree), so a flattened tree lines up with the
JAX package's leaf for leaf: a checkpoint's words, and the sum order of
AdamW's global gradient norm.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """A pytree's leaves in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def unflatten(template, values):
    """Rebuild ``template``'s structure from ``values`` in ``leaves``
    order (dicts keep the template's key order)."""
    return _build(template, iter(values))


def _build(node, it):
    # module-level, not a closure: a recursive closure is a reference
    # cycle, and its iterator would keep the values (a restored image's
    # views) alive until the cycle collector ran
    if isinstance(node, dict):
        vals = {k: _build(node[k], it) for k in sorted(node)}
        return {k: vals[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return None if node is None else next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), as ``jax.tree.map``."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
