"""θ tree ↔ flat vector.

A θ tree is nested dicts, lists and tuples of tensors. Its flat view
concatenates the raveled leaves in the JAX package's leaf order: a dict's
entries by sorted key, a list's or tuple's in order (the order of
``jax.flatten_util.ravel_pytree``, which ``odinn_tpu.utils.flatten``
uses), so a flat θ, a flat gradient or a member row of an ensemble lines up
entry for entry with the JAX package's. Ensemble Kalman inversion and the
Laplace posterior ravel θ through this module and nothing else.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["theta_to_vector", "vector_to_theta", "theta_size", "tree_leaves", "tree_unflatten",
           "tree_map", "stack_to_rows", "rows_to_stack"]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the flat view's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples of tensors), in a tree of that structure. It calls ``fn`` in the
    first tree's own entry order, which only a ``fn`` with side effects
    sees: the Levenberg–Marquardt probes draw their signs leaf by leaf
    through it."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in the flat view's
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def theta_to_vector(theta) -> Tuple[torch.Tensor, Callable]:
    """(flat vector, unravel): the leaves raveled and concatenated, and the
    function that rebuilds θ's tree from such a vector: leaves of θ's shapes
    and dtypes from a tensor, of θ's shapes and the vector's own dtype from
    a numpy array."""
    leaves = tree_leaves(theta)
    flat = torch.cat([x.reshape(-1) for x in leaves]) if leaves else torch.zeros(0)
    shapes = [(tuple(x.shape), x.dtype) for x in leaves]

    def unravel(vec):
        out, off = [], 0
        for shape, dtype in shapes:
            n = 1
            for s in shape:
                n *= s
            x = vec[off:off + n].reshape(shape)
            out.append(x.to(dtype) if isinstance(x, torch.Tensor) else x)
            off += n
        return tree_unflatten(theta, out)

    return flat, unravel


def vector_to_theta(vec, unravel):
    """The inverse of :func:`theta_to_vector`."""
    return unravel(vec)


def theta_size(theta) -> int:
    return sum(x.numel() for x in tree_leaves(theta))


def stack_to_rows(stacked) -> torch.Tensor:
    """(J, d): each member of a θ stack (every leaf with a leading member
    axis J) raveled as one row, in the flat view's order."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    return torch.cat([x.reshape(n, -1) for x in leaves], dim=1)


def rows_to_stack(rows, like):
    """The θ stack of the (J, d) ``rows``, leaves shaped as ``like``'s (one
    member's θ, no member axis) in their dtypes."""
    n = rows.shape[0]
    out, off = [], 0
    for x in tree_leaves(like):
        k = x.numel()
        out.append(rows[:, off:off + k].reshape((n,) + tuple(x.shape)).to(x.dtype))
        off += k
    return tree_unflatten(like, out)
