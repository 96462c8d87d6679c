"""odinn_tpu_torch's θ ravel (``utils/flatten.py``) against the JAX
package's (``odinn_tpu.utils.flatten``, ``jax.flatten_util.ravel_pytree``):
the same θ trees, made from a numpy seed, ravel to the same vector in the
same leaf order, unravel back exactly, and count the same size. Float64,
exact."""

import jax.flatten_util  # noqa: F401  (odinn_tpu.utils.flatten reads it off jax)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odinn_tpu.utils import flatten as jflat
from odinn_tpu_torch.utils import flatten as tflat


def _tree(kind, rng):
    """A θ tree of numpy float64 leaves: an MLP's layers, a classical
    inversion's per-glacier leaves, or nested tuples and dicts whose keys
    are out of sorted order."""
    if kind == "mlp":
        return {"A": [{"w": rng.standard_normal((1, 3)), "b": rng.standard_normal(3)},
                      {"w": rng.standard_normal((3, 1)), "b": rng.standard_normal(1)}]}
    if kind == "classical":
        return {"H0": rng.standard_normal((2, 4, 4)), "A": rng.standard_normal(2)}
    return {"z": (rng.standard_normal(2), {"y": rng.standard_normal((2, 2)),
                                           "x": rng.standard_normal(1)}),
            "a": [rng.standard_normal(3)]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


KINDS = ("mlp", "classical", "nested")


@pytest.mark.parametrize("kind", KINDS)
def test_ravel_matches_jax_and_round_trips(kind):
    """theta_to_vector's vector equals the JAX package's entry for entry;
    vector_to_theta gives back every leaf exactly, from a tensor in θ's
    dtype and from a numpy vector in its own; theta_size agrees."""
    tree = _tree(kind, np.random.default_rng(7))
    jflat_vec, _ = jflat.theta_to_vector(_map(jnp.asarray, tree))
    ttree = _map(torch.from_numpy, tree)
    vec, unravel = tflat.theta_to_vector(ttree)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jflat_vec))
    assert tflat.theta_size(ttree) == jflat.theta_size(_map(jnp.asarray, tree)) == vec.numel()
    back = tflat.vector_to_theta(vec, unravel)
    back_np = unravel(vec.numpy())
    for a, b, c in zip(tflat.tree_leaves(ttree), tflat.tree_leaves(back),
                       tflat.tree_leaves(back_np)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert isinstance(c, np.ndarray) and np.array_equal(a.numpy(), c)
    assert list(tflat.tree_unflatten(ttree, tflat.tree_leaves(ttree))) == list(ttree)


@pytest.mark.parametrize("kind", KINDS)
def test_stack_rows_match_jax_member_ravel(kind):
    """stack_to_rows of a 3-member θ stack is each member raveled as the
    JAX package ravels it; rows_to_stack inverts it exactly."""
    rng = np.random.default_rng(11)
    members = [_tree(kind, rng) for _ in range(3)]
    stack = tflat.tree_map(lambda *xs: torch.from_numpy(np.stack(xs)), *members)
    rows = tflat.stack_to_rows(stack)
    want = np.stack([np.asarray(jflat.theta_to_vector(_map(jnp.asarray, m))[0]) for m in members])
    np.testing.assert_array_equal(rows.numpy(), want)
    like = _map(torch.from_numpy, members[0])
    again = tflat.rows_to_stack(rows, like)
    for a, b in zip(tflat.tree_leaves(stack), tflat.tree_leaves(again)):
        assert torch.equal(a, b)
