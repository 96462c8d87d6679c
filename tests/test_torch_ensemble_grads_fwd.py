"""odinn_tpu_torch's ``multistart_train`` under forward mode
(``grad="forward"``) and the dummy gradient (``grad="dummy"``) against the
JAX package's, on tests/torch_ensemble_grads.py's problem (float64, 2
restarts × 2 glaciers on 24², SI at PCG-6, 3 Adam epochs, from JAX's θ
stack): the loss curves, final losses, winner and θ stack to 1e-8.

Forward mode runs one dual solve a θ leaf for every member at once and
scatters member k's per-glacier loss tangents into its own θ row; it
needs per-glacier scalar θ of the member's shape, as JAX's does under its
restart ``vmap``. JAX's dummy gradient draws from an unbatched key inside
that ``vmap``, so every restart gets the same draw of the member's shape
at every step; the port draws once from its ``torch.Generator`` and
broadcasts it. The parity runs give the port JAX's draw.
"""

import jax
import numpy as np
import pytest
import torch

from odinn_tpu_torch.simulation import ensemble as tens
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.utils.flatten import tree_leaves, tree_unflatten
from tests.torch_ensemble_grads import jens, make_truth, problem, run_both
from tests.torch_parity import tree_to_port


@pytest.fixture(scope="module")
def truth():
    return make_truth()


def test_forward_mode_matches_jax(truth):
    """Per-glacier scalar A: JAX's run against the port's (1e-8); every
    restart's loss falls."""
    ms, _, _ = run_both("per_glacier_A", "forward", truth)
    assert np.all(ms.losses[:, -1] < ms.losses[:, 0])


def test_forward_mode_refuses_nn_theta(truth):
    """An NN θ: both packages raise the same error, naming the member's
    leaf shape (not the stack's)."""
    jinv, inv, jthetas = problem("nn", "forward", truth)
    with pytest.raises(ValueError, match="per-glacier SCALAR") as jerr:
        jens.multistart_train(jinv, thetas=jthetas)
    with pytest.raises(ValueError, match="per-glacier SCALAR") as terr:
        tens.multistart_train(inv, thetas=tree_to_port(jthetas))
    assert str(terr.value) == str(jerr.value)


def jax_dummy_draw(jthetas):
    """The JAX package's dummy gradient of one member: a PRNGKey(0) normal
    draw a leaf, in its leaf order, as numpy."""
    member = jax.tree.map(lambda x: x[0], jthetas)
    leaves, treedef = jax.tree.flatten(member)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    return jax.tree.unflatten(treedef, [jax.random.normal(k, l.shape, l.dtype)
                                        for k, l in zip(keys, leaves)])


@pytest.mark.parametrize("kind", ["per_glacier_A", "nn"])
def test_dummy_matches_jax(truth, kind, monkeypatch):
    """The port's draw replaced by JAX's (one draw of the member's shape,
    the same for every member): JAX's run against the port's (1e-8). Each
    member's θ moves by the same Adam update (1e-12)."""
    _, _, jthetas = problem(kind, "dummy", truth)
    draw = tree_to_port(jax_dummy_draw(jthetas))

    def jax_draw(stacked, members=None):
        like = tree_unflatten(tens.member_theta(stacked, 0), tree_leaves(draw))
        return [d.expand(x.shape).clone()
                for d, x in zip(tinv._tree_leaves(like), tinv._tree_leaves(stacked))]

    monkeypatch.setattr(tinv, "_dummy_grad", jax_draw)
    ms, _, stack = run_both(kind, "dummy", truth)
    for a, b in zip(tree_leaves(ms.thetas), tree_leaves(stack)):
        step = a - b
        scale = float(step.abs().max())
        assert float((step - step[0]).abs().max()) <= 1e-12 * scale


def test_dummy_draw_is_shared_by_the_members(truth):
    """The port's own draw: one ``torch.Generator`` draw seeded 0 of the
    member's leaf shape, the same for every member, and the same as a
    single start's draw."""
    _, inv, jthetas = problem("nn", "dummy", truth)
    stack = tree_to_port(jthetas)
    shared = tinv._dummy_grad(stack, members=2)
    single = tinv._dummy_grad(tens.member_theta(stack, 0))
    for s, one, x in zip(shared, single, tinv._tree_leaves(stack)):
        assert s.shape == x.shape and torch.equal(s[0], one) and torch.equal(s[1], one)
