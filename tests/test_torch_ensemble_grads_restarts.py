"""odinn_tpu_torch's folded ``multistart_train`` against single starts:
under every gradient mode of the JAX package's ``_make_grad_fn``
(autograd's is in test_torch_ensemble.py), restart k's loss curve equals
a single-start ``train_ude`` from θ_k to 1e-12, on
tests/torch_ensemble_grads.py's problem (float64, 2 restarts × 2 glaciers
on 24², SI at PCG-6, 3 Adam epochs): the fold gives each member its own
glaciers' losses and gradient, through the manual adjoints, forward mode
and the dummy draw alike. A = NN(T), or per-glacier scalar A where the
mode needs it (forward).
"""

import pytest

from tests.torch_ensemble_grads import assert_restarts_are_single_starts, make_truth


@pytest.fixture(scope="module")
def truth():
    return make_truth()


@pytest.mark.parametrize("mode,kind", [
    ("discrete", "nn"), ("DiscreteAdjoint", "nn"), ("continuous", "nn"),
    ("ContinuousAdjoint(DiscreteVJP)", "ic"), ("forward", "per_glacier_A"), ("dummy", "nn"),
])
def test_restart_k_is_a_single_start(truth, mode, kind):
    """Restart k's curve is a single start's from θ_k: 1e-12."""
    assert_restarts_are_single_starts(kind, mode, truth)
