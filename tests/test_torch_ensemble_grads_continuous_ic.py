"""odinn_tpu_torch's ``multistart_train`` with a trainable initial
condition under ``ContinuousAdjoint(VJP_method=DiscreteVJP())`` (the
fused route: the kernels' RHS pullback, their plain version on the CPU,
over the folded table of N·G rows) against the JAX package's, on
tests/torch_ensemble_grads.py's problem (float64, 2 restarts × 2 glaciers
on 24², SI at PCG-6, 3 Adam epochs): 1e-8.
"""

import pytest
import torch

from tests.torch_ensemble_grads import make_truth, run_both


@pytest.fixture(scope="module")
def truth():
    return make_truth()


def test_trainable_initial_condition_matches_jax(truth):
    """θ = {A, H₀}: JAX's run against the port's (1e-8), whose adjoint adds
    member k's λ₀σ′ into θ_IC[k]; H₀ trains."""
    ms, _, stack = run_both("ic", "ContinuousAdjoint(DiscreteVJP)", truth)
    assert not torch.equal(ms.thetas["IC"][1], stack["IC"][1])

