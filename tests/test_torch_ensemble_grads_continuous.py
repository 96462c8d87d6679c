"""odinn_tpu_torch's ``multistart_train`` under the continuous adjoint
(``grad="continuous"``) against the JAX package's, on
tests/torch_ensemble_grads.py's problem (float64, 2 restarts × 2 glaciers
on 24², SI at PCG-6, 3 Adam epochs, from JAX's θ stack): the loss curves,
final losses, winner and θ stack to 1e-8. Each glacier's reverse BS3(2)
controller steps on its own, so member k's glaciers take a single start's
steps; the JAX package's vmapped while loop runs in lockstep with the
same per-glacier result. A trainable H₀ and the ``ContinuousAdjoint``
instance are in ``test_torch_ensemble_grads_continuous_ic.py``.
"""

import numpy as np
import pytest

from tests.torch_ensemble_grads import make_truth, run_both


@pytest.fixture(scope="module")
def truth():
    return make_truth()


@pytest.mark.parametrize("kind", ["per_glacier_A", "nn"])
def test_multistart_matches_jax(truth, kind):
    """JAX's run against the port's (1e-8); every restart's loss falls."""
    ms, _, _ = run_both(kind, "continuous", truth)
    assert np.all(ms.losses[:, -1] < ms.losses[:, 0])
