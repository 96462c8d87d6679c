"""odinn_tpu_torch's manual adjoints for the D and capped targets against
odinn_tpu's (the D rows of tests/test_adjoint_matrix.py).

``make_adjoint_value_and_grad`` of DiscreteAdjoint through RK4 and SI and
of ContinuousAdjoint, each with DiscreteVJP, for the hybrid-D (``LawY``),
pure-D (``LawU``) and capped A (``max_D``) models, against the JAX
package's: loss to 1e-10, gradient to 1e-9 relative. The problems are
test_torch_d_targets.py's (``tests/torch_parity.py``).

The JAX package's discrete adjoint is not its own exact gradient for the D
targets: its local pullback of D to (H̄, |∇S|) holds the inner law's values
fixed, dropping ∂Y/∂H̄, ∂U/∂H̄ and ∂U/∂|∇S| on the explicit stages (the SI
transposes pull back through the frozen D whole). The port reproduces that,
so its discrete gradient minus its own autograd gradient is held to the
JAX package's gap, within 1 % of the gap.
"""

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    D_KINDS, classical_truth, count_kernel_plain_versions, jax_d_value_and_grad,
    port_d_value_and_grad, tree_rel_err)


@pytest.fixture(scope="module")
def truth():
    return classical_truth()


@pytest.mark.parametrize("solver,grad", [("RK4", "DA"), ("SI", "DA"), ("RK4", "CA")])
@pytest.mark.parametrize("kind", D_KINDS)
def test_manual_adjoints_match_jax(truth, kind, solver, grad, monkeypatch):
    jb, tb = truth
    jtheta, jval, jgrad = jax_d_value_and_grad(kind, solver, grad, jb)
    counts = count_kernel_plain_versions(monkeypatch)
    tval, tgrad = port_d_value_and_grad(kind, solver, grad, tb, jtheta)
    assert abs(tval - jval) <= 1e-10 * abs(jval)
    err = tree_rel_err(tgrad, jgrad)
    assert err <= 1e-9, f"{kind} {solver} {grad}: gradient relative error {err:.3e}"
    assert counts == {}, f"{kind} {solver} {grad}: a kernel's plain version ran: {counts}"


def _flat(tree):
    return np.concatenate([np.ravel(x.detach().numpy() if torch.is_tensor(x) else np.asarray(x))
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("kind", ["Y", "U"])
def test_discrete_adjoint_gap_to_autograd_is_jaxs(truth, kind):
    """The discrete adjoint's gap to autograd (RK4) is the JAX package's,
    within 1 % of the gap: the port drops the same inner-law partials."""
    jb, tb = truth
    jtheta, _, j_auto = jax_d_value_and_grad(kind, "RK4", "jax", jb)
    _, _, j_disc = jax_d_value_and_grad(kind, "RK4", "DA", jb)
    _, t_auto = port_d_value_and_grad(kind, "RK4", "jax", tb, jtheta)
    _, t_disc = port_d_value_and_grad(kind, "RK4", "DA", tb, jtheta)
    j_gap = _flat(j_disc) - _flat(j_auto)
    t_gap = _flat(t_disc) - _flat(t_auto)
    rel_gap = np.abs(j_gap).max() / np.abs(_flat(j_auto)).max()
    assert rel_gap > 1e-6, f"{kind}: no gap to pin ({rel_gap:.2e})"
    miss = np.abs(t_gap - j_gap).max() / np.abs(j_gap).max()
    assert miss <= 0.01, f"{kind}: the port's gap differs from the JAX package's by {miss:.3e}"
