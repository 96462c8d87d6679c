"""The rest of the D-target adjoint matrix: odinn_tpu_torch's manual
adjoints for the hybrid-D (``LawY``) and capped A (``max_D``) models
through the other solvers and VJP flavors, against odinn_tpu's
``make_adjoint_value_and_grad``: DiscreteAdjoint(DiscreteVJP) through
Euler, SSPRK3, RKC and SI2, DiscreteAdjoint(AutoVJP) through RK4 and
ContinuousAdjoint(ContinuousVJP); loss to 1e-10, gradient to 1e-9
relative, no kernel's plain version run. The problems are
test_torch_d_targets.py's (``tests/torch_parity.py``), float64 on the CPU.
"""

import pytest

from tests.torch_parity import (
    classical_truth, count_kernel_plain_versions, jax_d_value_and_grad,
    port_d_value_and_grad, tree_rel_err)


@pytest.fixture(scope="module")
def truth():
    return classical_truth()


@pytest.mark.parametrize("solver,grad", [("Euler", "DA"), ("SSPRK3", "DA"), ("RKC", "DA"),
                                         ("SI2", "DA"), ("RK4", "DA-auto"),
                                         ("RK4", "CA-cont")])
@pytest.mark.parametrize("kind", ["Y", "capped"])
def test_manual_adjoint_matrix_matches_jax(truth, kind, solver, grad, monkeypatch):
    jb, tb = truth
    jtheta, jval, jgrad = jax_d_value_and_grad(kind, solver, grad, jb)
    counts = count_kernel_plain_versions(monkeypatch)
    tval, tgrad = port_d_value_and_grad(kind, solver, grad, tb, jtheta)
    assert abs(tval - jval) <= 1e-10 * abs(jval)
    err = tree_rel_err(tgrad, jgrad)
    assert err <= 1e-9, f"{kind} {solver} {grad}: gradient relative error {err:.3e}"
    assert counts == {}, f"{kind} {solver} {grad}: a kernel's plain version ran: {counts}"
