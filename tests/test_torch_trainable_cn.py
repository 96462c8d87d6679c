"""odinn_tpu_torch's trainable sliding coefficient C and Glen exponent n
(``LawC_inversion``, ``LawN_inversion``) against odinn_tpu's.

The kernels' backwards pull back to the creep column only, except the SI
step's, which also has the slide column; their exponents are numbers. So a
trainable C takes the fused kernels on the SI route and the generic path on
the RKC route, and a trainable n the generic path everywhere; a fused
route would drop the gradient without an error. The gradient through the
SI and RKC solves, by autograd (``grad="jax"``) and by the discrete
adjoint, is held to the JAX package's (``jax.grad`` of its loss, its
``make_adjoint_value_and_grad``) at 1e-9 relative, with the route checked by
counting the kernels' plain versions; two 24² glaciers with a known
per-glacier C or n, 3 monthly intervals, float64 on the CPU (the port of
``tests/test_trainable_cn.py``'s gradient checks).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.inverse.adjoint_types as JA
import odinn_tpu.laws.laws as JL
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.inverse.adjoint_types as TA
import odinn_tpu_torch.laws.laws as TL
from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad as j_adjoint_vg
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.simulation.inversion import (
    Inversion as JInversion, batch_transient_loss as j_loss)
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel
from odinn_tpu_torch.simulation.inversion import (
    Inversion, assemble_tstops, batch_transient_loss)
from tests.torch_parity import (
    CLASSICAL_TSPAN, CPU, assert_rel, assert_tree_rel, classical_params, classical_truth,
    per_glacier_const_law, theta_to_port)

A_GLEN = (2e-18, 1e-18)


@pytest.fixture(scope="module")
def truths():
    return {"C": classical_truth(truth_c=(3e-16, 6e-16)),
            "n": classical_truth(truth_n=(2.8, 3.2))}


def _models(slot, jp, tp):
    if slot == "C":
        return (JModel(iceflow=JSIA2DModel(A=JL.ConstantA(1e-18), C=JL.LawC_inversion(jp))),
                Model(iceflow=SIA2DModel(A=TL.ConstantA(1e-18), C=TL.LawC_inversion(tp))))
    return (JModel(iceflow=JSIA2DModel(A=per_glacier_const_law(JL.Law, "A", A_GLEN, jax=True),
                                       n=JL.LawN_inversion(jp))),
            Model(iceflow=SIA2DModel(A=per_glacier_const_law(TL.Law, "A", A_GLEN),
                                     n=TL.LawN_inversion(tp))))


def _count(monkeypatch):
    counts = {}
    for mod, name in [(si_kernel, "si_step_vjp_reference"), (rkc_kernel, "_forward"),
                      (sia_kernel, "sia2d_rhs_vjp_reference"), (si_kernel, "_forward")]:
        real = getattr(mod, name)
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

        def counted(*a, _r=real, _k=key, **k):
            counts[_k] = counts.get(_k, 0) + 1
            return _r(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("grad", ["jax", "discrete"])
@pytest.mark.parametrize("solver", ["SI", "RKC"])
@pytest.mark.parametrize("slot", ["C", "n"])
def test_trainable_c_and_n_gradients_match_jax(truths, slot, solver, grad, monkeypatch):
    jb, tb = truths[slot]
    jp = classical_params(JP, solver, grad="jax" if grad == "jax" else JA.DiscreteAdjoint())
    tp = classical_params(TP, solver, grad="jax" if grad == "jax" else TA.DiscreteAdjoint())
    jm, tm = _models(slot, jp, tp)
    jtheta = {slot: jnp.asarray([0.2, -0.3])}
    if grad == "jax":
        ts = j_tstops(CLASSICAL_TSPAN, 1.0 / 12.0)
        jval, jgrad = jax.value_and_grad(lambda th: j_loss(th, jb, jm, jp, ts))(jtheta)
    else:
        jval, jgrad = j_adjoint_vg(JInversion(model=jm, glaciers=jb, parameters=jp,
                                              theta=jtheta), flavor="discrete")(jtheta)
    counts = _count(monkeypatch)
    ttheta = theta_to_port(jtheta)
    if grad == "jax":
        ttheta[slot].requires_grad_(True)
        tval = batch_transient_loss(ttheta, tb, tm, tp, assemble_tstops(tp, tb))
        tgrad = {slot: torch.autograd.grad(tval, ttheta[slot])[0]}
    else:
        tinv = Inversion(model=tm, glaciers=tb, parameters=tp, theta=ttheta, device=CPU)
        tval, tgrad = make_adjoint_value_and_grad(tinv, flavor="discrete")(ttheta)
    assert_rel(tval, jval, 1e-10, f"{slot} {solver} {grad} loss")
    assert_tree_rel(tgrad, jgrad, 1e-9, f"{slot} {solver} {grad} gradient")
    assert float(tgrad[slot].abs().min()) > 0.0, "a glacier's gradient is zero"
    # the route: C on SI through the fused step and its slide pullback, C on
    # RKC and n everywhere on the generic path; the discrete adjoint's
    # forward solve, without a gradient, takes the fused RKC step for C (n
    # differs between the glaciers, which that step refuses)
    fused_si = slot == "C" and solver == "SI"
    assert counts.get("si_kernel.si_step_vjp_reference", 0) == (6 if fused_si else 0)
    fused_rkc_forward = slot == "C" and solver == "RKC" and grad == "discrete"
    assert counts.get("rkc_kernel._forward", 0) == (6 if fused_rkc_forward else 0)
    assert counts.get("sia_kernel.sia2d_rhs_vjp_reference", 0) == 0
    if slot == "n":
        assert counts.get("si_kernel._forward", 0) == 0


def test_fused_table_gates(truths):
    """The table of the fused kernels is refused when n, p or q carries a
    gradient, and when C does except on the SI route."""
    from odinn_tpu_torch.core.glacier import per_glacier_column
    from odinn_tpu_torch.physics.sia2d import SIAValues, ValuesFn, scalar_law_table
    from odinn_tpu_torch.physics.targets import ATarget

    _, tb = truths["C"]
    col = lambda v: torch.tensor(v, dtype=torch.float64).reshape(-1, 1, 1)
    dx, dy = per_glacier_column(tb, tb.dx), per_glacier_column(tb, tb.dy)
    base = dict(A=col([1e-18, 2e-18]), C=col([1e-16, 2e-16]), n=3.0, p=3.0, q=0.0)

    def table(slide_grad=False, **kw):
        vals = SIAValues(**dict(base, **kw))
        return scalar_law_table(ValuesFn(vals), ATarget(), dx, dy, tb.H0, slide_grad)

    grad = lambda v: col(v).requires_grad_(True)
    assert table() is not None
    assert table(A=grad([1e-18, 2e-18])) is not None
    assert table(C=grad([1e-16, 2e-16])) is None
    assert table(slide_grad=True, C=grad([1e-16, 2e-16])) is not None
    for slot in ("n", "p", "q"):
        v = [0.0, 0.0] if slot == "q" else [3.0, 3.1]
        assert table(slide_grad=True, **{slot: grad(v)}) is None
