"""odinn_tpu_torch's discrete adjoint against odinn_tpu's.

``make_adjoint_value_and_grad`` with a ``DiscreteAdjoint`` against the JAX
package's on the same θ and batch (two 24² Halfar glaciers of different A,
3 monthly intervals at 2 substeps; SI and SI2 at PCG-10, predictor PCG-4):
loss to 1e-10 and θ-gradient to 1e-9 relative, float64 on the CPU, for
Euler, RK4, SSPRK3, RKC, SI and SI2 with the discrete and the autograd
VJP. The JAX package holds these rows against finite differences
(``tests/test_gradients.py``); here they are held to its gradient. The
A = NN(T) law takes the fused kernels' pullbacks (their plain versions on
the CPU), whose calls are counted; an inner law takes the tensor code.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.inverse.adjoint_types as JA
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.inverse.adjoint_types as TA
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad as j_adjoint_vg
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson, LawA as JLawA
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.models.nn import NeuralNetwork as JNeuralNetwork, default_architecture as j_arch
from odinn_tpu.simulation.implicit import _cg as j_cg, _div_flux as j_div_flux
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.convert import mlp_from_numpy
from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
from odinn_tpu_torch.laws.laws import LawA
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
from odinn_tpu_torch.ops.cuda import common, rkc_kernel, si_kernel, sia_kernel
from odinn_tpu_torch.simulation.inversion import Inversion
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.0 + 3.0 / 12.0)     # 3 monthly intervals
METHODS = ["Euler", "RK4", "SSPRK3", "RKC", "SI", "SI2"]


def _params(P, method, adjoint):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=2, solver=method, rkc_stages=6,
                                  cg_iters=10, cg_iters_predictor=4),
        UDE=P.UDEParameters(grad=adjoint))


@pytest.fixture(scope="module")
def problem():
    """Two 24² Halfar glaciers with Cuffey–Paterson ground truth (JAX), the
    batch carried into the port, and one A = NN(T) θ in both packages."""
    jp = _params(JP, "RK4", "jax")
    gl = [j_halfar(nx=24, ny=24, dx=200.0, h0=150.0, r0=1600.0, temp=t, rgi_id=f"g{i}")
          for i, t in enumerate((-27.0, -32.0))]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                        j_tstops(TSPAN, 1.0 / 12.0), store=("H",))
    truth = j_stack(gl)
    jtheta = {"A": JNeuralNetwork(j_arch(1)).init()}
    ttheta = {"A": mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                                   for layer in jtheta["A"]], default_architecture(1),
                                  device=CPU)}
    return truth, carry_glacier(truth), jtheta, ttheta


def _models(jp, tp, inner=False):
    jlaw, tlaw = JLawA(JNeuralNetwork(j_arch(1)), jp), LawA(NeuralNetwork(default_architecture(1)),
                                                            tp)
    if inner:
        jlaw = dataclasses.replace(jlaw, callback_freq=None)
        tlaw = dataclasses.replace(tlaw, callback_freq=None)
    return JModel(iceflow=JSIA2DModel(A=jlaw)), Model(iceflow=SIA2DModel(A=tlaw))


def _leaves(tree):
    return [layer[k] for layer in tree["A"] for k in ("w", "b")]


def run_both(problem, method, jadjoint, tadjoint, flavor="discrete", inner=False, jp=None,
             tp=None, jtruth=None, tbatch=None):
    """(JAX (loss, grads), port (loss, grads)) of make_adjoint_value_and_grad."""
    truth, batch, jtheta, ttheta = problem
    jp = jp or _params(JP, method, jadjoint)
    tp = tp or _params(TP, method, tadjoint)
    jm, tm = _models(jp, tp, inner)
    jtruth = truth if jtruth is None else jtruth
    tbatch = batch if tbatch is None else tbatch
    jval, jgrad = j_adjoint_vg(JInversion(model=jm, glaciers=jtruth, parameters=jp, theta=jtheta),
                               flavor=flavor)(jtheta)
    tinv = Inversion(model=tm, glaciers=tbatch, parameters=tp, theta=ttheta, device=CPU)
    vg = make_adjoint_value_and_grad(tinv, flavor=flavor)
    tval, tgrad = vg(ttheta)
    return (jval, jgrad), (tval, tgrad), vg


def assert_matches(jax_out, port_out, what):
    (jval, jgrad), (tval, tgrad) = jax_out, port_out
    assert_rel(tval, jval, 1e-10, f"{what} loss")
    for a, b in zip(_leaves(tgrad), _leaves(jgrad)):
        assert_rel(a, np.asarray(b), 1e-9, f"{what} gradient")
    assert float(tval) > 0.0


def _count_calls(monkeypatch, names):
    """Counts of the plain versions the kernel wrappers run on the CPU."""
    counts = {}
    for mod, name in names:
        real = getattr(mod, name)

        def counted(*a, _r=real, _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _r(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("vjp", ["discrete", "auto"])
@pytest.mark.parametrize("method", METHODS)
def test_discrete_adjoint_matches_jax(problem, method, vjp, monkeypatch):
    """Loss and gradient against the JAX package's; on the discrete VJP the
    pullbacks are the kernels' plain versions: one RHS pullback per
    explicit stage (an RKC step one rematerialising rkc_interval and s
    pullbacks), and per SI solve one plain-CG forward, one plain-CG
    transpose solve and one si_step pullback."""
    jf, tf = {"discrete": (JA.DiscreteVJP(), TA.DiscreteVJP()),
              "auto": (JA.AutoVJP(), TA.AutoVJP())}[vjp]
    counts = _count_calls(monkeypatch, [
        (sia_kernel, "sia2d_rhs_vjp_reference"), (rkc_kernel, "stage_pullback_reference"),
        (si_kernel, "_si_solve_reference"), (si_kernel, "si_step_transpose_reference"),
        (si_kernel, "si_step_vjp_reference")])
    jax_out, port_out, _ = run_both(problem, method, JA.DiscreteAdjoint(VJP_method=jf),
                                    TA.DiscreteAdjoint(VJP_method=tf))
    assert_matches(jax_out, port_out, f"{method} {vjp}")
    if vjp == "discrete":
        substeps = 6     # 3 intervals of 2 substeps
        stages = {"Euler": 1, "RK4": 4, "SSPRK3": 3, "RKC": 6}.get(method, 0)
        solves = {"SI": 1, "SI2": 2}.get(method, 0)
        pullbacks = counts.get("sia2d_rhs_vjp_reference", 0) + counts.get(
            "stage_pullback_reference", 0)
        assert pullbacks == substeps * stages
        # the forward's own solves, the rematerialised substeps, and the
        # transposes' plain-CG rematerialisations
        assert counts.get("si_step_transpose_reference", 0) == substeps * solves
        assert counts.get("si_step_vjp_reference", 0) == substeps * solves
        assert counts.get("_si_solve_reference", 0) == (6 + 3 + 6) * solves


@pytest.mark.parametrize("method", ["Euler", "SI2"])
def test_discrete_adjoint_tensor_code_matches_jax(problem, method, monkeypatch):
    """An inner law (evaluated at every RHS call) is not the kernels'
    configuration: the adjoint takes the tensor code of the hand chain and
    of the SI transpose, and still matches the JAX package's."""
    counts = _count_calls(monkeypatch, [
        (sia_kernel, "sia2d_rhs_vjp_reference"), (si_kernel, "si_step_vjp_reference")])
    jax_out, port_out, _ = run_both(problem, method, JA.DiscreteAdjoint(),
                                    TA.DiscreteAdjoint(), inner=True)
    assert_matches(jax_out, port_out, f"{method} tensor code")
    assert counts == {}


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_unpreconditioned_si_solves_match_jax_cg(problem, theta):
    """si_step and si_step_transpose with precondition=False (their plain
    versions on the CPU) are the JAX package's unpreconditioned ``_cg``
    solves of the manual SI transposes: the rematerialised pre-relu state
    from H₀ and the adjoint solve from λ·[w > 0], 1e-12."""
    truth, batch, jtheta, ttheta = problem
    phys = TP.PhysicalParameters()
    H = batch.H0
    n_g = H.shape[0]
    raw = torch.stack([batch.dx, batch.dy, torch.tensor([2e-17, 5e-18], dtype=H.dtype),
                       torch.zeros(n_g, dtype=H.dtype), torch.full((n_g,), 3.0, dtype=H.dtype),
                       torch.full((n_g,), 3.0, dtype=H.dtype), torch.zeros(n_g, dtype=H.dtype)],
                      dim=1)
    derived = common.derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)
    B, dt, it = batch.B.contiguous(), 1.0 / 12.0, 7
    H_D = (0.97 * H).contiguous()
    out, w = si_kernel.si_step(H, H_D, B, H, derived, dt, theta, it, precondition=False,
                               keep_x=True)
    lam = torch.from_numpy(np.random.default_rng(5).standard_normal(tuple(H.shape)))
    mu = si_kernel.si_step_transpose(lam, w, H_D, B, derived, dt, theta, it, precondition=False)
    dx, dy, creep, slide = (derived[:, k].reshape(-1, 1, 1) for k in range(4))
    D = si_kernel._frozen_D_scalar(H_D, B, dx, dy, creep, slide, (5.0, 2.0, 4.0, 2.0))
    interior = torch.zeros_like(H)
    interior[:, 1:-1, 1:-1] = 1.0
    for g in range(n_g):
        Dg, Hg, Bg, ig = (jnp.asarray(t[g].numpy()) for t in (D, H, B, interior))
        dxg, dyg = float(dx[g]), float(dy[g])
        matvec = lambda u: u - theta * dt * ig * j_div_flux(ig * u, Dg, dxg, dyg)
        b = Hg + dt * ig * j_div_flux(Bg + (1.0 - ig) * Hg + (1.0 - theta) * ig * Hg, Dg, dxg,
                                      dyg)
        w_j = j_cg(matvec, b, Hg, it)
        assert_rel(w[g], w_j, 1e-12, "w")
        assert_rel(out[g], jnp.maximum(w_j, 0.0), 1e-12, "relu(w)")
        lam_r = jnp.asarray(lam[g].numpy()) * (w_j > 0.0)
        assert_rel(mu[g], j_cg(matvec, lam_r, lam_r, it), 1e-12, "mu")
    # the Jacobi default differs from plain CG at a few iterations
    x_pcg = si_kernel.si_step(H, H_D, B, H, derived, dt, theta, it, keep_x=True)[1]
    assert float((x_pcg - w).abs().max()) > 1e-6 * float(w.abs().max())
