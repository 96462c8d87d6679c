"""The ice-sheet scenario of ``benchmarks/icesheet_scale.py`` in the port,
held to the JAX package on the CPU at a cut size.

One Halfar dome of R0 = 800 km and H0 = 3000 m (A = 8e-19, T = −20 °C)
from its intrinsic time ``halfar_t0`` (≈ 2.5e5 years, where float32 times
are 1/64 year apart and a month's step is differenced from them), on
N = 48 cells a side at dx = 2.56·R0/N, each package building it with its
own ``halfar_glacier``; one year of monthly saves through SI2 (PCG-12, a
PCG-6 predictor, one substep), no mass balance:

- the forward of ``ConstantA(8e-19)`` (``forward_batch``);
- the classical scalar-A inversion's loss and gradient
  (``LawA_inversion(p, scalar=True)`` at θ = 0) against observations at the
  span's ends from the forward at 1.2·A.

Float64 is held to 1e-9 relative; float32 (the benchmark's dtype: H0 and B
cast, the rest as built) to TOL_F32_H on the trajectory and TOL_F32_LOSS on
the loss and gradient: the packages sum CG's dot products in another order
(1e-7 of each α and β). A year moves the dome by less than float32 resolves
of its 3000 m at most cells, so the float32 trajectories round alike
almost everywhere; the gradient, a sum over the whole plane, shows the
order most.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import ThicknessData as JThicknessData, stack_glaciers as j_stack
from odinn_tpu.data.halfar import HalfarParameters as JHalfarParameters, halfar_t0 as j_t0
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar_glacier
from odinn_tpu.laws.laws import ConstantA as JConstantA, LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.simulation.inversion import batch_transient_loss as j_loss
from odinn_tpu.simulation.prediction import forward_batch as j_forward_batch
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.core.glacier import ThicknessData, stack_glaciers
from odinn_tpu_torch.data.halfar import HalfarParameters, halfar_t0
from odinn_tpu_torch.data.synthetic import halfar_glacier
from odinn_tpu_torch.laws.laws import ConstantA, LawA_inversion
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.simulation.inversion import batch_transient_loss
from odinn_tpu_torch.simulation.prediction import forward_batch
from odinn_tpu_torch.simulation.solver import build_tstops
from tests.torch_parity import CPU, assert_rel, np64

torch.set_num_threads(1)

R0, H0, A_TRUE = 800_000.0, 3000.0, 8e-19
N = 48
DX = 2.56 * R0 / N
YEARS = 1.0
STEP = 1.0 / 12.0
TOL_F64 = 1e-9
# measured on the CPU: 3.1e-13 (trajectory), 0 (loss), 1.3e-7 (gradient)
TOL_F32_H = 1e-6
TOL_F32_LOSS = 1e-5


def _t0():
    t0 = halfar_t0(HalfarParameters(R0=R0, H0=H0, A=A_TRUE, n=3.0))
    assert t0 == pytest.approx(float(j_t0(JHalfarParameters(R0=R0, H0=H0, A=A_TRUE, n=3.0))),
                               rel=1e-15)
    return t0


def _params(P, t0):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=(t0, t0 + YEARS), use_MB=False,
                                          use_velocities=False),
        solver=P.SolverParameters(solver="SI2", step=STEP, substeps=1, cg_iters=12,
                                  cg_iters_predictor=6),
        UDE=P.UDEParameters(grad="jax"))


@pytest.fixture(scope="module")
def scenario():
    """Per dtype: (JAX batch, port batch, JAX params, port params, tstops)."""
    t0 = _t0()
    out = {}
    for name, jdt, tdt in (("float64", jnp.float64, torch.float64),
                           ("float32", jnp.float32, torch.float32)):
        kw = dict(nx=N, ny=N, dx=DX, dy=DX, r0=R0, h0=H0, A=A_TRUE, temp=-20.0, t_ic=t0,
                  rgi_id=f"icesheet-{N}")
        jg = j_halfar_glacier(**kw)
        jg = jg.replace(H0=jg.H0.astype(jdt), B=jg.B.astype(jdt))
        tg = halfar_glacier(**kw, device=CPU)
        tg = tg.replace(H0=tg.H0.to(tdt), B=tg.B.to(tdt))
        # the two packages' powers round the dome apart by an ulp
        assert_rel(tg.H0, np.asarray(jg.H0), 1e-14 if name == "float64" else 1e-7, "H0")
        jp, tp = _params(JP, t0), _params(TP, t0)
        ts = j_tstops((t0, t0 + YEARS), STEP)
        tstops = build_tstops((t0, t0 + YEARS), STEP)
        np.testing.assert_array_equal(tstops.numpy(), np.asarray(ts))
        out[name] = (j_stack([jg]), stack_glaciers([tg], device=CPU), jp, tp, ts, tstops)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_icesheet_forward_matches_jax(scenario, dtype):
    """The SI2 forward of ConstantA(8e-19) over a year: every monthly
    thickness field against the JAX package's."""
    jb, tb, jp, tp, ts, tstops = scenario[dtype]
    jH = j_forward_batch(None, jb, JModel(iceflow=JSIA2DModel(A=JConstantA(A_TRUE))), jp, ts)
    tH = forward_batch(None, tb, Model(iceflow=SIA2DModel(A=ConstantA(A_TRUE))), tp, tstops,
                       device=CPU)
    assert tH.dtype == getattr(torch, dtype) and tuple(tH.shape) == (1, len(tstops), N, N)
    assert torch.isfinite(tH).all() and float(tH[0, -1].max()) > 0.5 * H0
    assert_rel(tH, np.asarray(jH), TOL_F64 if dtype == "float64" else TOL_F32_H, "H")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_icesheet_loss_and_gradient_match_jax(scenario, dtype):
    """The scalar-A inversion's loss and its gradient at θ = 0 against
    observations at the span's ends from the forward at 1.2·A (the JAX
    package's, handed to both as numpy)."""
    jb, tb, jp, tp, ts, tstops = scenario[dtype]
    traj = j_forward_batch(None, jb, JModel(iceflow=JSIA2DModel(A=JConstantA(1.2 * A_TRUE))),
                           jp, ts)
    obs_t = np.asarray([[ts[0], ts[-1]]])
    obs_H = np.stack([np.asarray(traj[:, 0]), np.asarray(traj[:, -1])], axis=1)
    jb = jb.replace(thickness_data=JThicknessData(t=jnp.asarray(obs_t), H=jnp.asarray(obs_H)))
    tb = dataclasses.replace(tb, thickness_data=ThicknessData(
        t=torch.as_tensor(obs_t), H=torch.as_tensor(obs_H)))
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    jm = JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True)))
    val_j, grad_j = jax.value_and_grad(lambda th: j_loss(th, jb, jm, jp, ts))(
        {"A": jnp.zeros((1,), jdt)})
    tm = Model(iceflow=SIA2DModel(A=LawA_inversion(tp, scalar=True)))
    theta = {"A": torch.zeros(1, dtype=getattr(torch, dtype), requires_grad=True)}
    val = batch_transient_loss(theta, tb, tm, tp, tstops)
    (grad,) = torch.autograd.grad(val, [theta["A"]])
    tol = TOL_F64 if dtype == "float64" else TOL_F32_LOSS
    assert float(np64(val)) > 0.0 and np.isfinite(np64(grad)).all()
    assert_rel(val, np.asarray(val_j), tol, "loss")
    assert_rel(grad, np.asarray(grad_j["A"]), tol, "gradient")
