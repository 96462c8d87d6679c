"""odinn_tpu_torch's time-aggregated losses against odinn_tpu's.

``_state_at``, ``LossDhdt`` and ``LossAvgV`` on a stacked batch of three
glaciers (each with its own observation dates) against the JAX functions
run glacier by glacier: values, residuals, and the gradients with respect
to the trajectory and the creep coefficients (autograd against
``jax.grad``); float64 on the CPU, 1e-12 relative.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.losses.time_aggregated as JT
import odinn_tpu.physics.sia2d as jsia
import odinn_tpu.physics.targets as jtg
import odinn_tpu_torch.losses.time_aggregated as TT
import odinn_tpu_torch.physics.sia2d as tsia
import odinn_tpu_torch.physics.targets as ttg
from odinn_tpu.core.glacier import DhdtData as JDhdt, SurfaceVelocityData as JVel
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu.losses.losses import LossContext as JLossContext
from odinn_tpu_torch.core.glacier import DhdtData, SurfaceVelocityData
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from odinn_tpu_torch.losses.losses import LossContext
from tests.torch_parity import assert_rel

RTOL = 1e-12
N_G, NX, NY = 3, 24, 28
TSTOPS = np.array([5.0, 5.08, 5.2, 5.25, 5.4, 5.5])
DX = np.array([100.0, 120.0, 140.0])
A_VALS = np.array([2e-18, 6e-18, 1e-17])
T1 = np.array([5.0, 5.1, 5.2])          # between saves, on one, on one
T2 = np.array([5.5, 5.33, 5.45])
NORM = np.array([NX * NY, 500.0, 600.0])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x, y = np.meshgrid(np.linspace(-1, 1, NX), np.linspace(-1, 1, NY), indexing="ij")
    dome = np.clip(250.0 * (1 - (x ** 2 + y ** 2) / 0.7), 0.0, None)
    traj = dome[None, None] * (1.0 + 0.05 * rng.standard_normal((len(TSTOPS), N_G, 1, 1)))
    traj = traj + 3.0 * rng.standard_normal(traj.shape) * (dome > 0)
    B = 40.0 * rng.random((N_G, NX, NY))
    dhdt = 5.0 * rng.standard_normal((N_G, NX, NY))
    vabs = np.abs(20.0 * rng.standard_normal((N_G, 1, NX, NY))) * (dome > 0)
    return traj, B, dhdt, vabs


def _jax_ctx(g, data, A=None, dates=True):
    traj, B, dhdt, vabs = data
    a = A_VALS[g] if A is None else A
    Bg = jnp.asarray(B[g])

    def vfn(h, t):
        vals = jsia.SIAValues(A=a, C=0.0, n=3.0, p=3.0, q=0.0)
        return jsia.v_from_h(h, Bg, DX[g], DX[g], lambda hb, gs: vals, jtg.ATarget(), JPhys())

    glacier = types.SimpleNamespace(
        dhdt_data=JDhdt(t1=jnp.asarray(T1[g]), t2=jnp.asarray(T2[g]), dhdt=jnp.asarray(dhdt[g])),
        velocity_data=JVel(t=jnp.asarray([T2[g]]), vabs=jnp.asarray(vabs[g]),
                           date1=jnp.asarray(T1[g]) if dates else None,
                           date2=jnp.asarray(T2[g]) if dates else None))
    return JLossContext(velocity_fn=vfn, normalization=NORM[g], glacier=glacier)


def _port_ctx(data, A, dates=True):
    traj, B, dhdt, vabs = data
    t = torch.from_numpy
    col = lambda a: a.reshape(-1, 1, 1)

    def vfn(h, tt):
        vals = tsia.SIAValues(A=col(A), C=0.0, n=3.0, p=3.0, q=0.0)
        return tsia.v_from_h(h, t(B), col(t(DX)), col(t(DX)), tsia.ValuesFn(vals),
                             ttg.ATarget(), TPhys())

    glacier = types.SimpleNamespace(
        dhdt_data=DhdtData(t1=t(T1), t2=t(T2), dhdt=t(dhdt)),
        velocity_data=SurfaceVelocityData(t=t(T2[:, None]), vabs=t(vabs),
                                          date1=t(T1) if dates else None,
                                          date2=t(T2) if dates else None))
    return LossContext(velocity_fn=vfn, normalization=t(NORM), glacier=glacier)


@pytest.mark.parametrize("when", ["per glacier", "one time", "clipped"])
def test_state_at_matches_jax(data, when):
    traj = data[0]
    ts = torch.from_numpy(TSTOPS)
    if when == "per glacier":
        out = TT._state_at(torch.from_numpy(traj), ts, torch.from_numpy(T2))
        for g in range(N_G):
            ref = JT._state_at(jnp.asarray(traj[:, g]), jnp.asarray(TSTOPS), T2[g])
            assert_rel(out[g], ref, RTOL, "state")
    else:
        t = 5.3 if when == "one time" else 5.7
        out = TT._state_at(torch.from_numpy(traj), ts, t)
        ref = JT._state_at(jnp.asarray(traj), jnp.asarray(TSTOPS), t)
        assert_rel(out, ref, RTOL, "state")


@pytest.mark.parametrize("name,dates", [("dhdt", True), ("avgV", True), ("avgV", False)])
def test_loss_values_residuals_and_gradients_match_jax(data, name, dates):
    """Value, residuals, and the gradient with respect to the trajectory
    and each glacier's A, against the JAX term per glacier (``dates``:
    LossAvgV's interval from the data's dates or the whole span)."""
    jterm, tterm = (JT.LossDhdt(), TT.LossDhdt()) if name == "dhdt" else (JT.LossAvgV(),
                                                                          TT.LossAvgV())
    traj = data[0]
    ts = torch.from_numpy(TSTOPS)
    ttraj = torch.from_numpy(traj).requires_grad_(True)
    tA = torch.from_numpy(A_VALS).requires_grad_(True)
    ctx = _port_ctx(data, tA, dates)
    val = tterm(ctx, ttraj, ts)
    (res,) = tterm.residuals(ctx, ttraj, ts)
    assert val.shape == (N_G,)
    d_traj, d_A = torch.autograd.grad(torch.sum(val), (ttraj, tA), allow_unused=True)
    for g in range(N_G):
        jtraj = jnp.asarray(traj[:, g])
        jval, (jg_traj, jg_A) = jax.value_and_grad(
            lambda tr, a: jterm(_jax_ctx(g, data, a, dates), tr, jnp.asarray(TSTOPS)),
            argnums=(0, 1))(jtraj, jnp.asarray(A_VALS[g]))
        assert_rel(val[g], jval, RTOL, f"{name} value")
        (jres,) = jterm.residuals(_jax_ctx(g, data, None, dates), jtraj, jnp.asarray(TSTOPS))
        assert_rel(res[g], jres, RTOL, f"{name} residual")
        assert_rel(d_traj[:, g], jg_traj, RTOL, f"{name} trajectory gradient")
        if name == "avgV":
            assert_rel(d_A[g], jg_A, RTOL, f"{name} A gradient")
    assert_rel(torch.sum(res ** 2, dim=(-2, -1)), val, RTOL, "Σr²")
    assert float(val.detach().min()) > 0.0


def test_missing_observations_give_zero(data):
    ctx = LossContext(glacier=types.SimpleNamespace(dhdt_data=None, velocity_data=None))
    traj = torch.from_numpy(data[0])
    ts = torch.from_numpy(TSTOPS)
    for term in (TT.LossDhdt(), TT.LossAvgV()):
        assert float(term(ctx, traj, ts)) == 0.0
        assert term.residuals(ctx, traj, ts) == ()
