"""odinn_tpu_torch time integration against odinn_tpu: tstops, the explicit
steppers, the fixed-substep and semi-implicit integrators, and the places
where a port can drift from the JAX package without failing loudly (float32
time arithmetic, the month-window index, dtype promotion, the CG warm
start).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.simulation.implicit as jimp
import odinn_tpu.simulation.solver as jsol
import odinn_tpu_torch.simulation.implicit as timp
import odinn_tpu_torch.simulation.solver as tsol
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu.physics.sia2d import SIAValues as JVals
from odinn_tpu.physics.targets import ATarget as JTarget
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from odinn_tpu_torch.physics.sia2d import SIAValues as TVals, ValuesFn
from odinn_tpu_torch.physics.targets import ATarget as TTarget
from tests.torch_parity import assert_rel

RTOL = 1e-12


def test_build_tstops_matches():
    for args in [((5.0, 10.0), 1 / 12), ((2010.0, 2012.0), 0.25, [2010.3, 2011.0000001, 2013.0]),
                 ((0.0, 1.0), 0.1, np.float32([0.35, 0.4]))]:
        np.testing.assert_array_equal(tsol.build_tstops(*args).numpy(),
                                      np.asarray(jsol.build_tstops(*args)))


def _linear_rhs(k):
    """dy/dt = −k·y + sin(y) on both sides."""
    return (lambda y, t: -k * y + jnp.sin(y)), (lambda y, t: -k * y + torch.sin(y))


@pytest.mark.parametrize("method,compensated", [
    ("Euler", False), ("RK4", False), ("SSPRK3", False), ("RKC", False),
    ("RK4", True), ("SSPRK3", True), ("Euler", True),
])
def test_integrate_scan_matches(method, compensated):
    rng = np.random.default_rng(3)
    y0 = rng.random((2, 5, 6))
    fj, ft = _linear_rhs(2.0)
    ts = jsol.build_tstops((0.0, 1.0), 0.125)

    def cb_j(y, t0, t1, i):
        return jax.lax.cond(i % 2 == 1, lambda y: y * 0.99 + 0.01, lambda y: y, y)

    def cb_t(y, t0, t1, i):
        return y * 0.99 + 0.01 if i % 2 == 1 else y

    ref = jsol.integrate_scan(fj, jnp.asarray(y0), ts, 3, method=method, callback=cb_j,
                              rkc_stages=5, compensated=compensated)
    out = tsol.integrate_scan(ft, torch.from_numpy(y0), tsol.build_tstops((0.0, 1.0), 0.125),
                              3, method=method, callback=cb_t, rkc_stages=5,
                              compensated=compensated)
    assert_rel(out, ref, RTOL)


def test_float32_time_arithmetic_matches():
    """tstops are cast to the state dtype before differencing: in a float32
    solve dt and the substep times are float32 quantities, and dt is
    (t1 − t0)·fl32(1/substeps), the reciprocal product XLA compiles the JAX
    package's division into. Euler on dy/dt = 1 then matches the JAX
    package bit for bit at every substep count from 1 to 25; IEEE division
    by the count, or differencing the float64 tstops first, would give
    another trajectory."""
    tspan = (2010.0, 2015.0)
    ts64 = np.asarray(jsol.build_tstops(tspan, 1 / 12), np.float64)
    ts32 = ts64.astype(np.float32)
    y0 = np.zeros((3, 4), dtype=np.float32)
    for k in range(1, 26):
        ref = jsol.integrate_scan(lambda y, t: jnp.ones_like(y), jnp.asarray(y0),
                                  jsol.build_tstops(tspan, 1 / 12), k, method="Euler")
        out = tsol.integrate_scan(lambda y, t: torch.ones_like(y), torch.from_numpy(y0),
                                  tsol.build_tstops(tspan, 1 / 12), k, method="Euler")
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=f"substeps={k}")
    rec = np.float32(1.0) / np.float32(3)
    y_rec, y_div, y64dt = [np.float32(0.0)], [np.float32(0.0)], [np.float32(0.0)]
    for i in range(len(ts32) - 1):
        dt_rec = (ts32[i + 1] - ts32[i]) * rec
        dt_div = (ts32[i + 1] - ts32[i]) / np.float32(3)
        dt64 = (ts64[i + 1] - ts64[i]) / 3.0      # differenced before the cast
        a, b, c = y_rec[-1], y_div[-1], y64dt[-1]
        for _ in range(3):
            a, b, c = (np.float32(a + dt_rec), np.float32(b + dt_div),
                       np.float32(c + np.float32(dt64)))
        y_rec.append(a)
        y_div.append(b)
        y64dt.append(c)
    out = tsol.integrate_scan(lambda y, t: torch.ones_like(y), torch.from_numpy(y0),
                              tsol.build_tstops(tspan, 1 / 12), 3, method="Euler")
    np.testing.assert_array_equal(out[:, 0, 0].numpy(), np.asarray(y_rec))
    assert not np.array_equal(np.asarray(y_rec), np.asarray(y_div))
    assert not np.array_equal(np.asarray(y_rec), np.asarray(y64dt))
    # and a stiff nonlinear RHS, compensated SSPRK3, to float32 roundoff
    fj, ft = _linear_rhs(3.0)
    y1 = np.linspace(0.1, 2.0, 12, dtype=np.float32).reshape(3, 4)
    ref = jsol.integrate_scan(fj, jnp.asarray(y1), jsol.build_tstops(tspan, 1 / 12), 4,
                              method="SSPRK3", compensated=True)
    out = tsol.integrate_scan(ft, torch.from_numpy(y1), tsol.build_tstops(tspan, 1 / 12), 4,
                              method="SSPRK3", compensated=True)
    assert_rel(out, ref, 1e-6)
    ts32 = tsol.host_tstops(tsol.build_tstops(tspan, 1 / 12), torch.float32)
    assert ts32.dtype == np.float32
    dts = np.diff(ts32)
    assert len(set(dts.tolist())) > 1   # float32 monthly steps are not all equal


def _si_problem(n_g=2, nx=20, ny=24, seed=6):
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - nx / 2) * 100.0
    y = (np.arange(ny) - ny / 2) * 100.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    H = np.stack([300.0 * s * np.clip(1 - r2 / (700.0 * s) ** 2, 0, None) ** (3 / 7)
                  for s in (1.0, 0.8, 1.2)[:n_g]])
    B = 10.0 * rng.random((n_g, nx, ny))
    A = np.array([2e-18, 6e-18, 4e-18])[:n_g]
    return H, B, A


def _j_vfn(A):
    vals = JVals(A=A, C=0.0, n=3.0, p=3.0, q=0.0)
    return lambda hb, gs: vals


def _t_vfn(A, fused=True):
    vals = TVals(A=torch.from_numpy(A).reshape(-1, 1, 1), C=0.0, n=3.0, p=3.0, q=0.0)
    return ValuesFn(vals) if fused else ValuesFn(vals, lambda v, hb, gs: v)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("theta,star", [(1.0, False), (0.5, True)])
def test_semi_implicit_step_matches(fused, theta, star):
    H, B, A = _si_problem()
    H_star = 0.95 * H if star else None
    x0 = 1.01 * H

    def jone(h, b, a, hs, x):
        return jimp.semi_implicit_step(h, b, 100.0, 100.0, _j_vfn(a), JTarget(), JPhys(),
                                       0.25, 10, x0=x, theta=theta,
                                       H_star=hs if star else None)

    ref = jax.vmap(jone)(jnp.asarray(H), jnp.asarray(B), jnp.asarray(A),
                         jnp.asarray(H if H_star is None else H_star), jnp.asarray(x0))
    t = torch.from_numpy
    out = timp.semi_implicit_step(t(H), t(B), 100.0, 100.0, _t_vfn(A, fused), TTarget(), TPhys(),
                                  0.25, 10, x0=t(x0), theta=theta,
                                  H_star=None if H_star is None else t(H_star))
    assert_rel(out, ref, 1e-10)


@pytest.mark.parametrize("corrector", [False, True])
def test_integrate_semi_implicit_matches(corrector):
    H, B, A = _si_problem()
    ts = jsol.build_tstops((0.0, 0.5), 1 / 12)

    def jone(h, b, a):
        return jimp.integrate_semi_implicit(h, b, 100.0, 100.0, _j_vfn(a), JTarget(), JPhys(),
                                            ts, substeps=2, cg_iters=8,
                                            corrector=corrector, cg_iters_predictor=4)

    ref = jax.vmap(jone)(jnp.asarray(H), jnp.asarray(B), jnp.asarray(A))
    out = timp.integrate_semi_implicit(
        torch.from_numpy(H), torch.from_numpy(B), 100.0, 100.0, _t_vfn(A), TTarget(), TPhys(),
        tsol.build_tstops((0.0, 0.5), 1 / 12), substeps=2, cg_iters=8, corrector=corrector,
        cg_iters_predictor=4)
    assert_rel(out.movedim(0, 1), ref, 1e-10)


def test_si_warm_start_begins_with_ratio_zero():
    """The warm-start carry starts at dt_prev = 0, so the first step's CG
    guess is H itself; the second step extrapolates."""
    H, B, A = _si_problem()
    t = torch.from_numpy
    ts = tsol.build_tstops((0.0, 2 / 12), 1 / 12)
    traj = timp.integrate_semi_implicit(t(H), t(B), 100.0, 100.0, _t_vfn(A), TTarget(), TPhys(),
                                        ts, cg_iters=3)
    dt = float(ts[1] - ts[0])
    first = timp.semi_implicit_step(t(H), t(B), 100.0, 100.0, _t_vfn(A), TTarget(), TPhys(),
                                    dt, 3, x0=t(H))
    assert torch.equal(traj[1], first)
    second = timp.semi_implicit_step(first, t(B), 100.0, 100.0, _t_vfn(A), TTarget(), TPhys(),
                                     dt, 3, x0=first + 1.0 * (first - t(H)))
    assert torch.equal(traj[2], second)
    # 3 CG iterations from a cold guess give another answer
    cold = timp.semi_implicit_step(first, t(B), 100.0, 100.0, _t_vfn(A), TTarget(), TPhys(),
                                   dt, 3, x0=first)
    assert not torch.equal(traj[2], cold)


def test_float64_law_values_do_not_promote_a_float32_solve():
    """Cuffey–Paterson gives float64 values and the bed may be float64: the
    RHS, the SI step and the MB step all stay in the state's float32."""
    from odinn_tpu_torch.core.glacier import Glacier
    from odinn_tpu_torch.data.synthetic import monthly_dummy_climate
    from odinn_tpu_torch.laws.laws import poly_A_paterson_cuffey
    from odinn_tpu_torch.physics.mass_balance import TImodel1, mb_timestep
    from odinn_tpu_torch.physics.sia2d import sia2d_rhs

    H, B, _ = _si_problem()
    A = poly_A_paterson_cuffey()(torch.tensor([-10.0, -20.0]))
    assert A.dtype == torch.float64
    H32, B64 = torch.from_numpy(H).float(), torch.from_numpy(B)
    for fused in (True, False):
        vfn = ValuesFn(TVals(A=A.reshape(-1, 1, 1), C=0.0, n=3.0, p=3.0, q=0.0),
                       None if fused else (lambda v, hb, gs: v))
        assert sia2d_rhs(H32, B64, 100.0, 100.0, vfn, TTarget(), TPhys()).dtype == torch.float32
        step = timp.semi_implicit_step(H32, B64, 100.0, 100.0, vfn, TTarget(), TPhys(),
                                       float(np.float32(1 / 12)), 4)
        assert step.dtype == torch.float32
    clim = monthly_dummy_climate(0.0, 14, device="cpu")
    stacked = Glacier(H0=H32, B=B64, climate=type(clim)(
        **{k: torch.stack([v, v]) for k, v in vars(clim).items() if v is not None}))
    assert mb_timestep(H32, stacked, TImodel1(), np.float32(0.5), 1 / 12).dtype == torch.float32


def test_mb_window_index_in_state_dtype():
    """m0 = round((t − step − t_start)·12) is formed in the state dtype with
    round-half-even. Times t = 2010 + (k + ½)/12 put the index near the tie
    k − ½, where float32 and float64 rounding pick different months for
    some k; the port picks the JAX package's month in both dtypes."""
    import odinn_tpu.physics.mass_balance as jmb
    import odinn_tpu.data.synthetic as jsyn
    import odinn_tpu_torch.physics.mass_balance as tmb
    from tests.torch_parity import carry_glacier

    found = False
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        clim = jsyn.monthly_dummy_climate(2010.0, 30, temp_amplitude=9.0)
        g = jsyn.halfar_glacier(nx=10, ny=10, dx=100.0, climate=clim)
        g = jax.tree.map(lambda x: x.astype(jdt) if jnp.issubdtype(x.dtype, jnp.floating) else x, g)
        tg = carry_glacier(g)
        mb_j, mb_t = jmb.TImodel1(), tmb.TImodel1()
        for k in range(1, 25):
            tj = jnp.asarray(2010.0 + (k + 0.5) / 12.0, jdt)
            idx_j = int(jnp.round((tj - 1 / 12 - g.climate.t_start) * 12.0))
            idx_64 = int(np.round((2010.0 + (k + 0.5) / 12.0 - 1 / 12 - 2010.0) * 12.0))
            found |= idx_j != idx_64
            ref = jmb.compute_mb(mb_j, g.climate, g.S, tj, 1 / 12)
            out = tmb.compute_mb(mb_t, tg.climate, tg.S, np.asarray(tj), 1 / 12)
            assert out.dtype == dtype
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert found   # some float32 window index differs from the float64 one


@pytest.mark.parametrize("args", [
    dict(dx=100.0, dy=100.0, h_max=500.0, a_max=8e-18),
    dict(dx=50.0, dy=80.0, h_max=324.5, a_max=2.4e-18, n=3.0, step=0.25),
    dict(dx=200.0, dy=200.0, h_max=150.0, a_max=1e-19, n=4.0, slope_max=0.5, safety=1.5),
])
def test_stage_and_substep_sizing_match(args):
    assert tsol.rkc_stages_for(**args) == jsol.rkc_stages_for(**args)
    assert tsol.suggest_substeps(**args) == jsol.suggest_substeps(**args)


def test_bs32_step_matches():
    """The embedded BS3(2) step of the continuous adjoint against the JAX
    package's: with one dt for the batch, and with a dt (and a time) per
    glacier, each glacier as the JAX step with its own, 1e-12."""
    rng = np.random.default_rng(9)
    y, k = rng.standard_normal((3, 5, 6)), rng.uniform(0.5, 2.0, (3, 1, 1))

    def f_t(u, t):
        t = t.reshape(-1, 1, 1) if isinstance(t, torch.Tensor) else t
        return -torch.from_numpy(k) * u + torch.sin(u + t)

    def f_j(u, t, kk=jnp.asarray(k)):
        return -kk * u + jnp.sin(u + t)

    k1_t, k1_j = f_t(torch.from_numpy(y), 0.3), f_j(jnp.asarray(y), 0.3)
    for a, b in zip(tsol._bs32_step(f_t, torch.from_numpy(y), 0.3, 0.05, k1_t),
                    jsol._bs32_step(f_j, jnp.asarray(y), 0.3, 0.05, k1_j)):
        assert_rel(a, b, RTOL)
    ts, dts = np.array([0.3, 0.5, 0.7]), np.array([0.05, 0.02, 0.1])
    k1 = f_t(torch.from_numpy(y), torch.from_numpy(ts))
    got = tsol._bs32_step(f_t, torch.from_numpy(y), torch.from_numpy(ts), torch.from_numpy(dts),
                          k1)
    for g in range(3):
        kg = jnp.asarray(k[g])
        want = jsol._bs32_step(lambda u, t: f_j(u, t, kg), jnp.asarray(y[g]), ts[g], dts[g],
                               jnp.asarray(k1[g].numpy()))
        for a, b in zip(got, want):
            assert_rel(a[g], b, RTOL)


def _count_fused_steps(monkeypatch):
    from odinn_tpu_torch.ops.cuda import rkc_kernel

    steps = []
    forward = rkc_kernel._forward
    monkeypatch.setattr(rkc_kernel, "_forward",
                        lambda *a, **k: steps.append(1) or forward(*a, **k))
    return steps


@pytest.mark.parametrize("use_mb", [False, True])
def test_fused_rkc_forward_matches_jax(use_mb, monkeypatch):
    """solver="RKC" with per-glacier scalar laws runs one fused RKC step per
    substep (rkc_interval, its plain version on the CPU), against the JAX
    package's generic RKC stages in integrate_scan: 2 glaciers, 24², half a
    year, 2 substeps of s = 5, with and without monthly mass balance,
    float64, 1e-10."""
    import odinn_tpu.simulation.prediction as jpred
    from odinn_tpu.core.glacier import stack_glaciers as j_stack
    from odinn_tpu.core.params import (
        Parameters as JParams, SimulationParameters as JSim, SolverParameters as JSolver)
    from odinn_tpu.data.synthetic import halfar_glacier as j_halfar, monthly_dummy_climate
    from odinn_tpu.laws.laws import CuffeyPaterson as JCP
    from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSM
    from odinn_tpu.physics.mass_balance import TImodel1 as JTI
    from odinn_tpu_torch.core.params import (
        Parameters as TParams, SimulationParameters as TSim, SolverParameters as TSolver)
    from odinn_tpu_torch.laws.laws import CuffeyPaterson as TCP
    from odinn_tpu_torch.models.model import Model as TModel, SIA2DModel as TSM
    from odinn_tpu_torch.physics.mass_balance import TImodel1 as TTI
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from tests.torch_parity import carry_glacier

    tspan = (5.0, 5.5)
    gl = [j_halfar(nx=24, ny=24, dx=150.0, temp=t, rgi_id=f"r{i}",
                   climate=monthly_dummy_climate(5.0, 12, longterm_temp=t, nx=24, ny=24))
          for i, t in enumerate((-15.0, -22.0))]
    jb = j_stack(gl)

    def mk(P, Sim, Solver):
        return P(simulation=Sim(tspan=tspan, use_MB=use_mb, use_velocities=False),
                 solver=Solver(step=1.0 / 12.0, substeps=2, solver="RKC", rkc_stages=5))

    ts = jsol.build_tstops(tspan, 1.0 / 12.0)
    jm = JModel(iceflow=JSM(A=JCP()), mass_balance=JTI() if use_mb else None)
    ref = jpred.forward_batch(None, jb, jm, mk(JParams, JSim, JSolver), ts)
    steps = _count_fused_steps(monkeypatch)
    tm = TModel(iceflow=TSM(A=TCP()), mass_balance=TTI() if use_mb else None)
    out = forward_batch(None, carry_glacier(jb), tm, mk(TParams, TSim, TSolver),
                        tsol.build_tstops(tspan, 1.0 / 12.0), device="cpu")
    assert len(steps) == 6 * 2
    assert_rel(out, ref, 1e-10)


def test_golden_rkc_replay_runs_the_fused_step(monkeypatch):
    """The golden rkc_noMB trajectory (1 year, 20 substeps of s = 16) replays
    at 1e-10 through the fused RKC step, one per substep."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from tests.test_torch_prediction import _FIXTURE, _golden_cases

    params, glacier, model = _golden_cases()["rkc_noMB"]
    with np.load(_FIXTURE) as z:
        ref = z["rkc_noMB_traj"]
    steps = _count_fused_steps(monkeypatch)
    traj = forward_batch(None, stack_glaciers([glacier], device="cpu"), model, params,
                         tsol.build_tstops(params.simulation.tspan, params.solver.step),
                         device="cpu")
    assert len(steps) == 12 * 20
    assert_rel(traj[0], ref, 1e-10)
