"""odinn_tpu_torch's Halfar dome against odinn_tpu's, and ports of the
analytic checks of ``tests/test_halfar.py``.

The dome, ``halfar_solution`` and ``halfar_velocity`` on the same grids
and times as the JAX package's, float64, 1e-12 relative; then the
similarity solution's own properties: its profile at t₀, volume
conservation without mass balance, spreading and flattening, the
``halfar_solution`` API against the ``Halfar`` closure, and an outward
velocity.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.data.halfar as jh
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu_torch.core.params import PhysicalParameters
from odinn_tpu_torch.data.halfar import Halfar, HalfarParameters, halfar_solution, halfar_velocity
from tests.torch_parity import assert_rel


def grid(nx, ny, dx, dy):
    xs = torch.tensor([(i - nx / 2) * dx for i in range(nx)], dtype=torch.float64)
    ys = torch.tensor([(j - ny / 2) * dy for j in range(ny)], dtype=torch.float64)
    return torch.meshgrid(xs, ys, indexing="ij")


_CASES = [dict(R0=2000.0, H0=400.0, A=1.1e-17, n=3.0),
          dict(R0=1500.0, H0=300.0, A=4e-18, n=3.0, lam=0.2),
          dict(R0=1800.0, H0=350.0, A=2e-18, n=4.0)]


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_halfar_dome_and_velocity_match_jax(case):
    kw = _CASES[case]
    p, jp = HalfarParameters(**kw), jh.HalfarParameters(**kw)
    x, y = grid(64, 60, 70.0, 75.0)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    fn, t0 = Halfar(p)
    jfn, jt0 = jh.Halfar(jp)
    assert abs(t0 - jt0) <= 1e-12 * jt0
    for t in (t0, 1.7 * t0):
        assert_rel(fn(x, y, t), jfn(jx, jy, t), 1e-12, "H")
        vx, vy = halfar_velocity(p)(x, y, t)
        jvx, jvy = jh.halfar_velocity(jp)(jx, jy, t)
        assert_rel(vx, jvx, 1e-12, "vx")
        assert_rel(vy, jvy, 1e-12, "vy")
    phys, jphys = PhysicalParameters(), JPhys()
    r = torch.sqrt(x ** 2 + y ** 2)
    assert_rel(halfar_solution(r, 5.0, kw["H0"], kw["R0"], kw["A"], kw["n"], phys,
                               kw.get("lam", 0.0)),
               jh.halfar_solution(jnp.asarray(r.numpy()), 5.0, kw["H0"], kw["R0"], kw["A"],
                                  kw["n"], jphys, kw.get("lam", 0.0)), 1e-12, "solution")


def test_profile_at_t0():
    p = HalfarParameters(R0=2000.0, H0=400.0, A=1.1e-17, n=3.0)
    fn, t0 = Halfar(p)
    assert t0 > 0
    x, y = grid(128, 128, 40.0, 40.0)
    H = fn(x, y, t0)
    np.testing.assert_allclose(float(H.max()), p.H0, rtol=1e-2)
    r = torch.sqrt(x ** 2 + y ** 2)
    margin = float(torch.where(H > 0, r, torch.zeros_like(r)).max())
    assert p.R0 - 60.0 <= margin <= p.R0 + 60.0


def test_volume_conserved_no_mb():
    """λ = 0: the ice volume does not change in time."""
    p = HalfarParameters(R0=2000.0, H0=400.0, A=1.1e-17, n=3.0, lam=0.0)
    fn, t0 = Halfar(p)
    x, y = grid(256, 256, 30.0, 30.0)
    np.testing.assert_allclose(float(fn(x, y, t0).sum()), float(fn(x, y, t0 + 20.0).sum()),
                               rtol=2e-3)


def test_dome_spreads_and_flattens():
    p = HalfarParameters(R0=2000.0, H0=400.0, A=1.1e-17, n=3.0)
    fn, t0 = Halfar(p)
    x, y = grid(128, 128, 60.0, 60.0)
    H0, H1 = fn(x, y, t0), fn(x, y, t0 + 30.0)
    assert float(H1.max()) < float(H0.max())
    assert int((H1 > 0).sum()) > int((H0 > 0).sum())


def test_halfar_solution_api():
    """halfar_solution(R, t, …) is the Halfar closure at radius R."""
    phys = PhysicalParameters()
    p = HalfarParameters(R0=1000.0, H0=500.0, A=8e-19, n=3.0, rho=phys.rho, g=phys.g)
    fn, t0 = Halfar(p)
    x, y = grid(100, 100, 50.0, 50.0)
    r = torch.sqrt(x ** 2 + y ** 2)
    np.testing.assert_allclose(halfar_solution(r, 5.0, 500.0, 1000.0, 8e-19, 3.0, phys).numpy(),
                               fn(x, y, 5.0).numpy(), atol=1e-10)
    assert 5.0 > t0


def test_velocity_points_outward():
    p = HalfarParameters(R0=2000.0, H0=400.0, A=1.1e-17, n=3.0)
    vel, t0 = halfar_velocity(p), Halfar(p)[1]
    x, y = grid(64, 64, 80.0, 80.0)
    vx, vy = vel(x, y, t0 * 2.0)
    assert float((vx * x + vy * y).min()) >= -1e-9
    assert float(torch.sqrt(vx ** 2 + vy ** 2).max()) > 0.0
