"""odinn_tpu_torch's regularization terms against odinn_tpu's.

The Laplacian and its hand transpose, and every term's value and residuals
on a stacked batch of three glaciers (per-glacier spacings) against the JAX
package's terms run glacier by glacier; float64 on the CPU, 1e-12
relative. Then the ports of three ``tests/test_losses.py`` cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.losses.regularization as JR
import odinn_tpu.physics.sia2d as jsia
import odinn_tpu.physics.targets as jtg
import odinn_tpu_torch.losses.regularization as TR
import odinn_tpu_torch.physics.sia2d as tsia
import odinn_tpu_torch.physics.targets as ttg
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu.losses.losses import LossContext as JLossContext
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from odinn_tpu_torch.losses.losses import LossContext, LossH, LossHV, LossV, MultiLoss
from odinn_tpu_torch.losses.losses import loss_uses_velocity, term_kind
from odinn_tpu_torch.losses.time_aggregated import LossAvgV, LossDhdt
from tests.torch_parity import assert_rel

RTOL = 1e-12
N_G, NX, NY = 3, 26, 30
DX = np.array([90.0, 110.0, 130.0])
DY = np.array([95.0, 95.0, 120.0])
A_VALS = np.array([2e-18, 8e-18, 4e-17])


def _dome(seed=0):
    """(H, B): three rough domes, some cells ice-free."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(-1, 1, NX), np.linspace(-1, 1, NY), indexing="ij")
    H = np.stack([np.clip(300.0 * (1 - (x ** 2 + y ** 2) / r) + 20.0 * rng.standard_normal(
        (NX, NY)), 0.0, None) for r in (0.6, 0.8, 1.1)])
    B = 50.0 * rng.random((N_G, NX, NY))
    return H, B


def _jctx(g, theta=None, H=None, B=None):
    vals = jsia.SIAValues(A=A_VALS[g], C=0.0, n=3.0, p=3.0, q=0.0)
    vfn = None
    if H is not None:
        Bg = jnp.asarray(B[g])
        vfn = lambda h, t: jsia.v_from_h(h, Bg, DX[g], DY[g], lambda hb, gs: vals,
                                         jtg.ATarget(), JPhys())
    return JLossContext(velocity_fn=vfn, theta=theta, glacier_idx=g, dx=DX[g], dy=DY[g])


def _tctx(theta=None, B=None):
    col = lambda a: torch.from_numpy(a).reshape(-1, 1, 1)
    vals = tsia.SIAValues(A=col(A_VALS), C=0.0, n=3.0, p=3.0, q=0.0)
    vfn = None
    if B is not None:
        Bt = torch.from_numpy(B)
        vfn = lambda h, t: tsia.v_from_h(h, Bt, col(DX), col(DY), tsia.ValuesFn(vals),
                                         ttg.ATarget(), TPhys())
    return LossContext(velocity_fn=vfn, theta=theta, glacier_idx=torch.arange(N_G),
                       dx=torch.from_numpy(DX), dy=torch.from_numpy(DY))


def test_laplacian_and_transpose_match_jax():
    """∇² of a batch with per-glacier spacings, and its transpose, against
    the JAX functions glacier by glacier; the dot-product identity
    ⟨λ, ∇²a⟩ = ⟨∇²ᵀλ, a⟩ per glacier."""
    rng = np.random.default_rng(1)
    a, lam = rng.standard_normal((2, N_G, NX, NY))
    ta, tl = torch.from_numpy(a), torch.from_numpy(lam)
    dx, dy = torch.from_numpy(DX), torch.from_numpy(DY)
    lap, lapT = TR.laplacian(ta, dx, dy), TR.laplacian_vjp(tl, ta, dx, dy)
    for g in range(N_G):
        assert_rel(lap[g], JR.laplacian(jnp.asarray(a[g]), DX[g], DY[g]), RTOL, "laplacian")
        assert_rel(lapT[g], JR.laplacian_vjp(jnp.asarray(lam[g]), jnp.asarray(a[g]), DX[g],
                                             DY[g]), RTOL, "laplacian_vjp")
    lhs = torch.sum(tl * lap, dim=(-2, -1))
    rhs = torch.sum(lapT * ta, dim=(-2, -1))
    assert_rel(lhs, rhs, RTOL, "dot-product identity")
    # and against autograd's transpose
    x = ta.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(TR.laplacian(x, dx, dy), x, tl)
    assert_rel(lapT, ref, RTOL, "autograd transpose")


@pytest.mark.parametrize("name", ["initial", "velocity", "rheology"])
def test_term_values_and_residuals_match_jax(name):
    """Each term's per-glacier value and residual blocks against the JAX
    term's, glacier by glacier; Σ r² equals the value."""
    H, B = _dome()
    rng = np.random.default_rng(2)
    theta_a = rng.standard_normal((N_G, NX - 1, NY - 1))
    if name == "initial":
        jterm, tterm = JR.InitialThicknessRegularization(), TR.InitialThicknessRegularization()
        tctx = _tctx()
        jctx = [_jctx(g) for g in range(N_G)]
    elif name == "velocity":
        jterm, tterm = JR.VelocityRegularization(), TR.VelocityRegularization()
        tctx = _tctx(B=B)
        jctx = [_jctx(g, H=H, B=B) for g in range(N_G)]
    else:
        jterm = JR.RheologyRegularization(min_A=8e-21, max_A=8e-18)
        tterm = TR.RheologyRegularization(min_A=8e-21, max_A=8e-18)
        tctx = _tctx(theta={"A": torch.from_numpy(theta_a)})
        jctx = [_jctx(g, theta={"A": jnp.asarray(theta_a)}) for g in range(N_G)]
    assert tterm.kind == jterm.kind
    tH = torch.from_numpy(H)
    val = tterm(tctx, tH, 5.0)
    (res,) = tterm.residuals(tctx, tH, 5.0)
    assert val.shape == (N_G,)
    for g in range(N_G):
        jH = jnp.asarray(H[g])
        assert_rel(val[g], jterm(jctx[g], jH, 5.0), RTOL, f"{name} value")
        (jres,) = jterm.residuals(jctx[g], jH, 5.0)
        assert_rel(res[g], jres, RTOL, f"{name} residual")
    assert_rel(torch.sum(res ** 2, dim=(-2, -1)), val, RTOL, "Σr²")
    assert float(val.min()) > 0.0


def test_tikhonov_penalizes_roughness():
    smooth = torch.outer(torch.linspace(0, 1, NX, dtype=torch.float64),
                         torch.linspace(0, 1, NY, dtype=torch.float64))
    rough = smooth + 0.1 * torch.from_numpy(np.random.default_rng(0).standard_normal((NX, NY)))
    reg = TR.TikhonovRegularization()
    mask = torch.ones((NX, NY), dtype=torch.bool)
    assert float(reg(rough, 1.0, 1.0, mask)) > 10.0 * float(reg(smooth, 1.0, 1.0, mask))


def test_laplacian_vjp_transpose_identity():
    """⟨λ, ∇²a⟩ = ⟨∇²ᵀλ, a⟩ on one glacier with number spacings, and the
    transpose equals jax.linear_transpose of the JAX Laplacian."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((NX, NY)))
    lam = torch.from_numpy(np.random.default_rng(4).standard_normal((NX, NY)))
    dx, dy = 37.0, 53.0
    lhs = torch.sum(lam * TR.laplacian(a, dx, dy))
    rhs = torch.sum(TR.laplacian_vjp(lam, a, dx, dy) * a)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    (ref,) = jax.linear_transpose(lambda x: JR.laplacian(x, dx, dy), jnp.asarray(a.numpy()))(
        jnp.asarray(lam.numpy()))
    np.testing.assert_allclose(TR.laplacian_vjp(lam, a, dx, dy).numpy(), np.asarray(ref),
                               atol=1e-12)


def test_term_kinds_and_velocity_trait():
    assert term_kind(LossH()) == "transient"
    assert term_kind(TR.InitialThicknessRegularization()) == "initial"
    assert term_kind(TR.RheologyRegularization()) == "initial"
    assert term_kind(TR.VelocityRegularization()) == "transient"
    assert term_kind(LossDhdt()) == "aggregate"
    assert term_kind(LossAvgV()) == "aggregate"
    assert not loss_uses_velocity(LossH())
    assert loss_uses_velocity(LossV())
    assert loss_uses_velocity(LossHV())
    assert loss_uses_velocity(MultiLoss((LossH(), LossV()), (1.0, 0.5)))


def test_diffusivity_regularization_is_declared_only():
    term = TR.DiffusivityRegularization()
    assert term.kind == "transient"
    with pytest.raises(NotImplementedError, match="not defined"):
        term(_tctx(), torch.zeros((N_G, NX, NY), dtype=torch.float64), 0.0)
