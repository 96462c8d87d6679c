"""odinn_tpu_torch's hand-written VJPs against odinn_tpu's.

The stencil transposes by the dot-product identity ⟨A x, y⟩ = ⟨x, Aᵀ y⟩
against the forward stencils and against the JAX package's transposes;
ports of the five cases of ``tests/test_vjps.py`` (the discrete VJP
against autograd, the continuous operator against the discrete one, the
velocity and mass-balance pullbacks against finite differences); and each
function of :mod:`odinn_tpu_torch.inverse.vjps` against its JAX namesake on
two glaciers of different A, float64, 1e-10 relative to the largest value
compared. The A-target law configuration takes the fused RHS pullback (its
plain version on the CPU); an inner (per-RHS-call) law takes the tensor
code of the hand chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.inverse.adjoint_types as JA
import odinn_tpu.ops.stencils as jst
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.inverse.adjoint_types as TA
import odinn_tpu_torch.ops.stencils as tst
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar, monthly_dummy_climate
from odinn_tpu.inverse import vjps as jv
from odinn_tpu.laws.laws import LawA as JLawA
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.models.nn import NeuralNetwork as JNeuralNetwork, default_architecture as j_arch
from odinn_tpu.physics.mass_balance import TImodel1 as JTImodel1
from odinn_tpu_torch.convert import mlp_from_numpy
from odinn_tpu_torch.inverse import vjps as tv
from odinn_tpu_torch.laws.laws import LawA
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
from odinn_tpu_torch.ops.cuda import sia_kernel
from odinn_tpu_torch.physics.mass_balance import TImodel1, mb_timestep
from odinn_tpu_torch.physics.sia2d import surface_velocity
from tests.torch_parity import CPU, assert_rel, carry_glacier

RTOL = 1e-10
T = 5.0
TEMPS = (-16.0, -22.0)


def _rng_field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# Stencil transposes
# ---------------------------------------------------------------------------

_SHAPE = (2, 9, 11)
_LINEAR = {
    # name: (forward, transpose, input shape)
    "diff_x": (lambda a: tst.diff_x(a) / 3.0, lambda i: tst.diff_x_adjoint(i, 3.0), _SHAPE),
    "diff_y": (lambda a: tst.diff_y(a) / 5.0, lambda i: tst.diff_y_adjoint(i, 5.0), _SHAPE),
    "avg": (tst.avg, tst.avg_adjoint, _SHAPE),
    "avg_x": (tst.avg_x, tst.avg_x_adjoint, _SHAPE),
    "avg_y": (tst.avg_y, tst.avg_y_adjoint, _SHAPE),
}


@pytest.mark.parametrize("name", sorted(_LINEAR))
def test_linear_stencil_adjoints_are_transposes(name):
    """⟨A x, y⟩ = ⟨x, Aᵀ y⟩ to roundoff, and Aᵀ equals the JAX package's."""
    fwd, adj, shape = _LINEAR[name]
    x = torch.from_numpy(_rng_field(1, shape))
    y = torch.from_numpy(_rng_field(2, tuple(fwd(x).shape)))
    lhs, rhs = float(torch.sum(fwd(x) * y)), float(torch.sum(x * adj(y)))
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), 1.0)
    j_args = {"diff_x": (3.0,), "diff_y": (5.0,)}.get(name, ())
    assert_rel(adj(y), getattr(jst, f"{name}_adjoint")(jnp.asarray(y.numpy()), *j_args), 1e-14)


@pytest.mark.parametrize("axis", ["dx", "dy"])
def test_clamp_adjoints_are_the_pullback(axis):
    """clamp_borders_d{x,y}_adjoint is the pullback of the clamp in (ds, h)
    (the clamp is piecewise linear: autograd gives its transpose), and
    equals the JAX package's."""
    rng = np.random.default_rng(3)
    h = np.abs(rng.standard_normal((2, 10, 12))) * 2.0
    ds_shape = (2, 9, 10) if axis == "dx" else (2, 8, 11)
    ds = rng.standard_normal(ds_shape)
    dC = rng.standard_normal(ds_shape)
    eta0, d = 1.0, 2.0
    fwd = getattr(tst, f"clamp_borders_{axis}")
    d_ds, d_h = getattr(tst, f"clamp_borders_{axis}_adjoint")(
        torch.from_numpy(dC), eta0, d, torch.from_numpy(h), torch.from_numpy(ds))
    dsr, hr = torch.from_numpy(ds).requires_grad_(True), torch.from_numpy(h).requires_grad_(True)
    g_ds, g_h = torch.autograd.grad(fwd(dsr, hr, eta0, d), (dsr, hr), torch.from_numpy(dC))
    assert_rel(d_ds, g_ds, 1e-14, "d_ds")
    assert_rel(d_h, g_h, 1e-14, "d_h")
    j_ds, j_h = getattr(jst, f"clamp_borders_{axis}_adjoint")(
        jnp.asarray(dC), eta0, d, jnp.asarray(h), jnp.asarray(ds))
    assert_rel(d_ds, j_ds, 1e-14)
    assert_rel(d_h, j_h, 1e-14)


# ---------------------------------------------------------------------------
# The VJPs
# ---------------------------------------------------------------------------

def _params(P):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=(5.0, 6.0), use_MB=False),
        solver=P.SolverParameters(),
        UDE=P.UDEParameters(grad="discrete"))


@pytest.fixture(scope="module")
def setup():
    """Two Halfar glaciers (36 × 32, of different temperature and so A) with
    a monthly climate, A = NN(T) in both packages from the same θ, and a
    cotangent from a numpy seed."""
    jp, tp = _params(JP), _params(TP)
    clim = monthly_dummy_climate(5.0, 24, temp_mean=-2.0, nx=36, ny=32)
    gl = [j_halfar(nx=36, ny=32, dx=110.0, dy=130.0, temp=t, climate=clim, rgi_id=f"g{i}")
          for i, t in enumerate(TEMPS)]
    gl = [g.replace(B=jnp.asarray(g.B) + 1800.0) for g in gl]
    jbatch = j_stack(gl)
    arch = j_arch(1, light=True)
    jtheta = {"A": JNeuralNetwork(arch, seed=2).init()}
    t_arch = default_architecture(1, light=True)
    ttheta = {"A": mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                                   for layer in jtheta["A"]], t_arch, device=CPU)}
    jlaw, tlaw = JLawA(JNeuralNetwork(arch), jp), LawA(NeuralNetwork(t_arch), tp)
    models = {
        "fused": (JModel(iceflow=JSIA2DModel(A=jlaw)), Model(iceflow=SIA2DModel(A=tlaw))),
        # an inner law (evaluated at every RHS call): the tensor code
        "generic": (JModel(iceflow=JSIA2DModel(A=dataclasses.replace(jlaw, callback_freq=None))),
                    Model(iceflow=SIA2DModel(A=dataclasses.replace(tlaw, callback_freq=None)))),
    }
    lam = 1e-2 * _rng_field(4, jbatch.H0.shape)
    return jp, tp, jbatch, carry_glacier(jbatch), jtheta, ttheta, models, lam


def _per_glacier(fn, jbatch, n=len(TEMPS)):
    """The JAX function at each glacier of the batch: (stacked planes) or
    (summed θ tree)."""
    return [fn(jax.tree.map(lambda x: x[i], jbatch), i) for i in range(n)]


def _leaves(tree):
    return [layer[k] for layer in tree["A"] for k in ("w", "b")]


def _sum_trees(trees):
    return [np.sum([np.asarray(leaf) for leaf in leaves], axis=0)
            for leaves in zip(*[_leaves(t) for t in trees])]


_FLAVORS = {"discrete": (JA.DiscreteVJP(), TA.DiscreteVJP()),
            "continuous": (JA.ContinuousVJP(), TA.ContinuousVJP()),
            "auto": (JA.AutoVJP(), TA.AutoVJP()), "none": (JA.NoVJP(), TA.NoVJP())}


@pytest.mark.parametrize("route", ["fused", "generic"])
@pytest.mark.parametrize("flavor", sorted(_FLAVORS))
def test_vjp_sia_dH_matches_jax(setup, flavor, route):
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    jm, tm = models[route]
    jf, tf = _FLAVORS[flavor]
    ref = np.stack(_per_glacier(lambda g, i: jv.vjp_sia_dH(
        jf, jnp.asarray(lam[i]), g.H0, jtheta, g, i, jm, jp, T), jbatch))
    out = tv.vjp_sia_dH(tf, torch.from_numpy(lam), tbatch.H0, ttheta, tbatch, tm, tp, T)
    if flavor == "none":
        assert float(out.abs().max()) == 0.0
    else:
        assert_rel(out, ref, RTOL, f"{flavor} {route}")


@pytest.mark.parametrize("route", ["fused", "generic"])
@pytest.mark.parametrize("flavor", sorted(_FLAVORS))
def test_vjp_sia_dtheta_matches_jax(setup, flavor, route):
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    jm, tm = models[route]
    jf, tf = _FLAVORS[flavor]
    ref = _sum_trees(_per_glacier(lambda g, i: jv.vjp_sia_dtheta(
        jf, jnp.asarray(lam[i]), g.H0, jtheta, g, i, jm, jp, T), jbatch))
    out = _leaves(tv.vjp_sia_dtheta(tf, torch.from_numpy(lam), tbatch.H0, ttheta, tbatch, tm,
                                    tp, T))
    for a, b in zip(out, ref):
        if flavor == "none":
            assert float(a.abs().max()) == 0.0
        else:
            assert_rel(a, b, RTOL, f"{flavor} {route}")


def test_fused_route_is_the_kernel_pullback(setup, monkeypatch):
    """The A-target law configuration takes sia2d_rhs_vjp (its plain
    version on the CPU) for the discrete dH and for the θ route of the
    discrete and continuous flavors; the inner law does not."""
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    calls = []
    real = sia_kernel.sia2d_rhs_vjp_reference
    monkeypatch.setattr(sia_kernel, "sia2d_rhs_vjp_reference",
                        lambda *a: calls.append(1) or real(*a))
    args = (torch.from_numpy(lam), tbatch.H0, ttheta, tbatch)
    fused, generic = models["fused"][1], models["generic"][1]
    tv.vjp_sia_dH(TA.DiscreteVJP(), *args, fused, tp, T)
    tv.vjp_sia_dtheta(TA.DiscreteVJP(), *args, fused, tp, T)
    tv.vjp_sia_dtheta(TA.ContinuousVJP(), *args, fused, tp, T)
    assert len(calls) == 3
    tv.vjp_sia_dH(TA.DiscreteVJP(), *args, generic, tp, T)
    tv.vjp_sia_dtheta(TA.DiscreteVJP(), *args, generic, tp, T)
    assert tv.fused_table(ttheta, tbatch, generic, tp, T, tbatch.H0) is None
    assert len(calls) == 3


def test_rhs_and_velocity_vjps_match_jax(setup):
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    jm, tm = models["fused"]
    n = jbatch.H0.shape
    lx, ly = (1e-3 * _rng_field(s, (n[0], n[1] - 1, n[2] - 1)) for s in (5, 6))
    ref_rhs = np.stack(_per_glacier(
        lambda g, i: jv.rhs_with_theta(g.H0, jtheta, g, i, jm, jp, T), jbatch))
    assert_rel(tv.rhs_with_theta(tbatch.H0, ttheta, tbatch, tm, tp, T), ref_rhs, RTOL)
    targs = (torch.from_numpy(lx), torch.from_numpy(ly), tbatch.H0, ttheta, tbatch, tm, tp, T)
    ref_dH = np.stack(_per_glacier(lambda g, i: jv.vjp_surface_v_dH(
        JA.DiscreteVJP(), jnp.asarray(lx[i]), jnp.asarray(ly[i]), g.H0, jtheta, g, i, jm, jp, T),
        jbatch))
    assert_rel(tv.vjp_surface_v_dH(TA.DiscreteVJP(), *targs), ref_dH, RTOL, "velocity dH")
    ref_th = _sum_trees(_per_glacier(lambda g, i: jv.vjp_surface_v_dtheta(
        JA.DiscreteVJP(), jnp.asarray(lx[i]), jnp.asarray(ly[i]), g.H0, jtheta, g, i, jm, jp, T),
        jbatch))
    for a, b in zip(_leaves(tv.vjp_surface_v_dtheta(TA.DiscreteVJP(), *targs)), ref_th):
        assert_rel(a, b, RTOL, "velocity dθ")


@pytest.mark.parametrize("flavor", ["discrete", "auto", "none"])
def test_vjp_mb_dH_matches_jax(setup, flavor):
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    jf, tf = _FLAVORS[flavor]
    lam_mb = _rng_field(7, jbatch.H0.shape)
    ref = np.stack(_per_glacier(lambda g, i: jv.vjp_mb_dH(
        jf, jnp.asarray(lam_mb[i]), g.H0, g, JTImodel1(), 5.5, 1.0 / 12.0), jbatch))
    out = tv.vjp_mb_dH(tf, torch.from_numpy(lam_mb), tbatch.H0, tbatch, TImodel1(), 5.5,
                       1.0 / 12.0)
    if flavor == "none":
        assert float(out.abs().max()) == 0.0
    else:
        assert_rel(out, ref, RTOL, flavor)


# ---------------------------------------------------------------------------
# Ports of tests/test_vjps.py
# ---------------------------------------------------------------------------

def test_discrete_vjp_dH_matches_ad(setup):
    """The hand chain (tensor code) and the fused pullback against autograd
    of the RHS, 1e-12 in norm."""
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    tm = models["fused"][1]
    lam_t = torch.from_numpy(lam)
    auto = tv.vjp_sia_dH(TA.AutoVJP(), lam_t, tbatch.H0, ttheta, tbatch, tm, tp, T)
    chain = tv._vjp_dH_discrete(lam_t, tbatch.H0, tv._values_fn(ttheta, tbatch, tm, T), tbatch,
                                tm, tp)
    fused = tv.vjp_sia_dH(TA.DiscreteVJP(), lam_t, tbatch.H0, ttheta, tbatch, tm, tp, T)
    for got in (chain, fused):
        assert float(torch.linalg.norm(got - auto) / torch.linalg.norm(auto)) < 1e-12


def test_discrete_vjp_dtheta_matches_ad(setup):
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    for route in ("fused", "generic"):
        tm = models[route][1]
        args = (torch.from_numpy(lam), tbatch.H0, ttheta, tbatch, tm, tp, T)
        manual = _leaves(tv.vjp_sia_dtheta(TA.DiscreteVJP(), *args))
        auto = _leaves(tv.vjp_sia_dtheta(TA.AutoVJP(), *args))
        for m, a in zip(manual, auto):
            assert float(torch.linalg.norm(m - a) / (torch.linalg.norm(a) + 1e-30)) < 1e-10


def test_continuous_vjp_dH_consistent(setup):
    """The continuous operator is another discretisation of the same
    object: it agrees with the discrete transpose in direction and size on
    a smooth cotangent."""
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    tm = models["fused"][1]
    x = torch.from_numpy(np.array(jbatch.coords_x[0]))
    y = torch.from_numpy(np.array(jbatch.coords_y[0]))
    lam_s = torch.exp(-(x[:, None] ** 2 + y[None, :] ** 2) / 800.0 ** 2).expand(
        tbatch.H0.shape).contiguous()
    args = (lam_s, tbatch.H0, ttheta, tbatch, tm, tp, T)
    m = tv.vjp_sia_dH(TA.ContinuousVJP(), *args).ravel()
    a = tv.vjp_sia_dH(TA.DiscreteVJP(), *args).ravel()
    cos = float(torch.dot(m, a) / (torch.linalg.norm(m) * torch.linalg.norm(a)))
    ratio = float(torch.linalg.norm(m) / torch.linalg.norm(a))
    assert cos > 0.97, cos
    assert 0.8 < ratio < 1.25, ratio


def test_surface_velocity_vjps(setup):
    """The velocity pullback in H against central finite differences along
    a direction on the dome's smooth interior."""
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    tm = models["fused"][1]
    H = tbatch.H0
    n = H.shape
    lx, ly = (torch.from_numpy(1e-3 * _rng_field(s, (n[0], n[1] - 1, n[2] - 1))) for s in (8, 9))
    dH = tv.vjp_surface_v_dH(TA.DiscreteVJP(), lx, ly, H, ttheta, tbatch, tm, tp, T)
    assert torch.isfinite(dH).all()
    v = torch.from_numpy(_rng_field(10, tuple(n))) * (H > 100.0)
    vfn = tv._values_fn(ttheta, tbatch, tm, T)
    dx, dy = tv._spacings(tbatch)

    def proj(h):
        vx, vy, _ = surface_velocity(h, tbatch.B, dx, dy, vfn, tm.target, tp.physical)
        return float(torch.sum(vx * lx) + torch.sum(vy * ly))

    eps = 1e-4
    fd = (proj(H + eps * v) - proj(H - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(dH * v)), fd, rtol=1e-5)
    dth = tv.vjp_surface_v_dtheta(TA.DiscreteVJP(), lx, ly, H, ttheta, tbatch, tm, tp, T)
    assert all(torch.isfinite(leaf).all() for leaf in _leaves(dth))


def test_mb_vjp_vs_fd(setup):
    """The mass-balance pullback against central finite differences."""
    jp, tp, jbatch, tbatch, jtheta, ttheta, models, lam = setup
    H = tbatch.H0
    lam_mb = torch.from_numpy(_rng_field(11, tuple(H.shape)))
    dH = tv.vjp_mb_dH(TA.AutoVJP(), lam_mb, H, tbatch, TImodel1(), 5.5, 1.0 / 12.0)
    v = torch.from_numpy(_rng_field(12, tuple(H.shape)))

    def proj(h):
        return float(torch.sum(lam_mb * (mb_timestep(h, tbatch, TImodel1(), 5.5, 1.0 / 12.0)
                                         - h)))

    eps = 1e-5
    fd = (proj(H + eps * v) - proj(H - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(dH * v)), fd, rtol=1e-5, atol=1e-8)
    zero = tv.vjp_mb_dH(TA.NoVJP(), lam_mb, H, tbatch, TImodel1(), 5.5, 1.0 / 12.0)
    assert float(zero.abs().max()) == 0.0
