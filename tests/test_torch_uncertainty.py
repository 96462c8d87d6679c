"""odinn_tpu_torch's Laplace posterior (``inverse/uncertainty.py``) against
the JAX package's (``odinn_tpu.inverse.uncertainty``), float64, on the JAX
test's problem (tests/test_uncertainty.py): 2 Halfar glaciers on 20²
planes, 3 monthly intervals of RK4 at 8 substeps, the per-glacier A
slightly off its truth.

The raw JᵀJ of each curvature path (dense: p J·v products and pullbacks;
per-glacier: one J·v per θ leaf, with duplicate ``glacier_ids``) equals the
JAX package's to 1e-10 relative; the matrix-free CG solve with a prior,
the delta-method std, the band and its covariance, the posterior draws and
the predictive to 1e-8 (in ``test_torch_uncertainty_queries.py``: the
JAX package's compiles of both files would take one past ~30 s); the numpy
algebra (σ², the χ² tail, the whitened calibration, the PSD projection) to
1e-14.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.inverse import gauss_newton as jgn
from odinn_tpu.inverse import uncertainty as junc
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse import gauss_newton as tgn
from odinn_tpu_torch.inverse import uncertainty as tunc
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.simulation.solver import build_tstops as t_tstops
from tests.torch_parity import assert_rel, carry_glacier, tree_to_port

A_TRUE = np.array([6.5e-18, 3.0e-18])
TSPAN = (5.0, 5.25)


def _params(P):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=8),
        UDE=P.UDEParameters(grad="jax"))


@pytest.fixture(scope="module")
def classical():
    """The JAX test's 2-glacier scalar-A problem, in both packages: (JAX
    batch, port batch, JAX θ, JAX residual map, port residual map)."""
    jp, tp = _params(JP), _params(TP)
    tstops = j_tstops(TSPAN, jp.solver.step)
    gl = [j_halfar(nx=20, ny=20, dx=150.0, temp=-20.0, A=float(A_TRUE[0]), rgi_id="u0"),
          j_halfar(nx=20, ny=20, dx=150.0, r0=600.0, h0=450.0, temp=-15.0,
                   A=float(A_TRUE[1]), rgi_id="u1")]
    phys = jp.physical
    th_truth = {"A": jnp.asarray(np.arctanh(
        2 * (A_TRUE - phys.min_A) / (phys.max_A - phys.min_A) - 1))}
    model = JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True)))
    jb = j_stack(j_ground_truth(gl, jp, model, tstops, store=("H",), theta=th_truth))
    tb = carry_glacier(jb)
    jres = jgn.make_residual_fn(model, jp, tstops)
    tmodel = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)))
    tres = tgn.make_residual_fn(tmodel, tp, tinv.assemble_tstops(tp, tb))
    return jb, tb, {"A": th_truth["A"] + 0.05}, jres, tres


def _short(P, model, batch):
    """The residual map of the problem's first month only (its first
    observation), for the tests of the posterior's queries, which need a
    curvature, not the whole series."""
    span = (TSPAN[0], TSPAN[0] + 1.0 / 12.0)
    if P is JP:
        return jgn.make_residual_fn(model, _params(P), j_tstops(span, 1.0 / 12.0))
    return tgn.make_residual_fn(model, _params(P), t_tstops(span, 1.0 / 12.0))


@pytest.fixture(scope="module")
def jax_dense(classical):
    """The JAX package's dense posterior (σ² = 1, prior_std 10) with the raw
    JᵀJ it was built from."""
    jb, _, jtheta, jres, _ = classical
    seen = []
    real = junc._finish_dense

    def spy(theta, p, sigma2, prior_precision, JtJ64):
        seen.append(np.array(JtJ64, np.float64))
        return real(theta, p, sigma2, prior_precision, JtJ64)

    junc._finish_dense = spy
    try:
        post = junc.laplace_posterior(jtheta, jb, jres, sigma2=1.0, prior_std=10.0)
    finally:
        junc._finish_dense = real
    return post, seen[0]


def _capture_jtj(monkeypatch, module):
    """The raw JᵀJ each call of ``module._finish_dense`` receives."""
    seen = []
    real = module._finish_dense

    def spy(theta, p, sigma2, prior_precision, JtJ64):
        seen.append(np.array(JtJ64, np.float64))
        return real(theta, p, sigma2, prior_precision, JtJ64)

    monkeypatch.setattr(module, "_finish_dense", spy)
    return seen


def test_dense_jtj_matches_jax(classical, jax_dense):
    """The dense path's raw JᵀJ (p J·v products and pullbacks) and its
    posterior (σ² = 1, prior_std 10). JᵀJ 1e-10, Σ 1e-8."""
    _, tb, jtheta, _, tres = classical
    jpost, jJtJ = jax_dense
    seen = []
    real = tunc._finish_dense

    def spy(theta, p, sigma2, prior_precision, JtJ64):
        seen.append(np.array(JtJ64, np.float64))
        return real(theta, p, sigma2, prior_precision, JtJ64)

    tunc._finish_dense = spy
    try:
        post = tunc.laplace_posterior(tree_to_port(jtheta), tb, tres, sigma2=1.0, prior_std=10.0)
    finally:
        tunc._finish_dense = real
    assert_rel(seen[0], jJtJ, 1e-10, "JᵀJ")
    assert_rel(post._cov, jpost._cov, 1e-8, "Σ")


@pytest.mark.parametrize("ids", [None, [1, 1]])
def test_per_glacier_jtj_matches_jax(classical, monkeypatch, ids):
    """The per-glacier path's raw JᵀJ (one J·v per θ leaf), also with
    duplicate ``glacier_ids`` (both batch rows read θ[1]: the curvature
    accumulates in one column), σ² by its estimate, and the posterior's θ
    std. JᵀJ 1e-10, σ² and stds 1e-8."""
    jb, tb, jtheta, jres, tres = classical
    j_seen = _capture_jtj(monkeypatch, junc)
    t_seen = _capture_jtj(monkeypatch, tunc)
    prior = None if ids is None else 1.0
    jpost = junc.laplace_posterior(jtheta, jb, jres, structure="per_glacier", prior_std=prior,
                                   glacier_ids=None if ids is None else jnp.asarray(ids))
    post = tunc.laplace_posterior(tree_to_port(jtheta), tb, tres, structure="per_glacier",
                                  glacier_ids=ids, prior_std=prior)
    assert_rel(t_seen[0], j_seen[0], 1e-10, "JᵀJ")
    assert_rel(post.sigma2, jpost.sigma2, 1e-8, "σ²")
    assert_rel(post.theta_std()["A"], np.asarray(jpost.theta_std()["A"]), 1e-8, "θ std")
    if ids is not None:
        assert t_seen[0][0, 0] == 0.0 and t_seen[0][1, 1] > 0.0


def test_matrix_free_matches_jax(classical, jax_dense):
    """The matrix-free CG path with a prior (σ² = 1, prior_std 10, CG 3
    iterations on two unknowns: converged): every θ std against the JAX
    package's posterior, whose own test holds its matrix-free path to this
    dense one. 1e-8."""
    _, tb, jtheta, _, tres = classical
    mf = tunc.laplace_posterior(tree_to_port(jtheta), tb, tres, sigma2=1.0, prior_std=10.0,
                                dense_threshold=0, cg_iters=3)
    assert mf._cov is None
    assert_rel(mf.theta_std()["A"], np.asarray(jax_dense[0].theta_std()["A"]), 1e-8, "θ std")


def test_matrix_free_probe_scale_without_prior(classical):
    """Without a prior the matrix-free path floors the precision at 1e-8 of
    a Rademacher probe's curvature scale (a generator seeded 0): the std
    then sits near the dense path's, whose floor is 1e-8 of the mean
    diagonal (first month's residuals)."""
    _, tb, jtheta, _, _ = classical
    theta = tree_to_port(jtheta)
    tres = _short(TP, TModel(iceflow=TSIA2DModel(A=TLawA_inversion(_params(TP)))), tb)
    mf = tunc.laplace_posterior(theta, tb, tres, sigma2=1.0, dense_threshold=0, cg_iters=3)
    dense = tunc.laplace_posterior(theta, tb, tres, sigma2=1.0)
    assert_rel(mf.theta_std()["A"], dense.theta_std()["A"], 1e-3, "probe-floored std")


def test_numpy_algebra_matches_jax():
    """estimate_sigma2, the χ² tail and the whitened calibration on the same
    inputs. 1e-14."""
    rng = np.random.default_rng(0)
    r = rng.standard_normal(50)
    r[::7] = 0.0
    for p in (1, 3, 43, 60):
        assert_rel(tunc.estimate_sigma2(r, p), junc.estimate_sigma2(r, p), 1e-14, "σ²")
    for x, k in ((3.0, 4), (0.5, 12), (40.0, 25), (1.0, 0)):
        a, b = tunc._chi2_sf(x, k), junc._chi2_sf(x, k)
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-14 * max(abs(b), 1e-300)
    G = rng.standard_normal((12, 4))
    C = G @ G.T + 1e-6 * np.eye(12)
    for d in (rng.standard_normal(12), 3.0 * rng.standard_normal(12)):
        a, b = tunc.whitened_calibration(d, C), junc.whitened_calibration(d, C)
        assert a["rank"] == b["rank"]
        for key in ("T", "T_over_r", "p_value", "max_abs_z", "median_abs_z"):
            assert_rel(a[key], b[key], 1e-14, key)
    # the overparameterized fallback: ‖r‖²/N_eff when p ≥ N_eff
    r3 = np.array([0.0, 1.0, 2.0, 0.0, 3.0])
    assert tunc.estimate_sigma2(r3, 1) == 14.0 / 2
    assert tunc.estimate_sigma2(r3, 3) == tunc.estimate_sigma2(r3, 50) == 14.0 / 3


def test_psd_projection_matches_jax():
    """A rank-5 GGN with float32-scale symmetric noise (negative
    eigenvalues) and a tight σ²: both packages project to the PSD cone and
    return the same posterior; the std stays under the prior's."""
    rng = np.random.default_rng(0)
    p = 20
    J = rng.standard_normal((5, p))
    E = 1e-7 * rng.standard_normal((p, p))
    JtJ = J.T @ J + 0.5 * (E + E.T)
    assert np.linalg.eigvalsh(JtJ).min() < 0
    post = tunc._finish_dense({"w": torch.zeros(p, dtype=torch.float64)}, p, 1e-14, 1.0, JtJ)
    jpost = junc._finish_dense({"w": jnp.zeros(p)}, p, 1e-14, 1.0, JtJ)
    assert_rel(post._cov, jpost._cov, 1e-12, "Σ")
    std = post.theta_std()["w"]
    assert np.isfinite(std).all() and (std > 0).all() and std.max() <= 1.0 + 1e-9


def test_overparameterized_sigma2_warns():
    """p ≥ N_eff without a prior warns and falls back to ‖r‖²/N_eff; with
    a prior it does not warn."""
    theta = {"w": torch.linspace(0.1, 2.0, 6, dtype=torch.float64)}

    def resid(th, b):
        w = th["w"]
        return torch.stack([w[0] * w[1] - 1.0, w[2] ** 2 - 0.5, torch.zeros((), dtype=w.dtype)])

    with pytest.warns(UserWarning, match="no prior_std"):
        post = tunc.laplace_posterior(theta, None, resid, prior_std=None)
    r = resid(theta, None).numpy()
    assert post.sigma2 == float(np.sum(r * r) / 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tunc.laplace_posterior(theta, None, resid, prior_std=1.0)
