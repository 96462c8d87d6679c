"""odinn_tpu_torch's trainable initial condition against odinn_tpu's.

The three positivity filters, their derivatives and inverses (at and around
the ramp's kinks), ``init_theta`` with ``"Farinotti2019"``, the smoothing of
``random_field`` given the same white noise, and ``evaluate_H0``/``dH0``;
float64 on the CPU, 1e-12 relative. The port draws its white noise from a
``torch.Generator``, not ``jax.random``: its statistics and its
reproducibility from ``seed`` are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.models.initial_condition as JIC
import odinn_tpu_torch.models.initial_condition as TIC
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu_torch.core.glacier import stack_glaciers
from odinn_tpu_torch.data.synthetic import halfar_glacier
from tests.torch_parity import CPU, assert_rel, carry_glacier

RTOL = 1e-12
FILTERS = ["identity", "softplus", "Zang1980"]
EPS = 1e-9


def _points():
    """Zero, ±ε and the ramp's kinks ±1 with ±ε around them, plus a spread
    of values up to thicknesses of hundreds of metres."""
    around = [0.0, EPS, -EPS, 1.0, 1.0 - EPS, 1.0 + EPS, -1.0, -1.0 - EPS, -1.0 + EPS]
    spread = np.random.default_rng(0).uniform(-30.0, 400.0, 40)
    return np.concatenate([around, spread, [19.0, 21.0, 35.0, 700.0]])


@pytest.mark.parametrize("name", FILTERS)
def test_filters_derivatives_and_inverses_match_jax(name):
    x = _points()
    tx = torch.from_numpy(x)
    assert_rel(TIC.apply_filter(tx, name), JIC.apply_filter(jnp.asarray(x), name), RTOL, "σ")
    assert_rel(TIC.filter_derivative(tx, name), JIC.filter_derivative(jnp.asarray(x), name),
               RTOL, "σ′")
    h = np.abs(x)
    assert_rel(TIC._inverse_filter(torch.from_numpy(h), name),
               JIC._inverse_filter(jnp.asarray(h), name), RTOL, "σ⁻¹")
    # σ′ is autograd's derivative of σ away from the kinks
    smooth = tx[np.abs(np.abs(x) - 1.0) > 1e-3].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(TIC.apply_filter(smooth, name).sum(), smooth)
    assert_rel(g, TIC.filter_derivative(smooth.detach(), name), RTOL, "autograd σ′")


def test_filters_refuse_an_unknown_name():
    x = torch.zeros(3, dtype=torch.float64)
    for fn in (TIC.apply_filter, TIC.filter_derivative, TIC._inverse_filter):
        with pytest.raises(ValueError, match="unknown initial-condition filter"):
            fn(x, "relu")


@pytest.fixture(scope="module")
def batches():
    gl = [j_halfar(nx=28, ny=32, dx=100.0, temp=-15.0, rgi_id="a"),
          j_halfar(nx=24, ny=26, dx=150.0, h0=300.0, temp=-20.0, rgi_id="b")]
    jb = j_stack(gl)
    return jb, carry_glacier(jb)


@pytest.mark.parametrize("name", FILTERS)
def test_init_theta_farinotti_matches_jax(batches, name):
    jb, tb = batches
    jic, tic = JIC.InitialCondition(filter=name), TIC.InitialCondition(filter=name)
    th = tic.init_theta(tb)
    ref = jic.init_theta(jb)
    assert th.shape == tuple(ref.shape) and th.dtype == torch.float64
    assert_rel(th, ref, RTOL, "θ_IC")
    assert tic.init_theta(tb, torch.float32).dtype == torch.float32
    # evaluate_H0 / dH0 of a subset of the rows
    idx = torch.tensor([1, 0])
    jth = {"IC": ref + 3.0 * jnp.sin(ref)}
    tth = {"IC": torch.from_numpy(np.array(jth["IC"]))}
    assert_rel(tic.evaluate_H0(tth, idx), jic.evaluate_H0(jth, jnp.asarray([1, 0])), RTOL, "H₀")
    assert_rel(tic.evaluate_dH0(tth, idx), jic.evaluate_dH0(jth, jnp.asarray([1, 0])), RTOL,
               "σ′(θ)")
    if name != "softplus":          # σ(σ⁻¹(H₀)) = H₀ (softplus clamps H₀ = 0 to 1e-6)
        assert_rel(tic.evaluate_H0({"IC": th}, torch.arange(2)), np.asarray(jb.H0), RTOL,
                   "round trip")


@pytest.mark.parametrize("shape,dx,corr", [((32, 36), 100.0, 500.0), ((30, 40), 130.0, 260.0),
                                           ((24, 24), 600.0, 500.0)])
def test_smoothing_matches_jax_on_the_same_white_noise(shape, dx, corr, monkeypatch):
    """random_field's smoothing (separable Gaussian, numpy "same" centring,
    population std) against the JAX random_field with its draw replaced by
    the same white noise."""
    white = np.random.default_rng(7).standard_normal(shape)
    monkeypatch.setattr(jax.random, "normal", lambda key, shp: jnp.asarray(white))
    ref = JIC.random_field(jax.random.PRNGKey(0), shape, dx, corr_len=corr, sigma=12.0)
    out = TIC.smooth_noise(torch.from_numpy(white), dx, corr_len=corr, sigma=12.0)
    assert_rel(out, ref, RTOL, "smoothed noise")
    assert abs(float(torch.std(out, correction=0)) - 12.0) < 1e-9


def test_smoothing_refuses_a_kernel_longer_than_the_grid():
    with pytest.raises(ValueError, match="does not fit"):
        TIC.smooth_noise(torch.zeros((20, 20), dtype=torch.float64), 10.0, corr_len=500.0)


def test_random_start_statistics_and_seed():
    """Farinotti2019Random: H₀ plus noise of std σ on the ice, zero where
    H₀ = 0, the same θ from the same seed and another from another."""
    gl = [halfar_glacier(nx=40, ny=40, dx=100.0, temp=-15.0, device=CPU),
          halfar_glacier(nx=40, ny=40, dx=120.0, h0=300.0, temp=-20.0, device=CPU)]
    batch = stack_glaciers(gl, device=CPU)
    ic = TIC.InitialCondition(init="Farinotti2019Random", noise_sigma=15.0, seed=3)
    th = ic.init_theta(batch)
    again = ic.init_theta(gl)                       # a list is stacked first
    assert torch.equal(th, again)
    other = TIC.InitialCondition(init="Farinotti2019Random", noise_sigma=15.0,
                                 seed=4).init_theta(batch)
    assert not torch.equal(th, other)
    ice = batch.H0 > 0.0
    assert torch.equal(th[~ice], torch.zeros_like(th[~ice]))
    # the noise before the clamp at 0, per glacier: std σ over the plane
    gen = torch.Generator().manual_seed(3)
    for g in range(2):
        noise = TIC.random_field(gen, (40, 40), float(batch.dx[g]), 500.0, 15.0)
        assert abs(float(torch.std(noise, correction=0)) - 15.0) < 1e-9
        thick = batch.H0[g] > 50.0          # deep ice: the clamp at 0 never acts
        assert_rel(th[g][thick], (batch.H0[g] + noise)[thick], RTOL, "H₀ + noise")
