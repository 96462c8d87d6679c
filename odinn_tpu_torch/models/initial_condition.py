"""Trainable initial ice thickness H₀.

A per-glacier trainable H₀ field θ["IC"] of shape (n_glaciers, nx, ny),
passed through a positivity filter σ so the thickness stays non-negative:

- ``identity``;
- ``softplus``;
- ``Zang1980``, a C¹ ramp: x for x ≥ ε, (x + ε)²/(4ε) on (−ε, ε), 0 below.

The filters' derivatives σ′ (:func:`filter_derivative`) serve the
hand-written adjoints' H₀ route; autograd differentiates σ itself.

The ``Farinotti2019Random`` start adds spatially correlated noise: white
noise drawn from an explicit ``torch.Generator`` seeded with the
condition's ``seed``, then smoothed by :func:`smooth_noise`, a separable
Gaussian filter normalised to the requested standard deviation. The
smoothing is deterministic; the draw is the port's own (its bits are not
the JAX package's).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from odinn_tpu_torch.core.glacier import stack_glaciers

__all__ = ["InitialCondition", "sigma_zang", "apply_filter", "filter_derivative",
           "smooth_noise", "random_field"]

_EPS = 1.0     # the Zang (1980) ramp's half-width


def sigma_zang(x, eps: float = _EPS):
    """Zang (1980) smooth positivity filter."""
    ramp = (x + eps) ** 2 / (4.0 * eps)
    return torch.where(x >= eps, x, torch.where(x <= -eps, torch.zeros_like(x), ramp))


def _d_sigma_zang(x, eps: float = _EPS):
    ramp = (x + eps) / (2.0 * eps)
    return torch.where(x >= eps, torch.ones_like(x),
                       torch.where(x <= -eps, torch.zeros_like(x), ramp))


def apply_filter(x, name: str):
    """σ(x) for the filter ``name``."""
    if name == "identity":
        return x
    if name == "softplus":
        return torch.logaddexp(x, torch.zeros_like(x))
    if name == "Zang1980":
        return sigma_zang(x)
    raise ValueError(f"unknown initial-condition filter {name!r}")


def filter_derivative(x, name: str):
    """σ′(x) for the filter ``name``."""
    if name == "identity":
        return torch.ones_like(x)
    if name == "softplus":
        return torch.sigmoid(x)
    if name == "Zang1980":
        return _d_sigma_zang(x)
    raise ValueError(f"unknown initial-condition filter {name!r}")


def _inverse_filter(h, name: str):
    """The pre-filter parameter of a target thickness (the warm start)."""
    if name == "identity":
        return h
    if name == "softplus":
        # softplus⁻¹(h) = log(expm1(h)), clamped as h → 0
        return torch.log(torch.expm1(torch.clamp(h, min=1e-6)))
    if name == "Zang1980":
        # the ramp inverted on (0, ε); the identity above
        ramp_inv = 2.0 * torch.sqrt(_EPS * torch.clamp(h, min=0.0)) - _EPS
        return torch.where(h >= _EPS, h, ramp_inv)
    raise ValueError(f"unknown initial-condition filter {name!r}")


def _convolve_same(a, kern, dim):
    """Each line of ``a`` along ``dim`` convolved with the odd-length,
    symmetric ``kern``, centred to the line's own length (numpy's
    ``mode="same"``)."""
    k = kern.shape[0]
    n = a.shape[dim]
    if k > n:
        raise ValueError(f"random_field: a smoothing kernel of {k} cells does not fit a "
                         f"{n}-cell axis; lower corr_len or refine dx")
    lines = a.movedim(dim, -1)
    flat = lines.reshape(-1, 1, n)
    out = F.conv1d(flat, kern.reshape(1, 1, k).to(a.dtype), padding=(k - 1) // 2)
    return out.reshape(lines.shape).movedim(-1, dim)


def smooth_noise(white, dx, corr_len: float = 500.0, sigma: float = 10.0):
    """Spatially correlated noise from a white-noise plane: a separable
    Gaussian filter of radius r = max(⌊corr_len/dx⌋, 1) cells over ±3r, along
    x then y, rescaled to standard deviation ``sigma`` (the plane's
    population standard deviation)."""
    r = max(int(corr_len / float(dx)), 1)
    xs = torch.arange(-3 * r, 3 * r + 1, dtype=torch.float64)
    kern = torch.exp(-0.5 * (xs / r) ** 2)
    kern = (kern / torch.sum(kern)).to(white.device)
    sm = _convolve_same(_convolve_same(white, kern, -2), kern, -1)
    return sigma * sm / torch.clamp(torch.std(sm, correction=0), min=1e-12)


def random_field(generator, shape, dx, corr_len: float = 500.0, sigma: float = 10.0,
                 dtype=torch.float64):
    """Spatially correlated Gaussian noise of ``shape``: white noise drawn
    from ``generator`` (a CPU ``torch.Generator``), then :func:`smooth_noise`."""
    white = torch.randn(tuple(shape), generator=generator, dtype=dtype)
    return smooth_noise(white, dx, corr_len, sigma)


@dataclass(frozen=True)
class InitialCondition:
    """Per-glacier trainable H₀.

    ``init``: "Farinotti2019" starts θ from the glaciers' H₀;
    "Farinotti2019Random" adds correlated noise on the ice (std
    ``noise_sigma``, correlation length ``noise_corr_len``), drawn glacier by
    glacier from one generator seeded with ``seed``. θ["IC"] has shape
    (n_glaciers, nx, ny); ``evaluate_H0`` filters the rows of the given
    glaciers.
    """

    filter: str = "identity"
    init: str = "Farinotti2019"
    noise_sigma: float = 10.0
    noise_corr_len: float = 500.0
    seed: int = 0

    def init_theta(self, glaciers, dtype=torch.float64):
        batch = stack_glaciers(list(glaciers), device=glaciers[0].H0.device) if isinstance(
            glaciers, (list, tuple)) else glaciers
        h0 = batch.H0.to(torch.float64)
        if self.init == "Farinotti2019Random":
            gen = torch.Generator().manual_seed(self.seed)
            noise = torch.stack([
                random_field(gen, h0.shape[1:], float(batch.dx[i]), self.noise_corr_len,
                             self.noise_sigma)
                for i in range(h0.shape[0])]).to(h0.device)
            h0 = torch.clamp(h0 + noise * (h0 > 0.0), min=0.0)
        elif self.init != "Farinotti2019":
            raise ValueError(f"unknown initial-condition init {self.init!r}")
        return _inverse_filter(h0, self.filter).to(dtype)

    def evaluate_H0(self, theta, glacier_idx):
        """H₀ = σ(θ_IC[glacier_idx])."""
        return apply_filter(theta["IC"][glacier_idx], self.filter)

    def evaluate_dH0(self, theta, glacier_idx):
        """σ′(θ_IC[glacier_idx])."""
        return filter_derivative(theta["IC"][glacier_idx], self.filter)

    def add_cotangent(self, d_theta_ic, glacier_idx, d_rows):
        """θ_IC's cotangent ``d_theta_ic`` with ``d_rows``, the cotangents of
        the rows ``glacier_idx`` of θ_IC, added in."""
        return d_theta_ic.index_add(0, glacier_idx, d_rows)
