"""Neural-network regressors as plain tensor trees, and the NN I/O scaling
helpers.

A stateless :class:`MLP` description plus a parameter tree shaped like the
JAX package's: a list of ``{"w": (fan_in, fan_out), "b": (fan_out,)}``
dicts of leaf tensors, so ``torch.optim`` takes the leaves and
:mod:`odinn_tpu_torch.convert` maps the JAX parameters one to one.
Evaluation over a batch of inputs is one matmul chain ``(…, n_in) @ W + b``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

__all__ = [
    "MLP",
    "init_mlp",
    "mlp_apply",
    "default_architecture",
    "NeuralNetwork",
    "normalize",
    "scale",
    "prescale",
    "postscale",
    "fourier_feature",
    "predict_A_bar",
]

# the JAX package's activations: softplus is log(1 + eˣ) as logaddexp(x, 0)
# and gelu is the tanh approximation (jax.nn.gelu's default)
_ACTS = {
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


@dataclass(frozen=True)
class MLP:
    """Static MLP description: layer widths and activation names."""

    widths: Tuple[int, ...]            # (n_in, h1, ..., n_out)
    activations: Tuple[str, ...]       # len == len(widths) - 1

    @property
    def n_in(self) -> int:
        return self.widths[0]

    @property
    def n_out(self) -> int:
        return self.widths[-1]


def default_architecture(n_input: int = 1, light: bool = False) -> MLP:
    """The default net 1→3→10→3→1, softplus×3 and a sigmoid head; ``light``
    is the 2-layer test variant."""
    if light:
        return MLP((n_input, 3, 1), ("softplus", "sigmoid"))
    return MLP((n_input, 3, 10, 3, 1), ("softplus", "softplus", "softplus", "sigmoid"))


def init_mlp(arch: MLP, generator: torch.Generator, dtype=torch.float64, device=None):
    """Glorot-uniform weights, zero biases, drawn from ``generator`` (its
    numbers are not JAX's: carry JAX parameters over with
    :func:`odinn_tpu_torch.convert.mlp_from_numpy`)."""
    params = []
    for fan_in, fan_out in zip(arch.widths[:-1], arch.widths[1:]):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=generator, dtype=torch.float64)
        w = (2.0 * bound * u - bound).to(device=device, dtype=dtype)
        params.append({"w": w, "b": torch.zeros((fan_out,), dtype=dtype, device=device)})
    return params


def mlp_apply(arch: MLP, params, x):
    """Apply the MLP to inputs of shape (…, n_in); returns (…, n_out)."""
    h = x
    for layer, act in zip(params, arch.activations):
        h = _ACTS[act](h @ layer["w"] + layer["b"])
    return h


@dataclass(frozen=True)
class NeuralNetwork:
    """Architecture + init; the parameter tree itself lives in θ."""

    architecture: MLP
    seed: int = 666

    def init(self, dtype=torch.float64, device=None):
        gen = torch.Generator().manual_seed(self.seed)
        return init_mlp(self.architecture, gen, dtype, device)

    def apply(self, params, x):
        return mlp_apply(self.architecture, params, x)


def normalize(x, lims: Tuple[float, float]):
    """Affine map [m, M] → [0, 1]."""
    m, M = lims
    return (x - m) / (M - m)


def scale(x, lims: Tuple[float, float]):
    """Affine map [0, 1] → [m, M]."""
    m, M = lims
    return m + (M - m) * x


def prescale(x, bounds: Sequence[Tuple[float, float]]):
    """Per-feature normalization of (…, n_in) inputs."""
    lo = torch.tensor([b[0] for b in bounds], dtype=x.dtype, device=x.device)
    hi = torch.tensor([b[1] for b in bounds], dtype=x.dtype, device=x.device)
    return (x - lo) / (hi - lo)


def postscale(y, max_nn: float):
    """max·exp((y−1)/y) output rescaling: (0, 1] → (0, max], 0 at y → 0."""
    safe = torch.clamp(y, min=1e-12)
    return max_nn * torch.exp((safe - 1.0) / safe)


def fourier_feature(x, n_freq: int = 4, scale_ff: float = 1.0):
    """Fourier-feature embedding of (…, d) inputs: sin and cos of the input
    at ``n_freq`` octaves, (…, 2·n_freq·d)."""
    freqs = scale_ff * (2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)) * math.pi
    xf = x[..., None, :] * freqs[:, None]
    feats = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-1)
    return feats.reshape(*x.shape[:-1], -1)


def predict_A_bar(arch: MLP, params, temp, lims: Tuple[float, float]):
    """A(T) = scale(NN(T), lims): the network's output for the
    temperatures ``temp`` (a number or a tensor) mapped onto
    [min_A, max_A], in the parameters' dtype and on their device."""
    w = params[0]["w"]
    t = torch.atleast_1d(torch.as_tensor(temp, dtype=w.dtype, device=w.device))[..., None]
    return scale(mlp_apply(arch, params, t)[..., 0], lims)
