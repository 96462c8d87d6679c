"""Laws: parameterizations binding inputs (and trainable θ) to PDE slots.

A ``Law`` is a static description: input specs, a pure apply function and a
schedule. Trainable state lives in the θ dict under the law's slot key.
``callback_freq``: ``None`` → evaluated at every RHS call (inner laws);
``0`` → once at simulation start; ``x > 0`` → every x years at tstop
boundaries.

This module holds the non-learnable laws of the forward path, the NN creep
law ``LawA``, the NN sliding law ``LawC``, the classical-inversion laws
``LawA_inversion``, ``LawC_inversion`` and ``LawN_inversion`` (one
tanh-bounded value, or grid, per glacier, selected by the ``glacier_idx``
input), and the inner NN laws of the D targets: ``LawY`` (T, H̄) → Y and
``LawU`` (H̄, |∇S|) → U, evaluated at every RHS call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from odinn_tpu_torch.laws import inputs as law_inputs
from odinn_tpu_torch.models import nn as nnmod
from odinn_tpu_torch.ops.stencils import avg

__all__ = [
    "Law",
    "LawA",
    "LawA_inversion",
    "LawC",
    "LawC_inversion",
    "LawN_inversion",
    "LawY",
    "LawU",
    "ConstantA",
    "CuffeyPaterson",
    "poly_A_paterson_cuffey",
    "SyntheticC",
    "eval_law",
]


@dataclass(frozen=True)
class Law:
    """A parameterization of one PDE slot: ``apply_fn(theta, inputs)``."""

    slot: str                                   # "A" | "C" | "n" | "Y" | "U" | ...
    apply_fn: Callable[[Any, dict], Any]
    inputs: Tuple[Any, ...] = ()
    callback_freq: Optional[float] = 0.0
    trainable: bool = True
    name: str = "law"
    init_theta: Optional[Callable] = None       # (glaciers, dtype) -> θ subtree

    @property
    def is_inner(self) -> bool:
        """True if the law must be evaluated inside the RHS (every call)."""
        return self.callback_freq is None

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(i.name for i in self.inputs)

    def apply(self, theta, inputs: dict):
        return self.apply_fn(theta, inputs)


def LawA(nn: nnmod.NeuralNetwork, params, scalar: bool = True,
         head: str = "sigmoid", prescale_bounds=None,
         n_fourier: Optional[int] = None, fourier_scale: float = 1.0) -> Law:
    """NN law T → A ∈ [minA, maxA], evaluated once at simulation start.

    ``head``: ``"sigmoid"`` maps the network's output linearly onto
    [min_A, max_A]; ``"log"`` maps it onto [log min_A, log max_A] and
    exponentiates. ``prescale_bounds`` normalizes the temperature input
    first; ``n_fourier`` embeds it with that many Fourier frequencies (the
    MLP's input width must then be 2·n_fourier). θ["A"] is the MLP's
    parameter tree. With ``scalar`` the input is each glacier's mean
    temperature and the law gives one A per glacier, which keeps its graph
    to θ through the fused kernels' table.
    """
    min_a, max_a = params.physical.min_A, params.physical.max_A
    arch = nn.architecture
    if head not in ("sigmoid", "log"):
        raise ValueError(f"LawA head must be 'sigmoid' or 'log', got {head!r}")
    log_head = head == "log"

    def apply_fn(theta, inputs):
        t_in = inputs["T"] if scalar else inputs["T_grid"]
        w = theta["A"][0]["w"]
        x = torch.as_tensor(t_in).to(device=w.device, dtype=w.dtype)[..., None]
        if prescale_bounds is not None:
            x = nnmod.prescale(x, prescale_bounds)
        if n_fourier:
            x = nnmod.fourier_feature(x, n_freq=n_fourier, scale_ff=fourier_scale)
        out = nnmod.mlp_apply(arch, theta["A"], x)[..., 0]
        if log_head:
            return torch.exp(nnmod.scale(out, (math.log(min_a), math.log(max_a))))
        return nnmod.scale(out, (min_a, max_a))

    inp = (law_inputs.AvgScalarTemp(),) if scalar else (law_inputs.AvgGriddedTemp(),)
    return Law(
        slot="A",
        apply_fn=apply_fn,
        inputs=inp,
        callback_freq=0.0,
        trainable=True,
        name="NN_A",
        init_theta=lambda glaciers, dtype=torch.float64: nn.init(dtype, glaciers.H0.device),
    )


def _n_glaciers(glaciers) -> int:
    return len(glaciers) if isinstance(glaciers, (list, tuple)) else glaciers.H0.shape[0]


def _device_of(glaciers):
    first = glaciers[0] if isinstance(glaciers, (list, tuple)) else glaciers
    return first.H0.device


def _per_glacier_init(scalar: bool, grid_shape=None):
    """θ's initial value for a per-glacier law: zeros of shape (n_g,), or
    (n_g, nx − 1, ny − 1) on the staggered grid of ``grid_shape`` (default:
    the largest grid of the glaciers)."""

    def init_theta(glaciers, dtype=torch.float64):
        n_g, dev = _n_glaciers(glaciers), _device_of(glaciers)
        if scalar:
            return torch.zeros((n_g,), dtype=dtype, device=dev)
        if grid_shape is not None:
            nx, ny = grid_shape
        elif isinstance(glaciers, (list, tuple)):
            nx, ny = max(g.nx for g in glaciers), max(g.ny for g in glaciers)
        else:
            nx, ny = glaciers.H0.shape[-2:]
        return torch.zeros((n_g, nx - 1, ny - 1), dtype=dtype, device=dev)

    return init_theta


def _tanh_bounded(lo: float, hi: float, slot: str):
    """apply_fn of a classical-inversion law: lo + (hi − lo)·(tanh θ + 1)/2
    of the glaciers' entries of θ[slot]."""

    def apply_fn(theta, inputs):
        raw = theta[slot][inputs["glacier_idx"]]
        return lo + (hi - lo) * (torch.tanh(raw) + 1.0) / 2.0

    return apply_fn


def LawA_inversion(params, scalar: bool = True, grid_shape=None) -> Law:
    """Classical-inversion A law: one tanh-bounded A ∈ [min_A, max_A] per
    glacier, or one per staggered cell (``scalar=False``). θ["A"] has shape
    (n_glaciers,) or (n_glaciers, nx − 1, ny − 1); a scalar A keeps its
    graph to θ through the fused kernels' table."""
    return Law(
        slot="A",
        apply_fn=_tanh_bounded(params.physical.min_A, params.physical.max_A, "A"),
        inputs=(),
        callback_freq=0.0,
        trainable=True,
        name="InvA" if scalar else "InvA_grid",
        init_theta=_per_glacier_init(scalar, grid_shape),
    )


def LawC(nn: nnmod.NeuralNetwork, params,
         prescale_bounds: Tuple[Tuple[float, float], ...] = ((0.0, 2000.0), (0.0, 0.05))
         ) -> Law:
    """NN sliding law (CPDD, topographic roughness) → C ∈ [min_C, max_C]:
    per-cell features through one MLP, the sigmoid head mapped linearly onto
    the bounds, averaged onto the staggered (nx − 1, ny − 1) grid. Its CPDD
    input depends on time, so the law always takes the generic path."""
    min_c, max_c = params.physical.min_C, params.physical.max_C
    arch = nn.architecture

    def apply_fn(theta, inputs):
        w = theta["C"][0]["w"]
        rough = torch.as_tensor(inputs["topo_rough"]).to(device=w.device, dtype=w.dtype)
        cpdd = torch.as_tensor(inputs["CPDD"]).to(device=w.device, dtype=w.dtype)
        feats = torch.stack([torch.broadcast_to(cpdd, rough.shape), rough], dim=-1)
        if prescale_bounds is not None:
            feats = nnmod.prescale(feats, prescale_bounds)
        out = nnmod.mlp_apply(arch, theta["C"], feats.reshape(-1, 2))[..., 0]
        return avg(nnmod.scale(out.reshape(rough.shape), (min_c, max_c)))

    return Law(
        slot="C",
        apply_fn=apply_fn,
        inputs=(law_inputs.CPDD(), law_inputs.TopoRough()),
        callback_freq=0.0,
        trainable=True,
        name="NN_C",
        init_theta=lambda glaciers, dtype=torch.float64: nn.init(dtype, _device_of(glaciers)),
    )


def LawC_inversion(params, scalar: bool = True, grid_shape=None) -> Law:
    """Classical sliding inversion: one tanh-bounded C ∈ [min_C, max_C] per
    glacier (or per staggered cell), the C-slot counterpart of
    :func:`LawA_inversion`. A trainable C takes the fused kernels only on the
    semi-implicit route, whose backward has the slide cotangent."""
    return Law(
        slot="C",
        apply_fn=_tanh_bounded(params.physical.min_C, params.physical.max_C, "C"),
        inputs=(),
        callback_freq=0.0,
        trainable=True,
        name="InvC" if scalar else "InvC_grid",
        init_theta=_per_glacier_init(scalar, grid_shape),
    )


def LawN_inversion(params, bounds: Tuple[float, float] = (1.5, 4.2)) -> Law:
    """Per-glacier Glen-exponent inversion: one tanh-bounded n per glacier.
    The fused kernels take the exponents as numbers, so a trainable n (or
    one that differs between glaciers on the SI and RKC routes) takes the
    generic path, where the diffusivity's powers are differentiable in n."""
    lo, hi = bounds
    return Law(
        slot="n",
        apply_fn=_tanh_bounded(lo, hi, "n"),
        inputs=(),
        callback_freq=0.0,
        trainable=True,
        name="InvN",
        init_theta=_per_glacier_init(True),
    )


def _per_pixel_mlp(arch, layers, feats, shape, prescale_bounds, max_nn):
    """The inner laws' per-pixel MLP: (…, 2) features, prescaled, through
    one (npix, 2) matmul chain, reshaped to ``shape`` and postscaled."""
    if prescale_bounds is not None:
        feats = nnmod.prescale(feats, prescale_bounds)
    out = nnmod.mlp_apply(arch, layers, feats.reshape(-1, 2)).reshape(shape)
    return nnmod.postscale(out, max_nn) if max_nn is not None else out


def LawY(nn: nnmod.NeuralNetwork, params, max_nn: Optional[float] = None,
         prescale_bounds: Tuple[Tuple[float, float], ...] = ((-25.0, 0.0), (0.0, 500.0))
         ) -> Law:
    """NN law (T, H̄) → Y, the hybrid diffusivity (``DHybridTarget``). An
    inner law: evaluated at every RHS call on the staggered H̄, with each
    glacier's mean temperature broadcast over its grid; the head is
    postscaled to (0, max_nn] when ``max_nn`` is given. θ["Y"] is the MLP's
    parameter tree."""
    arch = nn.architecture

    def apply_fn(theta, inputs):
        w = theta["Y"][0]["w"]
        hbar = inputs["Hbar"]
        temp = torch.as_tensor(inputs["T"]).to(device=w.device, dtype=w.dtype)
        temp = temp.reshape(temp.shape + (1,) * (hbar.ndim - temp.ndim))
        feats = torch.stack([torch.broadcast_to(temp, hbar.shape), hbar.to(w.dtype)], dim=-1)
        return _per_pixel_mlp(arch, theta["Y"], feats, hbar.shape, prescale_bounds, max_nn)

    return Law(
        slot="Y",
        apply_fn=apply_fn,
        inputs=(law_inputs.AvgScalarTemp(), law_inputs.HbarInput()),
        callback_freq=None,
        trainable=True,
        name="NN_Y",
        init_theta=lambda glaciers, dtype=torch.float64: nn.init(dtype, _device_of(glaciers)),
    )


def LawU(nn: nnmod.NeuralNetwork, params, max_nn: Optional[float] = 50.0,
         prescale_bounds: Tuple[Tuple[float, float], ...] = ((0.0, 300.0), (0.0, 0.5))
         ) -> Law:
    """NN law (H̄, |∇S|) → U, the diffusive velocity of ``DPureTarget``
    (D = H̄·U). An inner law, evaluated at every RHS call on the staggered
    fields; the head is postscaled to (0, max_nn]. θ["U"] is the MLP's
    parameter tree."""
    arch = nn.architecture

    def apply_fn(theta, inputs):
        w = theta["U"][0]["w"]
        hbar, grad_s = inputs["Hbar"], inputs["gradS"]
        feats = torch.stack([hbar, grad_s], dim=-1).to(w.dtype)
        return _per_pixel_mlp(arch, theta["U"], feats, hbar.shape, prescale_bounds, max_nn)

    return Law(
        slot="U",
        apply_fn=apply_fn,
        inputs=(law_inputs.HbarInput(), law_inputs.GradSInput()),
        callback_freq=None,
        trainable=True,
        name="NN_U",
        init_theta=lambda glaciers, dtype=torch.float64: nn.init(dtype, _device_of(glaciers)),
    )


def ConstantA(a_value: float) -> Law:
    """Constant creep coefficient (a float64 0-dim tensor)."""
    return Law(
        slot="A",
        apply_fn=lambda theta, inputs: torch.tensor(a_value, dtype=torch.float64),
        inputs=(),
        callback_freq=0.0,
        trainable=False,
        name="ConstantA",
    )


# Cuffey & Paterson (2010, "The Physics of Glaciers", Table 3.4) creep
# coefficients A(T) in Pa⁻³ s⁻¹, converted to yr⁻¹ below.
_CP_TEMPS = np.array(
    [-50.0, -45.0, -40.0, -35.0, -30.0, -25.0, -20.0, -15.0, -10.0, -5.0, -2.0, 0.0]
)
_CP_A_SI = np.array(
    [2.6e-27, 5.2e-27, 1.0e-26, 2.0e-26, 3.7e-26, 6.8e-26, 1.2e-25, 2.1e-25,
     3.5e-25, 9.3e-25, 1.7e-24, 2.4e-24]
)
_SEC_IN_YEAR = 365.25 * 24 * 3600
_CP_A_YR = _CP_A_SI * _SEC_IN_YEAR


def poly_A_paterson_cuffey():
    """Degree-4 fit of log₁₀A(T) to the Cuffey–Paterson table; returns A(T)
    in Pa⁻³ yr⁻¹, evaluated in float64 whatever the temperature's dtype."""
    coeffs = [float(c) for c in np.polyfit(_CP_TEMPS, np.log10(_CP_A_YR), deg=4)]

    def a_of_t(temp):
        temp = torch.clamp(torch.as_tensor(temp, dtype=torch.float64),
                           float(_CP_TEMPS[0]), float(_CP_TEMPS[-1]))
        acc = torch.zeros_like(temp)
        for c in coeffs:                       # Horner, highest power first
            acc = acc * temp + c
        return 10.0 ** acc

    return a_of_t


def CuffeyPaterson(scalar: bool = True) -> Law:
    """A(T) from the Cuffey–Paterson polynomial."""
    a_of_t = poly_A_paterson_cuffey()

    def apply_fn(theta, inputs):
        return a_of_t(inputs["T"] if scalar else inputs["T_grid"])

    inp = (law_inputs.AvgScalarTemp(),) if scalar else (law_inputs.AvgGriddedTemp(),)
    return Law(
        slot="A",
        apply_fn=apply_fn,
        inputs=inp,
        callback_freq=0.0,
        trainable=False,
        name="CuffeyPaterson",
    )


def SyntheticC(params, inputs: Tuple[Any, ...] = None, c_max: Optional[float] = None) -> Law:
    """Synthetic sliding coefficient from CPDD and topographic roughness:
    C = maxC · σ(CPDD/1000) · exp(−roughness/10⁻²), bounded in [0, maxC].
    Inputs missing from the resolved dict count as 0; gridded values are
    averaged onto the staggered grid."""
    if inputs is None:
        inputs = (law_inputs.CPDD(), law_inputs.TopoRough())
    c_hi = c_max if c_max is not None else params.physical.max_C

    def apply_fn(theta, inp):
        cpdd = torch.as_tensor(inp.get("CPDD", 0.0), dtype=torch.float64)
        rough = torch.as_tensor(inp.get("topo_rough", 0.0), dtype=torch.float64)
        c = c_hi * torch.sigmoid(cpdd / 1000.0) * torch.exp(-rough / 1e-2)
        return avg(c) if c.ndim >= 2 else c

    return Law(
        slot="C",
        apply_fn=apply_fn,
        inputs=inputs,
        callback_freq=0.0,
        trainable=False,
        name="SyntheticC",
    )


def eval_law(law: Law, theta, glacier, state=None, t=0.0, glacier_idx=0):
    """One-shot law evaluation with freshly resolved inputs."""
    resolved = {"glacier_idx": torch.as_tensor(glacier_idx)}
    for spec in law.inputs:
        resolved[spec.name] = spec.get(glacier, state, t)
    return law.apply(theta, resolved)
