"""Law inputs: small frozen dataclasses with ``get(glacier, state, t)``.

The long-term temperatures (scalar and gridded), cumulative positive
degree-days and topographic roughness, and the inner inputs H̄ and |∇S|,
which the RHS passes to inner laws from its own staggered fields (their
``get`` serves one-shot evaluations, :func:`~odinn_tpu_torch.laws.laws.eval_law`).
On a stacked batch ``get`` returns one value (or grid) per glacier along the
leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from odinn_tpu_torch.ops import stencils as st

__all__ = ["AvgScalarTemp", "AvgGriddedTemp", "CPDD", "HbarInput", "GradSInput", "TopoRough",
           "INNER_INPUTS"]

#: input names resolved inside the RHS from the current state
INNER_INPUTS = ("Hbar", "gradS")


def _trail(a, k: int):
    """``a`` with k trailing singleton axes (a no-op on Python numbers)."""
    return a.reshape(a.shape + (1,) * k) if isinstance(a, torch.Tensor) else a


@dataclass(frozen=True)
class AvgScalarTemp:
    """Mean long-term air temperature (scalar)."""

    name: str = "T"

    def get(self, glacier, state, t):
        return glacier.climate.avg_scalar_temp(t, batched=glacier.is_batched)


@dataclass(frozen=True)
class AvgGriddedTemp:
    """Mean long-term air temperature (gridded)."""

    name: str = "T_grid"

    def get(self, glacier, state, t):
        return glacier.climate.avg_gridded_temp(t, batched=glacier.is_batched)


@dataclass(frozen=True)
class CPDD:
    """Cumulative positive degree-days over the trailing ``window`` (years),
    per grid cell, from a monthly ``Climate2D`` downscaled to the surface."""

    window: float = 1.0
    name: str = "CPDD"

    def get(self, glacier, state, t):
        clim = glacier.climate
        if getattr(clim, "temp", None) is None:
            raise ValueError("CPDD input requires a monthly Climate2D")
        months = torch.arange(clim.temp.shape[-1], device=clim.temp.device)
        t_m = _trail(clim.t_start, 1) + (months + 0.5) / 12.0
        in_window = (t_m > t - self.window) & (t_m <= t)
        S = glacier.B + st.relu_strict(state) if state is not None else glacier.S
        t2d = _trail(clim.temp, 2) + _trail(clim.gradient, 2) * (
            S.unsqueeze(-3) - _trail(clim.ref_hgt, 3))
        # degree-months → degree-days (×30.44 days/month), positive part only
        pdd = torch.clamp(t2d, min=0.0) * 30.44
        return torch.sum(torch.where(_trail(in_window, 2), pdd, torch.zeros_like(pdd)), dim=-3)


@dataclass(frozen=True)
class HbarInput:
    """Staggered average ice thickness H̄ (inner input)."""

    name: str = "Hbar"

    def get(self, glacier, state, t):
        return st.avg(st.relu_strict(state))


@dataclass(frozen=True)
class GradSInput:
    """Staggered surface-slope magnitude |∇S| (inner input)."""

    name: str = "gradS"

    def get(self, glacier, state, t):
        s = glacier.B.to(state.dtype) + st.relu_strict(state)
        sx, sy = st.grad_slope(s, _trail(glacier.dx, 2), _trail(glacier.dy, 2))
        return st.safe_norm(sx, sy)


@dataclass(frozen=True)
class TopoRough:
    """Topographic roughness: the local standard deviation of the bed
    Laplacian over a (2·window+1)² neighbourhood (zero-padded at the edge).
    On a row-sharded glacier it reads the bed's static slab of ``halo``
    ghost rows and returns the own rows."""

    window: int = 2
    curvature_type: str = "laplacian"
    name: str = "topo_rough"

    @property
    def halo(self) -> int:
        """The bed's ghost rows an own row's roughness reads."""
        return self.window + 1

    def get(self, glacier, state, t):
        shard = getattr(glacier, "row_shard", None)
        if shard is not None:
            return shard.crop(self._roughness(shard.bed(self.halo), glacier), self.halo)
        return self._roughness(glacier.B, glacier)

    def _roughness(self, b, glacier):
        dx, dy = _trail(glacier.dx, 2), _trail(glacier.dy, 2)
        pad = torch.nn.functional.pad
        lap = (pad(st.diff_x(st.diff_x(b)), (0, 0, 1, 1)) / dx ** 2
               + pad(st.diff_y(st.diff_y(b)), (1, 1, 0, 0)) / dy ** 2)
        w = 2 * self.window + 1
        kernel = torch.ones((1, 1, w, w), dtype=lap.dtype, device=lap.device)

        def win(a):
            out = torch.nn.functional.conv2d(a.reshape(-1, 1, *a.shape[-2:]), kernel,
                                             padding=w // 2)
            return out.reshape(a.shape)

        cnt = win(torch.ones_like(lap))
        mean = win(lap) / cnt
        var = win(lap ** 2) / cnt - mean ** 2
        return torch.sqrt(torch.clamp(var, min=0.0))
