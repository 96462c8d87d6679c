"""MassBalanceMachine: MLP mass-balance models.

:class:`CustomMLP` is a drop-in mass-balance model beside ``TImodel1``
(:func:`odinn_tpu_torch.physics.mass_balance.mb_timestep` takes any object
with ``compute_mb_field``): the monthly climate features of every grid
cell of every glacier go through the network as one ``(npix, n_features)``
matmul chain, and its output is the mass balance of the window.

Interchange format, the JAX package's (``odinn_tpu.models.mb_machine``),
so either package loads the other's files::

    model.json : {"widths": [...], "activations": [...],
                  "features": ["temp", "pdd", "snow", "elevation"],
                  "feature_means": [...], "feature_stds": [...]}
    params.json: {"layers": [{"w": [[...]], "b": [...]}, ...]}
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from odinn_tpu_torch.convert import mlp_from_numpy
from odinn_tpu_torch.models.nn import MLP, mlp_apply
from odinn_tpu_torch.physics.mass_balance import _DAYS_PER_MONTH, _trail

__all__ = ["CustomMLP", "save_model", "load_model", "download_MLP"]

@dataclass(frozen=True)
class CustomMLP:
    """MLP mass-balance model: ``params`` is the MLP's layer list, as
    :func:`odinn_tpu_torch.models.nn.init_mlp` makes it."""

    architecture: MLP
    params: Any
    features: Tuple[str, ...] = ("temp", "pdd", "snow", "elevation")
    feature_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 2000.0)
    feature_stds: Tuple[float, ...] = (10.0, 100.0, 0.1, 1000.0)

    def compute_mb_field(self, climate, S, t, step):
        """MB over the window (t − step, t] per cell [m ice], for one
        glacier (``S`` (nx, ny), series (n_months,)) or a stacked batch
        (``S`` (G, nx, ny), series (G, n_months), per-glacier scalars (G,)).

        Each glacier's window holds the months whose mid-month time
        t_start + (m + ½)/12 falls in (t − step, t], from its own t_start:
        the JAX package's mask over the whole series, applied to the
        ⌈12·step⌉ + 2 months around the window (the window's months and
        none past the series' ends), so a step's work does not grow with
        the series. The features are the window's mean surface temperature,
        its positive degree-days, its snow sum and the elevation; all
        G·nx·ny cells then go through the MLP at once.

        The dtype rule: the network runs in its parameters' dtype (the
        features are cast to it, as the JAX package promotes float32
        features against float64 parameters) and returns that dtype;
        ``mb_timestep`` casts the MB to H's dtype."""
        n_m = climate.temp.shape[-1]
        n_win = min(math.ceil(12.0 * step) + 2, n_m)
        # the first candidate month: one before the first whose mid-month
        # time can pass t − step, so rounding never drops a month
        first = torch.floor((t - step - climate.t_start) * 12.0 - 0.5).to(torch.long)
        idx = _trail(first, 1) + torch.arange(n_win, device=first.device)  # (…, n_win)
        months = idx.to(climate.t_start.dtype)
        t_m = _trail(climate.t_start, 1) + (months + 0.5) / 12.0
        w = ((idx >= 0) & (idx < n_m) & (t_m > t - step) & (t_m <= t)).to(S.dtype)
        idx = idx.clamp(0, n_m - 1)

        def window(series):
            return torch.take_along_dim(series, idx, dim=-1)

        t2d = _trail(window(climate.temp), 2) + _trail(window(climate.gradient), 2) * (
            S.unsqueeze(-3) - _trail(climate.ref_hgt, 3))            # (…, n_win, nx, ny)
        w2d = _trail(w, 2)
        temp_avg = torch.sum(w2d * t2d, dim=-3) / _trail(
            torch.clamp(torch.sum(w, dim=-1), min=1.0), 2)
        pdd = torch.sum(w2d * torch.clamp(t2d, min=0.0) * _DAYS_PER_MONTH, dim=-3)
        snow = _trail(torch.sum(w * window(climate.snow), dim=-1), 2).expand(S.shape)
        feats_map = {"temp": temp_avg, "pdd": pdd, "snow": snow, "elevation": S}
        p_dtype = self.params[0]["w"].dtype
        x = torch.stack([(feats_map[name] - mu) / sd for name, mu, sd in
                         zip(self.features, self.feature_means, self.feature_stds)], dim=-1)
        x = x.reshape(-1, len(self.features)).to(p_dtype)
        return mlp_apply(self.architecture, self.params, x)[..., 0].reshape(S.shape)


def save_model(dirpath: str, model: CustomMLP) -> None:
    """Write the ``model.json`` / ``params.json`` pair."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "model.json"), "w") as f:
        json.dump(
            {
                "widths": list(model.architecture.widths),
                "activations": list(model.architecture.activations),
                "features": list(model.features),
                "feature_means": list(model.feature_means),
                "feature_stds": list(model.feature_stds),
            },
            f,
        )
    layers = [{"w": layer["w"].detach().cpu().double().tolist(),
               "b": layer["b"].detach().cpu().double().tolist()} for layer in model.params]
    with open(os.path.join(dirpath, "params.json"), "w") as f:
        json.dump({"layers": layers}, f)


def load_model(dirpath: str, device=None,
               dtype: Optional[torch.dtype] = torch.float64) -> CustomMLP:
    """Read the ``model.json`` / ``params.json`` pair; the parameters go to
    ``device`` (None: the CUDA card) in ``dtype``."""
    with open(os.path.join(dirpath, "model.json")) as f:
        meta = json.load(f)
    with open(os.path.join(dirpath, "params.json")) as f:
        raw = json.load(f)
    arch = MLP(tuple(meta["widths"]), tuple(meta["activations"]))
    layers = [{"w": np.asarray(layer["w"], np.float64), "b": np.asarray(layer["b"], np.float64)}
              for layer in raw["layers"]]
    return CustomMLP(
        architecture=arch,
        params=mlp_from_numpy(layers, arch, device=device, dtype=dtype),
        features=tuple(meta.get("features", ("temp", "pdd", "snow", "elevation"))),
        feature_means=tuple(meta.get("feature_means", (0.0,) * 4)),
        feature_stds=tuple(meta.get("feature_stds", (1.0,) * 4)),
    )


def download_MLP(*args, **kwargs):
    """Gated: there is no network. Place the exported (model.json,
    params.json) pair on disk and call :func:`load_model`."""
    raise RuntimeError(
        "download_MLP requires network access; export the MLP to "
        "(model.json, params.json) and call load_model(dir) instead"
    )
