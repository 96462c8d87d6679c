"""Plotting: glacier fields, gridded data, learned laws, mass balance and
animations.

Figures are made with matplotlib's Agg backend on the CPU and returned
(:func:`save_plot` writes one); tensors are read through
``.detach().cpu().numpy()``, and a law is evaluated by the port's own
``Law.apply``. ``matplotlib`` (and ``PIL`` for the animation) is imported
inside the functions, so importing this module needs neither.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from odinn_tpu_torch.convert import to_numpy as _np

__all__ = [
    "plot_glacier",
    "plot_gridded_data",
    "plot_law",
    "plot_cumulative_mb",
    "plot_glacier_vid",
    "save_plot",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_plot(fig, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    _plt().close(fig)


def plot_glacier(glacier, fields: Sequence[str] = ("H0", "B"), title: Optional[str] = None):
    """Heatmaps of glacier fields, on its coordinates when it has them."""
    plt = _plt()
    fields = list(fields)
    fig, axes = plt.subplots(1, len(fields), figsize=(5 * len(fields), 4))
    if len(fields) == 1:
        axes = [axes]
    extent = None
    if glacier.coords_x is not None and glacier.coords_y is not None:
        cx, cy = _np(glacier.coords_x), _np(glacier.coords_y)
        extent = [cy[0], cy[-1], cx[0], cx[-1]]
    for ax, f in zip(axes, fields):
        im = ax.imshow(_np(getattr(glacier, f)), origin="lower", extent=extent, cmap="viridis")
        ax.set_title(f"{glacier.rgi_id}: {f}")
        fig.colorbar(im, ax=ax, shrink=0.8)
    if title:
        fig.suptitle(title)
    return fig


def plot_gridded_data(data, title: str = "", cmap: str = "viridis", mask=None):
    """One gridded field, NaN outside ``mask`` when given."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 4.5))
    arr = _np(data).astype(float)
    if mask is not None:
        arr = np.where(_np(mask).astype(bool), arr, np.nan)
    im = ax.imshow(arr, origin="lower", cmap=cmap)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.85)
    return fig


def plot_law(law, theta, glacier, input_ranges: dict, truth_fn=None, n: int = 100,
             glacier_idx: int = 0, t: float = 0.0, surface: bool = False,
             posterior=None):
    """Evaluate a law over 1 or 2 swept inputs: a line for one input, a
    heatmap for two (a 3-D surface with ``surface=True``, the truth as a
    wireframe), each with the truth overlaid when ``truth_fn`` is given.
    The other inputs are the law's own, read from ``glacier`` at ``t``.

    ``posterior``: a ``inverse.uncertainty.LaplacePosterior``; a 1-input
    plot then shades the law's pointwise ±2σ band."""
    plt = _plt()
    names = list(input_ranges.keys())
    base_inputs = {"glacier_idx": torch.tensor(glacier_idx)}
    for spec in law.inputs:
        base_inputs[spec.name] = spec.get(glacier, glacier.H0, t)

    def value(th, swept):
        inp = dict(base_inputs, **swept)
        return torch.as_tensor(law.apply(th, inp)).reshape(-1)[0]

    if len(names) == 1:
        name = names[0]
        lo, hi = input_ranges[name]
        xs = np.linspace(lo, hi, n)
        with torch.no_grad():
            ys = [float(value(theta, {name: torch.tensor(x)})) for x in xs]
        fig, ax = plt.subplots(figsize=(5.5, 4))
        ax.plot(xs, ys, label=f"law {law.name}")
        if posterior is not None:
            def band_fn(th):
                return torch.stack([value(th, {name: torch.tensor(x)}) for x in xs])

            vals, stds = posterior.band(band_fn)
            vals, stds = _np(vals), np.asarray(stds)
            ax.fill_between(xs, vals - 2 * stds, vals + 2 * stds, alpha=0.25,
                            label="±2σ (Laplace)")
        if truth_fn is not None:
            ax.plot(xs, [float(truth_fn(x)) for x in xs], "--", label="truth")
        ax.set_xlabel(name)
        ax.set_ylabel(law.slot)
        ax.legend()
        return fig

    if len(names) == 2:
        nx_name, ny_name = names
        f64 = torch.float64
        xs = np.linspace(*input_ranges[nx_name], n)
        ys = np.linspace(*input_ranges[ny_name], n)
        with torch.no_grad():
            Z = np.array([[float(value(theta, {nx_name: torch.full((1, 1), x, dtype=f64),
                                               ny_name: torch.full((1, 1), y, dtype=f64)}))
                           for y in ys] for x in xs])
        if surface:
            fig = plt.figure(figsize=(7, 5.5))
            ax = fig.add_subplot(projection="3d")
            YY, XX = np.meshgrid(ys, xs)
            surf = ax.plot_surface(XX, YY, Z, cmap="magma", alpha=0.9,
                                   linewidth=0, antialiased=True)
            if truth_fn is not None:
                Zt = np.array([[float(truth_fn(x, y)) for y in ys] for x in xs])
                ax.plot_wireframe(XX, YY, Zt, color="k", linewidth=0.4,
                                  rstride=max(n // 12, 1), cstride=max(n // 12, 1),
                                  label="truth")
            ax.set_xlabel(nx_name)
            ax.set_ylabel(ny_name)
            ax.set_zlabel(law.slot)
            fig.colorbar(surf, ax=ax, shrink=0.6, label=law.slot)
            return fig
        fig, ax = plt.subplots(figsize=(6, 4.5))
        im = ax.pcolormesh(ys, xs, Z, shading="auto", cmap="magma")
        ax.set_xlabel(ny_name)
        ax.set_ylabel(nx_name)
        fig.colorbar(im, ax=ax, label=law.slot)
        return fig

    raise ValueError("plot_law supports 1 or 2 swept inputs")


def plot_cumulative_mb(glacier, mb_model, tspan, step: float = 1.0 / 12.0):
    """The glacier-wide mean mass balance, accumulated over the span, of a
    ``TImodel1`` on the glacier's initial surface."""
    from odinn_tpu_torch.physics.mass_balance import compute_mb

    plt = _plt()
    ts = np.arange(tspan[0] + step, tspan[1] + 1e-9, step)
    S = glacier.B + glacier.H0
    inside = _np(glacier.H0) > 0
    cum, series = 0.0, []
    for t in ts:
        mb = _np(compute_mb(mb_model, glacier.climate, S, float(t), step))
        cum += float(mb[inside].mean()) if inside.any() else 0.0
        series.append(cum)
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(ts, series)
    ax.set_xlabel("time [yr]")
    ax.set_ylabel("cumulative MB [m ice]")
    ax.set_title(f"{glacier.rgi_id} cumulative mass balance")
    return fig


def plot_glacier_vid(path: str, traj, glacier, fps: int = 8, field_label: str = "H [m]"):
    """An animated GIF of a thickness trajectory (frames on the first axis)."""
    from PIL import Image

    plt = _plt()
    traj = _np(traj)
    vmax = float(traj.max())
    frames = []
    for k in range(traj.shape[0]):
        fig, ax = plt.subplots(figsize=(4.5, 4))
        ax.imshow(traj[k], origin="lower", cmap="Blues", vmin=0.0, vmax=vmax)
        ax.set_title(f"{glacier.rgi_id}  t index {k}  ({field_label})")
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8).reshape(h, w, 4)
        frames.append(Image.fromarray(buf[..., :3]))
        plt.close(fig)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=int(1000 / fps),
                   loop=0)
    return path
