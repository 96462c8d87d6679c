"""Carry state from the JAX package into the port.

The JAX package's state arrives as plain numpy (for example
``np.asarray`` of each leaf of a stacked ``odinn_tpu`` Glacier), so this
module imports nothing of it:

- :func:`glacier_from_numpy` turns a glacier (or stacked batch), given as a
  dict of field name → array, with the climate and observation containers
  as nested dicts, plus the static ``rgi_id`` (a tuple for a batch), into
  the port's :class:`~odinn_tpu_torch.core.glacier.Glacier`;
- :func:`theta_from_numpy` turns a θ tree (nested dicts, lists or tuples of
  arrays) into the same tree of tensors;
- :func:`mlp_from_numpy` turns the JAX package's MLP parameters (the
  ``init_mlp`` / ``NeuralNetwork.init`` tree: a list of
  ``{"w": (fan_in, fan_out), "b": (fan_out,)}`` dicts), given as numpy
  arrays, into the port's, checked against the architecture. The port's
  ``mlp_apply`` then computes what the JAX package's does:
  ``theta = {"A": mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
  for layer in jax_theta["A"]], arch)``.

:func:`to_numpy` goes the other way, for the files the port writes.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.core.glacier import (
    Climate2D,
    DhdtData,
    DummyClimate2D,
    Glacier,
    SurfaceVelocityData,
    ThicknessData,
)

__all__ = ["glacier_from_numpy", "theta_from_numpy", "mlp_from_numpy", "to_numpy"]

_NESTED = {
    "thickness_data": ThicknessData,
    "velocity_data": SurfaceVelocityData,
    "dhdt_data": DhdtData,
}


def _tensor(a, device, dtype: Optional[torch.dtype]):
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _fields(cls, d: Mapping, device, dtype):
    out = {}
    for name, v in d.items():
        if v is None or isinstance(v, (bool, str)):
            out[name] = v
        else:
            out[name] = _tensor(v, device, dtype)
    return cls(**out)


def glacier_from_numpy(fields: Mapping[str, Any], rgi_id, device=None,
                       dtype: Optional[torch.dtype] = None) -> Glacier:
    """The port's Glacier from a dict of numpy arrays (see the module doc).
    A climate dict with monthly series (``temp``) becomes a ``Climate2D``,
    otherwise a ``DummyClimate2D``. Floating arrays keep their dtype unless
    ``dtype`` is given; ``device`` None means the CUDA card."""
    dev = resolve_device(device)
    kw = {}
    for name, v in fields.items():
        if name == "rgi_id" or v is None:
            continue
        if name == "climate":
            cls = Climate2D if v.get("temp") is not None else DummyClimate2D
            kw[name] = _fields(cls, v, dev, dtype)
        elif name in _NESTED:
            kw[name] = _fields(_NESTED[name], v, dev, dtype)
        else:
            kw[name] = _tensor(v, dev, dtype)
    return Glacier(rgi_id=rgi_id, **kw)


def theta_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """The same tree with every array leaf a tensor on ``device`` (None: the
    CUDA card); None stays None."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(x, dev, dtype)

    return conv(tree)


def mlp_from_numpy(layers, arch=None, device=None, dtype: Optional[torch.dtype] = None):
    """The port's MLP parameter list from the JAX package's, as numpy (see
    the module doc). With ``arch`` (an ``MLP``) the layer count and every
    weight and bias shape are checked against its widths. ``device`` None
    means the CUDA card; floating arrays keep their dtype unless ``dtype``
    is given."""
    if arch is not None:
        if len(layers) != len(arch.widths) - 1:
            raise ValueError(f"{len(layers)} layers for an MLP of widths {arch.widths}")
        for k, (layer, fi, fo) in enumerate(zip(layers, arch.widths[:-1], arch.widths[1:])):
            shapes = (np.shape(layer["w"]), np.shape(layer["b"]))
            if shapes != ((fi, fo), (fo,)):
                raise ValueError(f"layer {k}: w, b of shapes {shapes}, expected "
                                 f"{((fi, fo), (fo,))}")
    return [{"w": t["w"], "b": t["b"]}
            for t in theta_from_numpy([dict(layer) for layer in layers], device, dtype)]


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device, detached) or anything numpy takes, as a
    numpy array of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
