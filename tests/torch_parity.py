"""Shared helpers of the tests that hold odinn_tpu_torch to odinn_tpu.

Inputs go from the JAX package to the port as numpy, through
``odinn_tpu_torch.convert``, and results come back as numpy.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

CPU = "cpu"


def jax_to_numpy_fields(obj):
    """A (stacked) JAX container dataclass as the dict of numpy arrays that
    ``odinn_tpu_torch.convert`` takes; static fields are left out."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.metadata.get("static") or f.name == "rgi_id":
            continue
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = jax_to_numpy_fields(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def carry_glacier(jax_glacier):
    """A JAX glacier (or stacked batch) carried into the port on the CPU."""
    from odinn_tpu_torch.convert import glacier_from_numpy

    return glacier_from_numpy(jax_to_numpy_fields(jax_glacier), jax_glacier.rgi_id,
                              device=CPU)


def np64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_rel(actual, desired, rtol, what=""):
    """max|actual − desired| ≤ rtol · max|desired|."""
    a, d = np64(actual), np64(desired)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    scale = max(float(np.abs(d).max()), 1e-300)
    err = float(np.abs(a - d).max()) / scale
    assert err <= rtol, f"{what}: relative error {err:.3e} > {rtol:.1e}"
