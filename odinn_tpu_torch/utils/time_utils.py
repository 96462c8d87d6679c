"""Time utilities: float year ↔ datetime, and lookups on the tstops grid.

The float-year conversions are plain Python. ``ind_from_t`` and
``stop_condition_tstops`` take tensors (or anything ``torch.as_tensor``
takes) and return 0-dim tensors; ``torch.argmin`` returns the first
minimum, so ties resolve as ``jnp.argmin``'s do.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

__all__ = [
    "datetime_to_floatyear",
    "floatyear_to_datetime",
    "partial_year",
    "ind_from_t",
    "stop_condition_tstops",
    "t_data",
]


def datetime_to_floatyear(dt: _dt.datetime) -> float:
    """A datetime as a float year: the year plus the elapsed share of it."""
    start = _dt.datetime(dt.year, 1, 1)
    end = _dt.datetime(dt.year + 1, 1, 1)
    return dt.year + (dt - start).total_seconds() / (end - start).total_seconds()


def floatyear_to_datetime(t: float) -> _dt.datetime:
    """Inverse of :func:`datetime_to_floatyear`."""
    year = int(np.floor(t))
    start = _dt.datetime(year, 1, 1)
    end = _dt.datetime(year + 1, 1, 1)
    return start + _dt.timedelta(seconds=(t - year) * (end - start).total_seconds())


def partial_year(t: float) -> _dt.datetime:
    """Alias of :func:`floatyear_to_datetime`."""
    return floatyear_to_datetime(t)


def ind_from_t(tstops, t, atol: float = 1e-9) -> torch.Tensor:
    """Index of the tstop nearest to ``t`` (the first on a tie); callers
    check closeness where they need it."""
    tstops = torch.as_tensor(tstops)
    return torch.argmin(torch.abs(tstops - t))


def stop_condition_tstops(t, tstops, atol: float = 1e-9) -> torch.Tensor:
    """True iff ``t`` is within ``atol`` of one of the tstops."""
    tstops = torch.as_tensor(tstops)
    return torch.any(torch.abs(tstops - t) <= atol)


def t_data(data, tspan):
    """Timestamps of an observation container inside the simulation span,
    as a numpy array."""
    t = data.t
    ts = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return ts[(ts >= tspan[0] - 1e-9) & (ts <= tspan[1] + 1e-9)]
