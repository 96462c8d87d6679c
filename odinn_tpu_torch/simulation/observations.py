"""Time-matched observation lookup, shared by the losses of the trainer.

An observation matches a tstop when their times agree within a few float32
ulps, the tolerance with which ``build_tstops`` merges data times into the
save grid (keeping the data time), so "merged into this tstop" and "matches
this tstop" agree. On a stacked batch the observation times are
(n_g, n_obs) and each glacier gets its own match.
"""

from __future__ import annotations

import torch

__all__ = ["match_time", "thickness_at", "velocity_at", "TIME_MATCH_TOL"]


def TIME_MATCH_TOL(t):
    """Few-float32-ulp time tolerance, equal to build_tstops's merge
    tolerance."""
    return 1e-9 + 5e-7 * abs(t)


def match_time(t_obs, t, dtype):
    """Nearest observation index ``k`` along the last axis and its validity
    gate (1.0 when the observation time equals ``t`` up to float32
    roundoff, else 0.0), in ``dtype``."""
    t_obs = torch.as_tensor(t_obs)
    dist = torch.abs(t_obs.to(torch.float64) - float(t))
    k = torch.argmin(dist, dim=-1)
    nearest = torch.gather(dist, -1, k.unsqueeze(-1)).squeeze(-1)
    return k, (nearest < TIME_MATCH_TOL(float(t))).to(dtype)


def _take(series, k):
    """series[k] for one glacier; series[g, k[g]] for a batch."""
    if k.ndim == 0:
        return series[k]
    return series[torch.arange(k.shape[0], device=series.device), k.to(series.device)]


def thickness_at(td, t, dtype):
    """(H_ref, valid) for a ThicknessData record at time ``t``; (None, 1.0)
    without thickness data."""
    if td is None or td.t is None:
        return None, 1.0
    k, valid = match_time(td.t, t, dtype)
    return _take(td.H, k), valid


def velocity_at(vd, t, dtype):
    """(vabs, vx, vy, valid) for a SurfaceVelocityData cube at time ``t``;
    (None, None, None, 1.0) without a time-resolved cube."""
    if vd is None or vd.vabs is None or vd.t is None or vd.vabs.ndim != vd.t.ndim + 2:
        return None, None, None, 1.0
    k, valid = match_time(vd.t, t, dtype)
    return _take(vd.vabs, k), _take(vd.vx, k), _take(vd.vy, k), valid
