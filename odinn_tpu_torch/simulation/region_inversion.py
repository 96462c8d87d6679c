"""Legacy region-split inversion.

The port of ``odinn_tpu.simulation.region_inversion``: partition a
glacier's grid into ``regions_split`` = (rx, ry) blocks and invert one
bounded creep value per region against thickness observations, with x/f
tolerances (``InversionParameters``).

The region values are sigmoid-bounded into [lower_bound, upper_bound]; the
region → grid scatter is a one-hot matrix product; the optimizer is
``torch.optim.LBFGS`` with its strong-Wolfe line search (one iteration a
step, history 10, up to 20 line-search steps, as the trainer's LBFGS), by
autograd through the solve. A gridded A is not the fused kernels' (one
value per glacier): the RHS is the generic tensor path, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from odinn_tpu_torch.core.glacier import is_in_glacier, loss_normalization
from odinn_tpu_torch.losses.losses import L2Sum, simple_loss
from odinn_tpu_torch.physics.sia2d import SIAValues, sia2d_rhs
from odinn_tpu_torch.physics.targets import ATarget
from odinn_tpu_torch.simulation.solver import build_tstops, integrate_scan

__all__ = ["region_map", "region_split_inversion"]


def region_map(nx: int, ny: int, regions_split) -> np.ndarray:
    """(nx−1, ny−1) staggered-grid map of region indices (row-major blocks)."""
    rx, ry = regions_split
    ix = np.minimum((np.arange(nx - 1) * rx) // (nx - 1), rx - 1)
    iy = np.minimum((np.arange(ny - 1) * ry) // (ny - 1), ry - 1)
    return ix[:, None] * ry + iy[None, :]


def region_split_inversion(glacier, params, tstops=None, max_iters: int = 100):
    """Invert one A per region of a lone glacier; returns dict(A_regions,
    A_field, losses, retcode). ``losses`` holds the loss at each
    iteration's start; it stops when the loss improves by less than f_tol
    (``"FTolReached"``) or θ moves by less than x_tol (``"XTolReached"``),
    else after ``max_iters`` (``"MaxIters"``)."""
    inv_p = params.inversion
    phys = params.physical
    lo = float(np.asarray(inv_p.lower_bound).ravel()[0])
    hi = float(np.asarray(inv_p.upper_bound).ravel()[0])
    rx, ry = inv_p.regions_split
    n_regions = rx * ry

    if tstops is None:
        tstops = build_tstops(params.simulation.tspan, params.solver.step)
    td = glacier.thickness_data
    if td is None:
        raise ValueError("region-split inversion requires thickness observations")
    H0 = glacier.H0
    dtype, device = H0.dtype, H0.device
    ts = np.asarray(torch.as_tensor(tstops).detach().cpu(), dtype=np.float64)
    dts = np.diff(ts)
    H_obs = torch.as_tensor(td.H).to(device=device, dtype=dtype)

    rmap = torch.as_tensor(region_map(H0.shape[-2], H0.shape[-1], (rx, ry)), device=device)
    onehot = torch.nn.functional.one_hot(rmap, n_regions).to(dtype)    # (nx-1, ny-1, R)
    target = ATarget()
    # the pre-padding pixel count (loss_normalization), as train_ude weighs it
    npix = float(loss_normalization(glacier))
    masks = [is_in_glacier(H_obs[tau], 3) for tau in range(len(ts))]

    def a_field_of(theta):
        return onehot @ (lo + (hi - lo) * torch.sigmoid(theta))

    def loss_fn(theta):
        vals = SIAValues(A=a_field_of(theta), C=torch.zeros_like(glacier.C), n=glacier.n,
                         p=glacier.n, q=torch.zeros_like(glacier.n))

        def rhs(H, t):
            return sia2d_rhs(H, glacier.B, glacier.dx, glacier.dy, lambda hb, gs: vals, target,
                             phys)

        traj = integrate_scan(rhs, H0, ts, params.solver.substeps)
        total = torch.zeros((), dtype=dtype, device=device)
        for tau in range(1, len(ts)):
            total = total + simple_loss(L2Sum(), traj[tau], H_obs[tau], masks[tau],
                                        npix) * float(dts[tau - 1])
        return total

    theta = torch.zeros((n_regions,), dtype=dtype, device=device, requires_grad=True)
    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=1, max_eval=21, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        val = loss_fn(theta)
        val.backward()
        return val

    losses, retcode = [], "MaxIters"
    for _ in range(max_iters):
        before = theta.detach().clone()
        losses.append(float(opt.step(closure)))
        dx_step = float(torch.linalg.norm(theta.detach() - before))
        if len(losses) > 1 and abs(losses[-2] - losses[-1]) < inv_p.f_tol:
            retcode = "FTolReached"
            break
        if dx_step < inv_p.x_tol:
            retcode = "XTolReached"
            break

    with torch.no_grad():
        a_reg = lo + (hi - lo) * torch.sigmoid(theta)
        return {
            "A_regions": a_reg.cpu().numpy(),
            "A_field": a_field_of(theta).cpu().numpy(),
            "losses": losses,
            "retcode": retcode,
        }
