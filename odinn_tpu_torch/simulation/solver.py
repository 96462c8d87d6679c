"""Time integrators for the SIA2D solve.

:func:`integrate_scan` advances the state with a fixed number of substeps
per save interval (Euler, RK4, SSPRK3 or RKC2), optionally with Kahan-
compensated accumulation, and runs a callback (mass balance) at every
interval end. :func:`integrate_adaptive` is the error-controlled
Bogacki–Shampine 3(2) forward, one step-size controller per glacier, and
:func:`integrate_replay` re-runs the accepted steps it recorded as a fixed,
differentiable step sequence. Each returns the trajectory saved at the
tstops.

Times are handled on the host in the state's dtype: the tstops are cast to
it before they are differenced, so a float32 solve steps by float32 dt, as
the JAX package does, and dt is the interval times the rounded reciprocal
of the substep count (:func:`substep_dt`), the product XLA compiles the JAX
package's division into. Steppers receive dt as a Python number holding
that value.
"""

from __future__ import annotations

from typing import Callable, Optional

import math

import numpy as np
import torch

__all__ = [
    "build_tstops",
    "host_tstops",
    "substep_dt",
    "suggest_substeps",
    "rkc_stages_for",
    "integrate_scan",
    "integrate_adaptive",
    "error_norm",
    "integrate_replay",
    "rk4_step",
    "ssprk3_step",
    "euler_step",
    "get_stepper",
    "make_rkc2_step",
    "make_rkc_interval_step",
]


def suggest_substeps(
    dx, dy, h_max, a_max, n: float = 3.0, rho: float = 900.0, g: float = 9.81,
    step: float = 1.0 / 12.0, slope_max: float = 0.3, safety: float = 2.0,
) -> int:
    """Substep count per save interval satisfying the explicit diffusion
    stability limit dt ≤ dx²/(4·D_max) with
    D_max = Γ(a_max)·h_max^{n+2}·slope^{n−1}; size it for the largest A the
    optimizer can reach (params.physical.max_A)."""
    gamma = 2.0 * a_max * (rho * g) ** n / (n + 2.0)
    d_max = gamma * float(h_max) ** (n + 2.0) * slope_max ** (n - 1.0)
    dt_stab = min(float(dx), float(dy)) ** 2 / (4.0 * max(d_max, 1e-30))
    return max(int(math.ceil(safety * step / dt_stab)), 1)


def rkc_stages_for(dx, dy, h_max, a_max, n=3.0, rho=900.0, g=9.81,
                   step=1.0 / 12.0, slope_max: float = 0.3, safety: float = 1.2) -> int:
    """Stage count s with 0.65·s² ≥ safety·dt·λ_max for one save interval,
    the RKC analogue of :func:`suggest_substeps`."""
    gamma = 2.0 * a_max * (rho * g) ** n / (n + 2.0)
    d_max = gamma * float(h_max) ** (n + 2.0) * slope_max ** (n - 1.0)
    lam = 4.0 * d_max / min(float(dx), float(dy)) ** 2
    return max(int(math.ceil(math.sqrt(safety * step * lam / 0.65))), 2)


def build_tstops(tspan, step, extra=None) -> torch.Tensor:
    """Uniform tstops over tspan at ``step``, unioned with ``extra`` times;
    a sorted float64 CPU tensor. Times closer than a few float32 ulps are
    merged, keeping the data time, so an observation instant never becomes a
    zero-length interval under a float32 solve."""
    t0, t1 = float(tspan[0]), float(tspan[1])
    n = int(round((t1 - t0) / step))
    grid = np.linspace(t0, t1, n + 1)
    if extra is None:
        return torch.from_numpy(grid)

    data = np.asarray(extra, float).ravel()
    data = data[(data >= t0 - 1e-9) & (data <= t1 + 1e-9)]
    cands = sorted(
        [(float(t), False) for t in grid] + [(float(t), True) for t in np.unique(data)]
    )

    def tol(t):
        return 1e-9 + 5e-7 * abs(t)   # ≈4 f32 ulps

    merged = []   # (representative, has_data)
    for t, is_data in cands:
        if merged and t - merged[-1][0] <= tol(t):
            rep, had_data = merged[-1]
            merged[-1] = (t if (is_data and not had_data) else rep,
                          had_data or is_data)
        else:
            merged.append((t, is_data))
    return torch.from_numpy(np.asarray([t for t, _ in merged]))


def host_tstops(tstops, dtype: torch.dtype) -> np.ndarray:
    """tstops as a numpy array in the state's dtype."""
    if isinstance(tstops, torch.Tensor):
        tstops = tstops.detach().cpu().numpy()
    return np.asarray(tstops, dtype=np.float32 if dtype == torch.float32 else np.float64)


def substep_dt(t0, t1, substeps: int):
    """The substep length of the interval [t0, t1] (numpy scalars of the
    state's dtype): (t1 − t0)·fl(1/substeps) in that dtype, which is what
    XLA makes of the JAX package's (t1 − t0)/substeps (checked bit for bit
    for 1–25 substeps in float32 and float64)."""
    npt = type(t0)
    return (t1 - t0) * (npt(1.0) / npt(substeps))


# ---------------------------------------------------------------------------
# Explicit steppers
# ---------------------------------------------------------------------------

def euler_step(f, y, t, dt):
    return y + dt * f(y, t)


def rk4_step(f, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = f(y + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = f(y + dt * k3, t + dt)
    return y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def ssprk3_step(f, y, t, dt):
    """3-stage 3rd-order strong-stability-preserving RK (Shu–Osher)."""
    y1 = y + dt * f(y, t)
    y2 = 0.75 * y + 0.25 * (y1 + dt * f(y1, t + dt))
    return y / 3.0 + (2.0 / 3.0) * (y2 + dt * f(y2, t + 0.5 * dt))


# Increment forms Δ = y_{n+1} − y_n for compensated accumulation.

def euler_increment(f, y, t, dt):
    return dt * f(y, t)


def rk4_increment(f, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = f(y + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = f(y + dt * k3, t + dt)
    return (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def ssprk3_increment(f, y, t, dt):
    """SSPRK3 as Δ = dt·(k1 + k2 + 4·k3)/6 with k1 = f(y), k2 = f(y + dt·k1),
    k3 = f(y + dt(k1+k2)/4)."""
    k1 = f(y, t)
    k2 = f(y + dt * k1, t + dt)
    k3 = f(y + 0.25 * dt * (k1 + k2), t + 0.5 * dt)
    return dt * (k1 + k2 + 4.0 * k3) / 6.0


_INCREMENTS = {"RK4": rk4_increment, "SSPRK3": ssprk3_increment,
               "Euler": euler_increment}


def _rkc2_coeffs(s: int, eps: float = 2.0 / 13.0):
    """Damped second-order Runge–Kutta–Chebyshev coefficients (RKC2); real-
    axis stability interval ≈ 0.65·s²."""
    w0 = 1.0 + eps / s**2

    T = np.zeros(s + 1)
    dT = np.zeros(s + 1)
    d2T = np.zeros(s + 1)
    T[0], dT[0], d2T[0] = 1.0, 0.0, 0.0
    T[1], dT[1], d2T[1] = w0, 1.0, 0.0
    for j in range(2, s + 1):
        T[j] = 2.0 * w0 * T[j - 1] - T[j - 2]
        dT[j] = 2.0 * T[j - 1] + 2.0 * w0 * dT[j - 1] - dT[j - 2]
        d2T[j] = 4.0 * dT[j - 1] + 2.0 * w0 * d2T[j - 1] - d2T[j - 2]

    w1 = dT[s] / d2T[s]
    b = np.zeros(s + 1)
    for j in range(2, s + 1):
        b[j] = d2T[j] / dT[j] ** 2
    b[0] = b[2]
    b[1] = 1.0 / w0
    a = 1.0 - b[: s + 1] * T[: s + 1]

    mu1_t = b[1] * w1
    mu = np.zeros(s + 1)
    nu = np.zeros(s + 1)
    mu_t = np.zeros(s + 1)
    gam_t = np.zeros(s + 1)
    c = np.zeros(s + 1)
    c[1] = mu1_t
    for j in range(2, s + 1):
        mu[j] = 2.0 * b[j] * w0 / b[j - 1]
        nu[j] = -b[j] / b[j - 2]
        mu_t[j] = mu[j] * w1 / w0
        gam_t[j] = -a[j - 1] * mu_t[j]
        c[j] = (dT[s] / d2T[s]) * (d2T[j] / dT[j]) if j < s else 1.0
    return w0, w1, mu1_t, mu, nu, mu_t, gam_t, c


def make_rkc2_step(s: int):
    """An s-stage RKC2 stepper ``step(f, y, t, dt)``. Coefficients are
    rounded to the state's dtype, and the stage weights formed in it."""
    _, _, mu1_t, mu_np, nu_np, mu_t_np, gam_t_np, c_np = _rkc2_coeffs(s)
    mu1_t = float(mu1_t)

    def step(f, y, t, dt):
        npt = np.float32 if y.dtype == torch.float32 else np.float64
        mu, nu, mu_t, gam_t, c = (a.astype(npt) for a in (mu_np, nu_np, mu_t_np, gam_t_np, c_np))
        dtn = npt(dt)
        f0 = f(y, t)
        y_jm1, y_jm2 = y + float(npt(mu1_t) * dtn) * f0, y
        for j in range(2, s + 1):
            f_j = f(y_jm1, float(t + c[j - 1] * dtn))
            y_j = (
                float(npt(1.0) - mu[j] - nu[j]) * y
                + float(mu[j]) * y_jm1
                + float(nu[j]) * y_jm2
                + float(mu_t[j] * dtn) * f_j
                + float(gam_t[j] * dtn) * f0
            )
            y_jm1, y_jm2 = y_j, y_jm1
        return y_jm1

    return step


def _col(a, y):
    """A per-glacier tensor (the state's leading shape) as a column that
    broadcasts over the state's (nx, ny) plane; a number unchanged."""
    return a.to(y.dtype).reshape(a.shape + (1, 1)) if isinstance(a, torch.Tensor) else a


def _bs32_step(f, y, t, dt, k1):
    """One embedded Bogacki–Shampine 3(2) step with FSAL: (y3, err, k4).
    ``t`` and ``dt`` are numbers, or tensors of the state's leading shape
    (one per glacier of a (n_g, nx, ny) state) whose glaciers each step by
    their own."""
    k2 = f(y + _col(0.5 * dt, y) * k1, t + 0.5 * dt)
    k3 = f(y + _col(0.75 * dt, y) * k2, t + 0.75 * dt)
    y3 = y + _col(dt, y) * (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / 9.0
    k4 = f(y3, t + dt)
    err = _col(dt, y) * (-5.0 * k1 / 72.0 + k2 / 12.0 + k3 / 9.0 - k4 / 8.0)
    return y3, err, k4


def _bs3_step(f, y, t, dt):
    """The update :func:`_bs32_step` applies on accept, without the
    embedded pair: its y3 does not involve the FSAL stage, and its k1 is
    f(y, t), so replaying the accepted steps through this stepper
    reproduces the adaptive trajectory to roundoff."""
    k1 = f(y, t)
    k2 = f(y + _col(0.5 * dt, y) * k1, t + 0.5 * dt)
    k3 = f(y + _col(0.75 * dt, y) * k2, t + 0.75 * dt)
    return y + _col(dt, y) * (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / 9.0


def error_norm(err, scale, shard=None, dtype=None):
    """Each glacier's error norm of an embedded step: the root mean square
    of err / scale over its plane (in ``dtype`` when given, after the
    square). On a row shard (``shard``, a ``parallel.spatial.RowShard``)
    the mean is over the padded plane, its own-row sums summed over the
    row group (``spatial.plane_mean``), so every rank of the group takes
    the same decision. The forward and reverse controllers share it."""
    q = (err / scale) ** 2
    if dtype is not None:
        q = q.to(dtype)
    if shard is None:
        return torch.sqrt(torch.mean(q, dim=(-2, -1)))
    from odinn_tpu_torch.parallel.spatial import plane_mean

    return torch.sqrt(plane_mean(q, shard))


def integrate_adaptive(
    rhs: Callable,
    y0,
    tstops,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    dt0: Optional[float] = None,
    max_steps_per_interval: int = 100_000,
    callback: Optional[Callable] = None,
    return_stats: bool = False,
    return_dts: int = 0,
    record: Optional[dict] = None,
    shard=None,
):
    """Adaptive BS3(2) integration hitting every tstop exactly.

    Each glacier of the state (its leading axes; a lone (nx, ny) plane is
    one) has its own time, step, FSAL derivative and counts, and steps
    while t < t₁ − 1e-12 and its trials in the interval are below
    ``max_steps_per_interval``. One RHS evaluation serves the whole batch;
    a glacier that has finished the interval is left bitwise unchanged.
    The error norm is each glacier's root mean square of
    err / (atol + rtol·max(|y|, |y3|)) over its plane; a step is accepted
    at a norm ≤ 1, and the next step is the trial's times
    clip(0.9·(norm + 1e-16)^(−1/3), 0.2, 5), truncated to land on the
    interval end. The step carries over from one interval to the next; the
    first is (t₁ − t₀)/100 of the first interval, or ``dt0``. Times, steps
    and norms are in the state's dtype. The loop reads one flag from the
    device per trial step (and one more that ends the interval).

    On a row-sharded state (``shard``: its rows are the rank's own, and
    ``rhs`` takes its ghost rows itself) the norm is :func:`error_norm`'s
    over the row group, so every rank of the group accepts alike, reads the
    same flag and keeps the same step record and counts.

    ``callback(y, t0, t1, interval_idx) -> y`` runs at the end of each save
    interval (mass balance); the FSAL derivative is then evaluated afresh.

    ``return_stats=True`` also returns the accepted step counts, shape
    ``(*lead, len(tstops) - 1)``; ``return_dts=cap`` the accepted step
    lengths, shape ``(*lead, len(tstops) - 1, cap)``, zero past each
    interval's count, with steps past ``cap`` dropped from the record (not
    from the solve). ``record``, a dict, receives ``"trials"``: each
    glacier's trial steps per interval, the shape of the accepted counts.

    ``integrate_adaptive.rhs_evals`` counts the RHS evaluations of the
    batch and ``integrate_adaptive.host_reads`` the reads of the loop
    condition, for whoever sets them to 0.
    """
    ts = host_tstops(tstops, y0.dtype)
    npt = ts.dtype.type
    dev, dtype, lead = y0.device, y0.dtype, y0.shape[:-2]
    cap = int(return_dts)
    dt_init = npt(dt0) if dt0 is not None else (ts[1] - ts[0]) / npt(100.0)

    def full(v):
        return torch.full(lead, float(v), dtype=dtype, device=dev)

    y, t, dt = y0, full(ts[0]), full(dt_init)
    k1 = rhs(y0, t)
    integrate_adaptive.rhs_evals += 1
    traj, naccs, trials, dts = [y0], [], [], []
    for i in range(len(ts) - 1):
        t1 = full(ts[i + 1])
        t_end = t1 - 1e-12
        it = torch.zeros(lead, dtype=torch.long, device=dev)
        nacc = torch.zeros_like(it)
        rec = torch.zeros(lead + (cap,), dtype=dtype, device=dev) if cap else None
        while True:
            active = (t < t_end) & (it < max_steps_per_interval)
            integrate_adaptive.host_reads += 1
            if not bool(active.any()):
                break
            dt_eff = torch.minimum(dt, t1 - t)
            y3, err, k4 = _bs32_step(rhs, y, t, dt_eff, k1)
            integrate_adaptive.rhs_evals += 3
            scale = atol + rtol * torch.maximum(y.abs(), y3.abs())
            en = error_norm(err, scale, shard)
            accept = active & (en <= 1.0)
            fac = torch.clamp(0.9 * (en + 1e-16) ** (-1.0 / 3.0), 0.2, 5.0)
            acc = accept.reshape(lead + (1, 1))
            y = torch.where(acc, y3, y)
            k1 = torch.where(acc, k4, k1)
            t = torch.where(accept, t + dt_eff, t)
            dt = torch.where(active, dt_eff * fac, dt)
            if rec is not None:
                # the accepted step at the accepted-count cursor, dropped
                # past the end of the record
                at = nacc.clamp(max=cap - 1).unsqueeze(-1)
                put = (accept & (nacc < cap)).unsqueeze(-1)
                rec.scatter_(-1, at, torch.where(put, dt_eff.unsqueeze(-1), rec.gather(-1, at)))
            nacc = nacc + accept.long()
            it = it + active.long()
        if callback is not None:
            y = callback(y, ts[i], ts[i + 1], i)
            k1 = rhs(y, t1)              # the state jumped: a fresh FSAL derivative
            integrate_adaptive.rhs_evals += 1
        traj.append(y)
        naccs.append(nacc)
        trials.append(it)
        if rec is not None:
            dts.append(rec)
    traj = torch.stack(traj)
    if record is not None:
        record["trials"] = torch.stack(trials, dim=-1)
    extras = ()
    if return_stats:
        extras += (torch.stack(naccs, dim=-1),)
    if cap:
        extras += (torch.stack(dts, dim=-2),)
    return (traj,) + extras if extras else traj


integrate_adaptive.rhs_evals = 0
integrate_adaptive.host_reads = 0


def integrate_replay(rhs: Callable, y0, tstops, dts, callback: Optional[Callable] = None):
    """Replay recorded accepted steps as a fixed, differentiable step
    sequence: ``dts`` of shape ``(*lead, len(tstops) - 1, cap)`` (numpy or
    a tensor; the record of :func:`integrate_adaptive`'s ``return_dts``),
    each glacier stepping by its own column entry through
    :func:`_bs3_step`. A zero step is the identity for a finite state, so a
    column that is zero for every glacier is skipped, and the record is
    read on the host. The trajectory equals the adaptive one to roundoff;
    its gradient is the exact gradient of that trajectory with the accepted
    steps held fixed. ``callback`` as in :func:`integrate_scan`."""
    ts = host_tstops(tstops, y0.dtype)
    steps = np.asarray(dts.detach().cpu() if isinstance(dts, torch.Tensor) else dts,
                       dtype=ts.dtype)
    steps_dev = torch.tensor(steps, device=y0.device)
    lead = y0.shape[:-2]
    y, traj = y0, [y0]
    for i in range(len(ts) - 1):
        t = torch.full(lead, float(ts[i]), dtype=y0.dtype, device=y0.device)
        for k in range(steps.shape[-1]):
            if not steps[..., i, k].any():
                continue
            dt = steps_dev[..., i, k]
            y = _bs3_step(rhs, y, t, dt)
            t = t + dt
        if callback is not None:
            y = callback(y, ts[i], ts[i + 1], i)
        traj.append(y)
    return torch.stack(traj)


def make_rkc_interval_step(s: int, B, table, eta0, exps):
    """An s-stage RKC2 stepper ``step(f, y, t, dt)`` that ignores ``f`` and
    takes the whole step as one fused launch,
    :func:`odinn_tpu_torch.ops.cuda.rkc_kernel.rkc_interval` (its plain
    version on the CPU): the right-hand side is the fused SIA2D RHS of the
    derived (n_g, 8) ``table`` with bed ``B``, which does not depend on t."""
    from odinn_tpu_torch.ops.cuda.rkc_kernel import rkc_interval

    def step(f, y, t, dt):
        return rkc_interval(y, B, table, dt, s, eta0, exps)

    return step


_STEPPERS = {"RK4": rk4_step, "SSPRK3": ssprk3_step, "Euler": euler_step}


def get_stepper(method: str, rkc_stages: int = 16):
    """Resolve a stepper name; "RKC" builds an s-stage Chebyshev stepper."""
    if method == "RKC":
        return make_rkc2_step(rkc_stages)
    return _STEPPERS[method]


def _kahan_add(y, c, inc):
    delta = inc - c
    t = y + delta
    return t, (t - y) - delta


def integrate_scan(
    rhs: Callable,
    y0,
    tstops,
    substeps: int,
    method: str = "RK4",
    callback: Optional[Callable] = None,
    rkc_stages: int = 16,
    compensated: bool = False,
    stepper: Optional[Callable] = None,
):
    """Integrate ``dy/dt = rhs(y, t)`` saving at every tstop.

    ``callback(y, t0, t1, interval_idx) -> y`` runs at the end of each save
    interval. ``compensated=True`` (Euler/SSPRK3/RK4) accumulates the state
    with Kahan summation in increment form, callback jumps folded in as
    increments. ``stepper(f, y, t, dt)``, when given, takes each substep in
    place of ``method``'s (the fused RKC step, :func:`make_rkc_interval_step`).
    Returns the trajectory, shape ``(len(tstops), *y0.shape)`` with
    ``traj[0] = y0``.
    """
    ts = host_tstops(tstops, y0.dtype)
    npt = ts.dtype.type
    if compensated and (method not in _INCREMENTS or stepper is not None):
        raise ValueError(
            f"compensated accumulation supports Euler/SSPRK3/RK4, not {method!r}")
    if compensated:
        advance = _INCREMENTS[method]
    else:
        advance = stepper if stepper is not None else get_stepper(method, rkc_stages)

    y, comp = y0, torch.zeros_like(y0)
    traj = [y0]
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = substep_dt(t0, t1, substeps)
        for k in range(substeps):
            t, h = float(t0 + npt(k) * dt), float(dt)
            if compensated:
                y, comp = _kahan_add(y, comp, advance(rhs, y, t, h))
            else:
                y = advance(rhs, y, t, h)
        if callback is not None:
            y_cb = callback(y, t0, t1, i)
            if compensated:
                y, comp = _kahan_add(y, comp, y_cb - y)
            else:
                y = y_cb
        traj.append(y)
    return torch.stack(traj)
