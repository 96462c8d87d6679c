"""Forward simulation: ``forward_batch``, ``Prediction``, ``run_prediction``
and ``generate_ground_truth``, and the tolerance contract's resolution of
``substeps="auto"`` and ``adaptive="replay"``.

The whole stacked glacier batch advances at once: the glacier axis is the
leading dimension of every state tensor, and per-glacier scalars are
(n_g, 1, 1) columns. A model with a trainable initial condition starts
from H₀ = σ(θ_IC) when θ holds "IC".

``solver.reltol`` is honoured three ways (``SolverParameters``):
``adaptive=True`` solves by the error-controlled BS3(2) integrator at
rtol = atol = reltol, one step-size controller per glacier;
``adaptive="replay"`` replays the accepted steps one such solve recorded
(:func:`resolve_replay`) as a fixed, differentiable step sequence; and
``substeps="auto"`` sizes the fixed-step solvers from probe solves
(:func:`resolve_substeps`). The BS3 stages evaluate the RHS as the
explicit steppers do: one ``sia2d_rhs`` launch on the card where the
fused kernels' law configuration holds.

With ``solver="RKC"`` and the fused kernels' law configuration (the A target
with one value per glacier for every slot, one exponent set for the batch, a
plane the kernel holds) each substep is one fused RKC2 step,
:func:`odinn_tpu_torch.ops.cuda.rkc_kernel.rkc_interval`; every other
configuration runs the generic RKC stages through the RHS.

A model with periodic laws (``callback_freq`` > 0) runs the interval loop
of :func:`forward_glacier`: each such law is re-evaluated every
round(callback_freq / step) save intervals from the evolving state, after
the interval's mass balance, and the loop resolves its laws afresh after
each refresh (at every interval when the model has inner laws, whose
static inputs are read at the interval start). Its substeps are SI steps
cold-started at H (``solver="SI"``) or the plain explicit steppers, never
compensated; where the interval's values are the fused kernels'
configuration (an A-target model whose periodic laws give one value per
glacier) an SI step is one ``si_step`` launch and an RKC step one
``rkc_interval`` launch, their table rebuilt with the resolver.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.core.glacier import (
    DhdtData, Glacier, SurfaceVelocityData, ThicknessData, per_glacier_column, stack_glaciers)
from odinn_tpu_torch.models.model import (
    Model, initial_thickness, make_values_fn, resolve_law, resolve_outer_values)
from odinn_tpu_torch.ops.cuda.common import shared_exps
from odinn_tpu_torch.ops.cuda.rkc_kernel import rkc_fits
from odinn_tpu_torch.ops.cuda.sia_kernel import derive_table
from odinn_tpu_torch.physics.mass_balance import mb_timestep
from odinn_tpu_torch.physics.sia2d import scalar_law_table, sia2d_rhs, v_from_h
from odinn_tpu_torch.simulation.implicit import integrate_semi_implicit, semi_implicit_step
from odinn_tpu_torch.simulation.solver import (
    build_tstops, get_stepper, host_tstops, integrate_adaptive, integrate_replay,
    integrate_scan, make_rkc_interval_step, substep_dt)

__all__ = ["forward_glacier", "forward_batch", "calibrate_substeps",
           "calibrate_substeps_si", "resolve_substeps", "resolve_replay", "Prediction",
           "run_prediction", "generate_ground_truth"]

_METHODS = ("RK4", "SSPRK3", "Euler", "RKC", "SI", "SI2")


def _mb_every(params) -> int:
    """MB callback cadence in save intervals: step_MB / solver.step."""
    return max(int(round(params.simulation.step_MB / params.solver.step)), 1)


def _check_supported(model: Model, params) -> None:
    """The JAX package's refusals, in its order."""
    solver = params.solver
    if solver.adaptive:
        if model.iceflow.periodic_laws:
            raise NotImplementedError(
                "solver.adaptive does not support periodic laws "
                "(callback_freq > 0): their values ride the fixed-shape scan "
                "carry; use a fixed-substep solver for periodic-law models")
        if solver.adaptive == "replay" and solver.replay_dts is None:
            raise ValueError(
                "solver.adaptive='replay' needs the recorded step schedule "
                "— train_ude/run_prediction resolve it automatically; when "
                "driving forward_glacier directly, call "
                "odinn_tpu_torch.simulation.prediction.resolve_replay(params, "
                "batch, model, theta, tstops) first")
        return
    if isinstance(solver.substeps, str):
        raise ValueError(
            "solver.substeps='auto' must be resolved before the solve "
            "— train_ude/run_prediction do it automatically; when driving "
            "forward_glacier directly, call "
            "odinn_tpu_torch.simulation.prediction.resolve_substeps(params, batch, "
            "model, theta, tstops) first")
    if model.iceflow.periodic_laws and solver.solver == "SI2":
        raise NotImplementedError(
            "solver='SI2' does not support periodic laws (callback_freq > 0): "
            "the periodic-law interval loop drives single steps and does not "
            "carry the predictor-corrector warm-start state; use solver='SI' "
            "or an explicit solver for periodic-law models")


def _replay_rows(replay_dts, glacier):
    """The recorded schedule's rows of ``glacier`` (its ``glacier_ids``
    when gathered from a larger batch; row 0 for a lone glacier)."""
    dts = np.asarray(replay_dts)
    if glacier.glacier_ids is not None:
        return dts[np.asarray(glacier.glacier_ids.cpu())]
    return dts if glacier.is_batched else dts[0]


def _fused_rkc_stepper(values_fn, target, dx, dy, glacier, H0, phys, s):
    """The fused RKC2 stepper when the configuration is the kernel's (see the
    module doc), else None. On a row-sharded batch each step extends the
    own rows by ``s`` ghost rows, launches on that slab and keeps the own
    rows (one stage spoils one row inward from the slab's ring)."""
    shard = glacier.row_shard
    table = scalar_law_table(values_fn, target, dx, dy, H0)
    nx = H0.shape[-2] if shard is None else H0.shape[-2] + sum(shard.extent(s))
    if table is None or not rkc_fits(nx, H0.shape[-1], H0.dtype):
        return None
    derived = derive_table(table, phys.rho, phys.g)
    exps = shared_exps(derived)
    if exps is None:
        return None
    if shard is None:
        return make_rkc_interval_step(s, glacier.B.to(H0.dtype).contiguous(), derived,
                                      phys.eta0, exps)
    step = make_rkc_interval_step(s, shard.bed(s, H0.dtype), derived, phys.eta0, exps)
    return lambda f, y, t, dt: shard.crop(step(f, shard.halo_rows(y, s), t, dt), s)


def forward_glacier(theta, glacier: Glacier, model: Model, params, tstops, H0=None,
                    _return_stats: bool = False, _return_dts: int = 0, _record=None):
    """Solve a glacier, or a stacked batch at once, over ``tstops``; returns
    the trajectory (T, …, nx, ny) with the time axis first.

    The solve starts from ``H0``, by default σ(θ_IC) when θ holds a
    trainable initial condition, else the glacier's H₀. Outer laws are
    evaluated at the first tstop and that H₀ (periodic laws again every
    ``callback_freq`` years, from the state then: the module doc), inner
    laws at every RHS call, and the mass balance is applied at every
    ``step_MB`` interval end.

    With ``params.solver.adaptive`` the solve is the error-controlled
    BS3(2) integrator at rtol = atol = ``reltol``; ``_return_stats`` then
    also returns the (…, intervals) accepted step counts, ``_return_dts=cap``
    the accepted step record and ``_record`` (a dict) the trial counts
    (:func:`~odinn_tpu_torch.simulation.solver.integrate_adaptive`). With
    ``adaptive="replay"`` it replays ``params.solver.replay_dts``, the
    (glaciers, intervals, cap) record of :func:`resolve_replay`, indexed by
    the glaciers' rows.
    """
    _check_supported(model, params)
    shard = glacier.row_shard
    phys = params.physical
    H0 = initial_thickness(model, theta, glacier) if H0 is None else H0
    ts = host_tstops(tstops, H0.dtype)
    t_first = float(ts[0])
    outer_vals = resolve_outer_values(model, theta, glacier, t_first, H=H0)
    target = model.target
    dx, dy = per_glacier_column(glacier, glacier.dx), per_glacier_column(glacier, glacier.dy)
    callback = None
    if params.simulation.use_MB and model.mass_balance is not None:
        k = _mb_every(params)
        step_mb = params.simulation.step_MB

        def callback(H, ta, tb, i):
            if (i + 1) % k != 0:
                return H
            return mb_timestep(H, glacier, model.mass_balance, tb, step_mb)

    method = params.solver.solver if params.solver.solver in _METHODS else "RK4"
    if model.iceflow.periodic_laws:
        return _periodic_solve(theta, glacier, model, params, ts, H0, outer_vals, dx, dy,
                               callback, method)
    values_fn = make_values_fn(model, theta, glacier, t_first, outer_vals)
    adaptive = params.solver.adaptive
    if method in ("SI", "SI2") and not adaptive:
        return integrate_semi_implicit(
            H0, glacier.B, dx, dy, values_fn, target, phys, ts,
            substeps=params.solver.substeps, cg_iters=params.solver.cg_iters,
            callback=callback, corrector=method == "SI2",
            cg_iters_predictor=params.solver.cg_iters_predictor, shard=shard,
        )

    def rhs(H, t):
        if not params.simulation.use_iceflow:
            return torch.zeros_like(H)
        return sia2d_rhs(H, glacier.B, dx, dy, values_fn, target, phys, shard=shard)

    if adaptive == "replay":
        return integrate_replay(rhs, H0, ts, _replay_rows(params.solver.replay_dts, glacier),
                                callback=callback)
    if adaptive:
        return integrate_adaptive(rhs, H0, ts, rtol=params.solver.reltol,
                                  atol=params.solver.reltol, callback=callback,
                                  return_stats=_return_stats, return_dts=_return_dts,
                                  record=_record, shard=shard)
    stepper = None
    if method == "RKC" and params.simulation.use_iceflow and not params.solver.compensated:
        stepper = _fused_rkc_stepper(values_fn, target, dx, dy, glacier, H0, phys,
                                     params.solver.rkc_stages)
    return integrate_scan(
        rhs, H0, ts, params.solver.substeps, method=method, callback=callback,
        rkc_stages=params.solver.rkc_stages, compensated=params.solver.compensated,
        stepper=stepper,
    )


def _periodic_solve(theta, glacier, model, params, ts, H0, outer_vals, dx, dy, callback,
                    method):
    """The periodic-law interval loop (module doc): the trajectory at the
    tstops ``ts`` (numpy, the state's dtype) from H0 and the laws' values at
    the first tstop, ``outer_vals``. A refresh after the last interval would
    feed no step, so none is made."""
    phys, sp, target = params.physical, params.solver, model.target
    periodic = model.iceflow.periodic_laws
    cadences = {slot: max(int(round(law.callback_freq / sp.step)), 1)
                for slot, law in periodic.items()}
    npt = ts.dtype.type
    inner = any(law.is_inner for law in model.iceflow.laws.values())
    H, vals, traj, vfn = H0, outer_vals, [H0], None
    n_int = len(ts) - 1
    for i in range(n_int):
        t0, t1 = ts[i], ts[i + 1]
        if vfn is None or inner:
            # a fresh resolver (the kernels' table is cached on it) at the
            # first interval and after each refresh; inner laws read t0
            vfn = make_values_fn(model, theta, glacier, float(t0), vals)
            if method != "SI":
                step = None
                if method == "RKC" and params.simulation.use_iceflow:
                    step = _fused_rkc_stepper(vfn, target, dx, dy, glacier, H, phys,
                                              sp.rkc_stages)
                step = step or get_stepper(method, sp.rkc_stages)
        dt = substep_dt(t0, t1, sp.substeps)
        if method == "SI":
            for _ in range(sp.substeps):
                H = semi_implicit_step(H, glacier.B, dx, dy, vfn, target, phys, float(dt),
                                       sp.cg_iters, shard=glacier.row_shard)
        else:
            def rhs(Hc, t, vfn=vfn):
                if not params.simulation.use_iceflow:
                    return torch.zeros_like(Hc)
                return sia2d_rhs(Hc, glacier.B, dx, dy, vfn, target, phys,
                                 shard=glacier.row_shard)

            for k in range(sp.substeps):
                H = step(rhs, H, float(t0 + npt(k) * dt), float(dt))
        if callback is not None:
            H = callback(H, t0, t1, i)
        traj.append(H)
        if i + 1 < n_int:
            for slot, law in periodic.items():
                if (i + 1) % cadences[slot] == 0:
                    vals = vals.replace(**{slot: resolve_law(law, theta, glacier, float(t1), H)})
                    vfn = None
    return torch.stack(traj)


def _adaptive_probe(theta, batch, model, params, tstops, cap=0):
    """One adaptive BS3(2) forward of the batch at rtol = atol = reltol
    without a gradient: its accepted step counts (and, with ``cap``, the
    step record) as (glaciers, intervals[, cap]) tensors."""
    p_ad = params.replace(solver=dataclasses.replace(params.solver, adaptive=True))
    with torch.no_grad():
        return forward_glacier(theta, batch, model, p_ad, tstops, _return_stats=True,
                               _return_dts=cap)[1:]


def calibrate_substeps(theta, batch, model, params, tstops, safety: float = 1.5):
    """Size the fixed-step integrators from ``solver.reltol``: one adaptive,
    error-controlled forward of the batch (BS3(2) at rtol = atol = reltol),
    and ``ceil(safety × the most steps it accepted in one interval)`` over
    all glaciers and intervals, at least 1. The explicit steppers of the
    same order at that uniform step then run within the tolerance's reach;
    ``safety`` absorbs the uniform-against-adaptive mismatch. On a
    row-sharded batch the most is taken over every rank of the job, after
    the probe."""
    (naccs,) = _adaptive_probe(theta, batch, model, params, tstops)
    return max(int(math.ceil(_job_max(float(naccs.max()), batch) * safety)), 1)


def _job_max(value: float, batch) -> float:
    """``value``'s max over every rank of the job when ``batch`` is
    row-sharded (``spatial.job_max``), else ``value``."""
    if getattr(batch, "row_shard", None) is None:
        return value
    from odinn_tpu_torch.parallel.spatial import job_max

    return job_max(value)


def calibrate_substeps_si(theta, batch, model, params, tstops,
                          max_substeps: int = 1024, cg_probe: int = 64,
                          cg_candidates=(4, 6, 8, 12, 16, 24, 32, 48)):
    """Size ``substeps`` and ``cg_iters`` of the semi-implicit solvers (SI,
    SI2) from ``solver.reltol`` by Richardson step-halving; returns
    ``(substeps, cg_iters, cg_iters_predictor)``.

    The SI steps are unconditionally stable, so their substeps buy accuracy
    only. With a generous PCG budget (``cg_probe``) the whole forward runs at
    n and 2n substeps until max |H_n − H_2n| / (reltol + reltol·max(|H_n|,
    |H_2n|)) over the trajectory is ≤ 1, and 2n is taken. Then ``cg_iters``
    is the first candidate whose trajectory at those substeps lies within
    half that scaled distance of the ``cg_probe`` one (``cg_probe`` when
    none does), and the predictor budget max(cg_iters // 2,
    ``cg_iters_predictor``) is the one the accepted probe ran with. On a
    row-sharded batch each distance is a plane max over the row group, then
    over every rank of the job, so every rank takes the same decisions."""
    reltol = params.solver.reltol
    shard = getattr(batch, "row_shard", None)

    def run(n, cg):
        p = params.replace(solver=dataclasses.replace(
            params.solver, substeps=int(n), cg_iters=int(cg),
            cg_iters_predictor=max(int(cg) // 2, params.solver.cg_iters_predictor),
            adaptive=False))
        with torch.no_grad():
            return forward_glacier(theta, batch, model, p, tstops)

    def scaled_err(a, b):
        scale = reltol + reltol * torch.maximum(a.abs(), b.abs())
        ratio = (a - b).abs() / scale
        if shard is None:
            return float(ratio.max())
        from odinn_tpu_torch.parallel.spatial import plane_max

        return _job_max(float(plane_max(ratio, shard).max()), batch)

    n = 1
    traj_n = run(n, cg_probe)
    while True:
        traj_2n = run(2 * n, cg_probe)
        if scaled_err(traj_n, traj_2n) <= 1.0:
            substeps = 2 * n
            ref = traj_2n
            break
        n *= 2
        traj_n = traj_2n
        if 2 * n > max_substeps:
            raise ValueError(
                f"calibrate_substeps_si: reltol={reltol:g} not reached at "
                f"{max_substeps} substeps/interval — the splitting error "
                "floor of the semi-implicit discretization is above the "
                "requested tolerance here; loosen reltol or use an explicit "
                "solver (substeps='auto' with solver='SSPRK3'/'RK4')")
    cg = cg_probe
    for c in cg_candidates:
        if c >= cg_probe:
            break
        if scaled_err(run(substeps, c), ref) <= 0.5:
            cg = c
            break
    return substeps, cg, max(int(cg) // 2, params.solver.cg_iters_predictor)


def resolve_substeps(params, batch, model, theta, tstops):
    """``solver.substeps == "auto"`` resolved into a count: by
    :func:`calibrate_substeps_si` (which also sizes ``cg_iters``) for SI and
    SI2, by :func:`calibrate_substeps` for the explicit solvers; the
    parameters unchanged for an integer count."""
    if params.solver.substeps != "auto":
        return params
    if params.solver.solver in ("SI", "SI2"):
        n, cg, cg_pred = calibrate_substeps_si(theta, batch, model, params, tstops)
        print(f"[odinn_tpu_torch] substeps='auto' ({params.solver.solver}): "
              f"calibrated {n} substeps/interval, cg_iters={cg} "
              f"(predictor {cg_pred}) from reltol={params.solver.reltol:g} "
              f"(Richardson step-halving)")
        return params.replace(solver=dataclasses.replace(
            params.solver, substeps=n, cg_iters=cg, cg_iters_predictor=cg_pred))
    n = calibrate_substeps(theta, batch, model, params, tstops)
    print(f"[odinn_tpu_torch] substeps='auto': calibrated {n} substeps/interval "
          f"from reltol={params.solver.reltol:g} (adaptive BS3(2) probe)")
    return params.replace(solver=dataclasses.replace(params.solver, substeps=n))


def resolve_replay(params, batch, model, theta, tstops):
    """``solver.adaptive == "replay"`` resolved into a recorded schedule in
    ``solver.replay_dts``, a (glaciers, intervals, cap) numpy array of the
    accepted steps in the state's dtype; the parameters unchanged otherwise
    or when already resolved.

    Two adaptive probes of the batch at rtol = atol = reltol: the first
    counts the accepted steps per interval to size the record, the second
    records them. An accept past the record's end, or a record whose steps
    do not tile each interval to 1e-4·|span| + 1e-9, raises. On a
    row-sharded batch the cap is the most over every rank of the job, and
    the glacier groups' records are gathered into one, indexed by the
    glaciers' ``glacier_ids``, before it is checked."""
    if params.solver.adaptive != "replay" or params.solver.replay_dts is not None:
        return params
    (naccs,) = _adaptive_probe(theta, batch, model, params, tstops)
    cap = int(_job_max(float(naccs.max()), batch))
    naccs2, dts = _adaptive_probe(theta, batch, model, params, tstops, cap)
    if getattr(batch, "row_shard", None) is not None:
        naccs2, dts = _gather_record(naccs2, dts, batch)
    if int(naccs2.max()) > cap:
        raise RuntimeError(
            "resolve_replay: the recording probe accepted more steps than "
            f"the counting probe sized for (cap {cap}) — re-run; if it "
            "persists, the two probes disagree on a borderline "
            "accept/reject and reltol should be nudged")
    # a lone glacier's record gets the glacier axis of a batch's
    naccs = naccs.reshape(-1, naccs.shape[-1])
    dts = dts.cpu().numpy().reshape((-1,) + tuple(dts.shape[-2:]))
    sums = dts.sum(axis=-1).astype(np.float64)
    spans = np.diff(np.asarray(torch.as_tensor(tstops).cpu(), dtype=np.float64))[None, :]
    if not np.all(np.abs(sums - spans) <= 1e-4 * np.abs(spans) + 1e-9):
        raise RuntimeError(
            "resolve_replay: recorded dts do not tile the save intervals "
            f"(max defect {float(np.max(np.abs(sums - spans))):.3e}) — record corrupt")
    print(f"[odinn_tpu_torch] adaptive='replay': recorded {int(naccs.sum())} accepted steps "
          f"({naccs.shape[0]} glaciers × {naccs.shape[1]} intervals, "
          f"cap {cap}/interval) at reltol={params.solver.reltol:g}")
    return params.replace(solver=dataclasses.replace(params.solver, replay_dts=dts))


def _gather_record(naccs, dts, batch):
    """Every glacier group's accepted counts and step record, gathered over
    the job's ranks (one ``all_gather``) into arrays indexed by the
    glaciers' ``glacier_ids`` (the ranks of a row group hold the same)."""
    import torch.distributed as dist

    from odinn_tpu_torch.models.model import glacier_index

    ids = glacier_index(batch).reshape(-1).to(device="cpu", dtype=torch.float64)
    n_l = ids.shape[0]
    flat = torch.cat([ids, naccs.reshape(-1).to(device="cpu", dtype=torch.float64),
                      dts.reshape(-1).to(device="cpu", dtype=torch.float64)])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    n_int, cap = dts.shape[-2], dts.shape[-1]
    all_ids = torch.cat([p[:n_l] for p in parts]).long()
    n_all = int(all_ids.max()) + 1
    out_n = torch.zeros((n_all, n_int), dtype=naccs.dtype)
    out_d = torch.zeros((n_all, n_int, cap), dtype=dts.dtype)
    for p in parts:
        rows = p[:n_l].long()
        out_n[rows] = p[n_l:n_l + n_l * n_int].reshape(n_l, n_int).to(naccs.dtype)
        out_d[rows] = p[n_l + n_l * n_int:].reshape(n_l, n_int, cap).to(dts.dtype)
    return out_n, out_d


def forward_batch(theta, batch: Glacier, model: Model, params, tstops, device=None):
    """Forward solve of a stacked batch on ``device`` (None: the CUDA card).
    Returns trajectories of shape (n_glaciers, T, nx, ny)."""
    batch = batch.to(resolve_device(device))
    return forward_glacier(theta, batch, model, params, tstops).movedim(0, 1)


@dataclass
class Prediction:
    """Forward-simulation container: a stacked batch (or a list of glaciers,
    stacked on construction) on ``device`` (None: the CUDA card).
    ``resolved_parameters`` holds the last run's parameters with
    ``substeps="auto"`` and the replay schedule resolved, for inspection:
    every run resolves them afresh from ``parameters``."""

    model: Model
    glaciers: Any
    parameters: Any
    theta: Any = None
    results: Any = None
    device: Optional[Any] = None
    resolved_parameters: Any = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        if isinstance(self.glaciers, (list, tuple)):
            self.glaciers = stack_glaciers(list(self.glaciers), device=dev)
        else:
            self.glaciers = self.glaciers.to(dev)
        self.device = dev


def run_prediction(pred: Prediction, tstops=None):
    """Run the forward solve; stores the trajectories (and, with
    ``use_velocities``, the surface velocities at every tstop) in
    ``pred.results``. ``substeps="auto"`` and ``adaptive="replay"`` are
    resolved for this call only (``pred.resolved_parameters``), at
    ``pred.theta`` and these tstops."""
    params = pred.parameters
    if tstops is None:
        tstops = build_tstops(params.simulation.tspan, params.solver.step)
    batch = pred.glaciers
    params = resolve_substeps(params, batch, pred.model, pred.theta, tstops)
    params = resolve_replay(params, batch, pred.model, pred.theta, tstops)
    pred.resolved_parameters = params
    trajs = forward_batch(pred.theta, batch, pred.model, params, tstops, device=pred.device)
    results = {"t": tstops, "H": trajs}
    if params.simulation.use_velocities:
        t_first = float(host_tstops(tstops, trajs.dtype)[0])
        dx, dy = per_glacier_column(batch, batch.dx), per_glacier_column(batch, batch.dy)
        vel = []
        for k in range(trajs.shape[1]):
            H = trajs[:, k]
            outer = resolve_outer_values(pred.model, pred.theta, batch, t_first, H=H)
            vfn = make_values_fn(pred.model, pred.theta, batch, t_first, outer)
            vel.append(v_from_h(H, batch.B, dx, dy, vfn, pred.model.target,
                                params.physical))
        vx, vy, vabs = (torch.stack(v, dim=1) for v in zip(*vel))
        results.update({"Vx": vx, "Vy": vy, "V": vabs})
    pred.results = results
    return results


def generate_ground_truth(
    glaciers: Sequence[Glacier],
    params,
    model: Model,
    tstops,
    theta=None,
    store: Tuple[str, ...] = ("H", "V"),
    device=None,
):
    """Run the forward model on ``device`` (None: the CUDA card) and return
    new glaciers with synthetic observations attached. ``store`` entries:
    ``"H"`` thickness at every tstop, ``"V"`` velocities at every tstop,
    ``"dhdt"`` the mean thickness-change rate over the span, ``"avgV"`` the
    Δt-weighted mean velocity as one annual product (exclusive with "V")."""
    if "V" in store and "avgV" in store:
        raise ValueError(
            'store cannot contain both "V" and "avgV": they populate the '
            "same velocity_data slot (time series vs annual product)")
    need_velocities = ("V" in store) or ("avgV" in store)
    if need_velocities and not params.simulation.use_velocities:
        params = params.replace(
            simulation=dataclasses.replace(params.simulation, use_velocities=True))
    pred = Prediction(model=model, glaciers=list(glaciers), parameters=params, theta=theta,
                      device=device)
    with torch.no_grad():
        results = run_prediction(pred, tstops=tstops)
    dev = pred.device
    t = torch.as_tensor(results["t"], dtype=torch.float64).to(dev)
    out = []
    for i, g in enumerate(glaciers):
        nx, ny = g.nx, g.ny
        gi = g.to(dev)
        H_traj = results["H"][i, :, :nx, :ny]
        if "H" in store:
            gi = gi.replace(thickness_data=ThicknessData(t=t, H=H_traj))
        if "V" in store:
            gi = gi.replace(velocity_data=SurfaceVelocityData(
                t=t, vx=results["Vx"][i, :, :nx, :ny], vy=results["Vy"][i, :, :nx, :ny],
                vabs=results["V"][i, :, :nx, :ny]))
        if "dhdt" in store:
            t1, t2 = t[0], t[-1]
            gi = gi.replace(dhdt_data=DhdtData(t1=t1, t2=t2,
                                               dhdt=(H_traj[-1] - H_traj[0]) / (t2 - t1)))
        if "avgV" in store:
            w = torch.diff(t) / torch.sum(torch.diff(t))

            def wavg(f):
                return torch.tensordot(w.to(f.dtype), f[1:], dims=1)

            gi = gi.replace(velocity_data=SurfaceVelocityData(
                t=t[-1:], vx=wavg(results["Vx"][i, :, :nx, :ny])[None],
                vy=wavg(results["Vy"][i, :, :nx, :ny])[None],
                vabs=wavg(results["V"][i, :, :nx, :ny])[None], date1=t[0], date2=t[-1]))
        out.append(gi)
    return out
