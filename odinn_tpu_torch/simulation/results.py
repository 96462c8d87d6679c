"""Results containers: training statistics and simulation results."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

__all__ = ["TrainingStats", "Results", "create_results"]


@dataclass
class TrainingStats:
    """Training diagnostics accumulated by the trainer. ``solves`` and
    ``gradients`` count the forward solves of the batch (every loss
    evaluation, with or without a gradient, and the final forward) and the
    backward passes through them. ``substeps_bumps`` lists each re-sizing
    of an auto-sized or replayed solve as (iteration, old, new): the
    substep counts, or ``"replay"`` and ``"re-recorded xK"`` for a schedule
    re-recorded with each step split K ways."""

    retcode: Optional[str] = None
    losses: List[float] = field(default_factory=list)
    niter: int = 0
    theta: Any = None
    theta_hist: List[Any] = field(default_factory=list)
    grad_hist: List[Any] = field(default_factory=list)
    grad_norm_hist: List[float] = field(default_factory=list)
    initial_conditions: Any = None
    last_call: float = 0.0
    time_per_iter: List[float] = field(default_factory=list)
    final_loss: Optional[float] = None   # loss of the returned (best) iterate
    solves: int = 0
    gradients: int = 0
    substeps_bumps: List[Any] = field(default_factory=list)


@dataclass
class Results:
    """Simulation + training results."""

    simulation: Any = None        # dict of trajectories/velocities per glacier
    stats: Optional[TrainingStats] = None


def create_results(trajs, tstops, glaciers=None, velocities=None):
    """Assemble a simulation-results dict."""
    out = {"t": tstops, "H": trajs}
    if velocities is not None:
        out.update(velocities)
    if glaciers is not None:
        out["rgi_ids"] = getattr(glaciers, "rgi_id", None)
    return out
