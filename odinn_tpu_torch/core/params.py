"""Typed parameter containers.

Plain frozen dataclasses holding static configuration: the physical
constants, the simulation switches, the solver settings, the training
hyperparameters, the UDE and legacy inversion settings, and the composite
``Parameters``. Field names and defaults are those of ``odinn_tpu``'s
parameter classes, so one configuration drives both packages. Tensors never
live here; glacier state lives in :mod:`odinn_tpu_torch.core.glacier`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import torch

__all__ = [
    "PhysicalParameters",
    "SimulationParameters",
    "SolverParameters",
    "Hyperparameters",
    "UDEParameters",
    "InversionParameters",
    "Parameters",
    "torch_dtype",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named by ``SimulationParameters.float_dtype``."""
    return {"float32": torch.float32, "float64": torch.float64}[name]


@dataclass(frozen=True)
class PhysicalParameters:
    """Physical constants: ρ [kg m⁻³], g [m s⁻²], lengths in m, time in years."""

    rho: float = 900.0          # ice density
    g: float = 9.81             # gravitational acceleration
    epsilon: float = 1e-3       # numerical regularization ϵ
    eta0: float = 1.0           # η₀ upstream-thickness flux-clamp factor
    min_A: float = 8.5e-20      # Glen creep coefficient bounds [Pa⁻ⁿ yr⁻¹]
    max_A: float = 8e-17
    min_C: float = 0.0          # sliding coefficient bounds
    max_C: float = 1.0
    min_T_law: float = -25.0    # temperature range seen by T→A laws
    max_T_law: float = 1.0
    noise_A_magnitude: float = 5e-18


@dataclass(frozen=True)
class SimulationParameters:
    """Global simulation switches."""

    tspan: Tuple[float, float] = (2010.0, 2015.0)
    use_MB: bool = True
    use_iceflow: bool = True
    use_velocities: bool = True
    plots: bool = False
    overwrite_climate: bool = False
    step_MB: float = 1.0 / 12.0      # mass-balance callback period [yr]
    multiprocessing: bool = False
    workers: int = 1
    test_mode: bool = False
    working_dir: str = ""
    rgi_paths: Any = None
    grid_scaling_factor: int = 1
    f_surface_velocity_factor: float = 1.0
    mapping: Any = None
    climate_data_source: str = "dummy"
    float_dtype: str = "float64"     # see torch_dtype


@dataclass(frozen=True)
class SolverParameters:
    """Time-integration configuration.

    ``solver``: "RK4" | "SSPRK3" | "Euler" | "RKC" (stabilized Chebyshev) |
    "SI" (semi-implicit, one warm-started Jacobi-PCG solve per step) | "SI2"
    (Crank–Nicolson with a Picard midpoint diffusivity: two solves per step).
    ``compensated`` accumulates Euler/SSPRK3/RK4 states with Kahan
    summation. ``reltol`` is honoured three ways:

    - ``adaptive=True``: the error-controlled Bogacki–Shampine 3(2)
      integrator at rtol = atol = reltol, one step-size controller per
      glacier; forward-only (Prediction, ground truth), so training refuses
      it.
    - ``adaptive="replay"``: one such solve per glacier records its accepted
      steps (``replay_dts``, resolved by ``run_prediction``/``train_ude``
      through ``prediction.resolve_replay``), which then run as a fixed
      step sequence: the adaptive trajectory to roundoff, differentiable
      by autograd with the steps held fixed.
    - ``substeps="auto"``: probe solves size the fixed substeps from reltol
      (``prediction.resolve_substeps``): one adaptive BS3(2) probe for the
      explicit solvers and RKC, Richardson step-halving probes that also
      size ``cg_iters`` for SI/SI2.
    """

    solver: str = "RK4"
    reltol: float = 1e-8
    step: float = 1.0 / 12.0        # save/callback step (tstop spacing) [yr]
    substeps: Union[int, str] = 20  # fixed substeps per tstop interval
    rkc_stages: int = 16            # stage count for the RKC stepper
    cg_iters: int = 30              # CG iterations for the semi-implicit solver
    cg_iters_predictor: int = 6     # CG iterations for SI2's predictor solve
    save_everystep: bool = False
    tstops: Optional[Tuple[float, ...]] = None
    progress: bool = False
    progress_steps: int = 10
    maxiters: int = 50_000
    adaptive: Union[bool, str] = False
    # recorded adaptive schedule; an array, so excluded from __eq__/__hash__
    replay_dts: Any = field(default=None, compare=False, hash=False)
    remat: bool = True
    compensated: bool = False


@dataclass(frozen=True)
class Hyperparameters:
    """Training hyperparameters; the ``gn_*`` fields serve the
    Gauss–Newton/LM stages, which come with a later slice."""

    optimizer: Union[str, Tuple[str, ...]] = "lbfgs"
    learning_rate: Union[float, Tuple[float, ...]] = 1e-3
    epochs: Union[int, Tuple[int, ...]] = 50
    batch_size: int = 15
    gn_cg_iters: int = 8
    gn_precond: bool = True
    gn_cg_restarts: int = 1
    gn_glacier_norm: bool = False
    lbfgs_linesearch: str = "auto"   # "auto" | "zoom" | "backtracking"
    grad_accum_chunks: Union[int, str] = 1


@dataclass(frozen=True)
class UDEParameters:
    """UDE/inversion configuration."""

    sensealg: str = "interpolating"
    optim_autoAD: str = "jax"
    grad: Any = "jax"
    optimization_method: str = "AD+AD"
    empirical_loss_function: Any = None
    target: str = "A"                         # "A" | "D_hybrid" | "D"
    initial_condition_filter: str = "identity"


@dataclass(frozen=True)
class InversionParameters:
    """Legacy region-split inversion configuration."""

    initial_conditions: Tuple[float, ...] = (1.0,)
    lower_bound: Tuple[float, ...] = (0.0,)
    upper_bound: Tuple[float, ...] = (1.0,)
    regions_split: Tuple[int, int] = (1, 1)
    x_tol: float = 1e-3
    f_tol: float = 1e-3
    solver: str = "lbfgs"


@dataclass(frozen=True)
class Parameters:
    """Composite parameter object."""

    physical: PhysicalParameters = field(default_factory=PhysicalParameters)
    simulation: SimulationParameters = field(default_factory=SimulationParameters)
    solver: SolverParameters = field(default_factory=SolverParameters)
    hyper: Hyperparameters = field(default_factory=Hyperparameters)
    UDE: UDEParameters = field(default_factory=UDEParameters)
    inversion: InversionParameters = field(default_factory=InversionParameters)

    def replace(self, **kwargs) -> "Parameters":
        return dataclasses.replace(self, **kwargs)
