"""The API facade: one import surface under the names a user of the
reference (ODINN.jl and its Huginn, Muninn and Sleipnir packages) and of
the JAX package knows, over the port's implementations:

    from odinn_tpu_torch.api import *

    params  = Parameters(simulation=SimulationParameters(...), ...)
    model   = Model(iceflow=SIA2Dmodel(params, A=LawA(nn, params)),
                    mass_balance=TImodel1())
    glaciers = initialize_glaciers(rgi_ids, params)
    sim = Inversion(model=model, glaciers=glaciers, parameters=params)
    run(sim)

Naming: Julia's ``run!`` is :func:`run` (it dispatches on Prediction and
Inversion); ``SciMLSensitivityAdjoint`` is :class:`JaxAdjoint` (autograd
through the solve) and ``EnzymeVJP`` :class:`AutoVJP`; ``∂`` is spelled
``d`` in the VJP names. :func:`enable_multiprocessing` registers a mesh
over the ranks of a ``torch.distributed`` job, one process per device
(:mod:`odinn_tpu_torch.parallel`); with ``rows > 1`` a 2-D
``("glaciers", "rows")`` mesh (``make_mesh_2d``) whose row ranks share
each glacier's grid (:mod:`odinn_tpu_torch.parallel.spatial`).
"""

from __future__ import annotations

from functools import partial as _partial
from typing import Optional

# parameters -----------------------------------------------------------------
from odinn_tpu_torch.core.params import (
    Hyperparameters,
    InversionParameters,
    Parameters,
    PhysicalParameters,
    SimulationParameters,
    SolverParameters,
    UDEParameters,
)

UDEparameters = UDEParameters  # reference spelling

# data -----------------------------------------------------------------------
from odinn_tpu_torch.core.glacier import (
    Climate2D,
    DhdtData,
    DummyClimate2D,
    Glacier,
    SurfaceVelocityData,
    ThicknessData,
    is_in_glacier,
    regrid_velocity_data,
    stack_glaciers,
)

Glacier2D = Glacier  # reference spelling
dhdtData = DhdtData

from odinn_tpu_torch.data.halfar import Halfar, HalfarParameters, halfar_solution, halfar_velocity
from odinn_tpu_torch.data.rgi import fake_multi_datacube, get_rgi_paths, initialize_glaciers
from odinn_tpu_torch.data.synthetic import halfar_glacier, monthly_dummy_climate

# physics / models -----------------------------------------------------------
from odinn_tpu_torch.models.initial_condition import InitialCondition
from odinn_tpu_torch.models.mb_machine import CustomMLP, load_model, save_model
from odinn_tpu_torch.models.model import Model, SIA2DModel, init_theta
from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture, fourier_feature
from odinn_tpu_torch.models.nn_utils import pretraining
from odinn_tpu_torch.physics.mass_balance import TImodel1, validate_model_simulation_compatibility
from odinn_tpu_torch.physics.sia2d import sia2d_rhs, surface_velocity, v_from_h
from odinn_tpu_torch.physics.targets import ATarget, CappedTarget, DHybridTarget, DPureTarget

# reference spellings of the targets
SIA2D_A_target = ATarget
SIA2D_D_hybrid_target = DHybridTarget
SIA2D_D_target = DPureTarget


def SIA2Dmodel(params=None, A=None, C=None, n=None, Y=None, U=None,
               n_H=None, n_gradS=None, n_value=None, p_value=None, q_value=None):
    """The reference's ``SIA2Dmodel`` constructor: slot keywords; the
    ``params`` positional is taken for the signature and not read."""
    return SIA2DModel(A=A, C=C, n=n, Y=Y, U=U, n_H=n_H, n_gradS=n_gradS,
                      n_value=n_value, p_value=p_value, q_value=q_value)


# laws -----------------------------------------------------------------------
from odinn_tpu_torch.laws.laws import (
    ConstantA,
    CuffeyPaterson,
    Law,
    LawA,
    LawA_inversion,
    LawC,
    LawC_inversion,
    LawN_inversion,
    LawU,
    LawY,
    SyntheticC,
    eval_law,
    poly_A_paterson_cuffey,
)

polyA_PatersonCuffey = poly_A_paterson_cuffey


def GlacierWideInv(params, grid_shape=None):
    """The reference's ``GlacierWideInv``: one trainable A per glacier."""
    return LawA_inversion(params, scalar=True, grid_shape=grid_shape)


def GriddedInv(params, grid_shape):
    """The reference's ``GriddedInv``: one trainable A per staggered cell."""
    return LawA_inversion(params, scalar=False, grid_shape=grid_shape)


from odinn_tpu_torch.laws.inputs import (
    CPDD,
    AvgGriddedTemp,
    AvgScalarTemp,
    GradSInput,
    HbarInput,
    TopoRough,
)

iAvgScalarTemp = AvgScalarTemp
iAvgGriddedTemp = AvgGriddedTemp
iCPDD = CPDD
iHbar = HbarInput
iGradS = GradSInput
iTopoRough = TopoRough

# losses ---------------------------------------------------------------------
from odinn_tpu_torch.losses.losses import L2Sum, LogSum, LossH, LossHV, LossV, MultiLoss
from odinn_tpu_torch.losses.losses import backward_simple_loss as backward_loss
from odinn_tpu_torch.losses.regularization import (
    DiffusivityRegularization,
    InitialThicknessRegularization,
    RheologyRegularization,
    TikhonovRegularization,
    VelocityRegularization,
)
from odinn_tpu_torch.losses.time_aggregated import LossAvgV, LossDhdt

# inverse --------------------------------------------------------------------
from odinn_tpu_torch.inverse.adjoint_types import (
    AutoVJP,
    ContinuousAdjoint,
    ContinuousVJP,
    DiscreteAdjoint,
    DiscreteVJP,
    DummyAdjoint,
    JaxAdjoint,
    NoVJP,
)

SciMLSensitivityAdjoint = JaxAdjoint
EnzymeVJP = AutoVJP

# the hand-written VJPs and gradient under the reference's names, the flavor
# bound as an instance (the port's dispatch reads the flavor's type)
from odinn_tpu_torch.inverse.gradient import (
    glacier_adjoint_value_and_grad,
    make_adjoint_value_and_grad,
)
from odinn_tpu_torch.inverse.vjps import vjp_sia_dH, vjp_sia_dtheta

SIA2D_grad = make_adjoint_value_and_grad
VJP_λ_dSIA_dH_discrete = _partial(vjp_sia_dH, DiscreteVJP())
VJP_λ_dSIA_dH_continuous = _partial(vjp_sia_dH, ContinuousVJP())
VJP_λ_dSIA_dθ_discrete = _partial(vjp_sia_dtheta, DiscreteVJP())
VJP_λ_dSIA_dθ_continuous = _partial(vjp_sia_dtheta, ContinuousVJP())

# simulation -----------------------------------------------------------------
from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion, train_ude
from odinn_tpu_torch.simulation.prediction import (
    Prediction,
    calibrate_substeps,
    generate_ground_truth,
    resolve_substeps,
    run_prediction,
)
from odinn_tpu_torch.simulation.results import Results, TrainingStats
from odinn_tpu_torch.simulation.solver import (
    build_tstops,
    integrate_adaptive,
    integrate_scan,
    suggest_substeps,
)

train_UDE = train_ude


def run(simulation, **kwargs):
    """``run!``: a Prediction through :func:`run_prediction`, an Inversion
    through :func:`run_inversion`."""
    if isinstance(simulation, Prediction):
        return run_prediction(simulation, **kwargs)
    if isinstance(simulation, Inversion):
        return run_inversion(simulation, **kwargs)
    raise TypeError(f"cannot run {type(simulation).__name__}")


# utils ----------------------------------------------------------------------
from odinn_tpu_torch.utils.flatten import theta_to_vector, vector_to_theta
from odinn_tpu_torch.utils.io import (
    TrainingResult,
    load_inversion_file,
    restore_checkpoint,
    save_checkpoint,
    save_inversion_file,
    save_results_file,
)
from odinn_tpu_torch.utils.logging import TrainingLogger
from odinn_tpu_torch.utils.plotting import (
    plot_cumulative_mb,
    plot_glacier,
    plot_glacier_vid,
    plot_gridded_data,
    plot_law,
)
from odinn_tpu_torch.utils.time_utils import (
    datetime_to_floatyear,
    floatyear_to_datetime,
    ind_from_t,
    stop_condition_tstops,
)

indFromT = ind_from_t

# the reference's ComponentArrays bridge: θ is a tree, its flat view a vector
Vector2ComponentVector = vector_to_theta
ComponentVector2Vector = theta_to_vector

# parallel -------------------------------------------------------------------
from odinn_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_batch_to,
    replicate,
    set_active_mesh,
    shard_glacier_axis,
)
from odinn_tpu_torch.parallel.multiprocess import gather_to_host, global_mesh, init_distributed
from odinn_tpu_torch.parallel.spatial import make_mesh_2d
from odinn_tpu_torch.simulation.region_inversion import region_split_inversion

# uncertainty, multi-start training and ensemble Kalman inversion ------------
from odinn_tpu_torch.inverse.uncertainty import (
    LaplacePosterior,
    laplace_posterior,
    laplace_uncertainty,
)
from odinn_tpu_torch.simulation.eki import EKIResult, eki_train
from odinn_tpu_torch.simulation.ensemble import MultistartResult, init_restarts, multistart_train


def enable_multiprocessing(params=None, workers: Optional[int] = None, rows: int = 1):
    """The reference's Distributed bootstrap: build the mesh over the
    ``torch.distributed`` job's ranks and register it as the active mesh,
    so that later ``run``/``train_ude`` calls split the glacier axis over
    it. ``workers`` (default ``params.simulation.workers``) beyond the
    job's ranks warns and is clamped; a job of one rank registers no mesh
    (None). Returns the mesh. ``rows > 1``: a 2-D mesh whose ``rows`` ranks
    share each glacier's grid (:func:`make_mesh_2d`), the glacier groups
    clamped as the 1-D path clamps its workers; ``rows`` beyond the job's
    ranks raises ``ValueError``, as does a glacier dimension that leaves
    ranks over."""
    import warnings

    from odinn_tpu_torch.parallel.mesh import _world_size

    n = workers or (params.simulation.workers if params is not None else None)
    world = _world_size()
    if rows > 1:
        max_g = world // rows
        if max_g < 1:
            raise ValueError(f"rows={rows} exceeds the {world} visible devices (ranks of the "
                             "torch.distributed job)")
        if n is not None and n > max_g:
            warnings.warn(f"requested {n} glacier-axis workers × {rows} rows but only {world} "
                          f"devices are visible; clamping the glacier axis to {max_g}")
            n = max_g
        return set_active_mesh(make_mesh_2d(n_glaciers=n, n_rows=rows))
    if n is not None and n > world:
        warnings.warn(f"requested {n} workers but the torch.distributed job has {world} "
                      "ranks (one process per device); sharding over the available mesh")
        n = world
    return set_active_mesh(make_mesh(None if n is None or n == world else n))
