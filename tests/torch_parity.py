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


# ---------------------------------------------------------------------------
# The classical-inversion problems shared by test_torch_classical_*.py
# ---------------------------------------------------------------------------

CLASSICAL_TSPAN = (5.0, 5.0 + 3.0 / 12.0)     # 3 monthly intervals
MAX_C = 1e-15


def classical_params(P, solver="SI", grad="jax", loss=None, **hyper):
    """One parameter set for either package (``P`` the params module):
    2 glaciers' worth of A, C and n bounds, 3 monthly intervals at 2
    substeps (RKC s = 6; SI/SI2 PCG-10, predictor PCG-4)."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=2e-18, min_C=0.0, max_C=MAX_C),
        simulation=P.SimulationParameters(tspan=CLASSICAL_TSPAN, use_MB=False,
                                          use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=2, solver=solver, rkc_stages=6,
                                  cg_iters=10, cg_iters_predictor=4),
        hyper=P.Hyperparameters(**hyper) if hyper else P.Hyperparameters(),
        UDE=P.UDEParameters(grad=grad, empirical_loss_function=loss))


def classical_truth(store=("H",), truth_c=None, truth_n=None):
    """Two 24² Halfar glaciers (JAX) with ground truth from the
    Cuffey–Paterson A(T), or from per-glacier constant A, C and n when
    ``truth_c``/``truth_n`` are given; returns (JAX batch, port batch)."""
    import jax.numpy as jnp
    import odinn_tpu.core.params as JP
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.data.synthetic import halfar_glacier
    from odinn_tpu.laws.laws import CuffeyPaterson, Law
    from odinn_tpu.models.model import Model, SIA2DModel
    from odinn_tpu.simulation.prediction import generate_ground_truth
    from odinn_tpu.simulation.solver import build_tstops

    def const(slot, values):
        vals = jnp.asarray(values)
        return Law(slot=slot, apply_fn=lambda th, inp: vals[inp["glacier_idx"]], inputs=(),
                   callback_freq=0.0, trainable=False, name=f"Const{slot}")

    gl = [halfar_glacier(nx=24, ny=24, dx=200.0, h0=150.0, r0=1600.0, temp=t, rgi_id=f"c{i}")
          for i, t in enumerate((-27.0, -32.0))]
    kw = {"A": CuffeyPaterson()}
    if truth_c is not None:
        kw["C"] = const("C", truth_c)
    if truth_n is not None:
        kw.update(A=const("A", (2e-18, 1e-18)), n=const("n", truth_n))
    # sliding or a larger n would need more explicit substeps: the
    # unconditionally stable SI step makes those truths
    jp = classical_params(JP, "RK4" if truth_c is None and truth_n is None else "SI")
    gl = generate_ground_truth(gl, jp, Model(iceflow=SIA2DModel(**kw)),
                               build_tstops(CLASSICAL_TSPAN, 1.0 / 12.0), store=store)
    batch = stack_glaciers(gl)
    return batch, carry_glacier(batch)


def per_glacier_const_law(law_cls, slot, values, jax=False):
    """A non-trainable law giving one constant per glacier, in either
    package (``law_cls`` its Law class)."""
    if jax:
        import jax.numpy as jnp

        vals = jnp.asarray(values)
    else:
        vals = torch.tensor(values, dtype=torch.float64)
    return law_cls(slot=slot, apply_fn=lambda th, inp: vals[inp["glacier_idx"]], inputs=(),
                   callback_freq=0.0, trainable=False, name=f"Const{slot}")


def theta_to_port(jtheta):
    """A JAX θ dict of arrays → the port's, through ``theta_from_numpy``."""
    from odinn_tpu_torch.convert import theta_from_numpy

    return theta_from_numpy({k: np.asarray(v) for k, v in jtheta.items()}, device=CPU)


def assert_tree_rel(port, jax_tree, rtol, what=""):
    """Every leaf of a θ dict (port) against the JAX dict's, relative to
    each leaf's own max|·|."""
    assert set(port) == set(jax_tree), (what, set(port), set(jax_tree))
    for k in jax_tree:
        assert_rel(port[k], np.asarray(jax_tree[k]), rtol, f"{what} {k}")
