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


def tree_to_port(jtree, dtype=None):
    """A JAX θ tree (nested dicts and lists of arrays, e.g. an MLP's layer
    list under a law's slot) → the port's, through ``theta_from_numpy``."""
    import jax

    from odinn_tpu_torch.convert import theta_from_numpy

    return theta_from_numpy(jax.tree.map(np.asarray, jtree), device=CPU, dtype=dtype)


def tree_rel_err(port, jax_tree) -> float:
    """The largest relative error over the leaves of a θ tree (port)
    against the JAX tree's, each leaf relative to its own max|·|."""
    import jax

    from odinn_tpu_torch.simulation.inversion import _tree_leaves

    errs = []
    for a, d in zip(_tree_leaves(port), jax.tree.leaves(jax_tree)):
        d = np64(d)
        errs.append(float(np.abs(np64(a) - d).max()) / max(float(np.abs(d).max()), 1e-300))
    return max(errs)


# ---------------------------------------------------------------------------
# The D-target problems shared by test_torch_d_target*.py
# ---------------------------------------------------------------------------

D_KINDS = ("Y", "U", "capped")
# U's bound: the glaciers' D/H̄ reaches ~100 m/yr; at 2000, the bound of
# tests/test_d_targets.py, these 2-substep explicit solves are unstable
U_MAX = 200.0
MAX_D = 5000.0        # below the capped model's largest D (~1.4e4 m²/yr): the cap bites


def d_target_models(kind, jp, tp):
    """(JAX model, port model): the hybrid-D target (``LawY``), the pure-D
    target (``LawU``) or the capped A target (``LawA_inversion``, n = 3,
    ``max_D``); NNs of ``default_architecture(2, light=True)``."""
    import odinn_tpu.laws.laws as JL
    import odinn_tpu_torch.laws.laws as TL
    from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
    from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork as TNN, default_architecture as t_arch

    if kind == "Y":
        kw = dict(max_nn=8e-18, prescale_bounds=((-25.0, 0.0), (0.0, 500.0)))
        return (JModel(iceflow=JSIA2DModel(Y=JL.LawY(JNN(j_arch(2, light=True), seed=5), jp,
                                                     **kw))),
                Model(iceflow=SIA2DModel(Y=TL.LawY(TNN(t_arch(2, light=True)), tp, **kw))))
    if kind == "U":
        kw = dict(max_nn=U_MAX, prescale_bounds=((0.0, 500.0), (0.0, 0.3)))
        return (JModel(iceflow=JSIA2DModel(U=JL.LawU(JNN(j_arch(2, light=True), seed=3), jp,
                                                     **kw))),
                Model(iceflow=SIA2DModel(U=TL.LawU(TNN(t_arch(2, light=True)), tp, **kw))))
    return (JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp), n_value=3.0, max_D=MAX_D)),
            Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0, max_D=MAX_D)))


def d_target_theta(kind, jmodel, jb):
    """The JAX θ of a D-target problem: the JAX package's NN init, or a
    per-glacier A for the capped model."""
    import jax.numpy as jnp
    from odinn_tpu.models.model import init_theta

    if kind == "capped":
        return {"A": jnp.asarray([0.3, -0.2])}
    return init_theta(jmodel, jb)


def d_target_problem(kind, solver, grad="jax"):
    """(JAX params, port params, JAX model, port model) of a D-target
    problem on ``classical_truth()``'s glaciers; ``grad`` "jax", "DA"
    (DiscreteAdjoint) or "CA" (ContinuousAdjoint), with DiscreteVJP, or
    with AutoVJP ("DA-auto") or ContinuousVJP ("CA-cont")."""
    import odinn_tpu.core.params as JP
    import odinn_tpu.inverse.adjoint_types as JA
    import odinn_tpu_torch.core.params as TP
    import odinn_tpu_torch.inverse.adjoint_types as TA

    def adjoint(A):
        if grad == "jax":
            return "jax"
        base, _, vjp = grad.partition("-")
        cls = A.DiscreteAdjoint if base == "DA" else A.ContinuousAdjoint
        return cls(VJP_method={"": A.DiscreteVJP, "auto": A.AutoVJP,
                               "cont": A.ContinuousVJP}[vjp]())

    jp, tp = (classical_params(JP, solver, grad=adjoint(JA)),
              classical_params(TP, solver, grad=adjoint(TA)))
    return (jp, tp) + d_target_models(kind, jp, tp)


def count_kernel_plain_versions(monkeypatch):
    """A dict that counts the calls of the kernels' plain versions (the
    kernels, on the CPU), by name."""
    from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel

    counts = {}
    for mod, name in [(si_kernel, "_forward"), (si_kernel, "si_step_vjp_reference"),
                      (rkc_kernel, "_forward"), (sia_kernel, "sia2d_rhs_reference"),
                      (sia_kernel, "sia2d_rhs_vjp_reference")]:
        real = getattr(mod, name)

        def counted(*a, _r=real, _k=f"{mod.__name__}.{name}", **k):
            counts[_k] = counts.get(_k, 0) + 1
            return _r(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return counts


_JAX_D_RESULTS = {}


def jax_d_value_and_grad(kind, solver, grad, jb):
    """(JAX θ, loss, gradient) of a D-target problem by ``jax.grad`` of
    ``batch_transient_loss`` or the JAX package's manual adjoint, computed
    once per case and process."""
    key = (kind, solver, grad)
    if key not in _JAX_D_RESULTS:
        import jax

        from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad
        from odinn_tpu.simulation.inversion import Inversion, batch_transient_loss
        from odinn_tpu.simulation.solver import build_tstops

        jp, _, jm, _ = d_target_problem(kind, solver, grad)
        jtheta = d_target_theta(kind, jm, jb)
        if grad == "jax":
            ts = build_tstops(CLASSICAL_TSPAN, 1.0 / 12.0)
            val, g = jax.value_and_grad(lambda th: batch_transient_loss(th, jb, jm, jp, ts))(
                jtheta)
        else:
            inv = Inversion(model=jm, glaciers=jb, parameters=jp, theta=jtheta)
            val, g = make_adjoint_value_and_grad(
                inv, flavor="discrete" if grad.startswith("DA") else "continuous")(jtheta)
        _JAX_D_RESULTS[key] = (jtheta, float(val), g)
    return _JAX_D_RESULTS[key]


def port_d_value_and_grad(kind, solver, grad, tb, jtheta):
    """(loss, gradient θ tree) of the port's D-target problem at the JAX θ,
    by autograd or by the port's manual adjoint."""
    import jax

    from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
    from odinn_tpu_torch.simulation.inversion import (
        Inversion, assemble_tstops, batch_transient_loss)

    _, tp, _, tm = d_target_problem(kind, solver, grad)
    theta = tree_to_port(jtheta)
    if grad == "jax":
        leaves = jax.tree.leaves(theta)
        for x in leaves:
            x.requires_grad_(True)
        val = batch_transient_loss(theta, tb, tm, tp, assemble_tstops(tp, tb))
        it = iter(torch.autograd.grad(val, leaves))
        return float(val.detach()), jax.tree.map(lambda _: next(it), theta)
    inv = Inversion(model=tm, glaciers=tb, parameters=tp, theta=theta, device=CPU)
    val, g = make_adjoint_value_and_grad(
        inv, flavor="discrete" if grad.startswith("DA") else "continuous")(theta)
    return float(val), g
