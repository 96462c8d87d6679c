"""odinn_tpu_torch's MLP mass balance against odinn_tpu: ``compute_mb_field``
on a stacked batch glacier by glacier, the model files read by either
package, and the SI solve and its autograd gradient with the MLP mass
balance folded in. Float64 on the CPU, with a float32 case; tolerances per
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.models.mb_machine as jmb
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.models.mb_machine as tmb
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar, monthly_dummy_climate as j_clim
from odinn_tpu.models.nn import MLP as JMLP
from odinn_tpu_torch.models.nn import MLP
from tests.torch_parity import CPU, assert_rel, carry_glacier, np64

TSPAN = (5.0, 5.5)           # 6 monthly intervals
ARCH = ((4, 16, 16, 1), ("softplus", "tanh", "identity"))


def _mlps(dtype=np.float64, seed=0):
    """(JAX CustomMLP, port CustomMLP) with the same parameters, drawn from
    a numpy seed: scaled normal weights, small biases."""
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.standard_normal((fi, fo)) / np.sqrt(fi),
               "b": 0.1 * rng.standard_normal(fo)}
              for fi, fo in zip(ARCH[0][:-1], ARCH[0][1:])]
    layers = [{k: v.astype(dtype) for k, v in layer.items()} for layer in layers]
    jm = jmb.CustomMLP(JMLP(*ARCH), [{k: jnp.asarray(v) for k, v in layer.items()}
                                     for layer in layers])
    tm = tmb.CustomMLP(MLP(*ARCH), [{k: torch.from_numpy(v) for k, v in layer.items()}
                                    for layer in layers])
    return jm, tm


def _glaciers(n=2, nx=24, t_starts=None):
    """JAX Halfar glaciers (dx 100 m) with monthly climates."""
    t_starts = t_starts or [TSPAN[0]] * n
    return [j_halfar(nx=nx, ny=nx, dx=100.0, dy=100.0, r0=700.0, temp=float(t), rgi_id=f"m{i}",
                     climate=j_clim(ts, 12, temp_mean=-4.0 + 2.0 * i, longterm_temp=float(t),
                                    nx=nx, ny=nx))
            for i, (t, ts) in enumerate(zip(np.linspace(-20.0, -14.0, n), t_starts))]


@pytest.mark.parametrize("t, step", [(5.5, 1.0 / 12.0), (5.5, 0.5), (5.04, 1.0 / 12.0),
                                     (9.0, 1.0), (4.6, 0.5), (5.31, 0.3)])
def test_compute_mb_field_on_a_stack_matches_jax(t, step):
    """Three glaciers of different t_start stacked: each glacier's field
    equals JAX's compute_mb_field (its mask over the whole series) of that
    glacier alone (1e-12): windows of one month, six months, a step that is
    no whole number of months, none (t beyond the series), and windows
    reaching past the series' start."""
    gl = _glaciers(3, t_starts=[5.0, 4.75, 4.5])
    jm, tm = _mlps()
    batch = carry_glacier(j_stack(gl))
    S = batch.B + batch.H0 * 0.9
    out = tm.compute_mb_field(batch.climate, S, t, step)
    assert out.shape == (3, 24, 24) and out.dtype == torch.float64
    for i, g in enumerate(gl):
        ref = jm.compute_mb_field(g.climate, jnp.asarray(np64(S[i])), t, step)
        assert_rel(out[i], ref, 1e-12, f"glacier {i}")
        one = tm.compute_mb_field(carry_glacier(g).climate, S[i], t, step)
        assert_rel(one, ref, 1e-12, f"glacier {i} alone")
    if step == 1.0 / 12.0 and t == 5.5:
        # the glaciers' windows differ: their fields differ beyond the climate
        assert float((out[0] - out[1]).abs().max()) > 1e-3


def test_model_files_read_by_either_package(tmp_path):
    """save_model of each package loaded by the other: the same files and
    the same field."""
    jm, tm = _mlps(seed=2)
    tmb.save_model(str(tmp_path / "t"), tm)
    jmb.save_model(str(tmp_path / "j"), jm)
    for name in ("model.json", "params.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    g = _glaciers(1)[0]
    S = jnp.asarray(g.B + g.H0)
    ref = jm.compute_mb_field(g.climate, S, 5.5, 1.0 / 12.0)
    for src in ("t", "j"):
        back_t = tmb.load_model(str(tmp_path / src), device=CPU)
        back_j = jmb.load_model(str(tmp_path / src))
        assert back_t.architecture == tm.architecture and back_t.features == tm.features
        assert_rel(back_t.compute_mb_field(carry_glacier(g).climate, torch.from_numpy(np.array(S)),
                                           5.5, 1.0 / 12.0), ref, 1e-15, src)
        assert_rel(back_j.compute_mb_field(g.climate, S, 5.5, 1.0 / 12.0), ref, 1e-15, src)
    f32 = tmb.load_model(str(tmp_path / "t"), device=CPU, dtype=torch.float32)
    assert f32.params[0]["w"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="network"):
        tmb.download_MLP()


def _params(P, grad="jax"):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=True, step_MB=1.0 / 12.0,
                                          use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=1, solver="SI", cg_iters=10),
        UDE=P.UDEParameters(grad=grad))


def _models(jm, tm, law="cp"):
    import odinn_tpu.laws.laws as JL
    import odinn_tpu.models.model as JM
    import odinn_tpu_torch.laws.laws as TL
    import odinn_tpu_torch.models.model as TM
    from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
    from odinn_tpu_torch.models.nn import NeuralNetwork as TNN, default_architecture as t_arch

    if law == "cp":
        ja, ta = JL.CuffeyPaterson(), TL.CuffeyPaterson()
    else:
        ja = JL.LawA(JNN(j_arch(1)), _params(JP))
        ta = TL.LawA(TNN(t_arch(1)), _params(TP))
    return (JM.Model(iceflow=JM.SIA2DModel(A=ja, n_value=3.0), mass_balance=jm),
            TM.Model(iceflow=TM.SIA2DModel(A=ta, n_value=3.0), mass_balance=tm))


def test_forward_batch_with_mlp_mass_balance_matches_jax():
    """SI at PCG-10, 2 × 24², 6 months of monthly MLP mass balance: the
    port's trajectories equal JAX's (1e-10) and differ from the solve
    without mass balance; float32 (glaciers and MLP) within 1e-6 of JAX's
    float32 run, and within 2× its error against float64."""
    from odinn_tpu.simulation.prediction import forward_batch as j_forward
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = j_stack(_glaciers())
    jmodel, tmodel = _models(*_mlps())
    ref = j_forward(None, jb, jmodel, _params(JP), j_tstops(TSPAN, 1 / 12))
    out = forward_batch(None, carry_glacier(jb), tmodel, _params(TP), build_tstops(TSPAN, 1 / 12),
                        device=CPU)
    assert tuple(out.shape) == (2, 7, 24, 24)
    assert_rel(out, ref, 1e-10, "float64")
    no_mb = forward_batch(None, carry_glacier(jb), _models(None, None)[1], _params(TP),
                          build_tstops(TSPAN, 1 / 12), device=CPU)
    assert float((out - no_mb).abs().max()) > 1.0

    jb32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jb)
    jm32, tm32 = _mlps(np.float32)
    jmodel32, tmodel32 = _models(jm32, tm32)
    ref32 = j_forward(None, jb32, jmodel32, _params(JP), j_tstops(TSPAN, 1 / 12))
    out32 = forward_batch(None, carry_glacier(jb32), tmodel32, _params(TP),
                          build_tstops(TSPAN, 1 / 12), device=CPU)
    assert out32.dtype == torch.float32
    assert_rel(out32, ref32, 1e-6, "float32")
    scale = float(np.abs(np64(ref)).max())
    err_port = float(np.abs(np64(out32) - np64(ref)).max()) / scale
    err_jax = float(np.abs(np64(ref32) - np64(ref)).max()) / scale
    assert err_port <= 2.0 * err_jax, (err_port, err_jax)


def test_gradient_through_mlp_mass_balance_matches_jax():
    """A = NN(T) trained against a Cuffey–Paterson truth with the MLP mass
    balance: the loss and its autograd θ-gradient through the SI solve and
    every MB step equal jax.value_and_grad's (1e-8); the discrete adjoint
    with the analytic (TImodel1) MB pullback refuses the MLP model in both
    packages (TypeError)."""
    import odinn_tpu.inverse.adjoint_types as JA
    import odinn_tpu_torch.inverse.adjoint_types as TA
    from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad as j_adjoint
    from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
    from odinn_tpu.simulation.inversion import Inversion as JInversion, batch_transient_loss
    from odinn_tpu.simulation.prediction import generate_ground_truth
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
    from odinn_tpu_torch.simulation.inversion import (
        Inversion, assemble_tstops, batch_transient_loss as t_loss)
    from tests.torch_parity import tree_to_port

    jm, tm = _mlps()
    truth_j, _ = _models(jm, tm)
    jp, tp = _params(JP), _params(TP)
    ts = j_tstops(TSPAN, 1 / 12)
    jb = j_stack(generate_ground_truth(_glaciers(), jp, truth_j, ts, store=("H",)))
    jmodel, tmodel = _models(jm, tm, law="nn")
    jtheta = {"A": JNN(j_arch(1)).init()}
    val_j, grad_j = jax.value_and_grad(lambda th: batch_transient_loss(th, jb, jmodel, jp, ts))(
        jtheta)
    batch = carry_glacier(jb)
    theta = tree_to_port(jtheta)
    leaves = [layer[k].requires_grad_(True) for layer in theta["A"] for k in ("w", "b")]
    val = t_loss(theta, batch, tmodel, tp, assemble_tstops(tp, batch))
    grads = torch.autograd.grad(val, leaves)
    assert_rel(val, val_j, 1e-8, "loss")
    for g, jg in zip(grads, [layer[k] for layer in grad_j["A"] for k in ("w", "b")]):
        assert_rel(g, jg, 1e-8, "gradient")
        assert float(g.abs().max()) > 0.0

    j_grad = JA.DiscreteAdjoint(MB_VJP=JA.DiscreteVJP())
    with pytest.raises(TypeError, match="TImodel1"):
        j_adjoint(JInversion(model=jmodel, glaciers=jb, parameters=_params(JP, j_grad),
                             theta=jtheta), flavor="discrete")(jtheta)
    inv = Inversion(model=tmodel, glaciers=batch,
                    parameters=_params(TP, TA.DiscreteAdjoint(MB_VJP=TA.DiscreteVJP())),
                    theta=tree_to_port(jtheta), device=CPU)
    with pytest.raises(TypeError, match="TImodel1"):
        make_adjoint_value_and_grad(inv, flavor="discrete")(tree_to_port(jtheta))
