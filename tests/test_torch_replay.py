"""odinn_tpu_torch's record-and-replay solve (``adaptive="replay"``) against
odinn_tpu: the recorded schedule, its replay, the gradient through the
replay by autograd, ``train_ude`` through it, and the instability recovery
that re-records the schedule. Float64 on the CPU; tolerances per test.
"""

import functools

import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.4)
TEMPS = (-25.0, -12.0)


def _params(P, reltol=1e-6, grad="jax", hyper=None, phys=None, **solver_kw):
    return P.Parameters(
        physical=phys or P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, adaptive="replay", reltol=reltol,
                                  **solver_kw),
        hyper=hyper or P.Hyperparameters(),
        UDE=P.UDEParameters(grad=grad))


def _jax_batch(temps=TEMPS, nx=32):
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.data.synthetic import halfar_glacier

    return stack_glaciers([halfar_glacier(nx=nx, ny=nx, dx=110.0, dy=110.0, r0=1200.0,
                                          h0=300.0, temp=t, rgi_id=f"rp{i}")
                           for i, t in enumerate(temps)])


def _cp_models():
    import odinn_tpu.laws.laws as jl
    import odinn_tpu.models.model as jm
    import odinn_tpu_torch.laws.laws as tl
    import odinn_tpu_torch.models.model as tm

    return (jm.Model(iceflow=jm.SIA2DModel(A=jl.CuffeyPaterson(), n_value=3.0)),
            tm.Model(iceflow=tm.SIA2DModel(A=tl.CuffeyPaterson(), n_value=3.0)))


@functools.cache
def _jax_schedule():
    """The JAX package's schedule recorded on _jax_batch() at _params(JP),
    with that batch and the models; shared by the tests that replay it."""
    from odinn_tpu.simulation.prediction import resolve_replay as j_resolve
    from odinn_tpu.simulation.solver import build_tstops as j_tstops

    jb = _jax_batch()
    jmodel, tmodel = _cp_models()
    return jb, jmodel, tmodel, j_resolve(_params(JP), jb, jmodel, None, j_tstops(TSPAN, 1 / 12))


def _with_schedule(params, dts):
    import dataclasses

    return params.replace(solver=dataclasses.replace(params.solver, replay_dts=dts))


# Per step, relative: the JAX package's own schedule for this batch moves by
# up to 1.16e-9 of a step when H0 moves by one ulp (7.4e-10 one ulp down,
# 6.8e-11 with glacier 0 alone perturbed, 9.9e-10 at H0 (1 + 2^-50)), in
# glacier 1's intervals 1-2; the port's moves by 1.74e-9 at the same place.
# The BS3 controller turns the roundoff of its error estimate, a difference
# of two close solutions, into changes of dt far above eps. The bound is
# 8.6x the largest self-spread.
REPLAY_STEP_RTOL = 1e-8


def test_resolve_replay_matches_jax():
    """The recorded schedule: the same cap, the same zero pattern and count
    of steps in every interval, tiling every interval (1e-12), and each
    step within REPLAY_STEP_RTOL of JAX's, relative to the step. The JAX
    package against itself, with H0 moved by one ulp, spreads by up to
    1.16e-9 of a step in this setting (REPLAY_STEP_RTOL's comment), so an
    absolute 1e-11 (~1.4e-9 of a 7e-3 step) sat at the edge of the two
    packages' roundoff: the port's 1.74e-9 passed on one machine and failed
    on another."""
    from odinn_tpu_torch.simulation.prediction import resolve_replay
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb, _, tmodel, jp = _jax_schedule()
    want = np.asarray(jp.solver.replay_dts)
    p = resolve_replay(_params(TP), carry_glacier(jb), tmodel, None, build_tstops(TSPAN, 1 / 12))
    got = p.solver.replay_dts
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal((got > 0).sum(axis=-1), (want > 0).sum(axis=-1))
    np.testing.assert_allclose(got, want, rtol=REPLAY_STEP_RTOL, atol=0)
    spans = np.diff(build_tstops(TSPAN, 1 / 12).numpy())
    np.testing.assert_allclose(got.sum(axis=-1), np.broadcast_to(spans, got.shape[:2]),
                               rtol=1e-12)
    assert resolve_replay(p, None, None, None, None) is p          # already resolved


def test_replay_reproduces_the_adaptive_solve():
    """Replaying the recorded steps gives the adaptive trajectory to
    roundoff, in the port as in the JAX package, and the two packages'
    replays of one schedule agree to 1e-10."""
    from odinn_tpu.simulation.prediction import forward_glacier as j_fwd
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    import jax
    import jax.numpy as jnp

    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb, jmodel, tmodel, jp = _jax_schedule()
    jts, ts = j_tstops(TSPAN, 1 / 12), build_tstops(TSPAN, 1 / 12)
    j_traj = jax.vmap(lambda g, i: j_fwd(None, g, i, jmodel, jp, jts))(
        jb, jnp.arange(len(TEMPS)))
    tb = carry_glacier(jb)
    replay = forward_glacier(None, tb, tmodel, _with_schedule(_params(TP), jp.solver.replay_dts),
                             ts)
    assert_rel(replay.movedim(0, 1), np.asarray(j_traj), 1e-10, "replay vs JAX replay")
    adaptive = forward_glacier(None, tb, tmodel, _params(TP).replace(
        solver=TP.SolverParameters(step=1.0 / 12.0, adaptive=True, reltol=1e-6)), ts)
    assert_rel(replay, adaptive, 1e-12, "replay vs adaptive")


def test_skipped_zero_columns_are_bitwise_the_identity():
    """A column of the record that is zero for every glacier is skipped;
    stepping through it instead (y + 0·k) gives the same bits."""
    from odinn_tpu_torch.models.model import make_values_fn, resolve_outer_values
    from odinn_tpu_torch.physics.sia2d import sia2d_rhs
    from odinn_tpu_torch.simulation.prediction import resolve_replay
    from odinn_tpu_torch.simulation.solver import (
        _bs3_step, build_tstops, host_tstops, integrate_replay)
    from odinn_tpu_torch.core.glacier import per_glacier_column

    _, tmodel = _cp_models()
    tb = carry_glacier(_jax_batch())
    ts = build_tstops(TSPAN, 1 / 12)
    dts = resolve_replay(_params(TP), tb, tmodel, None, ts).solver.replay_dts
    dts = np.concatenate([dts, np.zeros_like(dts)], axis=-1)    # padded columns
    assert (dts == 0).all(axis=0).any()
    dx, dy = per_glacier_column(tb, tb.dx), per_glacier_column(tb, tb.dy)
    t0 = float(host_tstops(ts, torch.float64)[0])
    vfn = make_values_fn(tmodel, None, tb, t0, resolve_outer_values(tmodel, None, tb, t0))

    def rhs(H, t):
        return sia2d_rhs(H, tb.B, dx, dy, vfn, tmodel.target, TP.PhysicalParameters())

    skipped = integrate_replay(rhs, tb.H0, ts, dts)
    y, every = tb.H0, [tb.H0]
    steps = torch.from_numpy(dts)
    host = host_tstops(ts, torch.float64)
    for i in range(len(host) - 1):
        t = torch.full((len(TEMPS),), float(host[i]), dtype=torch.float64)
        for k in range(dts.shape[-1]):
            y = _bs3_step(rhs, y, t, steps[:, i, k])
            t = t + steps[:, i, k]
        every.append(y)
    assert torch.equal(skipped, torch.stack(every))


@functools.cache
def _truth(temps=TEMPS, nx=32):
    """Glaciers with a Cuffey-Paterson thickness series (RK4 at 20
    substeps; the port's, which is the JAX package's to roundoff), stacked,
    in both packages; computed once, shared by the tests that train on it
    (none of them changes it)."""
    import jax.numpy as jnp

    from odinn_tpu.core.glacier import ThicknessData as JThicknessData, stack_glaciers

    _, tmodel = _cp_models()
    p = _params(TP).replace(solver=TP.SolverParameters(solver="RK4", substeps=20))
    singles = [_single(t, i, nx) for i, t in enumerate(temps)]
    obs = _flushed_truth([carry_glacier(g) for g in singles], p, tmodel)
    jb = stack_glaciers([g.replace(thickness_data=JThicknessData(
        t=jnp.asarray(o.thickness_data.t.numpy()), H=jnp.asarray(o.thickness_data.H.numpy())))
        for g, o in zip(singles, obs)])
    return jb, carry_glacier(jb)


def _flushed_truth(glaciers, params, model):
    """The port's ground truth with subnormal results flushed to zero, as
    XLA:CPU computes them: the ice-free cells hold 0 where the port would
    leave ~1e-320, which the loss's H > 0 mask counts (ROADMAP, "Subnormal
    numbers")."""
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth
    from odinn_tpu_torch.simulation.solver import build_tstops

    assert torch.set_flush_denormal(True)
    try:
        return generate_ground_truth(glaciers, params, model, build_tstops(TSPAN, 1 / 12),
                                     store=("H",), device=CPU)
    finally:
        torch.set_flush_denormal(False)


def _law_models(kind, jp, tp):
    """(JAX model, port model) training A: one per glacier
    (LawA_inversion), or A = NN(T) (LawA)."""
    from odinn_tpu.laws.laws import LawA as JLawA, LawA_inversion as JLawA_inv
    from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
    from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
    from odinn_tpu_torch.laws.laws import LawA, LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture

    if kind == "NN(T)":
        return (JModel(iceflow=JSIA2DModel(A=JLawA(JNN(j_arch(1), seed=1), jp), n_value=3.0)),
                Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1)), tp),
                                         n_value=3.0)))
    return (JModel(iceflow=JSIA2DModel(A=JLawA_inv(jp), n_value=3.0)),
            Model(iceflow=SIA2DModel(A=LawA_inversion(tp), n_value=3.0)))


@pytest.mark.parametrize("kind", ["per-glacier A", "NN(T)"])
def test_replay_gradient_matches_jax_grad(kind):
    """The gradient through the replay by autograd is jax.grad through the
    JAX package's replay (lax.scan) of the same schedule, recorded at the
    initial θ: the thickness loss and each θ leaf at 1e-9."""
    import jax

    from odinn_tpu.models.model import init_theta as j_init_theta
    from odinn_tpu.simulation.inversion import batch_transient_loss as j_loss
    from odinn_tpu.simulation.prediction import resolve_replay as j_resolve
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.inversion import batch_transient_loss
    from odinn_tpu_torch.simulation.solver import build_tstops
    from tests.torch_parity import tree_to_port

    jts, ts = j_tstops(TSPAN, 1 / 12), build_tstops(TSPAN, 1 / 12)
    jp, tp = _params(JP), _params(TP)
    jb, tb = _truth()
    jmodel, tmodel = _law_models(kind, jp, tp)
    jtheta = j_init_theta(jmodel, jb)
    jpr = j_resolve(jp, jb, jmodel, jtheta, jts)
    j_val, j_grad = jax.value_and_grad(lambda th: j_loss(th, jb, jmodel, jpr, jts))(jtheta)
    theta = _requires_grad(tree_to_port(jtheta))
    val = batch_transient_loss(theta, tb, tmodel, _with_schedule(tp, jpr.solver.replay_dts), ts)
    val.backward()
    assert_rel(val.detach(), np.asarray(j_val), 1e-12, "loss")
    for path, jg in _leaves_with_paths(j_grad):
        assert_rel(_at(theta, path).grad, np.asarray(jg), 1e-9, f"gradient {path}")


def _single(temp, i, nx=32):
    from odinn_tpu.data.synthetic import halfar_glacier

    return halfar_glacier(nx=nx, ny=nx, dx=110.0, dy=110.0, r0=1200.0, h0=300.0, temp=temp,
                          rgi_id=f"rp{i}")


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_requires_grad(v) for v in tree)
    return tree.detach().clone().requires_grad_(True)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_train_ude_replay_matches_jax():
    """train_ude with adaptive="replay" (Adam 4 epochs, per-glacier A):
    the schedule recorded before training is JAX's, and the losses agree
    at the training parity tests' 1e-9."""
    from odinn_tpu.models.model import init_theta as j_init_theta
    from odinn_tpu.simulation.inversion import Inversion as JInversion, train_ude as j_train
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude
    from tests.torch_parity import tree_to_port

    hyper = dict(optimizer="adam", learning_rate=5e-2, epochs=4, batch_size=4)
    jp = _params(JP, reltol=1e-5, hyper=JP.Hyperparameters(**hyper))
    tp = _params(TP, reltol=1e-5, hyper=TP.Hyperparameters(**hyper))
    jb, tb = _truth()
    jmodel, tmodel = _law_models("per-glacier A", jp, tp)
    jinv = JInversion(model=jmodel, glaciers=jb, parameters=jp)
    jtheta = j_init_theta(jmodel, jb)
    jinv.theta = jtheta
    jres = j_train(jinv)
    inv = Inversion(model=tmodel, glaciers=tb, parameters=tp, device=CPU,
                    theta=tree_to_port(jtheta))
    res = train_ude(inv)
    np.testing.assert_allclose(inv.parameters.solver.replay_dts,
                               np.asarray(jinv.parameters.solver.replay_dts), rtol=0,
                               atol=1e-11)
    assert len(res.stats.losses) == 4 and res.stats.substeps_bumps == []
    assert_rel(np.asarray(res.stats.losses), np.asarray(jres.stats.losses), 1e-9, "losses")
    assert res.stats.final_loss < res.stats.losses[0]


# The losses recorded before the instability test's last failure, relative
# to their largest: the gap between the packages comes from the recorded
# schedule (at θ0 the port's loss on JAX's schedule is JAX's to 2.7e-14; on
# its own, 1.07e-9 off), and at reltol 1e-2 the BS3 controller turns the
# roundoff of its error estimate into steps that move by up to 9.5e-6. The
# JAX package's own losses there move by 1.55e-8 (H0 one ulp down), 2.26e-8
# (one ulp up) and 3.21e-8 (H0 (1 + 2^-50)) when it trains on its own
# schedule (tests/replay_loss_spread.py). The bound is 3.1x the largest
# self-spread.
REPLAY_LOSS_RTOL = 1e-7


def _instability_setting():
    """tests/test_replay.py's violent setting on a 24² grid: (JAX params,
    port params, the observed JAX glacier, JAX model, port model). The
    observations are the port's replay of the truth with subnormals
    flushed, as XLA:CPU flushes them (the JAX package's to ~1e-12)."""
    import jax.numpy as jnp

    from odinn_tpu.core.glacier import ThicknessData as JThicknessData
    from odinn_tpu.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import ConstantA
    from odinn_tpu_torch.models.model import Model, SIA2DModel

    def params(P):
        return _params(P, reltol=1e-2,
                       phys=P.PhysicalParameters(min_A=2e-19, max_A=4e-16),
                       hyper=P.Hyperparameters(optimizer=("adam", "adam"),
                                               learning_rate=(0.8, 0.1), epochs=(25, 5),
                                               batch_size=4))

    g = halfar_glacier(nx=24, ny=24, dx=150.0, temp=-15.0, A=8e-19)
    jp, tp = params(JP), params(TP)
    (t_obs,) = _flushed_truth([carry_glacier(g)], tp, Model(iceflow=SIA2DModel(A=ConstantA(2e-16))))
    td = t_obs.thickness_data
    g_obs = g.replace(thickness_data=JThicknessData(t=jnp.asarray(td.t.numpy()),
                                                    H=jnp.asarray(td.H.numpy())))
    jmodel, tmodel = _law_models("per-glacier A", jp, tp)
    return jp, tp, g_obs, jmodel, tmodel


def test_replay_instability_recovers_or_fails_loudly():
    """tests/test_replay.py's violent setting (reltol 1e-2, A must climb
    three decades in one Adam stage at learning rate 0.8), on a 24² grid of
    the same extent: the held schedule goes unstable, and each time both
    packages rewind to the best finite iterate and re-record the schedule
    there with every step split 1, 2 and 4 ways, at the same iterations;
    the fourth failure raises FloatingPointError. The last schedule tiles
    every interval, and the losses recorded before the last failure are
    JAX's within REPLAY_LOSS_RTOL, the JAX package's own spread under a
    one-ulp change of H0 with a factor 3.1: each package records its own
    schedule. The observations are the port's, handed to both packages.
    The JAX package trains in a second thread while the port trains: its
    time is mostly its compiles, one for each recorded schedule."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from odinn_tpu.simulation.inversion import Inversion as JInversion, train_ude as j_train
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude

    jp, tp, g_obs, jmodel, tmodel = _instability_setting()
    jinv = JInversion(model=jmodel, glaciers=[g_obs], parameters=jp)
    jinv.theta = {"A": jnp.asarray([-2.0])}
    seen = {}
    inv = Inversion(model=tmodel, glaciers=carry_glacier(stack_glaciers([g_obs])),
                    parameters=tp, device=CPU,
                    theta={"A": torch.tensor([-2.0], dtype=torch.float64)})
    # the JAX package trains in a second thread while the port trains
    with ThreadPoolExecutor(max_workers=1) as pool:
        j_run = pool.submit(j_train, jinv, callback=lambda stats: seen.setdefault("jax", stats))
        with pytest.raises(FloatingPointError, match="non-finite"):
            train_ude(inv, callback=lambda stats: seen.setdefault("port", stats))
        with pytest.raises(FloatingPointError, match="non-finite"):
            j_run.result()
    bumps = seen["port"].substeps_bumps
    assert [b[1:] for b in bumps] == [("replay", "re-recorded x1"), ("replay", "re-recorded x2"),
                                     ("replay", "re-recorded x4")]
    assert bumps == seen["jax"].substeps_bumps
    assert seen["port"].retcode == "NumericalFailure"
    dts = inv.parameters.solver.replay_dts
    assert dts.shape[-1] % 4 == 0
    spans = np.diff(np.asarray(j_tstops(TSPAN, 1.0 / 12.0)))
    np.testing.assert_allclose(dts.sum(axis=-1), np.broadcast_to(spans, dts.shape[:2]),
                               rtol=1e-8)
    # the same accepted counts, so the same record's shape; at reltol 1e-2
    # the steps sit at BS3's stability limit, where the controller's step
    # sequence rings and amplifies roundoff (at θ0 the packages' steps
    # differ by up to 3.2e-7, JAX's own move by up to 9.5e-6 under a
    # one-ulp change of H0), so the steps are not compared, and the losses
    # on them are held to the JAX package's own spread
    assert np.asarray(jinv.parameters.solver.replay_dts).shape == dts.shape
    assert_rel(np.asarray(seen["port"].losses[:-1]), np.asarray(seen["jax"].losses[:-1]),
               REPLAY_LOSS_RTOL, "losses before the last failure")


def test_replay_refusals():
    """Replay trains by autograd only: the manual adjoints refuse it, as in
    the JAX package, by name or as adjoint objects."""
    from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint, DiscreteAdjoint
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude

    _, tmodel = _cp_models()
    tb = carry_glacier(_jax_batch(temps=TEMPS[:1], nx=24))
    for grad in ("discrete", "continuous", DiscreteAdjoint(), ContinuousAdjoint()):
        with pytest.raises(ValueError, match="replay"):
            train_ude(Inversion(model=tmodel, glaciers=tb, parameters=_params(TP, grad=grad),
                                device=CPU))


def test_run_prediction_resolves_per_call():
    """run_prediction records the schedule for its own call at pred.theta
    and these tstops (pred.resolved_parameters), leaving pred.parameters
    unresolved; generate_ground_truth runs through the adaptive forward."""
    from odinn_tpu_torch.simulation.prediction import (
        Prediction, generate_ground_truth, run_prediction)
    from odinn_tpu_torch.simulation.solver import build_tstops

    _, tmodel = _cp_models()
    tb = carry_glacier(_jax_batch())
    pred = Prediction(model=tmodel, glaciers=tb, parameters=_params(TP), device=CPU)
    H = run_prediction(pred)["H"]
    assert pred.parameters.solver.replay_dts is None
    assert pred.resolved_parameters.solver.replay_dts is not None
    p_ad = _params(TP).replace(solver=TP.SolverParameters(step=1.0 / 12.0, adaptive=True,
                                                          reltol=1e-6))
    H_ad = run_prediction(Prediction(model=tmodel, glaciers=tb, parameters=p_ad,
                                     device=CPU))["H"]
    assert_rel(H, H_ad, 1e-12, "replay vs adaptive")
    glaciers = [carry_glacier(_single(t, i)) for i, t in enumerate(TEMPS)]
    truth = generate_ground_truth(glaciers, p_ad, tmodel, build_tstops(TSPAN, 1 / 12),
                                  store=("H",), device=CPU)
    for i, g in enumerate(truth):
        assert torch.equal(g.thickness_data.H, H_ad[i])
