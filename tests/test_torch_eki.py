"""odinn_tpu_torch's ensemble Kalman inversion (``simulation/eki.py``)
against the JAX package's (``odinn_tpu.simulation.eki``), float64, on the
JAX test's problem (tests/test_eki.py): 2 Halfar glaciers on 24² planes,
SI at PCG-15, 3 intervals of two months; the adaptive forward on 2 × 20²,
RK4's BS3(2) at reltol 1e-4.

The port folds the J members into the kernels' glacier axis where the JAX
package vmaps them; on the same initial ensemble the two give the same
ensemble and misfit history (Θ to 1e-8 of its scale). Through the
adaptive forward the port's and the JAX package's step-size controllers
decide on roundoff-close error estimates, so the comparison there is
1e-6 relative (the tolerance of ``ROADMAP.md``'s replay schedule).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.models.model import init_theta as j_init_theta
from odinn_tpu.simulation import eki as jeki
from odinn_tpu.simulation.ensemble import init_restarts as j_init_restarts
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.laws.laws import LawA as TLawA
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN
from odinn_tpu_torch.models.nn import default_architecture as t_arch
from odinn_tpu_torch.simulation import eki as teki
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.simulation.ensemble import init_restarts as t_init_restarts
from odinn_tpu_torch.utils.flatten import stack_to_rows
from tests.torch_parity import CPU, assert_rel, carry_glacier, tree_to_port

TSPAN = (5.0, 5.5)


def _params(P, **solver_kw):
    """tests/test_eki.py's setting."""
    solver = dict(step=1.0 / 6.0, substeps=1, solver="SI", cg_iters=15)
    solver.update(solver_kw)
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, test_mode=True),
        solver=P.SolverParameters(**solver),
        hyper=P.Hyperparameters(optimizer=("adam",), learning_rate=(0.05,), epochs=(1,),
                                batch_size=8),
        UDE=P.UDEParameters(grad="jax", target="A"))


def _truth(jp, nx, temps, prefix):
    gl = [j_halfar(nx=nx, ny=nx, dx=150.0, temp=t, rgi_id=f"{prefix}-{i}")
          for i, t in enumerate(temps)]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                        j_tstops(TSPAN, jp.solver.step), store=("H",))
    jb = j_stack(gl)
    return jb, carry_glacier(jb)


@pytest.fixture(scope="module")
def truth():
    """(JAX batch, port batch) of the JAX test's two glaciers, whose true
    A lie inside the tanh bounds."""
    return _truth(_params(JP), 24, (-18.0, -14.0), "eki")


def _inversions(jb, tb, jp, tp):
    jmodel = JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True)))
    tmodel = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)))
    return (JInversion(model=jmodel, glaciers=jb, parameters=jp),
            tinv.Inversion(model=tmodel, glaciers=tb, parameters=tp, device=CPU))


def _rows_jax(stack):
    return np.asarray(jax.vmap(lambda th: jax.flatten_util.ravel_pytree(th)[0])(stack))


def _held_to_jax(jinv, inv, J, n_iters, seed, rtol):
    """Both EKIs from the JAX package's initial ensemble: the final Θ
    (relative to its scale), the misfit history, the winner and the
    write-back."""
    jthetas = j_init_restarts(j_init_theta(jinv.model, jinv.glaciers), J, 0.5, seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = jeki.eki_train(jinv, thetas=jthetas, n_iters=n_iters, seed=seed)
        res = teki.eki_train(inv, thetas=tree_to_port(jthetas), n_iters=n_iters, seed=seed)
    assert res.misfits.shape == jres.misfits.shape == (n_iters + 1, J)
    assert_rel(stack_to_rows(res.thetas), _rows_jax(jres.thetas), rtol, "Θ")
    assert_rel(res.misfits, jres.misfits, rtol, "misfits")
    assert res.best_idx == jres.best_idx and res.n_iters == jres.n_iters
    assert_rel(res.mean_loss, jres.mean_loss, rtol, "mean member's misfit")
    assert torch.equal(inv.theta["A"], res.best_theta["A"])
    return res


def test_eki_matches_jax(truth):
    """6 members, 4 iterations, perturb_obs off. 1e-8."""
    jb, tb = truth
    jinv, inv = _inversions(jb, tb, _params(JP), _params(TP))
    res = _held_to_jax(jinv, inv, 6, 4, 0, 1e-8)
    assert np.nanmin(res.misfits[-1]) < 1e-2 * np.nanmin(res.misfits[0])


def test_eki_through_adaptive_forward_matches_jax():
    """params.solver.adaptive=True (BS3(2), reltol 1e-4) on 2 × 20², ground
    truth under the same adaptive forward: 6 members, 2 iterations, one
    controller per member and glacier in the folded batch. 1e-6."""
    kw = dict(substeps=15, solver="RK4", adaptive=True, reltol=1e-4)
    jp, tp = _params(JP, **kw), _params(TP, **kw)
    jb, tb = _truth(jp, 20, (-18.0, -14.0), "eki-a")
    jinv, inv = _inversions(jb, tb, jp, tp)
    res = _held_to_jax(jinv, inv, 6, 2, 1, 1e-6)
    assert np.isfinite(res.misfits).all()


def test_eki_subspace_property(truth):
    """The final ensemble lies in the affine span of the initial one (the
    JAX test's pin, on an NN law with d ≫ J)."""
    _, tb = truth
    tp = _params(TP)
    model = TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp)))
    inv = tinv.Inversion(model=model, glaciers=tb, parameters=tp, device=CPU)
    J = 4
    thetas0 = t_init_restarts(inv.theta, J, init_scale=0.3, seed=7)
    Th0 = stack_to_rows(thetas0).numpy()
    assert Th0.shape[1] > J
    with pytest.warns(UserWarning, match="does not exceed the parameter dimension"):
        res = teki.eki_train(inv, thetas=thetas0, n_iters=3, seed=7)
    ThF = stack_to_rows(res.thetas).numpy()
    mean0 = Th0.mean(axis=0)
    A0 = (Th0 - mean0).T
    for j in range(J):
        target = ThF[j] - mean0
        coef, *_ = np.linalg.lstsq(A0, target, rcond=None)
        resid = np.linalg.norm(A0 @ coef - target)
        assert resid / max(np.linalg.norm(target), 1e-12) < 1e-10, j


def test_eki_select_mean_and_tol(truth):
    """``tol`` stops early; ``select="mean"`` writes the mean back."""
    _, tb = truth
    _, inv = _inversions(truth[0], tb, _params(JP), _params(TP))
    res = teki.eki_train(inv, n_ensemble=6, n_iters=30, seed=2, select="mean", tol=1e-3)
    assert res.n_iters < 30
    assert torch.equal(inv.theta["A"], res.mean_theta["A"])
    assert np.isfinite(res.mean_loss)


def test_eki_validation(truth):
    _, tb = truth
    _, inv = _inversions(truth[0], tb, _params(JP), _params(TP))
    with pytest.raises(ValueError, match="n_ensemble >= 2"):
        teki.eki_train(inv, n_ensemble=1)
    with pytest.raises(ValueError, match="select"):
        teki.eki_train(inv, n_ensemble=2, select="median")


def test_sanitize_rows_matches_jax():
    """A non-finite member row becomes the fill row, others stay; as the
    JAX package's."""
    R = [[1.0, 2.0], [np.nan, 0.0], [3.0, 4.0]]
    fill = [2.0, 3.0]
    out, ok = teki._sanitize_rows(torch.tensor(R), torch.tensor(fill))
    jout, jok = jeki._sanitize_rows(jax.numpy.asarray(R), jax.numpy.asarray(fill))
    assert ok.tolist() == [True, False, True] == np.asarray(jok).tolist()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_perturb_obs_repeatable(truth):
    """Observation perturbations (a generator seeded seed + 1) repeat for a
    seed and differ for another, and differ from the deterministic run."""
    _, tb = truth
    runs = {}
    for key, seed, perturb in (("a", 3, True), ("b", 3, True), ("c", 4, True),
                               ("d", 3, False)):
        _, inv = _inversions(truth[0], tb, _params(JP), _params(TP))
        thetas = t_init_restarts(inv.theta, 4, 0.5, seed=3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[key] = teki.eki_train(inv, thetas=thetas, n_iters=2, seed=seed,
                                       perturb_obs=perturb).misfits
    np.testing.assert_array_equal(runs["a"], runs["b"])
    assert not np.array_equal(runs["a"], runs["c"])
    assert not np.array_equal(runs["a"], runs["d"])
