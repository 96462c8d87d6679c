"""odinn_tpu_torch's API facade (``api.py``, the package ``__init__``) and the
public names it re-exports that the port lacked, against the JAX package
(tests/test_api.py): every name of ``test_api_surface_importable``
resolves, the constructors and ``run`` dispatch as there, and each ported
function equals its JAX namesake on seeded numpy inputs (1e-12).
"""

import ast
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, assert_rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_api_names():
    """The names ``tests/test_api.py::test_api_surface_importable`` checks."""
    with open(os.path.join(REPO, "tests", "test_api.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "test_api_surface_importable")
    loop = next(n for n in ast.walk(fn) if isinstance(n, ast.For))
    return [elt.value for elt in loop.iter.elts]


def test_api_surface_importable():
    from odinn_tpu_torch import api

    names = _jax_api_names()
    assert len(names) >= 90
    missing = [n for n in names if not hasattr(api, n)]
    assert not missing, missing
    assert api.SciMLSensitivityAdjoint is api.JaxAdjoint
    assert api.train_UDE is api.train_ude and api.Glacier2D is api.Glacier


def test_package_facade():
    import odinn_tpu
    import odinn_tpu_torch

    assert odinn_tpu_torch.__version__ == odinn_tpu.__version__
    for name in ("Parameters", "UDEParameters", "Climate2D", "Glacier", "stack_glaciers",
                 "is_in_glacier", "ThicknessData"):
        assert getattr(odinn_tpu_torch, name) is not None, name


def test_inv_component_constructors():
    """GlacierWideInv/GriddedInv build the same laws as LawA_inversion."""
    from odinn_tpu_torch import api

    params = api.Parameters()
    law = api.GlacierWideInv(params)
    assert law.slot == "A" and law.name == "InvA"
    gridded = api.GriddedInv(params, grid_shape=(8, 8))
    assert gridded.slot == "A" and gridded.name == "InvA_grid"


def test_run_dispatch():
    """``run`` sends a Prediction to ``run_prediction`` and an Inversion to
    ``run_inversion``; anything else raises."""
    from odinn_tpu_torch import api

    params = api.Parameters(
        simulation=api.SimulationParameters(tspan=(5.0, 5.25), use_MB=False,
                                            use_velocities=False),
        solver=api.SolverParameters(step=1 / 12, substeps=5),
        hyper=api.Hyperparameters(optimizer="adam", learning_rate=1e-2, epochs=1))
    g = api.halfar_glacier(nx=24, ny=24, dx=150.0, temp=-15.0, device=CPU)
    model = api.Model(iceflow=api.SIA2Dmodel(params, A=api.ConstantA(5e-18)))
    results = api.run(api.Prediction(model=model, glaciers=[g], parameters=params, device=CPU))
    assert results["H"].shape[0] == 1
    si = params.replace(solver=api.SolverParameters(step=1 / 12, solver="SI", substeps=1,
                                                    cg_iters=10))
    truth = api.generate_ground_truth([g], si, model, api.build_tstops((5.0, 5.25), 1 / 12),
                                      store=("H",), device=CPU)
    inv = api.Inversion(model=api.Model(iceflow=api.SIA2Dmodel(
        si, A=api.GlacierWideInv(si))), glaciers=truth, parameters=si, device=CPU)
    res = api.run(inv)
    assert isinstance(res, api.Results) and np.isfinite(res.stats.final_loss)
    with pytest.raises(TypeError):
        api.run(object())


def test_enable_multiprocessing_without_a_job():
    """In a process of its own there is no mesh: ``enable_multiprocessing``
    registers None, warns when more workers are asked for, and raises the
    JAX package's ``ValueError`` for ``rows > 1`` outside a job of that
    many ranks; ``make_mesh_2d`` is exported."""
    from odinn_tpu_torch import api
    from odinn_tpu_torch.parallel.mesh import active_mesh

    try:
        assert api.enable_multiprocessing() is None
        assert api.enable_multiprocessing(api.Parameters()) is None
        with pytest.warns(UserWarning, match="requested 4 workers"):
            assert api.enable_multiprocessing(workers=4) is None
        assert active_mesh() is None
        with pytest.raises(ValueError, match="needs 2 devices"):
            api.make_mesh(2)
    finally:
        api.set_active_mesh(None)
    with pytest.raises(ValueError, match="rows=2 exceeds the 1 visible devices"):
        api.enable_multiprocessing(rows=2)
    assert active_mesh() is None
    assert api.make_mesh_2d is __import__(
        "odinn_tpu_torch.parallel.spatial", fromlist=["make_mesh_2d"]).make_mesh_2d


@pytest.mark.parametrize("kind", ["L2Sum", "LogSum"])
def test_backward_simple_loss_matches_jax(kind):
    import odinn_tpu.losses.losses as J
    import odinn_tpu_torch.losses.losses as T
    from odinn_tpu_torch.api import backward_loss

    assert backward_loss is T.backward_simple_loss
    rng = np.random.default_rng(3)
    a = rng.normal(50.0, 40.0, (2, 9, 11))
    b = rng.normal(50.0, 40.0, (2, 9, 11))
    mask = rng.random((2, 9, 11)) > 0.3
    norm = 37.5
    ref = np.asarray(J.backward_simple_loss(getattr(J, kind)(), jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(mask), norm))
    out = T.backward_simple_loss(getattr(T, kind)(), torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(mask), norm)
    assert_rel(out, ref, 1e-12, kind)
    per_glacier = T.backward_simple_loss(getattr(T, kind)(), torch.from_numpy(a),
                                         torch.from_numpy(b), torch.from_numpy(mask),
                                         torch.tensor([norm, 2 * norm], dtype=torch.float64))
    assert_rel(per_glacier[1], ref[1] / 2, 1e-12, "per-glacier normalization")
    # it is the derivative of the loss
    at = torch.from_numpy(a).requires_grad_(True)
    (g,) = torch.autograd.grad(T.simple_loss(getattr(T, kind)(), at, torch.from_numpy(b),
                                             torch.from_numpy(mask), norm).sum(), at)
    assert_rel(out, g, 1e-12, "autograd")


def test_predict_A_bar_matches_jax():
    import odinn_tpu.models.nn as J
    import odinn_tpu_torch.models.nn as T
    from odinn_tpu_torch.convert import mlp_from_numpy

    arch = J.default_architecture(1)
    jparams = J.NeuralNetwork(arch, seed=5).init()
    tparams = mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
                             T.default_architecture(1), device=CPU)
    lims = (8e-21, 8e-18)
    temps = np.random.default_rng(4).uniform(-30.0, 0.0, 12)
    ref = np.asarray(J.predict_A_bar(arch, jparams, jnp.asarray(temps), lims))
    assert_rel(T.predict_A_bar(T.default_architecture(1), tparams, torch.from_numpy(temps), lims),
               ref, 1e-12, "A(T)")
    assert_rel(T.predict_A_bar(T.default_architecture(1), tparams, -12.5, lims),
               np.asarray(J.predict_A_bar(arch, jparams, -12.5, lims)), 1e-12, "scalar T")


def _climates(n_g=2, months=14):
    """A monthly climate per glacier, in both packages, from seeded numpy."""
    from odinn_tpu.core.glacier import Climate2D as JClimate
    from odinn_tpu_torch.core.glacier import Climate2D as TClimate

    rng = np.random.default_rng(7)
    fields = [dict(t_start=np.float64(2010.0 + 0.25 * i), temp=rng.normal(-3.0, 6.0, months),
                   gradient=rng.normal(-0.0065, 0.001, months), snow=rng.uniform(0, 0.1, months),
                   ref_hgt=np.float64(rng.uniform(1500.0, 2500.0))) for i in range(n_g)]
    jc = [JClimate(**{k: jnp.asarray(v) for k, v in f.items()}) for f in fields]
    tc = [TClimate(**{k: torch.as_tensor(v) for k, v in f.items()}) for f in fields]
    stacked = TClimate(**{k: torch.stack([torch.as_tensor(f[k]) for f in fields])
                          for k in fields[0]})
    return jc, tc, stacked


def test_downscale_2d_climate_matches_jax():
    from odinn_tpu.physics.mass_balance import downscale_2d_climate as j_downscale
    from odinn_tpu_torch.physics.mass_balance import downscale_2d_climate

    jc, tc, stacked = _climates()
    S = np.random.default_rng(8).uniform(1200.0, 3000.0, (2, 9, 11))
    refs = [np.asarray(j_downscale(c, jnp.asarray(S[i]))) for i, c in enumerate(jc)]
    for i, c in enumerate(tc):
        out = downscale_2d_climate(c, torch.from_numpy(S[i]))
        assert out.shape == (14, 9, 11)
        assert_rel(out, refs[i], 1e-12, f"glacier {i}")
    assert_rel(downscale_2d_climate(stacked, torch.from_numpy(S)), np.stack(refs), 1e-12,
               "stacked batch")


def test_month_index_matches_jax():
    jc, tc, stacked = _climates()
    ts = np.array([2009.0, 2010.0, 2010.04, 2010.0833333333333, 2010.5, 2011.0, 2011.2, 2013.0])
    for j, t in zip(jc, tc):
        ref = np.array([int(j.month_index(jnp.asarray(x))) for x in ts])
        out = np.array([int(t.month_index(float(x))) for x in ts])
        np.testing.assert_array_equal(out, ref)
    assert stacked.month_index(2010.5).tolist() == [int(c.month_index(2010.5)) for c in tc]


def test_validate_model_simulation_compatibility_matches_jax():
    import odinn_tpu.core.params as JP
    import odinn_tpu_torch.core.params as TP
    from odinn_tpu.models.model import Model as JModel
    from odinn_tpu.models.model import SIA2DModel as JSIA
    from odinn_tpu.physics.mass_balance import TImodel1 as JTI
    from odinn_tpu.physics.mass_balance import \
        validate_model_simulation_compatibility as j_validate
    from odinn_tpu_torch.models.model import Model as TModel
    from odinn_tpu_torch.models.model import SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1 as TTI
    from odinn_tpu_torch.physics.mass_balance import validate_model_simulation_compatibility

    for use_mb in (True, False):
        for with_mb in (True, False):
            jm = JModel(iceflow=JSIA(), mass_balance=JTI() if with_mb else None)
            tm = TModel(iceflow=SIA2DModel(), mass_balance=TTI() if with_mb else None)
            jp = JP.Parameters(simulation=JP.SimulationParameters(use_MB=use_mb))
            tp = TP.Parameters(simulation=TP.SimulationParameters(use_MB=use_mb))
            outcome = []
            for fn, m, p in ((j_validate, jm, jp), (validate_model_simulation_compatibility, tm,
                                                     tp)):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    try:
                        fn(m, p)
                        raised = None
                    except ValueError as e:
                        raised = str(e)
                outcome.append((raised, [str(w.message) for w in caught]))
            assert outcome[0] == outcome[1], (use_mb, with_mb, outcome)


def test_law_slots_provided_match_jax():
    import odinn_tpu.core.params as JP
    import odinn_tpu_torch.core.params as TP
    from odinn_tpu.laws.laws import LawU as JLawU
    from odinn_tpu.laws.laws import LawY as JLawY
    from odinn_tpu.models.model import SIA2DModel as JSIA
    from odinn_tpu.models.nn import NeuralNetwork as JNN
    from odinn_tpu.models.nn import default_architecture as j_arch
    from odinn_tpu_torch.laws.laws import LawU, LawY
    from odinn_tpu_torch.models.model import SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture

    jp, tp = JP.Parameters(), TP.Parameters()
    cases = [
        (JSIA(), SIA2DModel()),
        (JSIA(Y=JLawY(JNN(j_arch(2)), jp, max_nn=8e-18)),
         SIA2DModel(Y=LawY(NeuralNetwork(default_architecture(2)), tp, max_nn=8e-18))),
        (JSIA(U=JLawU(JNN(j_arch(2)), jp)), SIA2DModel(U=LawU(NeuralNetwork(
            default_architecture(2)), tp))),
    ]
    for jm, tm in cases:
        assert (tm.Y_is_provided, tm.U_is_provided) == (jm.Y_is_provided, jm.U_is_provided)
    assert [c[1].Y_is_provided for c in cases] == [False, True, False]
    assert [c[1].U_is_provided for c in cases] == [False, False, True]
