"""odinn_tpu_torch's legacy region-split inversion against the JAX package's
(``odinn_tpu.simulation.region_inversion``): the region map, the loss at
fixed region values (the sigmoid-bounded midpoints, the first iterate of
both packages), the convergence gates of ``tests/test_api.py``'s test on
the port's own L-BFGS run, and the refusal without thickness observations.
Float64, one glacier.
"""

import numpy as np
import pytest

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.laws.laws import ConstantA as JConstantA
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.simulation import region_inversion as jreg
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.data.synthetic import halfar_glacier as t_halfar
from odinn_tpu_torch.simulation import region_inversion as treg
from odinn_tpu_torch.simulation.solver import build_tstops as t_tstops
from tests.torch_parity import CPU, carry_glacier

A_TRUE = 5e-18
TSPAN = (5.0, 5.5)


def _params(P):
    """tests/test_api.py::test_region_split_inversion's parameters."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, use_velocities=False),
        solver=P.SolverParameters(step=1 / 12, substeps=10),
        inversion=P.InversionParameters(lower_bound=(1e-19,), upper_bound=(8e-18,),
                                        regions_split=(2, 2), x_tol=1e-10, f_tol=1e-14))


def test_region_split_inversion():
    """The port of tests/test_api.py::test_region_split_inversion: a
    uniform A on a 32² Halfar glacier, 2 × 2 regions, 6 monthly intervals.
    The region map is the JAX package's; the first iterate's loss (all
    regions at the bounds' midpoint) equals the JAX package's to 1e-12; and
    the port's own L-BFGS run (torch.optim.LBFGS, not optax's) meets the
    JAX test's gates: the loss falls below 5 % of its start, and a central
    region's A comes within 20 % of the truth."""
    jp = _params(JP)
    g = j_halfar(nx=32, ny=32, dx=130.0, temp=-15.0, A=A_TRUE)
    ts = j_tstops(TSPAN, 1 / 12)
    (g,) = j_ground_truth([g], jp, JModel(iceflow=JSIA2DModel(A=JConstantA(A_TRUE))), ts,
                          store=("H",))
    rmap = treg.region_map(32, 32, (2, 2))
    assert rmap.shape == (31, 31) and rmap.max() == 3
    np.testing.assert_array_equal(rmap, np.asarray(jreg.region_map(32, 32, (2, 2))))
    want = jreg.region_split_inversion(g, jp, tstops=ts, max_iters=1)

    tp, tg = _params(TP), carry_glacier(g)
    tts = t_tstops(TSPAN, 1 / 12)
    first = treg.region_split_inversion(tg, tp, tstops=tts, max_iters=1)
    np.testing.assert_allclose(first["losses"][0], want["losses"][0], rtol=1e-12)
    np.testing.assert_allclose(first["A_field"].shape, np.shape(want["A_field"]))

    out = treg.region_split_inversion(tg, tp, tstops=tts, max_iters=30)
    assert out["losses"][0] == first["losses"][0]
    assert out["losses"][-1] < 0.05 * out["losses"][0]
    rel = np.abs(out["A_regions"] - A_TRUE) / A_TRUE
    assert rel.min() < 0.2, f"A_regions {out['A_regions']}"
    assert out["retcode"] in ("MaxIters", "FTolReached", "XTolReached")


def test_region_split_inversion_requires_thickness_obs():
    """A glacier without thickness observations raises the ValueError with
    the remedy (the port of tests/test_api.py's test)."""
    g = t_halfar(nx=24, ny=24, dx=130.0, temp=-15.0, device=CPU)
    assert g.thickness_data is None
    with pytest.raises(ValueError, match="thickness observations"):
        treg.region_split_inversion(g, TP.Parameters(), max_iters=1)
