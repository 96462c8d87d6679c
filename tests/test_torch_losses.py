"""odinn_tpu_torch's losses, observation lookup, NN scaling helpers and
trainer helpers against odinn_tpu, float64 on the CPU (1e-12 relative
unless stated): one glacier and a stacked batch, whose per-glacier losses
equal the JAX package's vmapped ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.glacier as jglacier
import odinn_tpu.losses.losses as jl
import odinn_tpu.models.nn as jnn
import odinn_tpu.simulation.inversion as jinv
import odinn_tpu.simulation.observations as jobs
import odinn_tpu_torch.core.glacier as tglacier
import odinn_tpu_torch.losses.losses as tl
import odinn_tpu_torch.models.nn as tnn
import odinn_tpu_torch.simulation.inversion as tinv
import odinn_tpu_torch.simulation.observations as tobs
from tests.torch_parity import assert_rel

RTOL = 1e-12


def _fields(n_g=3, nx=20, ny=22, seed=0):
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - nx / 2)[:, None] ** 2 + (np.arange(ny) - ny / 2)[None, :] ** 2
    H_ref = np.stack([np.clip(60.0 - x / r, 0.0, None) for r in (1.0, 1.5, 2.0)[:n_g]])
    H = H_ref + 3.0 * rng.standard_normal(H_ref.shape) * (H_ref > 0)
    V = [rng.standard_normal(H.shape) * 10.0 for _ in range(3)]
    return H, H_ref, V


@pytest.mark.parametrize("distance", [0, 1, 3])
def test_is_in_glacier_matches(distance):
    _, H_ref, _ = _fields()
    ref = jglacier.is_in_glacier(jnp.asarray(H_ref), distance)
    out = tglacier.is_in_glacier(torch.from_numpy(H_ref), distance)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.any() and not out.all()


def _ctx(mod, t, H_ref, V, normalization):
    vx_ref, vy_ref = t(V[0]), t(V[1])
    v_ref = (vx_ref ** 2 + vy_ref ** 2) ** 0.5

    def velocity_fn(H, time):
        return 0.01 * H + vx_ref, 0.02 * H + vy_ref, 0.01 * H + v_ref

    return mod.LossContext(H_ref=t(H_ref), V_ref=v_ref, Vx_ref=vx_ref, Vy_ref=vy_ref,
                           velocity_fn=velocity_fn, normalization=normalization)


_LOSSES = {
    "H L2": lambda m: m.LossH(),
    "H log": lambda m: m.LossH(m.LogSum(distance=2, eps=0.2)),
    "V xy": lambda m: m.LossV(),
    "V abs unscaled": lambda m: m.LossV(component="abs", scale_loss=False),
    "HV": lambda m: m.LossHV(scaling=0.3),
    "multi": lambda m: m.MultiLoss(terms=(m.LossH(), m.LossV(m.LogSum())), weights=(1.0, 0.5)),
}


@pytest.mark.parametrize("name", list(_LOSSES))
def test_losses_match(name):
    """Per glacier (each glacier alone in JAX) and batched in the port."""
    H, H_ref, V = _fields()
    norm = np.array([440.0, 300.0, 123.0])
    ref = [float(_LOSSES[name](jl)(_ctx(jl, jnp.asarray, H_ref[k], [v[k] for v in V], norm[k]),
                                   jnp.asarray(H[k]), 0.0)) for k in range(3)]
    t = torch.from_numpy
    batched = _LOSSES[name](tl)(_ctx(tl, t, H_ref, V, t(norm)), t(H), 0.0)
    assert_rel(batched, np.asarray(ref), RTOL)
    one = _LOSSES[name](tl)(_ctx(tl, t, H_ref[1], [v[1] for v in V], float(norm[1])), t(H[1]), 0.0)
    assert_rel(one, ref[1], RTOL)
    assert tl.loss_uses_velocity(_LOSSES[name](tl)) == jl.loss_uses_velocity(_LOSSES[name](jl))


@pytest.mark.parametrize("name", ["H L2", "H log", "V xy", "HV"])
def test_residuals_square_to_the_loss(name):
    H, H_ref, V = _fields()
    t = torch.from_numpy
    norm = t(np.array([440.0, 300.0, 123.0]))
    loss = _LOSSES[name](tl)
    ctx = _ctx(tl, t, H_ref, V, norm)
    total = sum(torch.sum(r ** 2, dim=(-2, -1)) for r in loss.residuals(ctx, t(H), 0.0))
    assert_rel(total, loss(ctx, t(H), 0.0), RTOL)


def test_term_kind_and_missing_references():
    class Reg:
        kind = "initial"

    assert tl.term_kind(tl.LossH()) == jl.term_kind(jl.LossH()) == "transient"
    assert tl.term_kind(Reg()) == "initial"
    H = torch.ones((4, 5), dtype=torch.float64)
    assert float(tl.LossH()(tl.LossContext(), H, 0.0)) == 0.0
    assert float(tl.LossV()(tl.LossContext(), H, 0.0)) == 0.0
    assert tl.LossH().residuals(tl.LossContext(), H, 0.0) == ()


def test_observation_lookup_matches():
    """Nearest-time match and its float32-ulp gate, per glacier of a batch."""
    rng = np.random.default_rng(2)
    t_obs = np.array([[2010.0, 2010.25, 2010.5], [2010.0, 2010.2500001, 2011.0]])
    Hs = rng.random((2, 3, 4, 5))
    for t in (2010.0, 2010.25, 2010.5, 2010.3):
        for g in range(2):
            k, valid = jobs.match_time(jnp.asarray(t_obs[g]), t, jnp.float64)
            tk, tvalid = tobs.match_time(torch.from_numpy(t_obs[g]), t, torch.float64)
            assert int(tk) == int(k) and float(tvalid) == float(valid)
            jH, jv = jobs.thickness_at(jglacier.ThicknessData(t=jnp.asarray(t_obs[g]),
                                                               H=jnp.asarray(Hs[g])), t,
                                       jnp.float64)
            bH, bv = tobs.thickness_at(tglacier.ThicknessData(t=torch.from_numpy(t_obs),
                                                               H=torch.from_numpy(Hs)), t,
                                       torch.float64)
            np.testing.assert_array_equal(bH[g].numpy(), np.asarray(jH))
            assert float(bv[g]) == float(jv)
    assert tobs.thickness_at(None, 2010.0, torch.float64) == (None, 1.0)
    assert tobs.velocity_at(None, 2010.0, torch.float64) == (None, None, None, 1.0)


@pytest.mark.parametrize("fn", ["normalize", "scale", "prescale", "postscale", "fourier"])
def test_nn_helpers_match(fn):
    x = np.random.default_rng(3).random((5, 2)) * 4.0 - 1.0
    j, t = jnp.asarray(x), torch.from_numpy(x)
    calls = {
        "normalize": lambda m, a: m.normalize(a, (-1.0, 3.0)),
        "scale": lambda m, a: m.scale(a, (8e-21, 8e-18)),
        "prescale": lambda m, a: m.prescale(a, ((-1.0, 3.0), (0.0, 2.0))),
        "postscale": lambda m, a: m.postscale(a, 8e-18),
        "fourier": lambda m, a: m.fourier_feature(a, n_freq=3, scale_ff=0.5),
    }
    assert_rel(calls[fn](tnn, t), calls[fn](jnn, j), RTOL)


def test_trainer_helpers_match():
    class Hyper:
        optimizer = ("adam", "lbfgs")
        learning_rate = 0.1
        epochs = (4, 2)

    assert tinv._stages(Hyper) == jinv._stages(Hyper)
    for cfg, n in [("auto", 16), ("auto", 128), ("auto", 192), (2, 16), (None, 8)]:
        assert tinv.resolve_accum_chunks(cfg, n) == jinv.resolve_accum_chunks(cfg, n)
