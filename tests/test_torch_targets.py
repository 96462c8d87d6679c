"""odinn_tpu_torch's diffusivity targets and D-target laws against
odinn_tpu's: ``DHybridTarget`` (with and without the decoupled exponents
n_H, n_∇S), ``DPureTarget``, ``CappedTarget`` and ``cap_D`` (diffusivity and
surface-velocity prefactor on random staggered fields), ``LawY`` and
``LawU`` (one glacier and a stacked batch, θ carried across by
``convert.theta_from_numpy``), the inner inputs through ``eval_law``, and
target inference. Float64 on the CPU, inputs from numpy seeds; tolerance
1e-12 relative to the largest value compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.laws.laws as JL
import odinn_tpu.models.model as JM
import odinn_tpu.physics.sia2d as JS
import odinn_tpu.physics.targets as JT
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.laws.laws as TL
import odinn_tpu_torch.models.model as TM
import odinn_tpu_torch.physics.sia2d as TS
import odinn_tpu_torch.physics.targets as TT
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.models.nn import NeuralNetwork as JNN, default_architecture as j_arch
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN, default_architecture as t_arch
from tests.torch_parity import assert_rel, carry_glacier, tree_to_port

RTOL = 1e-12
PHYS_J, PHYS_T = JP.PhysicalParameters(), TP.PhysicalParameters()
SHAPE = (23, 27)


def _fields(seed):
    rng = np.random.default_rng(seed)
    hbar = np.abs(rng.normal(size=SHAPE)) * 120.0
    hbar[:3, :4] = 0.0                       # ice-free cells: zero bases
    grad_s = np.abs(rng.normal(size=SHAPE)) * 0.1
    grad_s[5, :3] = 0.0
    return hbar, grad_s, rng


def _values(mod, static_n, rng, tensor, decoupled=False):
    n = 3.0 if static_n else 3.2
    kw = dict(A=2e-17, C=3e-19, n=n, p=n, q=0.0,
              Y=rng.uniform(1e-18, 8e-18, size=SHAPE), U=rng.uniform(0.0, 300.0, size=SHAPE))
    if decoupled:
        kw.update(n_H=2.5, n_gradS=3.5)
    if not static_n:                          # exponents as arrays: the traced-n path
        kw.update({k: np.asarray(kw[k]) for k in ("n", "p", "q")})
    return mod.SIAValues(**{k: tensor(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})


@pytest.mark.parametrize("static_n", [True, False])
@pytest.mark.parametrize("name", ["hybrid", "hybrid decoupled", "pure", "capped A",
                                  "capped hybrid"])
def test_target_algebra_matches(name, static_n):
    hbar, grad_s, rng = _fields(7)
    decoupled = name == "hybrid decoupled"
    vj = _values(JS, static_n, np.random.default_rng(8), jnp.asarray, decoupled)
    vt = _values(TS, static_n, np.random.default_rng(8), torch.from_numpy, decoupled)
    make = {"hybrid": lambda m: m.DHybridTarget(), "hybrid decoupled": lambda m: m.DHybridTarget(),
            "pure": lambda m: m.DPureTarget(),
            "capped A": lambda m: m.CappedTarget(m.ATarget(), 40.0),
            "capped hybrid": lambda m: m.CappedTarget(m.DHybridTarget(), 25.0)}[name]
    tj, tt = make(JT), make(TT)
    assert tt.name == tj.name
    hj, gj = jnp.asarray(hbar), jnp.asarray(grad_s)
    ht, gt = torch.from_numpy(hbar), torch.from_numpy(grad_s)
    for fn in ("diffusivity", "velocity_up"):
        out = getattr(tt, fn)(vt, ht, gt, PHYS_T)
        assert_rel(out, getattr(tj, fn)(vj, hj, gj, PHYS_J), RTOL, f"{name} {fn}")
        assert torch.isfinite(out).all()
    # neither D target, nor the cap, has closed-form partials
    assert not hasattr(tt, "d_diffusivity_dH")


def test_cap_d_and_get_target_match():
    d = np.random.default_rng(3).uniform(0.0, 300.0, size=SHAPE)
    assert_rel(TT.cap_D(torch.from_numpy(d), 50.0), JT.cap_D(jnp.asarray(d), 50.0), RTOL)
    for name in ("A", "D_hybrid", "D"):
        assert type(TT.get_target(name)).__name__ == type(JT.get_target(name)).__name__


def _law_pair(kind, seed):
    """(JAX law, port law, JAX θ, port θ) with tests/test_d_targets.py's
    settings and default_architecture(2)."""
    jp, tp = JP.Parameters(), TP.Parameters()
    if kind == "Y":
        kw = dict(max_nn=8e-18, prescale_bounds=((-25.0, 0.0), (0.0, 500.0)))
        jl, tl = JL.LawY(JNN(j_arch(2), seed=seed), jp, **kw), TL.LawY(TNN(t_arch(2)), tp, **kw)
    else:
        kw = dict(max_nn=2000.0, prescale_bounds=((0.0, 500.0), (0.0, 0.3)))
        jl, tl = JL.LawU(JNN(j_arch(2), seed=seed), jp, **kw), TL.LawU(TNN(t_arch(2)), tp, **kw)
    jtheta = {kind: JNN(j_arch(2), seed=seed).init()}
    return jl, tl, jtheta, tree_to_port(jtheta)


@pytest.mark.parametrize("kind", ["Y", "U"])
def test_d_target_laws_match(kind):
    jl, tl, jth, tth = _law_pair(kind, 5)
    assert (tl.slot, tl.callback_freq, tl.input_names) == (jl.slot, jl.callback_freq,
                                                          jl.input_names)
    assert tl.is_inner and tl.trainable
    rng = np.random.default_rng(11)
    hbar = rng.uniform(0.0, 450.0, size=(3,) + SHAPE)
    grad_s = rng.uniform(0.0, 0.3, size=(3,) + SHAPE)
    temps = np.array([-22.0, -15.0, -4.0])
    # a stacked batch in the port: one mean temperature per glacier
    out_t = tl.apply(tth, {"Hbar": torch.from_numpy(hbar), "gradS": torch.from_numpy(grad_s),
                           "T": torch.from_numpy(temps)})
    for g in range(3):
        out_j = jl.apply(jth, {"Hbar": jnp.asarray(hbar[g]), "gradS": jnp.asarray(grad_s[g]),
                               "T": jnp.asarray(temps[g])})
        assert_rel(out_t[g], out_j, RTOL, f"Law{kind} glacier {g}")
        out_1 = tl.apply(tth, {"Hbar": torch.from_numpy(hbar[g]),
                               "gradS": torch.from_numpy(grad_s[g]),
                               "T": torch.tensor(temps[g])})
        assert_rel(out_1, out_j, RTOL, f"Law{kind} single glacier {g}")
    # θ's init: the port's own draw, the JAX package's shapes
    init = tl.init_theta([carry_glacier(j_halfar(nx=8, ny=8))], torch.float64)
    assert [tuple(layer["w"].shape) for layer in init] == [tuple(layer["w"].shape)
                                                          for layer in jth[kind]]


@pytest.mark.parametrize("kind", ["Y", "U"])
def test_inner_inputs_through_eval_law_match(kind):
    """eval_law resolves H̄ and |∇S| (the inner inputs' own ``get``) from a
    state, as the JAX package's does."""
    jl, tl, jth, tth = _law_pair(kind, 9)
    jg = j_halfar(nx=24, ny=28, dx=140.0, dy=120.0, temp=-12.0)
    tg = carry_glacier(jg)
    state = np.asarray(jg.H0) * 1.1
    out_t = TL.eval_law(tl, tth, tg, state=torch.from_numpy(state), t=5.0)
    out_j = JL.eval_law(jl, jth, jg, state=jnp.asarray(state), t=5.0)
    assert_rel(out_t, out_j, RTOL, f"eval_law Law{kind}")


def test_target_inference_matches():
    jp, tp = JP.Parameters(), TP.Parameters()
    _, y_t, _, _ = _law_pair("Y", 1)
    _, u_t, _, _ = _law_pair("U", 1)
    cases = {
        "A": (TM.Model(iceflow=TM.SIA2DModel(A=TL.ConstantA(1e-17))), TT.ATarget),
        "Y": (TM.Model(iceflow=TM.SIA2DModel(Y=y_t)), TT.DHybridTarget),
        "U": (TM.Model(iceflow=TM.SIA2DModel(U=u_t)), TT.DPureTarget),
    }
    for name, (model, cls) in cases.items():
        assert type(model.target) is cls, name
    capped = TM.Model(iceflow=TM.SIA2DModel(Y=y_t, max_D=30.0))
    assert isinstance(capped.target, TT.CappedTarget)
    assert type(capped.target.inner) is TT.DHybridTarget and capped.target.max_D == 30.0
    assert capped.target.name == "D_hybrid"
    # the JAX package infers the same
    j_capped = JM.Model(iceflow=JM.SIA2DModel(Y=JL.LawY(JNN(j_arch(2)), jp), max_D=30.0))
    assert type(j_capped.target.inner).__name__ == "DHybridTarget"
    with pytest.raises(ValueError, match="mutually exclusive"):
        TM.Model(iceflow=TM.SIA2DModel(Y=y_t, U=u_t))
    with pytest.raises(ValueError, match="built for slot"):
        TM.Model(iceflow=TM.SIA2DModel(A=y_t))


def test_d_target_values_reach_the_generic_rhs():
    """A D-target model's resolver is inner (never the kernels' table), and
    its RHS equals the JAX package's on a stacked batch."""
    jl, tl, jth, tth = _law_pair("Y", 5)
    jgs = [j_halfar(nx=24, ny=24, dx=200.0, temp=t, rgi_id=f"y{i}")
           for i, t in enumerate((-20.0, -10.0))]
    jb = j_stack(jgs)
    tb = carry_glacier(jb)
    jm = JM.Model(iceflow=JM.SIA2DModel(Y=jl))
    tm = TM.Model(iceflow=TM.SIA2DModel(Y=tl))
    outer = TM.resolve_outer_values(tm, tth, tb, 5.0)
    vfn = TM.make_values_fn(tm, tth, tb, 5.0, outer)
    assert vfn.constant is None
    dx, dy = (tb.dx.reshape(-1, 1, 1), tb.dy.reshape(-1, 1, 1))
    assert TS.scalar_law_table(vfn, tm.target, dx, dy, tb.H0) is None
    rhs_t = TS.sia2d_rhs(tb.H0, tb.B, dx, dy, vfn, tm.target, PHYS_T)

    def rhs_j(g, i):
        o = JM.resolve_outer_values(jm, jth, g, i, 5.0)
        v = JM.make_values_fn(jm, jth, g, i, 5.0, o)
        return JS.sia2d_rhs(g.H0, g.B, g.dx, g.dy, v, jm.target, PHYS_J)

    assert_rel(rhs_t, jax.vmap(rhs_j)(jb, jnp.arange(2)), RTOL, "D_hybrid RHS")
