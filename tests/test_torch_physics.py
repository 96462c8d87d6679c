"""odinn_tpu_torch physics against odinn_tpu: stencils, the A-target
diffusivity, the SIA2D right-hand side, the laws and the mass balance.

Float64 on the CPU, inputs from a numpy seed handed to both packages;
tolerance 1e-12 relative to the largest value compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.ops.stencils as jst
import odinn_tpu_torch.ops.stencils as tst
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from tests.torch_parity import assert_rel, carry_glacier

RTOL = 1e-12
PHYS_J, PHYS_T = JPhys(), TPhys()


def _field(seed, shape=(3, 24, 28)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) * 50.0 + 100.0


@pytest.mark.parametrize("name", ["diff_x", "diff_y", "avg", "avg_x", "avg_y", "inn",
                                  "inn1", "pad_inner", "relu_strict"])
def test_unary_stencils_match(name):
    a = _field(1) - 100.0
    assert_rel(getattr(tst, name)(torch.from_numpy(a)), getattr(jst, name)(jnp.asarray(a)),
               RTOL, name)


def test_slope_norm_and_clamps_match():
    s, h = _field(2), np.abs(_field(3))
    dx, dy = 90.0, 110.0
    gj, gt = jst.grad_slope(jnp.asarray(s), dx, dy), tst.grad_slope(torch.from_numpy(s), dx, dy)
    for a, b in zip(gt, gj):
        assert_rel(a, b, RTOL)
    z = np.zeros((4, 5))
    z[1, 2] = 3.0
    assert_rel(tst.safe_norm(torch.from_numpy(z), torch.from_numpy(z)),
               jst.safe_norm(jnp.asarray(z), jnp.asarray(z)), RTOL)
    dsx = np.diff(s[..., :, 1:-1], axis=-2) / dx
    dsy = np.diff(s[..., 1:-1, :], axis=-1) / dy
    assert_rel(tst.clamp_borders_dx(torch.from_numpy(dsx), torch.from_numpy(h), 1.0, dx),
               jst.clamp_borders_dx(jnp.asarray(dsx), jnp.asarray(h), 1.0, dx), RTOL)
    assert_rel(tst.clamp_borders_dy(torch.from_numpy(dsy), torch.from_numpy(h), 1.0, dy),
               jst.clamp_borders_dy(jnp.asarray(dsy), jnp.asarray(h), 1.0, dy), RTOL)


def _values(mod, A, C, n, tensor):
    return mod.SIAValues(A=tensor(A), C=tensor(C), n=tensor(n), p=tensor(n),
                         q=tensor(np.zeros_like(n)))


@pytest.mark.parametrize("static_n", [True, False])
def test_a_target_diffusivity_matches(static_n):
    import odinn_tpu.physics.sia2d as jsia
    import odinn_tpu.physics.targets as jtg
    import odinn_tpu_torch.physics.sia2d as tsia
    import odinn_tpu_torch.physics.targets as ttg

    rng = np.random.default_rng(4)
    hbar = np.abs(rng.normal(size=(2, 9, 11))) * 200.0
    gs = np.abs(rng.normal(size=(2, 9, 11))) * 0.1
    hbar[0, 0, 0] = gs[1, 2, 3] = 0.0
    A = np.array([8e-19, 3e-18])[:, None, None]
    C = np.array([0.0, 2e-18])[:, None, None]
    n = np.full((2, 1, 1), 3.0)
    if static_n:
        jv = jsia.SIAValues(A=jnp.asarray(A), C=jnp.asarray(C), n=3.0, p=3.0, q=0.0)
        tv = tsia.SIAValues(A=torch.from_numpy(A), C=torch.from_numpy(C), n=3.0, p=3.0, q=0.0)
    else:
        jv = _values(jsia, A, C, n, jnp.asarray)
        tv = _values(tsia, A, C, n, torch.from_numpy)
    dj = jtg.ATarget().diffusivity(jv, jnp.asarray(hbar), jnp.asarray(gs), PHYS_J)
    dt = ttg.ATarget().diffusivity(tv, torch.from_numpy(hbar), torch.from_numpy(gs), PHYS_T)
    assert_rel(dt, dj, RTOL)
    vj = jtg.ATarget().velocity_up(jv, jnp.asarray(hbar), jnp.asarray(gs), PHYS_J)
    vt = ttg.ATarget().velocity_up(tv, torch.from_numpy(hbar), torch.from_numpy(gs), PHYS_T)
    assert_rel(vt, vj, RTOL)


def _dome_batch():
    import odinn_tpu.core.glacier as jg
    import odinn_tpu.data.synthetic as js

    rng = np.random.default_rng(5)
    gl = []
    for i, (t, a) in enumerate([(-12.0, 8e-19), (-22.0, 3e-18), (-17.0, 1.5e-18)]):
        g = js.halfar_glacier(nx=26, ny=30, dx=100.0 + 10 * i, dy=95.0, temp=t, A=a,
                              climate=js.monthly_dummy_climate(5.0, 26, nx=26, ny=30))
        bed = 30.0 * rng.random((26, 30))
        gl.append(g.replace(B=jnp.asarray(bed), H0=g.H0 * (1.0 + 0.1 * i)))
    return jg.stack_glaciers(gl)


@pytest.mark.parametrize("fused", [True, False])
def test_sia2d_rhs_matches(fused):
    """``fused``: per-glacier scalar values (the kernel's configuration, its
    plain version on the CPU); otherwise an inner resolver (the unfused
    chain). Both against the JAX RHS vmapped over the batch."""
    import jax
    import odinn_tpu.physics.sia2d as jsia
    import odinn_tpu.physics.targets as jtg
    import odinn_tpu_torch.physics.sia2d as tsia
    import odinn_tpu_torch.physics.targets as ttg

    jb = _dome_batch()
    tb = carry_glacier(jb)
    C = np.array([0.0, 1e-18, 0.0])

    def jone(H, B, dx, dy, A, c):
        vals = jsia.SIAValues(A=A, C=c, n=3.0, p=3.0, q=0.0)
        return jsia.sia2d_rhs(H, B, dx, dy, lambda hb, gs: vals, jtg.ATarget(), PHYS_J)

    ref = jax.vmap(jone)(jb.H0, jb.B, jb.dx, jb.dy, jb.A, jnp.asarray(C))
    col = lambda x: x.reshape(-1, 1, 1)
    vals = tsia.SIAValues(A=col(tb.A), C=col(torch.from_numpy(C)), n=3.0, p=3.0, q=0.0)
    vfn = tsia.ValuesFn(vals) if fused else tsia.ValuesFn(vals, lambda v, hb, gs: v)
    dx, dy = col(tb.dx), col(tb.dy)
    assert (tsia.scalar_law_table(vfn, ttg.ATarget(), dx, dy, tb.H0) is not None) == fused
    out = tsia.sia2d_rhs(tb.H0, tb.B, dx, dy, vfn, ttg.ATarget(), PHYS_T)
    assert_rel(out, ref, RTOL)


def test_v_from_h_matches():
    import jax
    import odinn_tpu.physics.sia2d as jsia
    import odinn_tpu.physics.targets as jtg
    import odinn_tpu_torch.physics.sia2d as tsia
    import odinn_tpu_torch.physics.targets as ttg

    jb = _dome_batch()
    tb = carry_glacier(jb)

    def jone(H, B, dx, dy, A):
        vals = jsia.SIAValues(A=A, C=0.0, n=3.0, p=3.0, q=0.0)
        return jsia.v_from_h(H, B, dx, dy, lambda hb, gs: vals, jtg.ATarget(), PHYS_J)

    ref = jax.vmap(jone)(jb.H0, jb.B, jb.dx, jb.dy, jb.A)
    col = lambda x: x.reshape(-1, 1, 1)
    vfn = tsia.ValuesFn(tsia.SIAValues(A=col(tb.A), C=0.0, n=3.0, p=3.0, q=0.0))
    out = tsia.v_from_h(tb.H0, tb.B, col(tb.dx), col(tb.dy), vfn, ttg.ATarget(), PHYS_T)
    for a, b in zip(out, ref):
        assert_rel(a, b, RTOL)


def test_cuffey_paterson_matches():
    import odinn_tpu.laws.laws as jl
    import odinn_tpu_torch.laws.laws as tl

    temps = np.linspace(-60.0, 5.0, 27)
    assert_rel(tl.poly_A_paterson_cuffey()(torch.from_numpy(temps)),
               jl.poly_A_paterson_cuffey()(jnp.asarray(temps)), RTOL)
    # a float32 temperature still gives the float64 law value, as under x64
    a32 = tl.poly_A_paterson_cuffey()(torch.tensor([-15.0], dtype=torch.float32))
    assert a32.dtype == torch.float64
    jb = _dome_batch()
    tb = carry_glacier(jb)
    law_j, law_t = jl.CuffeyPaterson(), tl.CuffeyPaterson()
    for i in range(3):
        gj = jax_glacier_at(jb, i)
        assert_rel(tl.eval_law(law_t, None, tb)[i], jl.eval_law(law_j, None, gj), RTOL)


def jax_glacier_at(batch, i):
    import jax

    return jax.tree.map(lambda x: x[i], batch)


def test_constant_and_synthetic_laws_match():
    import odinn_tpu.core.params as jp
    import odinn_tpu.laws.laws as jl
    import odinn_tpu_torch.core.params as tp
    import odinn_tpu_torch.laws.laws as tl

    jb = _dome_batch()
    gj = jax_glacier_at(jb, 1)
    gt = carry_glacier(gj)
    assert float(tl.eval_law(tl.ConstantA(6e-18), None, gt)) == 6e-18
    H = np.asarray(gj.H0) * 0.9
    law_j, law_t = jl.SyntheticC(jp.Parameters()), tl.SyntheticC(tp.Parameters())
    cj = jl.eval_law(law_j, None, gj, state=jnp.asarray(H), t=5.75)
    ct = tl.eval_law(law_t, None, gt, state=torch.from_numpy(H), t=5.75)
    assert_rel(ct, cj, 1e-10)


@pytest.mark.parametrize("t", [5.5, 5.0 + 1.0 / 12.0, 6.0])
def test_mb_timestep_matches(t):
    import jax
    import odinn_tpu.physics.mass_balance as jmb
    import odinn_tpu_torch.physics.mass_balance as tmb

    jb = _dome_batch()
    tb = carry_glacier(jb)
    mb_j, mb_t = jmb.TImodel1(DDF=6e-3, acc_factor=1.2), tmb.TImodel1(DDF=6e-3, acc_factor=1.2)
    H = np.asarray(jb.H0) - 5.0   # some cells ice-free, some below 10 m
    ref = jax.vmap(lambda h, g: jmb.mb_timestep(h, g, mb_j, t, 1.0 / 12.0))(jnp.asarray(H), jb)
    out = tmb.mb_timestep(torch.from_numpy(H), tb, mb_t, t, 1.0 / 12.0)
    assert_rel(out, ref, RTOL)
    # one glacier (no batch axis) through the same function
    g0 = carry_glacier(jax_glacier_at(jb, 0))
    one = tmb.mb_timestep(torch.from_numpy(H[0]), g0, mb_t, t, 1.0 / 12.0)
    assert_rel(one, ref[0], RTOL)
