"""Forward-mode derivatives of odinn_tpu_torch's solve steps against the JAX
package's: ``torch.autograd.forward_ad`` through the port's
``semi_implicit_step``, ``si2_step``, ``sia2d_rhs`` and the RKC2 step
against ``jax.jvp`` of the JAX production functions
(``implicit.semi_implicit_step``, whose ``lax.custom_linear_solve`` takes
its tangent by the same PCG from the primal guess; ``physics.sia2d.
sia2d_rhs``; ``solver.make_rkc2_step``), on both of the port's routes (the
fused kernels' wrappers, which run their plain versions on the CPU, and the
generic tensor code). The kernels' tangent plain versions are held to the
jvp of their forward plain versions where the contracts meet. Float64, 2
glaciers on 16 × 18 planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import odinn_tpu.simulation.implicit as jimp
import odinn_tpu_torch.simulation.implicit as timp
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu.physics.sia2d import SIAValues as JVals
from odinn_tpu.physics.sia2d import sia2d_rhs as j_rhs
from odinn_tpu.physics.targets import ATarget as JTarget
from odinn_tpu.simulation.solver import make_rkc2_step as j_rkc2
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel, sia_kernel
from odinn_tpu_torch.ops.cuda.common import derived_scalars
from odinn_tpu_torch.physics.sia2d import SIAValues as TVals
from odinn_tpu_torch.physics.sia2d import ValuesFn
from odinn_tpu_torch.physics.sia2d import sia2d_rhs as t_rhs
from odinn_tpu_torch.physics.targets import ATarget as TTarget
from tests.torch_parity import assert_rel

RTOL = 1e-10
DX = 100.0
DT = 0.25


def _problem(seed=6, n_g=2, nx=16, ny=18):
    """Domes on a rough bed with ice-free margins, per-glacier A, and
    tangents of H, B, A and a second plane, from a seed."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - nx / 2) * DX
    y = (np.arange(ny) - ny / 2) * DX
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    H = np.stack([300.0 * s * np.clip(1 - r2 / (600.0 * s) ** 2, 0, None) ** (3 / 7)
                  for s in (1.0, 0.8)[:n_g]])
    B = 10.0 * rng.random((n_g, nx, ny))
    A = np.array([2e-18, 6e-18])[:n_g]
    tangents = (rng.standard_normal((n_g, nx, ny)), rng.standard_normal((n_g, nx, ny)),
                np.array([1e-18, -2e-18])[:n_g], rng.standard_normal((n_g, nx, ny)))
    return H, B, A, tangents


def _j_vfn(A, n=3.0):
    vals = JVals(A=A, C=0.0, n=n, p=n, q=0.0)
    return lambda hb, gs: vals


def _t_vfn(A, fused, n=3.0):
    """Constant values take the fused route, an inner law (the identity)
    the generic tensor code."""
    vals = TVals(A=A.reshape(-1, 1, 1), C=0.0, n=n, p=n, q=0.0)
    return ValuesFn(vals) if fused else ValuesFn(vals, lambda v, hb, gs: v)


def _dual(value, tangent):
    return fwAD.make_dual(torch.from_numpy(np.array(value)), torch.from_numpy(np.array(tangent)))


def _port_jvp(fn, primals, tangents):
    """(primal, tangent) of ``fn`` at numpy primals along numpy tangents."""
    with fwAD.dual_level():
        out = fn(*(_dual(p, t) for p, t in zip(primals, tangents)))
        primal, tangent = fwAD.unpack_dual(out)
    return primal, tangent


def _jax_jvp(fn, primals, tangents):
    return jax.jvp(fn, tuple(jnp.asarray(p) for p in primals),
                   tuple(jnp.asarray(t) for t in tangents))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("theta,star", [(1.0, False), (0.5, True)], ids=["SI", "CN-H_star"])
@pytest.mark.parametrize("cg_iters", [6, 20])
def test_semi_implicit_step_jvp_matches_jax(cg_iters, theta, star, fused):
    """ROADMAP Queue 3's fault: the tangent through one step is the
    custom_linear_solve tangent (the same PCG from the primal guess on the
    residual's tangent), not the unrolled PCG's. H, B, A, H_star and x0
    all carry tangents; D depends on H (or H_star). At PCG-6 the unrolled
    tangent was 4.9e-2 from JAX's; 1e-10 relative."""
    H, B, A, (tH, tB, tA, tX) = _problem()
    H_star, x0 = (0.95 * H if star else H), 1.01 * H
    t_star = 0.7 * tX

    def jone(h, b, a, hs, x):
        return jimp.semi_implicit_step(h, b, DX, DX, _j_vfn(a), JTarget(), JPhys(), DT,
                                       cg_iters, x0=x, theta=theta,
                                       H_star=hs if star else None)

    primals, tangents = (H, B, A, H_star, x0), (tH, tB, tA, t_star, tX)
    ref, want = _jax_jvp(jax.vmap(jone), primals, tangents)

    def tone(h, b, a, hs, x):
        return timp.semi_implicit_step(h, b, DX, DX, _t_vfn(a, fused), TTarget(), TPhys(), DT,
                                       cg_iters, x0=x, theta=theta,
                                       H_star=hs if star else None)

    out, got = _port_jvp(tone, primals, tangents)
    assert_rel(out, ref, 1e-12, "step")
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    assert_rel(got, want, RTOL, "tangent")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("cg_iters", [6, 20])
def test_si2_step_jvp_matches_jax(cg_iters, fused):
    """The second-order step: the predictor's tangent reaches the corrector
    through H_mid only (its guess takes none). 1e-10 relative."""
    H, B, A, (tH, tB, tA, tX) = _problem(seed=7)
    x0 = 1.01 * H

    def jone(h, b, a, x):
        return jimp.si2_step(h, b, DX, DX, _j_vfn(a), JTarget(), JPhys(), DT, cg_iters, 4, x0=x)

    primals, tangents = (H, B, A, x0), (tH, tB, tA, tX)
    ref, want = _jax_jvp(jax.vmap(jone), primals, tangents)

    def tone(h, b, a, x):
        return timp.si2_step(h, b, DX, DX, _t_vfn(a, fused), TTarget(), TPhys(), DT, cg_iters, 4,
                             x0=x)

    out, got = _port_jvp(tone, primals, tangents)
    assert_rel(out, ref, 1e-12, "step")
    assert_rel(got, want, RTOL, "tangent")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
@pytest.mark.parametrize("n", [3.0, 4.0, 2.5])
def test_sia2d_rhs_jvp_matches_jax(n, fused):
    """The RHS's tangent in H and A against jax.jvp of
    odinn_tpu/physics/sia2d.py's sia2d_rhs, the exponent sets of the
    kernel's specialisation (n = 3) and of its run-time path. 1e-10."""
    H, B, A, (tH, _, tA, _) = _problem(seed=8)

    def jone(h, a, b):
        return j_rhs(h, b, DX, DX, _j_vfn(a, n), JTarget(), JPhys())

    ref, want = _jax_jvp(lambda h, a: jax.vmap(jone)(h, a, jnp.asarray(B)), (H, A), (tH, tA))

    def tone(h, a):
        vfn = ValuesFn(TVals(A=a, C=0.0, n=n, p=n, q=0.0)) if fused else _t_vfn(a, False, n)
        return t_rhs(h, torch.from_numpy(B), DX, DX, vfn, TTarget(), TPhys())

    out, got = _port_jvp(tone, (H, A), (tH, tA))
    assert_rel(out, ref, 1e-12, "rhs")
    assert_rel(got, want, RTOL, "tangent")


def _derived(a, n_g, dtype=torch.float64):
    phys = TPhys()
    dx = torch.full((n_g,), DX, dtype=dtype)
    zero, three = torch.zeros(n_g, dtype=dtype), torch.full((n_g,), 3.0, dtype=dtype)
    return derived_scalars(dx, dx, a, zero, three, three, zero, phys.rho, phys.g)


@pytest.mark.parametrize("s", [2, 8])
def test_rkc_interval_jvp_matches_jax(s):
    """One fused RKC2 step's tangent in H and A (through the derived creep
    column) against jax.jvp of make_rkc2_step over the production RHS.
    1e-10."""
    H, B, A, (tH, _, tA, _) = _problem(seed=9)
    dt = 1.0 / 12.0

    def jstep(h, a):
        f = lambda y, t: j_rhs(y, jnp.asarray(B), DX, DX, _j_vfn(a), JTarget(), JPhys())
        return j_rkc2(s)(f, h, 0.0, dt)

    ref, want = _jax_jvp(jstep, (H, A.reshape(-1, 1, 1)), (tH, tA.reshape(-1, 1, 1)))

    def tstep(h, a):
        return rkc_kernel.rkc_interval(h, torch.from_numpy(B), _derived(a, 2), dt, s,
                                       TPhys().eta0)

    out, got = _port_jvp(tstep, (H, A), (tH, tA))
    assert_rel(out, ref, 1e-12, "step")
    assert_rel(got, want, RTOL, "tangent")


def _plain_jvp(fn, primals, tangents):
    """The forward-mode derivative of a plain version (PyTorch ops only)."""
    with fwAD.dual_level():
        out = fn(*(fwAD.make_dual(p, t) for p, t in zip(primals, tangents)))
        return fwAD.unpack_dual(out).tangent


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n", [3.0, 2.5])
def test_rhs_tangent_references_are_the_plain_jvp(n):
    """sia2d_rhs_jvp_reference (both modes) is the forward-mode derivative
    of the forward's plain version, in H and the creep column, to 1e-12;
    the stage mode applies the RKC stage's combination."""
    H, B, A, (tH, tX, tA, tY) = _problem(seed=10)
    h, b, th, tx, ty = _torch(H, B, tH, tX, tY)
    phys = TPhys()
    raw = torch.stack([torch.full((2,), DX, dtype=torch.float64)] * 2
                      + [torch.from_numpy(A), torch.zeros(2, dtype=torch.float64)]
                      + [torch.full((2,), n, dtype=torch.float64)] * 2
                      + [torch.zeros(2, dtype=torch.float64)], dim=1)
    t_raw = torch.zeros_like(raw)
    t_raw[:, 2] = torch.from_numpy(tA)
    want = _plain_jvp(lambda hh, rr: sia_kernel.sia2d_rhs_reference(hh, b, rr, phys.rho, phys.g,
                                                                    phys.eta0),
                      (h, raw), (th, t_raw))
    derived = sia_kernel.derive_table(raw, phys.rho, phys.g)
    d_creep = sia_kernel.creep_tangent(raw, t_raw[:, 2], phys.rho, phys.g)
    got = sia_kernel.sia2d_rhs_jvp_reference(th, h, b, derived, d_creep, phys.eta0)
    assert float(want.abs().max()) > 0.0
    assert_rel(got, want, 1e-12, "plain mode")

    weights = (0.25, 0.5, 0.25, 0.01, -0.003)
    y_j, f = sia_kernel.sia2d_rhs_jvp_reference(th, h, b, derived, d_creep, phys.eta0,
                                                stage=(tx, ty, 2.0 * th, weights))
    a, mu, nu, mutdt, gamdt = weights
    assert torch.equal(f, got)
    assert_rel(y_j, a * tx + mu * th + nu * ty + mutdt * got + gamdt * 2.0 * th, 1e-15, "stage")


def test_interval_tangent_reference_is_the_plain_jvp():
    """interval_tangent_reference is the forward-mode derivative of
    rkc_interval_reference in H and the creep column, to 1e-12."""
    H, B, A, (tH, _, tA, _) = _problem(seed=11)
    h, b, th = _torch(H, B, tH)
    der = _derived(torch.from_numpy(A), 2)
    t_der = torch.zeros_like(der)
    t_der[:, 2] = _derived(torch.from_numpy(tA), 2)[:, 2]
    eta0, dt, s = TPhys().eta0, 1.0 / 12.0, 6
    want = _plain_jvp(lambda hh, dd: rkc_kernel.rkc_interval_reference(hh, b, dd, dt, s, eta0),
                      (h, der), (th, t_der))
    got = rkc_kernel.interval_tangent_reference(th, t_der[:, 2], h, b, der, dt, s, eta0)
    assert float(want.abs().max()) > 0.0
    assert_rel(got, want, 1e-12, "RKC tangent")


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_si_tangent_reference_meets_the_unrolled_jvp_where_pcg_converged(theta):
    """si_step_tangent_reference on the residual's tangent is the jvp of
    custom_linear_solve; the unrolled PCG's jvp (forward-mode AD of the
    plain version's solve, x0 fixed) is another contract. They meet where
    PCG has converged: PCG-40, 1e-9 relative. (The plain solve reads the
    table detached, so the tangents here are H's and B's; the table's are
    held to JAX's above.)"""
    H, B, A, (tH, tB, _, _) = _problem(seed=12)
    h, b, th, tb = _torch(H, B, tH, tB)
    der = _derived(torch.from_numpy(A), 2)
    x0, iters, exps = 1.01 * h, 40, (5.0, 2.0, 4.0, 2.0)

    def unrolled(hh, bb):
        return st.relu_strict(si_kernel._si_solve_reference(hh, hh, bb, x0, der, DT, theta,
                                                            iters, exps))

    want = _plain_jvp(unrolled, (h, b), (th, tb))
    x = si_kernel._si_solve_reference(h, h, b, x0, der, DT, theta, iters, exps)
    rdot = si_kernel.si_step_residual_tangent(th, th, tb, None, h, h, b, x, der, DT, theta,
                                              exps)
    got = si_kernel.si_step_tangent_reference(rdot, x, x0, h, b, der, DT, theta, iters, exps)
    assert float(want.abs().max()) > 0.0
    assert_rel(got, want, 1e-9, "SI tangent")


def test_undifferentiated_tangents_raise():
    """A tangent the kernels' contract does not differentiate raises and is
    never dropped: the RHS table's C column and the bed, the RKC table's
    slide column, and the SI step's keep_x call. A zero tangent on those
    passes."""
    H, B, A, (tH, tB, _, _) = _problem(seed=13)
    h, b, th, tb = _torch(H, B, tH, tB)
    phys = TPhys()
    raw = torch.stack([torch.full((2,), DX, dtype=torch.float64)] * 2
                      + [torch.from_numpy(A), torch.full((2,), 1e-16, dtype=torch.float64)]
                      + [torch.full((2,), 3.0, dtype=torch.float64)] * 2
                      + [torch.zeros(2, dtype=torch.float64)], dim=1)
    t_c = torch.zeros_like(raw)
    t_c[:, 3] = 1.0
    rhs = lambda hh, bb, rr: sia_kernel.sia2d_rhs(hh, bb, rr, phys.rho, phys.g, phys.eta0)
    with pytest.raises(NotImplementedError, match="other than A"):
        _plain_jvp(lambda rr: rhs(h, b, rr), (raw,), (t_c,))
    with pytest.raises(NotImplementedError, match="bed"):
        _plain_jvp(lambda bb: rhs(h, bb, raw), (b,), (tb,))
    assert _plain_jvp(lambda rr: rhs(h, b, rr), (raw,), (torch.zeros_like(raw),)).abs().max() == 0

    der = sia_kernel.derive_table(raw, phys.rho, phys.g)
    t_slide = torch.zeros_like(der)
    t_slide[:, 3] = 1.0
    with pytest.raises(NotImplementedError, match="other than creep"):
        _plain_jvp(lambda dd: rkc_kernel.rkc_interval(h, b, dd, 0.05, 4, phys.eta0),
                   (der,), (t_slide,))
    with pytest.raises(NotImplementedError, match="keep_x"):
        _plain_jvp(lambda hh: si_kernel.si_step(hh, hh, b, hh, der, DT, keep_x=True)[0],
                   (h,), (th,))


def _c_params(source, name):
    """The ctypes types of an ``extern "C"`` function's parameters in a
    kernel source: a pointer is c_void_p, an int c_int, a double c_double."""
    import ctypes
    import re

    sig = re.search(rf'extern "C" int {name}\((.*?)\)', source, re.S).group(1)
    kinds = []
    for param in sig.split(","):
        param = param.strip()
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_double if param.startswith("double") else ctypes.c_int)
    return kinds


def test_tangent_kernel_interfaces_match_the_sources():
    """The kernels build only on the card, so their C interfaces are held
    to the wrappers here: sia2d_rhs_jvp's ctypes signature against both
    entry points of csrc/sia2d_rhs_jvp.cu, and si_step's mode numbers
    against csrc/si_step.cu's."""
    from odinn_tpu_torch.ops.cuda.build import SRC_DIR

    source = (SRC_DIR / "sia2d_rhs_jvp.cu").read_text()
    for name in ("sia2d_rhs_jvp_f32", "sia2d_rhs_jvp_f64"):
        assert _c_params(source, name) == sia_kernel.JVP_ARGTYPES, name
    si_source = (SRC_DIR / "si_step.cu").read_text()
    for const, value in (("kForward", si_kernel._FORWARD), ("kTranspose", si_kernel._TRANSPOSE),
                         ("kTangent", si_kernel._TANGENT)):
        assert f"constexpr int {const} = {value};" in si_source
