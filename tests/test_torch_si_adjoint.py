"""The gradient of odinn_tpu_torch's semi-implicit solve against the JAX
package's: ``semi_implicit_step``, ``si2_step`` and
``integrate_semi_implicit`` differentiate the PCG solve by the
implicit-function adjoint of ``lax.custom_linear_solve`` (one transpose
solve warm-started at the cotangent, one pullback of the residual; no
gradient through the guess x0 or the preconditioner), on both of the port's
routes: the fused step (``si_step``'s autograd Function, its plain backward
on the CPU) and the unfused one (``si_math.theta_solve``). Float64, 2
glaciers at most on 24² planes or smaller; tolerances stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.simulation.implicit as jimp
import odinn_tpu.simulation.solver as jsol
import odinn_tpu_torch.simulation.implicit as timp
import odinn_tpu_torch.simulation.solver as tsol
from odinn_tpu.core.params import PhysicalParameters as JPhys
from odinn_tpu.ops.pallas.rkc_kernel import derived_scalars as j_derived
from odinn_tpu.ops.pallas.si_kernel import si_step_pallas
from odinn_tpu.physics.sia2d import SIAValues as JVals
from odinn_tpu.physics.targets import ATarget as JTarget
from odinn_tpu_torch.core.params import PhysicalParameters as TPhys
from odinn_tpu_torch.ops import si_math
from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.common import derived_scalars
from odinn_tpu_torch.physics.sia2d import SIAValues as TVals, ValuesFn
from odinn_tpu_torch.physics.targets import ATarget as TTarget
from tests.torch_parity import assert_rel

RTOL = 1e-9
DX = 100.0
DT = 0.25
CG_ITERS = 10


def _problem(n_g=2, nx=16, ny=18, seed=6):
    """Domes on a rough bed with ice-free margins (x ≤ 0 there), per-glacier
    A, and a cotangent of the output, from a seed."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) - nx / 2) * DX
    y = (np.arange(ny) - ny / 2) * DX
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    H = np.stack([300.0 * s * np.clip(1 - r2 / (600.0 * s) ** 2, 0, None) ** (3 / 7)
                  for s in (1.0, 0.8)[:n_g]])
    B = 10.0 * rng.random((n_g, nx, ny))
    A = np.array([2e-18, 6e-18])[:n_g]
    return H, B, A, rng.standard_normal((n_g, nx, ny))


def _j_vfn(A):
    vals = JVals(A=A, C=0.0, n=3.0, p=3.0, q=0.0)
    return lambda hb, gs: vals


def _t_vfn(A, fused):
    """The port's law resolver: constant values take the fused step, an
    inner law (here the identity) the unfused path."""
    vals = TVals(A=A.reshape(-1, 1, 1), C=0.0, n=3.0, p=3.0, q=0.0)
    return ValuesFn(vals) if fused else ValuesFn(vals, lambda v, hb, gs: v)


def _leaves(*arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


def _grads(out, leaves, cot):
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("theta,star", [(1.0, False), (0.5, True)], ids=["SI", "CN-H_star"])
def test_semi_implicit_step_vjp_matches_jax(fused, theta, star):
    """Cotangents of H, B, H_star and A through one step against jax.vjp of
    the JAX package's semi_implicit_step (PCG-10, so the two PCGs are far
    from converged and only the same adjoint can agree); the x0 cotangent
    is zero in both packages. 1e-9 relative; measured ≤ 2e-15."""
    H, B, A, cot = _problem()
    H_star, x0 = (0.95 * H if star else H), 1.01 * H

    def jone(h, b, a, hs, x):
        return jimp.semi_implicit_step(h, b, DX, DX, _j_vfn(a), JTarget(), JPhys(), DT,
                                       CG_ITERS, x0=x, theta=theta,
                                       H_star=hs if star else None)

    ref, pull = jax.vjp(jax.vmap(jone), *(jnp.asarray(v) for v in (H, B, A, H_star, x0)))
    want = pull(jnp.asarray(cot))
    h, b, a, hs, x = _leaves(H, B, A, H_star, x0)
    out = timp.semi_implicit_step(h, b, DX, DX, _t_vfn(a, fused), TTarget(), TPhys(), DT,
                                  CG_ITERS, x0=x, theta=theta, H_star=hs if star else None)
    assert_rel(out, ref, 1e-12, "step")
    got = _grads(out, [h, b, a, hs, x], cot)
    for name, g, w in zip(("H", "B", "A", "H_star"), got, want):
        if name == "H_star" and not star:
            continue
        assert float(np.abs(np.asarray(w)).max()) > 0.0, name
        assert_rel(g, w, RTOL, name)
    assert float(np.abs(np.asarray(want[4])).max()) == 0.0
    assert float(got[4].abs().max()) == 0.0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_si2_step_vjp_matches_jax(fused):
    """The second-order step: the predictor's solution enters the corrector
    only through H_mid = (H + H_pred)/2 (its guess takes no gradient).
    Cotangents of H, B and A against jax.vjp of si2_step; x0's is zero.
    1e-9 relative."""
    H, B, A, cot = _problem(seed=7)
    x0 = 1.01 * H

    def jone(h, b, a, x):
        return jimp.si2_step(h, b, DX, DX, _j_vfn(a), JTarget(), JPhys(), DT, CG_ITERS, 4, x0=x)

    ref, pull = jax.vjp(jax.vmap(jone), *(jnp.asarray(v) for v in (H, B, A, x0)))
    want = pull(jnp.asarray(cot))
    h, b, a, x = _leaves(H, B, A, x0)
    out = timp.si2_step(h, b, DX, DX, _t_vfn(a, fused), TTarget(), TPhys(), DT, CG_ITERS, 4,
                        x0=x)
    assert_rel(out, ref, 1e-12, "step")
    got = _grads(out, [h, b, a, x], cot)
    for name, g, w in zip(("H", "B", "A"), got, want):
        assert_rel(g, w, RTOL, name)
    assert float(np.abs(np.asarray(want[3])).max()) == 0.0
    assert float(got[3].abs().max()) == 0.0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("corrector", [False, True], ids=["SI", "SI2"])
def test_integrate_semi_implicit_grad_in_log_a(corrector, fused):
    """d/d(log A) of Σ H(t_end)² over 3 monthly SI or SI2 steps with the
    warm-start carry, against jax.grad (the port's mirror of
    tests/test_implicit.py::test_si_gradient_via_implicit_diff and
    test_si2_gradient_via_implicit_diff, at 24²). 1e-9 relative."""
    H, B, _, _ = _problem(n_g=1, nx=24, ny=24, seed=8)
    H0, B0 = H[0], B[0]
    log_a = np.log(3e-18)
    ts = jsol.build_tstops((5.0, 5.25), 1.0 / 12.0)

    def jloss(la):
        vals = JVals(A=jnp.exp(la), C=0.0, n=3.0, p=3.0, q=0.0)
        tr = jimp.integrate_semi_implicit(jnp.asarray(H0), jnp.asarray(B0), DX, DX,
                                          lambda hb, gs: vals, JTarget(), JPhys(), ts,
                                          substeps=1, cg_iters=CG_ITERS, corrector=corrector,
                                          cg_iters_predictor=4)
        return jnp.sum(tr[-1] ** 2)

    want = jax.grad(jloss)(jnp.asarray(log_a))
    la = torch.tensor(log_a, dtype=torch.float64, requires_grad=True)
    tr = timp.integrate_semi_implicit(
        torch.from_numpy(H0[None]), torch.from_numpy(B0[None]), DX, DX,
        _t_vfn(torch.exp(la).reshape(1), fused), TTarget(), TPhys(),
        tsol.build_tstops((5.0, 5.25), 1.0 / 12.0), substeps=1, cg_iters=CG_ITERS,
        corrector=corrector, cg_iters_predictor=4)
    (got,) = torch.autograd.grad(torch.sum(tr[-1] ** 2), la)
    assert abs(float(want)) > 0.0
    assert_rel(got, want, RTOL, "d/dlogA")


def _graph_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return len(seen)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_cg_is_not_unrolled(fused, monkeypatch):
    """One CG call per step forward and one per step backward (the transpose
    solve), and an autograd graph whose size does not depend on cg_iters:
    the graph holds no per-iteration tensors."""
    calls = []
    real_cg = si_math.cg
    monkeypatch.setattr(si_math, "cg", lambda *a, **k: calls.append(1) or real_cg(*a, **k))
    H, B, A, cot = _problem()
    nodes = []
    for iters in (2, 12):
        calls.clear()
        h, a = _leaves(H, A)
        out = timp.semi_implicit_step(h, torch.from_numpy(B), DX, DX, _t_vfn(a, fused), TTarget(),
                                      TPhys(), DT, iters, x0=1.01 * h)
        assert len(calls) == 1
        nodes.append(_graph_nodes(out))
        torch.autograd.grad(out, [h, a], torch.from_numpy(cot))
        assert len(calls) == 2
    assert nodes[0] == nodes[1], nodes


def test_contracts_meet_where_pcg_has_converged():
    """The TPU kernel's backward (si_step_pallas._bwd) differentiates the
    unrolled PCG, x0 included; the port's si_step takes the production
    step's implicit-function adjoint. At a low cg_iters the two differ by
    design (PCG-6: 3.6e-5 of max|grad| here, and an x0 cotangent of 1.7e-5
    of max|dH|); once the forward residual is at roundoff (PCG-40 on this
    12×14 plane) they agree: measured 1.4e-15 relative, held to 1e-12,
    with the unrolled x0 cotangent 2.7e-16 of max|dH|."""
    rng = np.random.default_rng(0)
    n_g, nx, ny = 2, 12, 14
    H, B, _, _ = _problem(n_g, nx, ny, seed=0)
    raw = np.stack([np.full(n_g, DX), np.full(n_g, 0.9 * DX), np.array([8e-19, 3e-18]),
                    np.array([0.0, 2e-18]), np.full(n_g, 3.0), np.full(n_g, 3.0),
                    np.zeros(n_g)], axis=1)
    jt = j_derived(*(jnp.asarray(raw[:, k]) for k in range(7)), 900.0, 9.81)
    tt = derived_scalars(*(torch.from_numpy(raw[:, k]) for k in range(7)), 900.0, 9.81)
    cot = rng.standard_normal((n_g, nx, ny))
    H_D, x0, dt = 0.97 * H, 0.99 * H, 1.0 / 12.0
    gaps = {}
    for iters in (6, 40):
        fn = lambda h, hd, b, x, sc: si_step_pallas(h, hd, b, x, sc, dt, 0.5, iters,
                                                    (5.0, 2.0, 4.0, 2.0))
        _, pull = jax.vjp(fn, *(jnp.asarray(v) for v in (H, H_D, B, x0)), jt)
        want = pull(jnp.asarray(cot))
        leaves = _leaves(H, H_D, B) + [tt.clone().requires_grad_(True)]
        out = si_kernel.si_step(*leaves[:3], torch.from_numpy(x0), leaves[3], dt, 0.5, iters)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
        pairs = list(zip(got[:3], want[:3])) + [(got[3][:, k], want[4][:, k]) for k in (2, 3)]
        gaps[iters] = max(float(np.abs(g.numpy() - np.asarray(w)).max())
                          / float(np.abs(np.asarray(w)).max()) for g, w in pairs)
        gaps[f"x0 {iters}"] = float(np.abs(np.asarray(want[3])).max()) / float(
            np.abs(np.asarray(want[0])).max())
    assert gaps[6] > 1e-6 and gaps["x0 6"] > 1e-6, gaps
    assert gaps[40] <= 1e-12 and gaps["x0 40"] <= 1e-12, gaps


def test_kernel_backward_plain_versions_compose(monkeypatch):
    """On a CPU tensor si_step's backward is si_step_transpose_reference
    then si_step_vjp_reference, once each a step, and equals autograd
    through si_step_reference (si_math.theta_solve); the table's cotangent has only the creep
    and slide columns, and dx, dy and x0 get none."""
    H, B, _, cot = _problem()
    n_g = H.shape[0]
    raw = np.stack([np.full(n_g, DX), np.full(n_g, DX), np.array([2e-18, 6e-18]),
                    np.array([1e-18, 0.0]), np.full(n_g, 3.0), np.full(n_g, 3.0),
                    np.zeros(n_g)], axis=1)
    table = derived_scalars(*(torch.from_numpy(raw[:, k]) for k in range(7)), 900.0, 9.81)
    ran = []
    for name in ("si_step_transpose_reference", "si_step_vjp_reference"):
        real = getattr(si_kernel, name)
        monkeypatch.setattr(si_kernel, name,
                            lambda *a, _r=real, _n=name, **k: ran.append(_n) or _r(*a, **k))
    h, hd, b = _leaves(H, 0.97 * H, B)
    tab, x0 = table.clone().requires_grad_(True), torch.from_numpy(0.99 * H).requires_grad_(True)
    out = si_kernel.si_step(h, hd, b, x0, tab, DT, 0.5, CG_ITERS)
    got = torch.autograd.grad(out, [h, hd, b, tab, x0], torch.from_numpy(cot), allow_unused=True)
    assert ran == ["si_step_transpose_reference", "si_step_vjp_reference"]
    h, hd, b = _leaves(H, 0.97 * H, B)
    tab = table.clone().requires_grad_(True)
    plain = si_kernel.si_step_reference(h, hd, b, torch.from_numpy(0.99 * H), tab, DT, 0.5,
                                        CG_ITERS)
    want = torch.autograd.grad(plain, [h, hd, b, tab], torch.from_numpy(cot))
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    assert (got[3][:, 2] != 0).all() and got[3][0, 3] != 0
    assert torch.equal(got[3][:, [0, 1, 4, 5, 6, 7]], torch.zeros(n_g, 6, dtype=torch.float64))
    assert got[4] is None


def test_si_inversion_smoke():
    """run_inversion through solver='SI' (its fused step's plain version
    and plain backward on the CPU) on one 24² glacier, 2 Adam epochs: losses
    finite and decreasing, and the solves and gradients counted."""
    import dataclasses

    from odinn_tpu_torch.core import params as TP
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth

    tspan = (5.0, 5.25)
    params = TP.Parameters(
        physical=TP.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=TP.SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
        solver=TP.SolverParameters(step=1.0 / 12.0, substeps=1, solver="SI", cg_iters=20),
        hyper=TP.Hyperparameters(optimizer=("adam",), learning_rate=(0.08,), epochs=(2,)),
        UDE=TP.UDEParameters(grad="jax"))
    glaciers = generate_ground_truth(
        [halfar_glacier(nx=24, ny=24, dx=200.0, temp=-17.0, rgi_id="si", device="cpu")],
        params, Model(iceflow=SIA2DModel(A=CuffeyPaterson())),
        tsol.build_tstops(tspan, 1.0 / 12.0), store=("H",), device="cpu")
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True)),
                                            params)))
    stats = run_inversion(Inversion(model=model, glaciers=glaciers, parameters=params,
                                    device="cpu")).stats
    assert np.isfinite(stats.losses).all() and stats.losses[-1] < stats.losses[0], stats.losses
    # the loss before training, 2 steps, the stage's last iterate, the final
    # loss and the final forward
    assert (stats.solves, stats.gradients, stats.niter) == (6, 2, 2)
    assert dataclasses.is_dataclass(params.solver) and params.solver.solver == "SI"
