"""odinn_tpu_torch's Levenberg–Marquardt loop against the JAX package's
(``odinn_tpu.inverse.gauss_newton``) on the same Rademacher probes (JAX's
draw carried into the port): the Hutchinson diagonal, and the loss trace
and trained θ of three LM iterations through SI at PCG-6, whose J·v is the
tangent solve of ``lax.custom_linear_solve`` (the RK4 trace is in
``test_torch_lm_trace_rk4.py``: the JAX package's compiles of the two
traces would take a file past ~30 s). The classical per-glacier A
(``LawA_inversion``), float64, 2 glaciers on 16² planes, 3 monthly
intervals; the setting and helpers of ``test_torch_gauss_newton.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odinn_tpu.inverse import gauss_newton as jgn
from odinn_tpu_torch.inverse import gauss_newton as tgn
from tests.test_torch_gauss_newton import _jax_probes, _lm_problem
from tests.test_torch_gauss_newton import truth  # noqa: F401  (the module fixture)
from tests.torch_parity import assert_rel, tree_rel_err, tree_to_port


def test_diag_estimate_on_jax_draws(truth):
    """The per-leaf Hutchinson means of diag(JᵀJ) on the same two
    Rademacher probes against the JAX package's formula by jax.jvp and
    jax.vjp of its residuals, through SI; and the port's own draw is ±1 in
    every leaf's shape and dtype. 1e-10."""
    jtheta, jbatch, jres, batch, tres = _lm_problem(truth, "SI")
    probes = _jax_probes(jtheta, 2)

    @jax.jit
    def contrib(v):
        _, pb = jax.vjp(lambda th: jres(th, jbatch), jtheta)
        _, jv = jax.jvp(lambda th: jres(th, jbatch), (jtheta,), (v,))
        (jtv,) = pb(jv)
        return jax.tree.map(lambda x, y: jnp.mean(x * y), v, jtv)

    want = jax.tree.map(lambda a, b: (a + b) / 2.0, *(contrib(v) for v in probes))
    theta = tree_to_port(jtheta)
    _, tpb = tgn.linearize(tres, theta, batch)
    diag, mean = tgn.diag_estimate(theta, batch, tres, tpb, [tree_to_port(v) for v in probes])
    for d, w in zip(tgn._leaves(diag), jax.tree.leaves(want)):
        assert d.unique().numel() == 1
        assert_rel(d.reshape(-1)[0], np.asarray(w), 1e-10, "leaf mean")
    leaves = jax.tree.leaves(want)
    assert_rel(mean, sum(np.asarray(w) for w in leaves) / len(leaves), 1e-10, "mean")
    for v in tgn._draw_probes(torch.Generator().manual_seed(0), theta, 2):
        for p, x in zip(tgn._leaves(v), tgn._leaves(theta)):
            assert p.shape == x.shape and p.dtype == x.dtype
            assert set(p.unique().tolist()) <= {-1.0, 1.0}



def lm_trace_case(truth, solver, damping, monkeypatch):
    """Three LM iterations (gn_precond=False: damping λ·(mean diag)·I from
    one estimate on two probes; cg 2, exact for the two unknowns) from the
    same θ, the port's probes
    replaced by JAX's draw: the loss trace (3 iterations and the trailing
    evaluation) and the trained θ against the JAX package's. SI at PCG-6
    (λ₀ = 1: a rejected, then an accepted step) and RK4 (λ₀ = 1e-3: three
    accepted). 1e-8 relative."""
    jtheta, jbatch, jres, batch, tres = _lm_problem(truth, solver)
    kw = dict(iters=3, cg_iters=2, init_damping=damping, precond=False, diag_probes=2)
    jth, jlosses = jgn.lm_train(jtheta, jbatch, jres, **kw)
    probes = [tree_to_port(v) for v in _jax_probes(jtheta, 2)]
    monkeypatch.setattr(tgn, "_draw_probes", lambda gen, theta, n: probes[:n])
    th, losses = tgn.lm_train(tree_to_port(jtheta), batch, tres, **kw)
    assert len(losses) == len(jlosses) == 4
    assert_rel(np.asarray(losses), np.asarray(jlosses), 1e-8, "trace")
    assert losses[-1] < losses[0]
    assert tree_rel_err(th, jth) < 1e-8


@pytest.mark.parametrize("solver,damping", [("SI", 1.0)])
def test_lm_trace_matches_jax(truth, solver, damping, monkeypatch):
    """The loss trace of :func:`lm_trace_case` through SI."""
    lm_trace_case(truth, solver, damping, monkeypatch)
