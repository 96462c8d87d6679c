"""odinn_tpu_torch's NN pretraining (``models/nn_utils.py``) against
odinn_tpu's.

``msle_loss`` at 1e-12; 50 ``pretraining`` steps (torch.optim.Adam against
optax's Adam) from the same carried start, loss history and parameters at
1e-9; ``dense_lm_fit`` from a carried start, parameters and sum of squares
at 1e-8 (50 LM iterations: the accept/reject sequence must be JAX's);
``pretrain_law_from_A`` on 48 noisy Cuffey–Paterson targets with 8 Fourier
frequencies interpolating them below 1e-5 max relative error through
``eval_law``, as tests/test_features.py holds the JAX package's (its
restarts draw from ``torch.Generator``, so only the error tier is JAX's);
and tests/test_aux.py's pretraining convergence check. Float64 on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.models.nn_utils as JU
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.models.nn_utils as TU
from odinn_tpu.laws.laws import poly_A_paterson_cuffey as j_poly_a
from odinn_tpu.models.nn import (
    MLP as JMLP, NeuralNetwork as JNN, default_architecture as j_arch, scale as j_scale)
from odinn_tpu_torch.data.synthetic import halfar_glacier
from odinn_tpu_torch.laws.laws import LawA, eval_law, poly_A_paterson_cuffey
from odinn_tpu_torch.models.nn import MLP, NeuralNetwork, default_architecture, scale
from tests.torch_parity import CPU, assert_rel, tree_rel_err, tree_to_port


def test_msle_loss_matches():
    rng = np.random.default_rng(0)
    pred, target = rng.normal(size=40) * 3.0, rng.uniform(0.0, 5.0, size=40)
    assert_rel(TU.msle_loss(torch.from_numpy(pred), torch.from_numpy(target)),
               JU.msle_loss(jnp.asarray(pred), jnp.asarray(target)), 1e-12)


def _cp_pairs(n=50):
    X = np.linspace(-25.0, -5.0, n)[:, None]
    a = np.asarray(j_poly_a()(jnp.asarray(X[:, 0])))
    return X, 0.9 * a / a.max()      # inside the sigmoid head's (0, 1) range


def test_pretraining_matches_jax():
    X, Y = _cp_pairs()
    arch = j_arch(1)
    jparams = JNN(arch, seed=0).init()
    j_trained, j_hist = JU.pretraining(arch, jparams, jnp.asarray(X), jnp.asarray(Y),
                                       epochs=50, lr=5e-2)
    t_trained, t_hist = TU.pretraining(default_architecture(1), tree_to_port(jparams),
                                       torch.from_numpy(X), torch.from_numpy(Y),
                                       epochs=50, lr=5e-2)
    assert_rel(np.asarray(t_hist), np.asarray(j_hist), 1e-9, "loss history")
    assert tree_rel_err(t_trained, j_trained) <= 1e-9
    assert t_hist[-1] < t_hist[0]


def test_dense_lm_fit_matches_jax():
    X, Y = _cp_pairs(30)
    arch = j_arch(1)
    jparams = JNN(arch, seed=2).init()
    post = (lambda o: j_scale(o, (0.0, 1.0)), lambda o: scale(o, (0.0, 1.0)))
    w = np.linspace(0.5, 2.0, len(Y))
    j_fit, j_ssr = JU.dense_lm_fit(arch, jparams, jnp.asarray(X), jnp.asarray(Y),
                                   postprocess=post[0], iters=50, sample_weights=w)
    t_fit, t_ssr = TU.dense_lm_fit(default_architecture(1), tree_to_port(jparams),
                                   torch.from_numpy(X), torch.from_numpy(Y),
                                   postprocess=post[1], iters=50, sample_weights=w)
    assert abs(t_ssr - float(j_ssr)) <= 1e-8 * float(j_ssr)
    assert tree_rel_err(t_fit, j_fit) <= 1e-8


def test_pretraining_fits_target():
    """tests/test_aux.py::test_pretraining_fits_target on the port: 400 Adam
    steps on the Cuffey–Paterson curve lower the MSLE tenfold."""
    X, Y = _cp_pairs()
    arch = default_architecture(1)
    params = NeuralNetwork(arch, seed=0).init(device=CPU)
    _, hist = TU.pretraining(arch, params, torch.from_numpy(X), torch.from_numpy(Y),
                             epochs=400, lr=5e-2)
    assert hist[-1] < 0.1 * hist[0], f"pretraining did not converge: {hist[0]} -> {hist[-1]}"


def test_pretrain_law_from_a_interpolates():
    """tests/test_features.py::test_lawA_fourier_pretrain_interpolates on the
    port: 8 Fourier frequencies and one 32-wide layer interpolate 48 noisy
    targets below 1e-5 max relative error, read through the law."""
    params = TP.Parameters(physical=TP.PhysicalParameters(min_A=8e-21, max_A=8e-18))
    temps = np.linspace(-25.0, -14.0, 48)
    rng = np.random.default_rng(0)
    a_fn = poly_A_paterson_cuffey()
    A_tgt = a_fn(torch.from_numpy(temps)).numpy() * (1.0 + 3e-5 * rng.standard_normal(48))
    nf, pb = 8, ((-25.0, 0.0),)
    nn = NeuralNetwork(MLP((2 * nf, 32, 1), ("tanh", "sigmoid")), seed=666)
    th = TU.pretrain_law_from_A(nn, params, temps, A_tgt, head="log", prescale_bounds=pb,
                                n_fourier=nf, iters=300, restarts=2, device=CPU)
    law = LawA(nn, params, head="log", prescale_bounds=pb, n_fourier=nf)
    g0 = halfar_glacier(nx=16, ny=16, device=CPU)
    rels = []
    for t, a in zip(temps[::6], A_tgt[::6]):
        gi = g0.replace(climate=dataclasses.replace(
            g0.climate, longterm_temps_scalar=torch.tensor(float(t), dtype=torch.float64)))
        rels.append(abs(float(eval_law(law, {"A": th}, gi)) - a) / a)
    assert max(rels) < 1e-5, f"fourier fit does not interpolate: {max(rels):.2e}"


def _recording(monkeypatch, module):
    """Record each (result, sum of squares) of ``module.dense_lm_fit``."""
    calls, real = [], module.dense_lm_fit

    def recorded(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(module, "dense_lm_fit", recorded)
    return calls


def test_pretrain_law_from_a_carries_init_theta(monkeypatch):
    """The carried ``init_theta`` start is fitted first, through the same
    prescale, Fourier embedding and log head as the JAX package's: its fit
    equals JAX's at 1e-8; the other starts are the port's own draws."""
    kw = dict(head="log", prescale_bounds=((-25.0, 0.0),), n_fourier=2, iters=30,
              restarts=1)
    temps = np.linspace(-25.0, -14.0, 12)
    A_tgt = np.asarray(j_poly_a()(jnp.asarray(temps)))
    arch_j, arch_t = JMLP((4, 6, 1), ("tanh", "sigmoid")), MLP((4, 6, 1), ("tanh", "sigmoid"))
    jstart = JNN(arch_j, seed=1).init()
    j_calls, t_calls = _recording(monkeypatch, JU), _recording(monkeypatch, TU)
    JU.pretrain_law_from_A(JNN(arch_j, seed=1),
                           JP.Parameters(physical=JP.PhysicalParameters(min_A=8e-21,
                                                                        max_A=8e-18)),
                           temps, A_tgt, init_theta=jstart, **kw)
    TU.pretrain_law_from_A(NeuralNetwork(arch_t, seed=1),
                           TP.Parameters(physical=TP.PhysicalParameters(min_A=8e-21,
                                                                        max_A=8e-18)),
                           temps, A_tgt, init_theta=tree_to_port(jstart), device=CPU, **kw)
    assert len(j_calls) == len(t_calls) == 2
    (t_fit, t_ssr), (j_fit, j_ssr) = t_calls[0], j_calls[0]
    assert abs(t_ssr - float(j_ssr)) <= 1e-8 * float(j_ssr)
    assert tree_rel_err(t_fit, j_fit) <= 1e-8
