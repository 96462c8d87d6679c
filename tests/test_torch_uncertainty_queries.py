"""The queries of odinn_tpu_torch's Laplace posterior
(``inverse/uncertainty.py``: ``std``, ``band``, ``cov_band``, ``sample``,
``predictive``) against the JAX package's, float64, on
``test_torch_uncertainty.py``'s problem: each quantity's gradient or
Jacobian is taken by ``torch.autograd`` of the law, the contractions in
numpy float64, the draws from the same ``default_rng`` stream. 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.inverse import uncertainty as junc
from odinn_tpu.laws.laws import LawA as JLawA
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.laws.laws import eval_law as j_eval_law
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.models.model import init_theta as j_init_theta
from odinn_tpu.models.nn import NeuralNetwork as JNN
from odinn_tpu.models.nn import default_architecture as j_arch
from odinn_tpu_torch.inverse import uncertainty as tunc
from odinn_tpu_torch.laws.laws import LawA as TLawA
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.laws.laws import eval_law as t_eval_law
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN
from odinn_tpu_torch.models.nn import default_architecture as t_arch
from odinn_tpu_torch.utils.flatten import stack_to_rows, tree_leaves
from tests.test_torch_uncertainty import _params, _short
from tests.test_torch_uncertainty import classical  # noqa: F401  (the module fixture)
from tests.torch_parity import assert_rel, tree_to_port


def test_law_std_band_cov_band_sample_predictive_match_jax(classical):
    """On the light NN law A(T) at its JAX initial θ with prior_std 1 (first
    month's residuals): the
    delta-method std of the law at one temperature, the band and the full
    covariance over 7 temperatures, 16 posterior draws (the same
    default_rng stream) and the predictive of a linear quantity. 1e-8."""
    jb, tb, _, _, _ = classical
    jp, tp = _params(JP), _params(TP)
    jnn = JNN(j_arch(1, light=True), seed=3)
    jmodel = JModel(iceflow=JSIA2DModel(A=JLawA(jnn, jp)))
    tmodel = TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp)))
    jtheta = j_init_theta(jmodel, jb)
    jpost = junc.laplace_posterior(jtheta, jb, _short(JP, jmodel, jb), prior_std=1.0)
    post = tunc.laplace_posterior(tree_to_port(jtheta), tb, _short(TP, tmodel, tb),
                                  prior_std=1.0)
    assert_rel(post._cov, jpost._cov, 1e-8, "Σ")
    temps = np.linspace(-25.0, -10.0, 7)
    jlaw, law = jmodel.iceflow.A, tmodel.iceflow.A

    def jband(th):
        return jax.vmap(lambda T: jlaw.apply(th, {"T": T, "glacier_idx": jnp.asarray(0)}))(
            jnp.asarray(temps))

    def band(th):
        return law.apply(th, {"T": torch.as_tensor(temps), "glacier_idx": torch.tensor(0)})

    q, s = post.std(lambda th: band(th)[0])
    jq, js = jpost.std(lambda th: jband(th)[0])
    assert_rel(q, float(jq), 1e-8, "law value")
    assert_rel(s, float(js), 1e-8, "law std")
    vals, stds = post.band(band)
    jvals, jstds = jpost.band(jband)
    assert_rel(vals, np.asarray(jvals), 1e-8, "band values")
    assert_rel(stds, np.asarray(jstds), 1e-8, "band stds")
    _, C = post.cov_band(band)
    _, jC = jpost.cov_band(jband)
    assert_rel(C, jC, 1e-8, "band covariance")
    assert_rel(np.sqrt(np.diag(C)), stds, 1e-10, "cov_band diagonal")
    draws = post.sample(16, seed=42)
    jdraws = jpost.sample(16, seed=42)
    assert_rel(stack_to_rows(draws), np.asarray(jax.vmap(
        lambda th: jax.flatten_util.ravel_pytree(th)[0])(jdraws)), 1e-8, "draws")
    w = np.linspace(-1.0, 1.0, 13)

    def lin(th):
        return sum(float(w[i]) * x.reshape(-1)[0] for i, x in enumerate(tree_leaves(th)))

    def jlin(th):
        return sum(float(w[i]) * x.reshape(-1)[0] for i, x in enumerate(jax.tree.leaves(th)))

    m, sd = post.predictive(lin, n=16, seed=7)
    jm, jsd = jpost.predictive(jlin, n=16, seed=7)
    assert_rel(m, jm, 1e-8, "predictive mean")
    assert_rel(sd, jsd, 1e-8, "predictive std")


def test_per_glacier_law_std_matches_jax(classical):
    """The delta-method std of glacier 0's physical A through the tanh
    bound (``eval_law``), per-glacier path. 1e-8."""
    jb, tb, jtheta, jres, tres = classical
    jp, tp = _params(JP), _params(TP)
    jpost = junc.laplace_posterior(jtheta, jb, jres, structure="per_glacier")
    post = tunc.laplace_posterior(tree_to_port(jtheta), tb, tres, structure="per_glacier")
    jlaw, law = JLawA_inversion(jp, scalar=True), TLawA_inversion(tp, scalar=True)
    jq, js = jpost.std(lambda th: j_eval_law(jlaw, th, None, glacier_idx=0))
    q, s = post.std(lambda th: t_eval_law(law, th, None, glacier_idx=0))
    assert_rel(q, float(jq), 1e-12, "A₀")
    assert_rel(s, float(js), 1e-8, "std of A₀")
