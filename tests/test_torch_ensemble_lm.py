"""odinn_tpu_torch's multi-start LM refinement (``multistart_train`` with
``refine_top_k``, ``simulation/ensemble.py``) against the JAX package's, on
``test_torch_ensemble.py``'s problem and the JAX package's Rademacher
probes (its ``lm_train`` draw carried into the port, as
``test_torch_lm_trace.py`` does). Float64.
"""

import numpy as np

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.models.model import init_theta as j_init_theta
from odinn_tpu.simulation import ensemble as jens
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu_torch.inverse import gauss_newton as tgn
from odinn_tpu_torch.simulation import ensemble as tens
from odinn_tpu_torch.simulation import inversion as tinv
from tests.test_torch_ensemble import _jax_thetas, _models, _params
from tests.test_torch_ensemble import truth  # noqa: F401  (the module fixture)
from tests.test_torch_gauss_newton import _jax_probes
from tests.torch_parity import CPU, assert_rel, tree_to_port


def test_refine_top_k_lm_matches_jax(truth, monkeypatch):
    """Adam 2 epochs on 3 restarts, then LM 2 iterations on the best
    survivor, on JAX's θ stack and JAX's Rademacher probes: the refined
    restart, its loss, the winner and its θ. 1e-8."""
    jb, tb = truth
    kw = dict(optimizer=("adam", "lm"), lr=(0.08, 1e-2), epochs=(2, 2))
    jp, tp = _params(JP, **kw), _params(TP, **kw)
    jmodel, tmodel = _models("A", jp, tp)
    jthetas = _jax_thetas("A", jmodel, jb, 3, jp)
    jms = jens.multistart_train(JInversion(model=jmodel, glaciers=jb, parameters=jp),
                                thetas=jthetas, refine_top_k=1)
    probes = [tree_to_port(v) for v in _jax_probes(j_init_theta(jmodel, jb), 8)]
    monkeypatch.setattr(tgn, "_draw_probes", lambda gen, theta, n: probes[:n])
    inv = tinv.Inversion(model=tmodel, glaciers=tb, parameters=tp, device=CPU)
    ms = tens.multistart_train(inv, thetas=tree_to_port(jthetas), refine_top_k=1)
    assert list(ms.refined_idxs) == list(jms.refined_idxs)
    assert_rel(ms.refined_losses, jms.refined_losses, 1e-8, "refined losses")
    assert ms.best_idx == jms.best_idx
    assert_rel(ms.best_loss, jms.best_loss, 1e-8, "best loss")
    assert_rel(inv.theta["A"], np.asarray(jms.best_theta["A"]), 1e-8, "best θ")
    assert ms.best_loss <= np.min(ms.final_losses) * (1 + 1e-12)
