"""The first Levenberg–Marquardt step from the Adam iterate, on one CUDA card.

    python3 profile_lm_step.py

Builds the kernels, then takes chip_smoke.py's SI training problem
(A = NN(T), PCG-20) at full width (16 x 128^2, float32, 24 months) and its
float64 cut (4 x 128^2, 6 months), trains each by Adam as phase 13 does (3
and 2 epochs) and prints one JSON line per problem:

- ``leaves``: each θ leaf's shape, max |θ|, max |Jᵀr| and the 8-probe
  Hutchinson estimate of diag(JᵀJ) that ``lm_train``'s first iteration
  damps and preconditions with (``gauss_newton.diag_estimate`` on the
  probes of its seed 0);
- ``steps``: for each initial damping in LAMBDAS, the step that first
  iteration proposes (the same CG on the same system as ``lm_train``):
  the loss before it and at the candidate, whether the accept rule takes
  it, and its max |δ| on each leaf.

It explains why phase 13's LM stages start at a large damping. Without a
CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LAMBDAS = (1e-3, 1e4, 1e5, 1e6)


def first_step(cs, kw, adam_epochs, cg_iters):
    from odinn_tpu_torch.inverse import gauss_newton as gn
    from odinn_tpu_torch.simulation.inversion import train_ude

    inv, model, params, tstops, _ = cs.training_problem("SI", "jax", **kw)
    inv.parameters = params.replace(hyper=dataclasses.replace(
        params.hyper, optimizer=("adam",), learning_rate=(0.05,), epochs=(adam_epochs,)))
    train_ude(inv)
    theta = gn._tmap(lambda x: x.detach(), inv.theta)
    batch = inv.glaciers
    resid = gn.make_residual_fn(model, params, tstops)
    r, pb = gn.linearize(resid, theta, batch)
    loss = float(torch.sum(r * r))
    g = pb(r)
    gen = torch.Generator().manual_seed(0)
    diag, _ = gn.diag_estimate(theta, batch, resid, pb,
                               gn._draw_probes(gen, theta, cs.LM_PROBES))
    leaves = [{"shape": list(t.shape), "theta_max": float(t.abs().max()),
               "grad_max": float(gg.abs().max()), "diag": float(d.flatten()[0])}
              for t, gg, d in zip(gn._leaves(theta), gn._leaves(g), gn._leaves(diag))]
    steps = []
    for lam in LAMBDAS:
        def gnvp(v, lam=lam):
            jtv = pb(gn.jvp(resid, theta, batch, v))
            return gn._tmap(lambda a, d, vi: a + lam * d * vi, jtv, diag, v)

        minv = gn._tmap(lambda d: 1.0 / (d * (1.0 + lam)), diag)
        delta = gn._cg_tree(gnvp, gn._tmap(torch.neg, g), cg_iters, minv=minv)
        with torch.no_grad():
            r_new = resid(gn._tmap(torch.add, theta, delta), batch)
        new = float(torch.sum(r_new * r_new))
        steps.append({"init_damping": lam, "loss": loss, "candidate_loss": new,
                      "accepted": new < loss,
                      "step_max_by_leaf": [float(x.abs().max()) for x in gn._leaves(delta)]})
    return {"adam_epochs": adam_epochs, "gn_cg_iters": cg_iters,
            "dtype": str(kw.get("dtype", torch.float32)), "leaves": leaves, "steps": steps}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lm_step: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from odinn_tpu_torch.ops.cuda.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    print(cs.nvidia_smi(), flush=True)
    for name, kw, adam, cg in (
            ("full", {}, cs.SCALE_OUT_EPOCHS[0], cs.LM_CG),
            ("cut", dict(n_g=cs.SCALE_OUT_CUT_G, tspan=cs.SCALE_OUT_CUT_TSPAN,
                         dtype=torch.float64), cs.SCALE_OUT_CUT_EPOCHS[0], cs.SCALE_OUT_CUT_CG)):
        print(json.dumps(dict({"problem": name}, **first_step(cs, kw, adam, cg))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
