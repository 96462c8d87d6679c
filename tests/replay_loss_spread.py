"""The spread behind ``tests/test_torch_replay.py``'s REPLAY_LOSS_RTOL, in
the instability test's setting (reltol 1e-2, 24² grid, float64 on the CPU).

    python -m tests.replay_loss_spread

Prints, at the initial θ, each package's recorded schedule against the
other's and the port's loss on its own schedule and on JAX's; then, when
H0 moves by one ulp (down, up, and by the factor 1 + 2^-50), the JAX
package's schedule at θ0 and its losses before its last failure, relative
to the unperturbed run's.
"""

import dataclasses
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_replay import TSPAN, _instability_setting  # noqa: E402
from tests.torch_parity import carry_glacier  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax_losses(g, jp, jmodel):
    """The JAX package's losses before its last failure, trained from
    A = -2 on glacier ``g`` as the test trains it."""
    from odinn_tpu.simulation.inversion import Inversion, train_ude

    inv = Inversion(model=jmodel, glaciers=[g], parameters=jp)
    inv.theta = {"A": jnp.asarray([-2.0])}
    seen = {}
    try:
        train_ude(inv, callback=lambda stats: seen.setdefault("stats", stats))
    except FloatingPointError:
        pass
    return np.asarray(seen["stats"].losses[:-1])


def main():
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.simulation.inversion import batch_transient_loss as j_loss
    from odinn_tpu.simulation.prediction import resolve_replay as j_resolve
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.inversion import batch_transient_loss
    from odinn_tpu_torch.simulation.prediction import resolve_replay
    from odinn_tpu_torch.simulation.solver import build_tstops

    torch.set_num_threads(1)
    jp, tp, g_obs, jmodel, tmodel = _instability_setting()
    jb = stack_glaciers([g_obs])
    tb = carry_glacier(jb)
    jts, ts = j_tstops(TSPAN, 1 / 12), build_tstops(TSPAN, 1 / 12)
    jth, th = {"A": jnp.asarray([-2.0])}, {"A": torch.tensor([-2.0], dtype=torch.float64)}
    jpr = j_resolve(jp, jb, jmodel, jth, jts)
    tpr = resolve_replay(tp, tb, tmodel, th, ts)
    j_dts = np.asarray(jpr.solver.replay_dts)
    step = j_dts > 0
    print("steps at θ0, port against JAX, relative to each step: "
          f"{np.max(np.abs(tpr.solver.replay_dts - j_dts)[step] / j_dts[step]):.3e}")
    jl = float(j_loss(jth, jb, jmodel, jpr, jts))
    own = float(batch_transient_loss(th, tb, tmodel, tpr, ts))
    on_jax = float(batch_transient_loss(
        th, tb, tmodel, tp.replace(solver=dataclasses.replace(tp.solver, replay_dts=j_dts)), ts))
    print(f"loss at θ0, port against JAX: own schedule {_rel(own, jl):.3e}, "
          f"JAX's schedule {_rel(on_jax, jl):.3e}")
    base = _jax_losses(g_obs, jp, jmodel)
    for what, move in (("one ulp down", lambda h: jnp.nextafter(h, -jnp.inf)),
                       ("one ulp up", lambda h: jnp.nextafter(h, jnp.inf)),
                       ("x (1 + 2^-50)", lambda h: h * (1.0 + 2.0 ** -50))):
        g = g_obs.replace(H0=jnp.where(g_obs.H0 > 0, move(g_obs.H0), g_obs.H0))
        dts = np.asarray(j_resolve(jp, stack_glaciers([g]), jmodel, jth, jts).solver.replay_dts)
        print(f"JAX steps at θ0, H0 {what}, relative to each step: "
              f"{np.max(np.abs(dts - j_dts)[step] / j_dts[step]):.3e}"
              if dts.shape == j_dts.shape else "other shape")
        losses = _jax_losses(g, jp, jmodel)
        print(f"JAX losses before the last failure, H0 {what}: "
              f"{_rel(losses, base):.3e}" if losses.shape == base.shape else "other length")


if __name__ == "__main__":
    main()
